"""Share of the traced window in which no operation ran on the device (the
union of its kernels, copies and sets, ``slubench/trace.py``)."""

UNIT = "%"
LAYER = "device"
MOVES = "serve_utt_per_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx.get("trace")
    busy = tr.busy_s() if tr is not None else 0.0
    if busy <= 0.0 or tr.window_s <= 0.0:  # no operation ran: nothing to read
        return None
    return 100.0 * (1.0 - busy / tr.window_s)
