"""K7's bound for the real rows of the traced window's calls, each over its
own valid frames (``slubench/work.py`` ``k7_call_bound_s``), over the device
time of K7 (``ops/beam_fused.py``, found by kernel name), as a share."""

from slubench.work import k7_call_bound_s

UNIT = "%"
LAYER = "kernel: ops/beam_fused.py"
MOVES = "serve_utt_per_s"
SOURCE = "device_trace"
PATTERNS = (r"beam_decode_kernel",)


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("calls"):
        return None
    t = tr.device_time(PATTERNS)
    if t <= 0.0:
        return None
    bound = sum(k7_call_bound_s(ctx["arch"], c["lengths"], ctx["W"], ctx["U"]) for c in ctx["calls"])
    return 100.0 * bound / t
