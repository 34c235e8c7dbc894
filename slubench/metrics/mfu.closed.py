"""Useful FLOPs of the traced window's decodes, over the window, as a share
of the card's f32 peak: each real request at its own length through the
encoder, the intent encoder, the key and value projections and every step
of the search (``slubench/work.py`` ``decode_flops``)."""

from slubench.work import PEAK_F32, decode_flops

UNIT = "%"
LAYER = "decode API: models/slu.py Model.decode_intents"
MOVES = "serve_utt_per_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("calls"):
        return None
    flops = sum(decode_flops(ctx["arch"], int(n), ctx["W"], ctx["U"]) for c in ctx["calls"]
                for n in c["lengths"] if n > 0)
    return 100.0 * flops / tr.window_s / PEAK_F32
