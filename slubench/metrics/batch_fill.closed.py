"""Requests a device call carried, on average over the traced window:
``IntentServer.batch_sizes``, the server's count of its calls by the
number of requests each carried."""

UNIT = "req/call"
LAYER = "micro-batcher: serving.py IntentServer"
MOVES = "serve_utt_per_s"
SOURCE = "program_counter"


def read(ctx):
    fill = ctx.get("batch_fill")
    calls = sum(fill.values()) if fill else 0
    if calls <= 0:
        return None
    return sum(k * v for k, v in fill.items()) / calls
