"""Mean host time of a ``decode_intents`` call over the traced window, timed
by the forwarding model the benchmark hands ``IntentServer``."""

UNIT = "ms"
LAYER = "decode API: models/slu.py Model.decode_intents"
MOVES = "serve_p95_ms"
SOURCE = "host_clock"


def read(ctx):
    calls = ctx.get("calls")
    if not calls:
        return None
    return 1e3 * sum(c["t1"] - c["t0"] for c in calls) / len(calls)
