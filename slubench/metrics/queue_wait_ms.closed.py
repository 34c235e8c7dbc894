"""Mean time a request waited in ``IntentServer``'s queue over the traced
window: the program's ``serve.queue`` spans, from ``submit`` until the
worker took the request (``slubench/spans.py``)."""

from slubench.spans import mean_ms, window_spans

UNIT = "ms"
LAYER = "micro-batcher: serving.py IntentServer"
MOVES = "serve_p95_ms"
SOURCE = "program_span"


def read(ctx):
    return mean_ms([s.dur for s in window_spans(ctx, "serve.queue")])
