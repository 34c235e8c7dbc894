"""Mean time of a device call that ``IntentServer`` spends outside the
model's decode: each ``serve.batch`` span (first request taken to last
answer set: draining, padding, resolving the futures and the callbacks they
run) less the part its ``decode`` child covers (``slubench/spans.py``)."""

from slubench.spans import covered, mean_ms, union, window_spans

UNIT = "ms"
LAYER = "micro-batcher: serving.py IntentServer"
MOVES = "serve_utt_per_s"
SOURCE = "program_span"


def read(ctx):
    spans = window_spans(ctx)
    decodes: dict = {}
    for s in spans:
        if s.name == "decode":
            decodes.setdefault(s.parent, []).append((s.t0, s.t1))
    return mean_ms([b.dur - covered(b.t0, b.t1, union(decodes.get(b.id, [])))
                    for b in spans if b.name == "serve.batch"])
