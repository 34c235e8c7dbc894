"""Share of the traced window's device calls that a CUDA graph's replay
answered: of the ``decode`` spans (``Model.decode_intents``) whose device
work was recorded, under a ``decode.replay``, ``decode.capture`` or eager
``decode.frontend`` child, those with a ``decode.replay`` child
(``slubench/spans.py``). Nothing to read from a program without the
decode's graphs (``tpu_slu_torch/models/decode_graph.py``), without such
spans, or where no device operation ran."""

from slubench.spans import program_spans, window_spans

UNIT = "%"
LAYER = "decode API: models/slu.py Model.decode_intents"
MOVES = "serve_utt_per_s"
SOURCE = "program_span"
ROUTES = ("decode.replay", "decode.capture", "decode.frontend")


def read(ctx):
    try:
        import tpu_slu_torch.models.decode_graph  # noqa: F401
    except ImportError:
        return None
    routes: dict = {}
    for s in program_spans(ctx):
        if s.name in ROUTES:
            routes.setdefault(s.parent, set()).add(s.name)
    decodes = [routes[s.id] for s in window_spans(ctx, "decode") if s.id in routes]
    if not decodes or not ctx["trace"].busy_intervals():
        return None
    return 100.0 * sum("decode.replay" in r for r in decodes) / len(decodes)
