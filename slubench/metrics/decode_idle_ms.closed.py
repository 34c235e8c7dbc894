"""Mean time inside a ``decode`` span (``Model.decode_intents``) in which
the device ran no operation: each span, on the trace's clock and clipped
to its window, less the device's busy intervals of the trace
(``slubench/spans.py``). Nothing to read where no device operation ran."""

from slubench.spans import covered, mean_ms, window_spans

UNIT = "ms"
LAYER = "decode API: models/slu.py Model.decode_intents"
MOVES = "serve_utt_per_s"
SOURCE = "program_span"


def read(ctx):
    decodes = window_spans(ctx, "decode")
    busy = ctx["trace"].busy_intervals() if decodes else []
    if not busy:
        return None
    return mean_ms([s.dur - covered(s.t0, s.t1, busy) for s in decodes])
