"""Mean time of a call's input copy to the device: the program's
``decode.h2d`` spans (``torch.as_tensor`` of the padded batch and its
lengths from pageable host memory; ``slubench/spans.py``)."""

from slubench.spans import mean_ms, window_spans

UNIT = "ms"
LAYER = "decode API: models/slu.py Model.decode_intents"
MOVES = "serve_utt_per_s"
SOURCE = "program_span"


def read(ctx):
    return mean_ms([s.dur for s in window_spans(ctx, "decode.h2d")])
