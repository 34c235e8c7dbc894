"""Launches, copies and sets a device call enqueues: the trace's host
``cudaLaunchKernel*``, ``cudaMemcpyAsync`` and ``cudaMemsetAsync`` events
that begin inside a ``decode`` span, over the number of ``decode`` spans in
the window (``slubench/spans.py``). Nothing to read where the trace holds
no such host event."""

import bisect

from slubench.spans import LAUNCH_PREFIXES, window_spans

UNIT = "launches/call"
LAYER = "decode API: models/slu.py Model.decode_intents"
MOVES = "serve_utt_per_s"
SOURCE = "program_span"


def read(ctx):
    decodes = window_spans(ctx, "decode")
    launches = [t for name, t, _ in ctx["trace"].host if name.startswith(LAUNCH_PREFIXES)] if decodes else []
    if not launches:
        return None
    starts = [s.t0 for s in decodes]
    inside = 0
    for t in launches:
        i = bisect.bisect_right(starts, t) - 1
        inside += i >= 0 and t < decodes[i].t1
    return inside / len(decodes)
