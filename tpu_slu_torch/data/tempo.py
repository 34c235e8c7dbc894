"""Pitch-preserving tempo change (WSOLA) for train-time augmentation.

The port's own copy of ``tpu_slu/data/tempo.py``, the sox ``tempo``
semantics the reference requested: output frames lie on a fixed 50%-overlap
Hann grid ``hop_out`` samples apart; the input read position advances
``speed * hop_out`` a frame, so the output holds ``len(x)/speed`` samples;
each frame is taken at the offset within ``search`` samples that best
correlates with the natural continuation of the frame before it, which keeps
the pitch. Pure numpy, on the loader's threads.
"""

from __future__ import annotations

import numpy as np


def wsola_tempo(
    x: np.ndarray,
    speed: float,
    frame: int = 400,
    search: int = 120,
) -> np.ndarray:
    """Time-stretch ``x`` by ``speed`` without changing pitch.

    ``speed > 1`` shortens (faster speech), ``speed < 1`` lengthens; the
    output has ``round(len(x)/speed)`` samples. ``frame`` is the analysis
    window (25 ms at 16 kHz), ``search`` the alignment tolerance (7.5 ms).
    """
    x = np.asarray(x, np.float32)
    n = len(x)
    hop_out = frame // 2
    if abs(speed - 1.0) < 1e-4 or n < frame + hop_out:
        return x.copy()
    hop_in = speed * hop_out
    out_len = int(round(n / speed))
    win = np.hanning(frame).astype(np.float32)
    out = np.zeros(out_len + frame, np.float32)
    wsum = np.zeros(out_len + frame, np.float32)

    sel = 0  # input start of the previously copied frame
    k = 0
    while k * hop_out < out_len:
        center = int(round(k * hop_in))
        if center > n - frame:
            break
        if k == 0:
            sel = center
        else:
            # natural continuation of the previous frame: the segment that
            # follows it verbatim in the input
            tgt_start = sel + hop_out
            if tgt_start + frame > n:
                break
            target = x[tgt_start : tgt_start + frame]
            lo = max(0, center - search)
            hi = min(n - frame, center + search)
            if hi > lo:
                corr = np.correlate(x[lo : hi + frame], target, "valid")
                sel = lo + int(np.argmax(corr))
            else:
                sel = max(0, min(center, n - frame))
        pos = k * hop_out
        out[pos : pos + frame] += x[sel : sel + frame] * win
        wsum[pos : pos + frame] += win
        k += 1

    # normalize the overlap-add (interior sums to ~1 on the 50% Hann grid;
    # the edges and any early-break tail need the division) and fall back to
    # the raw input where no frame landed at all
    covered = wsum > 1e-3
    out[covered] /= wsum[covered]
    out = out[:out_len]
    uncovered = ~covered[:out_len]
    if uncovered.any():
        src = np.minimum((np.nonzero(uncovered)[0] * speed).astype(np.int64), n - 1)
        out[uncovered] = x[src]
    return out
