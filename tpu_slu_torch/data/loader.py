"""Bucket arithmetic of ``tpu_slu/data/loader.py`` (the batch loader is not ported)."""

from __future__ import annotations

WAVE_BUCKET_QUANT = 8000  # 0.5 s at 16 kHz: the bucket of bucket=True decodes and of the server


def pad_to_bucket(t: int, quant: int) -> int:
    """Smallest multiple of ``quant`` >= t (at least ``quant``)."""
    return max(quant, ((t + quant - 1) // quant) * quant)
