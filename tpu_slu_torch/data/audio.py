"""16-bit PCM WAV reading with the standard library's ``wave`` and numpy.

Port of ``read_wav`` in ``tpu_slu/data/audio.py`` for the format the decode
path takes: samples are scaled to [-1, 1) exactly as there (int16 / 32768 in
float64, then cast to float32).
"""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Decode a 16-bit PCM WAV file -> (float32 samples of channel 0, sample rate)."""
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: {8 * w.getsampwidth()}-bit samples; only 16-bit PCM is read")
        channels = w.getnchannels()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    x = np.frombuffer(raw, dtype="<i2")
    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels)[:, 0]
    return (x.astype(np.float64) / 32768.0).astype(np.float32), rate
