"""WAV decoding with the standard library's ``struct`` and numpy.

Port of ``tpu_slu/data/audio.py`` without its native C++ branch: RIFF/WAVE
parsing of PCM 8/16/24/32-bit and IEEE float32/float64, mono or
multi-channel (channel 0 by default), WAVE_FORMAT_EXTENSIBLE by its bit
depth. Samples are scaled to [-1, 1) in float64 exactly as there, then cast.
"""

from __future__ import annotations

import struct

import numpy as np

_PCM_DTYPES = {8: np.uint8, 16: np.dtype("<i2"), 32: np.dtype("<i4")}


def read_wav(path: str, dtype=np.float32, channel: int | None = 0):
    """Decode a WAV file -> (samples, sample_rate).

    samples: 1-D ``dtype`` array in [-1, 1) for the requested channel
    (``channel=None`` returns (frames, channels)).
    """
    with open(path, "rb") as f:
        data = f.read()
    return decode_wav_bytes(data, dtype=dtype, channel=channel, name=path)


def decode_wav_bytes(data: bytes, dtype=np.float32, channel: int | None = 0,
                     name: str = "<bytes>"):
    """Decode in-memory RIFF/WAVE bytes -> (samples, sample_rate), as
    :func:`read_wav`; the server decodes request bodies with it."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{name}: not a RIFF/WAVE file")

    fmt = None
    raw = None
    pos = 12
    n = len(data)
    while pos + 8 <= n:
        cid, size = data[pos : pos + 4], struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or raw is None:
        raise ValueError(f"{name}: missing fmt/data chunk")

    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: integer PCM or float by depth
        audio_format = 1 if bits in (8, 16, 24, 32) else 3

    if audio_format == 1:  # integer PCM
        if bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = (x ^ 0x800000) - 0x800000  # sign-extend
            out = x.astype(np.float64) / 8388608.0
        else:
            dt = _PCM_DTYPES.get(bits)
            if dt is None:
                raise ValueError(f"{name}: unsupported PCM bit depth {bits}")
            x = np.frombuffer(raw, dtype=dt)
            if bits == 8:
                out = (x.astype(np.float64) - 128.0) / 128.0
            else:
                out = x.astype(np.float64) / float(2 ** (bits - 1))
    elif audio_format == 3:  # IEEE float
        dt = np.dtype("<f4") if bits == 32 else np.dtype("<f8")
        out = np.frombuffer(raw, dtype=dt).astype(np.float64)
    else:
        raise ValueError(f"{name}: unsupported WAV format tag {audio_format}")

    if channels > 1:
        out = out[: (len(out) // channels) * channels].reshape(-1, channels)
        if channel is not None:
            out = out[:, channel]
    return out.astype(dtype), sample_rate


def write_wav(path: str, samples, sample_rate: int) -> None:
    """Write mono float [-1, 1] samples as 16-bit PCM."""
    x = np.clip(np.asarray(samples, np.float64), -1.0, 1.0 - 1.0 / 32768)
    pcm = (x * 32768.0).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(pcm))
    with open(path, "wb") as f:
        f.write(hdr + pcm)
