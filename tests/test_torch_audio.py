"""The port's WAV decoding against the JAX package's, on every format it reads."""

import struct

import numpy as np
import pytest

from tpu_slu.data import audio as jaudio
from tpu_slu_torch.data.audio import decode_wav_bytes, read_wav, write_wav

RATE = 16000


def riff(fmt_tag: int, channels: int, bits: int, data: bytes, extensible: bool = False,
         junk: bytes = b"") -> bytes:
    """RIFF/WAVE bytes: a fmt chunk (40 bytes when ``extensible``), an
    optional odd-sized LIST chunk before the data (tests word alignment)."""
    block = channels * bits // 8
    tag = 0xFFFE if extensible else fmt_tag
    fmt = struct.pack("<HHIIHH", tag, channels, RATE, RATE * block, block, bits)
    if extensible:  # cbSize, valid bits, channel mask, SubFormat GUID
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt_tag) + bytes(14)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if junk:
        body += b"LIST" + struct.pack("<I", len(junk)) + junk + (b"\0" if len(junk) & 1 else b"")
    body += b"data" + struct.pack("<I", len(data)) + data
    return b"RIFF" + struct.pack("<I", len(body)) + body


def samples(rng, bits: int, frames: int, channels: int) -> tuple[int, bytes]:
    n = frames * channels
    if bits == 8:
        return 1, rng.integers(0, 256, n).astype(np.uint8).tobytes()
    if bits == 16:
        return 1, rng.integers(-2**15, 2**15, n).astype("<i2").tobytes()
    if bits == 24:
        v = rng.integers(-2**23, 2**23, n).astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
        return 1, v.tobytes()
    if bits == 32:
        return 1, rng.integers(-2**31, 2**31, n, dtype=np.int64).astype("<i4").tobytes()
    dt = "<f4" if bits == -32 else "<f8"
    return 3, rng.uniform(-1, 1, n).astype(dt).tobytes()


FORMATS = [8, 16, 24, 32, -32, -64]  # negative: IEEE float of that width


@pytest.mark.parametrize("extensible", [False, True], ids=["plain", "extensible"])
@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
@pytest.mark.parametrize("bits", FORMATS, ids=lambda b: f"float{-b}" if b < 0 else f"pcm{b}")
def test_decode_wav_bytes_matches_jax(rng, bits, channels, extensible):
    tag, data = samples(rng, bits, 101, channels)
    wav = riff(tag, channels, abs(bits), data, extensible=extensible, junk=b"odd")
    for kw in ({}, {"channel": 1 if channels == 2 else 0}, {"channel": None},
               {"dtype": np.float64}):
        got, fs = decode_wav_bytes(wav, **kw)
        ref, ref_fs = jaudio.decode_wav_bytes(wav, **kw)
        assert fs == ref_fs == RATE
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    assert np.abs(decode_wav_bytes(wav)[0]).max() <= 1.0


@pytest.mark.parametrize("bad", [b"nope", riff(1, 1, 12, b"\0" * 6), riff(2, 1, 16, b"\0" * 4),
                                 b"RIFF\0\0\0\0WAVE"], ids=["not_riff", "pcm12", "adpcm", "no_chunks"])
def test_unreadable_bytes_raise_as_jax(bad):
    with pytest.raises(ValueError):
        jaudio.decode_wav_bytes(bad)
    with pytest.raises(ValueError):
        decode_wav_bytes(bad)


def test_read_and_write_wav_match_jax(rng, tmp_path):
    x = rng.uniform(-1.2, 1.2, 3001)
    write_wav(str(tmp_path / "port.wav"), x, RATE)
    jaudio.write_wav(str(tmp_path / "jax.wav"), x, RATE)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    got, fs = read_wav(str(tmp_path / "port.wav"))
    ref, _ = jaudio.decode_wav_bytes((tmp_path / "jax.wav").read_bytes())
    assert fs == RATE
    np.testing.assert_array_equal(got, ref)
