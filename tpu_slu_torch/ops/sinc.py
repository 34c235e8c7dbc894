"""SincNet band-pass filterbank front end, in PyTorch.

Port of ``tpu_slu/ops/sinc.py``. Keeps both quirks of the reference's float32
math: the ``t_right = linspace(1, (N-1)/2, (N-1)/2) / fs`` grid and the
Hamming window on the *inclusive* ``linspace(0, N, N)`` grid.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_slu_torch.ops.conv import conv1d


def mel_init(n_filt: int, fs: int) -> tuple[np.ndarray, np.ndarray]:
    """Mel-spaced (filt_b1, filt_band), normalised by fs."""
    low_freq_mel = 80.0
    high_freq_mel = 2595.0 * np.log10(1.0 + (fs / 2.0) / 700.0)
    mel_points = np.linspace(low_freq_mel, high_freq_mel, n_filt)
    f_cos = 700.0 * (10.0 ** (mel_points / 2595.0) - 1.0)
    b1 = np.roll(f_cos, 1)
    b2 = np.roll(f_cos, -1)
    b1[0] = 30.0
    b2[-1] = (fs / 2.0) - 100.0
    freq_scale = float(fs)
    return (b1 / freq_scale).astype(np.float32), ((b2 - b1) / freq_scale).astype(np.float32)


def sinc_filters(filt_b1: torch.Tensor, filt_band: torch.Tensor, filt_dim: int, fs: int):
    """(N_filt, filt_dim) Hamming-windowed band-pass bank, peak-normalised."""
    N = filt_dim
    dev = filt_b1.device
    filt_b1 = filt_b1.float()
    filt_band = filt_band.float()
    beg = filt_b1.abs() + 50.0 / fs
    end = beg + (filt_band.abs() + 50.0 / fs)

    half = (N - 1) // 2
    t_right = torch.linspace(1.0, (N - 1) / 2.0, half, dtype=torch.float32, device=dev) / fs

    def low_pass(cut):  # (F,) normalised cutoff -> (F, N) scaled sinc
        arg = 2.0 * math.pi * (cut[:, None] * fs) * t_right[None, :]
        y_right = torch.sin(arg) / arg
        ones = torch.ones((cut.shape[0], 1), dtype=torch.float32, device=dev)
        y = torch.cat([y_right.flip(1), ones, y_right], dim=1)
        return 2.0 * cut[:, None] * y

    band_pass = low_pass(end) - low_pass(beg)
    band_pass = band_pass / band_pass.max(dim=1, keepdim=True).values
    n = torch.linspace(0.0, float(N), N, dtype=torch.float32, device=dev)
    window = 0.54 - 0.46 * torch.cos(2.0 * math.pi * n / N)
    return band_pass * window


def sinc_conv(filt_b1, filt_band, x, filt_dim: int, fs: int, stride: int, padding: int):
    """x (B, 1, T) -> (B, N_filt, T_out), one conv over the whole bank."""
    filters = sinc_filters(filt_b1, filt_band, filt_dim, fs)
    return conv1d(x, filters[:, None, :], None, stride=stride, padding=padding)
