"""1-D convolution and ceil-mode pooling with torch semantics.

Port of ``tpu_slu/ops/conv.py`` (unmasked ops). Conv layout is (B, C, T);
the RNN stack uses (B, T, C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d(x, kernel, bias=None, stride: int = 1, padding: int = 0):
    """x (B, Cin, T), kernel (Cout, Cin, K) -> (B, Cout, T_out), in f32.

    On a CUDA tensor the conv goes to cuDNN with TF32 off for this call alone
    (``F.conv1d`` would follow the process-wide ``cudnn.allow_tf32``, True by
    default), as a (B, Cin, 1, T) conv the way ``F.conv1d`` hands it over.
    """
    if x.device.type != "cuda":
        return F.conv1d(x, kernel, bias, stride=stride, padding=padding)
    out = torch.cudnn_convolution(
        x[:, :, None, :], kernel[:, :, None, :], (0, padding), (1, stride), (1, 1), 1,
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic, False)[:, :, 0, :]
    return out if bias is None else out + bias[:, None]


def max_pool1d_ceil(x, k: int):
    """``max_pool1d(kernel_size=k, ceil_mode=True)`` on (B, C, T)."""
    if k == 1:
        return x
    return F.max_pool1d(x, k, ceil_mode=True)


def avg_pool1d_ceil(x, k: int):
    """``avg_pool1d(kernel_size=k, ceil_mode=True)`` on (B, C, T).

    With no padding, torch divides a trailing partial window by the number
    of its elements inside the input, as the JAX twin does.
    """
    if k == 1:
        return x
    return F.avg_pool1d(x, k, ceil_mode=True)


def downsample(x, method: str, factor: int, time_axis: int = 1):
    """Time-axis decimation: "none" -> strided slice; "avg"/"max" -> ceil pool."""
    if method not in ("none", "avg", "max"):
        raise ValueError(f"downsample method must be none/avg/max, got {method!r}")
    if factor == 1:
        return x
    if method == "none":
        idx = [slice(None)] * x.ndim
        idx[time_axis] = slice(None, None, factor)
        return x[tuple(idx)]
    xt = x.transpose(time_axis, x.ndim - 1)
    shape = xt.shape
    flat = xt.reshape(-1, 1, shape[-1])
    pooled = max_pool1d_ceil(flat, factor) if method == "max" else avg_pool1d_ceil(flat, factor)
    return pooled.reshape(*shape[:-1], pooled.shape[-1]).transpose(time_axis, x.ndim - 1)


def leaky_relu(x, negative_slope: float = 0.2):
    return F.leaky_relu(x, negative_slope)
