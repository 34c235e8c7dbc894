"""1-D convolution and ceil-mode pooling with torch semantics.

Port of ``tpu_slu/ops/conv.py``: the ops, and the length-aware ceil pools
of the length-exact path (``masked_*``, per-example valid frame counts
``n``). Conv layout is (B, C, T); the RNN stack uses (B, T, C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _CudnnConv1dF32(torch.autograd.Function):
    """cuDNN conv of (B, Cin, 1, T) by (Cout, Cin, 1, K) with TF32 off in the
    forward and in both gradients. ``torch.cudnn_convolution`` takes the flag
    for its forward only; its backward would follow the process-wide
    ``cudnn.allow_tf32`` (True by default), so the backward is written here."""

    @staticmethod
    def forward(ctx, x4, w4, stride: int, padding: int):
        ctx.save_for_backward(x4, w4)
        ctx.stride, ctx.padding = stride, padding
        return torch.cudnn_convolution(
            x4, w4, (0, padding), (1, stride), (1, 1), 1,
            torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic, False)

    @staticmethod
    def backward(ctx, grad):
        x4, w4 = ctx.saved_tensors
        with torch.backends.cudnn.flags(enabled=True, benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=torch.backends.cudnn.deterministic,
                                        allow_tf32=False):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                grad.contiguous(), x4, w4, None, (1, ctx.stride), (0, ctx.padding), (1, 1),
                False, (0, 0), 1, (ctx.needs_input_grad[0], ctx.needs_input_grad[1], False))
        return dx, dw, None, None


def conv1d(x, kernel, bias=None, stride: int = 1, padding: int = 0):
    """x (B, Cin, T), kernel (Cout, Cin, K) -> (B, Cout, T_out), in f32.

    On a CUDA tensor the conv goes to cuDNN with TF32 off for this call alone,
    forward and backward (``F.conv1d`` would follow the process-wide
    ``cudnn.allow_tf32``, True by default), as a (B, Cin, 1, T) conv the way
    ``F.conv1d`` hands it over.
    """
    if x.device.type != "cuda":
        return F.conv1d(x, kernel, bias, stride=stride, padding=padding)
    out = _CudnnConv1dF32.apply(x[:, :, None, :], kernel[:, :, None, :], stride, padding)[:, :, 0, :]
    return out if bias is None else out + bias[:, None]


def max_pool1d_ceil(x, k: int):
    """``max_pool1d(kernel_size=k, ceil_mode=True)`` on (B, C, T)."""
    if k == 1:
        return x
    return F.max_pool1d(x, k, ceil_mode=True)


def _window_sums(windows: torch.Tensor) -> torch.Tensor:
    """The sums over the last axis of (..., k) windows. A bf16 sum is taken
    frame by frame, rounded to bf16 after each add, as XLA's ``reduce_window``
    of the JAX twins sums bf16 (torch's ``sum`` and ``avg_pool1d`` round
    once, which differs from it for k > 2); any other dtype in one sum."""
    if windows.dtype != torch.bfloat16:
        return windows.sum(-1)
    s = windows[..., 0]
    for j in range(1, windows.shape[-1]):
        s = s + windows[..., j]
    return s


def avg_pool1d_ceil(x, k: int):
    """``avg_pool1d(kernel_size=k, ceil_mode=True)`` on (B, C, T).

    With no padding, torch divides a trailing partial window by the number
    of its elements inside the input, as the JAX twin does; a bf16 x's
    windows are summed as the twin sums them (:func:`_window_sums`).
    """
    if k == 1:
        return x
    if x.dtype != torch.bfloat16:
        return F.avg_pool1d(x, k, ceil_mode=True)
    T = x.shape[-1]
    t_out = -(-T // k)
    sums = _window_sums(F.pad(x, (0, t_out * k - T)).reshape(*x.shape[:-1], t_out, k))
    counts = torch.clamp(T - k * torch.arange(t_out, device=x.device), max=k)
    return sums / counts.to(x.dtype)


def _valid(n, t: int):
    """(B, 1, t) bool: frame t' < n_b of each row."""
    return (torch.arange(t, device=n.device)[None, :] < n[:, None])[:, None, :]


def masked_max_pool1d_ceil(x, k: int, n):
    """Length-aware ceil max-pool on (B, C, T); ``n`` (B,) = valid frames.

    Equal to :func:`max_pool1d_ceil` on each example cropped to its own
    length: frames >= n_b take no part in any window (-inf), and output
    frames >= ceil(n_b / k) are 0, a row with n_b = 0 too (``where``, so the
    -inf of an empty window never reaches the output).
    """
    if k == 1:
        return x
    out = max_pool1d_ceil(torch.where(_valid(n, x.shape[-1]), x, float("-inf")), k)
    return torch.where(_valid(-(-n // k), out.shape[-1]), out, 0.0)


def masked_avg_pool1d_ceil(x, k: int, n):
    """Length-aware ceil avg-pool on (B, C, T); ``n`` (B,) = valid frames.

    Each window's sum over its frames inside [0, n_b) is divided by their
    count ``clip(n_b - m k, 0, k)``, floored at 1: torch's partial-window
    divisor of an exact-shape (T = n_b) ceil-mode avg pool, per example.
    Output frames past the valid extent come out 0. A bf16 x's windows are
    summed as the JAX twin sums them (:func:`_window_sums`).
    """
    if k == 1:
        return x
    B, C, T = x.shape
    t_out = -(-T // k)
    xm = torch.where(_valid(n, T), x, 0.0)
    sums = _window_sums(F.pad(xm, (0, t_out * k - T)).reshape(B, C, t_out, k))
    m = torch.arange(t_out, device=n.device)
    counts = torch.clamp(n[:, None] - m[None, :] * k, 0, k)
    return sums / torch.clamp(counts, min=1)[:, None, :].to(x.dtype)


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
