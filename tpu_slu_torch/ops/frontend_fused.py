"""Fused SincNet front end (K8): the kernel's wrapper, its plain version, autograd.

Port of ``tpu_slu/ops/pallas_frontend.py`` (``sinc_frontend_fused``, the
TPU kernel ``_mk_kernel``): the sinc conv, |.|, the ceil-mode max pool over
time and the activation of the eval front end in one launch of
``csrc/sinc_frontend.cu``, counted on ``sinc_frontend_fused.launches``. The
filter bank is computed outside the kernel (:func:`sinc_filters`), as in
JAX. A CPU tensor runs the plain version, :func:`sinc_frontend_reference`,
the composition the kernel replaces. There is no backward kernel (JAX has
none either): under autograd the backward recomputes through the plain
composition, as JAX's custom VJP does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_slu_torch.ops import _build
from tpu_slu_torch.ops.conv import max_pool1d_ceil
from tpu_slu_torch.ops.sinc import sinc_conv, sinc_filters

ACTS = ("leaky_relu", "relu")


def _act(y: torch.Tensor, act: str) -> torch.Tensor:
    return F.leaky_relu(y, 0.2) if act == "leaky_relu" else torch.relu(y)


def _check_args(x: torch.Tensor, filt_dim: int, stride: int, padding: int, pool: int, act: str) -> None:
    if x.dim() != 2:
        raise ValueError(f"sinc_frontend_fused takes a (B, T) waveform, got shape {tuple(x.shape)}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if filt_dim < 1 or stride < 1 or padding < 0 or pool < 1:
        raise ValueError(f"sinc_frontend_fused: filt_dim, stride, pool >= 1 and padding >= 0 "
                         f"(filt_dim={filt_dim}, stride={stride}, padding={padding}, pool={pool})")
    if x.shape[1] + 2 * padding < filt_dim:
        raise ValueError(f"sinc_frontend_fused: {x.shape[1]} samples + 2 x {padding} padding are "
                         f"shorter than the {filt_dim} taps")


def sinc_frontend_reference(filt_b1, filt_band, x, *, filt_dim: int, fs: int, stride: int,
                            padding: int, pool: int, act: str = "leaky_relu") -> torch.Tensor:
    """K8's function in plain PyTorch, JAX's ``_xla_reference``: ``sinc_conv``
    -> abs -> ``max_pool1d_ceil`` -> act, channels-last: x (B, T) -> (B,
    ceil(t_out / pool), F)."""
    out = sinc_conv(filt_b1, filt_band, x[:, None, :], filt_dim, fs, stride, padding).abs()
    return _act(max_pool1d_ceil(out, pool), act).transpose(1, 2)


def _forward(filt_b1, filt_band, x, *, filt_dim: int, fs: int, stride: int, padding: int,
             pool: int, act: str) -> torch.Tensor:
    """The plain version on a CPU tensor, the kernel on a CUDA tensor."""
    kw = dict(filt_dim=filt_dim, fs=fs, stride=stride, padding=padding, pool=pool, act=act)
    if x.device.type == "cpu":
        with torch.no_grad():
            return sinc_frontend_reference(filt_b1, filt_band, x, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"sinc_frontend_fused runs on cpu or cuda tensors, not {x.device}")
    for name, t in (("x", x), ("filt_b1", filt_b1), ("filt_band", filt_band)):
        if t.device != x.device:
            raise ValueError(f"sinc_frontend_fused: {name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"sinc_frontend_fused: {name} is {t.dtype}; the kernel takes float32")
    if not x.is_contiguous():
        raise ValueError("sinc_frontend_fused: x is not contiguous")
    B, T = x.shape
    if B > 65535:
        raise ValueError(f"sinc_frontend_fused: B={B}; the kernel's grid takes at most 65535 examples")
    with torch.no_grad():
        filters = sinc_filters(filt_b1, filt_band, filt_dim, fs).contiguous()  # (F, K)
    n_filt = filters.shape[0]
    t_pool = -(-((T + 2 * padding - filt_dim) // stride + 1) // pool)
    out = torch.empty((B, n_filt, t_pool), device=x.device, dtype=torch.float32)
    lib = _build.library()
    err = lib.tsl_sinc_frontend_fwd(x.data_ptr(), filters.data_ptr(), out.data_ptr(), B, T, n_filt,
                                    filt_dim, stride, padding, pool, int(act == "leaky_relu"),
                                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"sinc_frontend_fused (B={B}, T={T}, F={n_filt}, K={filt_dim}, S={stride}, "
                      f"pool={pool})")
    sinc_frontend_fused.launches += 1
    return out.transpose(1, 2)


class _FusedFrontend(torch.autograd.Function):
    """The fused forward; the backward recomputes through the plain
    composition and takes its VJP (JAX ``_core_for``'s custom VJP)."""

    @staticmethod
    def forward(ctx, filt_b1, filt_band, x, kw):
        ctx.kw = kw
        ctx.save_for_backward(filt_b1, filt_band, x)
        return _forward(filt_b1, filt_band, x, **kw)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            out = sinc_frontend_reference(*leaves, **ctx.kw)
            grads = iter(torch.autograd.grad(out, [t for t in leaves if t.requires_grad], dy))
        return (*[next(grads) if n else None for n in need], None)


def sinc_frontend_fused(filt_b1, filt_band, x, *, filt_dim: int, fs: int, stride: int,
                        padding: int, pool: int, act: str = "leaky_relu") -> torch.Tensor:
    """K8: x (B, T) waveform -> (B, ceil(t_out / pool), F), channels-last, as
    :func:`sinc_frontend_reference` and JAX ``sinc_frontend_fused``.

    CPU tensors take the plain version. CUDA tensors launch the kernel on the
    current stream without synchronising, and anything the kernel does not
    take raises; the result is the (B, t_pool, F) view of the kernel's (B,
    F, t_pool) output, whose transpose back is contiguous for the convs
    after it. When grad mode is on and an input requires grad, the call goes
    through an autograd Function whose backward recomputes through the plain
    composition.
    """
    _check_args(x, filt_dim, stride, padding, pool, act)
    kw = dict(filt_dim=filt_dim, fs=fs, stride=stride, padding=padding, pool=pool, act=act)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (filt_b1, filt_band, x)):
        return _FusedFrontend.apply(filt_b1, filt_band, x, kw)
    return _forward(filt_b1, filt_band, x, **kw)


sinc_frontend_fused.launches = 0  # wrapper calls that launched K8
