"""Length-masked bidirectional GRU layer (K4f): the kernel's wrapper and its plain version.

Port of the length-exact path's bi-GRU, ``gru_apply_masked`` of
``tpu_slu/ops/gru.py``, which on the TPU runs the joint kernel
``_fused_fwd_kernel`` (``tpu_slu/ops/pallas_gru.py:323``). Batch-major, as
the JAX function: x (B, T, D) and valid lengths n (B,) -> (B, T, 2H), each
row equal to the layer on that example alone at T = n_b, zeros at t >= n_b.

:func:`bigru_masked` launches ``csrc/bigru_masked_fwd.cu`` on a CUDA tensor,
counted on ``bigru_masked.launches``, and runs :func:`bigru_masked_reference`
on a CPU tensor. The kernel has no backward yet (that is K4b, the TPU's
``_fused_bwd_kernel``): on CUDA, a call that would need a gradient raises.
"""

from __future__ import annotations

import torch

from tpu_slu_torch.ops import _build
from tpu_slu_torch.ops.gru import gru_apply_masked

_DIRS = ("fwd", "bwd")
_NAMES = ("weight_ih", "bias_ih", "weight_hh", "bias_hh")


# K4f's function in plain PyTorch (``reverse_padded`` plus one forward walk per
# direction, as the JAX scan branch); autograd through and through
bigru_masked_reference = gru_apply_masked


def _check_cuda(params: dict, x: torch.Tensor, n: torch.Tensor) -> tuple[int, int, int, int]:
    if x.dim() != 3:
        raise ValueError(f"bigru_masked: x has shape {tuple(x.shape)}, want (B, T, D)")
    B, T, D = x.shape
    tensors = [("x", x)] + [(f"{d}.{k}", params[d][k]) for d in _DIRS for k in _NAMES]
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"bigru_masked: {name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"bigru_masked: {name} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"bigru_masked: {name} is not contiguous")
    H = params["fwd"]["weight_hh"].shape[-1]
    want = {"weight_ih": (3 * H, D), "weight_hh": (3 * H, H), "bias_ih": (3 * H,), "bias_hh": (3 * H,)}
    for d in _DIRS:
        for k, shape in want.items():
            if tuple(params[d][k].shape) != shape:
                raise ValueError(f"bigru_masked: {d}.{k} has shape {tuple(params[d][k].shape)}, "
                                 f"want {shape}")
    if T < 1 or B < 1 or H % 4 != 0:
        raise ValueError(f"bigru_masked: kernel needs T, B >= 1 and H % 4 == 0 (T={T}, B={B}, H={H})")
    if 2 * B * T * 3 * H >= 2**31 or B * T * max(D, 2 * H) >= 2**31:
        raise ValueError(f"bigru_masked: B*T*H too large for the kernel's int indexing "
                         f"(B={B}, T={T}, H={H})")
    if n.device != x.device:
        raise ValueError(f"bigru_masked: n is on {n.device}, x on {x.device}")
    if n.dtype not in (torch.int32, torch.int64) or tuple(n.shape) != (B,):
        raise TypeError(f"bigru_masked: n must be an int32/int64 tensor of shape ({B},), "
                        f"got {n.dtype} {tuple(n.shape)}")
    lo, hi = (int(v) for v in torch.aminmax(n))
    if lo < 0 or hi > T:
        raise ValueError(f"bigru_masked: lengths must lie in [0, T={T}], got [{lo}, {hi}]")
    return B, T, D, H


def bigru_masked(params: dict, x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """K4f: ``(B, T, 2H)`` as :func:`bigru_masked_reference`.

    ``params``: ``{"fwd": d, "bwd": d}``, ``d`` holding ``weight_ih`` (3H,
    D), ``weight_hh`` (3H, H), ``bias_ih`` and ``bias_hh`` (3H,), torch
    layout. CPU tensors take the plain version. CUDA tensors launch the
    kernel on the current stream without synchronising (the range check of
    ``n`` reads it on the host); anything the kernel does not take raises,
    and so does a call with grad mode on and an input or weight that
    requires grad, since the kernel's backward (K4b) is not ported.
    """
    if x.device.type == "cpu":
        return bigru_masked_reference(params, x, n)
    if x.device.type != "cuda":
        raise ValueError(f"bigru_masked runs on cpu or cuda tensors, not {x.device}")
    weights = [params[d][k] for d in _DIRS for k in _NAMES]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *weights)):
        raise NotImplementedError(
            "bigru_masked on CUDA has no backward: K4b (the TPU's _fused_bwd_kernel, "
            "tpu_slu/ops/pallas_gru.py:400) is not ported; call it under torch.no_grad() or "
            "torch.inference_mode()")
    B, T, D, H = _check_cuda(params, x, n)
    lib = _build.library()
    lengths = n.to(torch.int64).contiguous()
    gi = torch.empty((2, B, T, 3 * H), device=x.device, dtype=torch.float32)
    out = torch.empty((B, T, 2 * H), device=x.device, dtype=torch.float32)
    err = lib.tsl_bigru_masked_fwd(
        x.data_ptr(), D, lengths.data_ptr(), *[t.data_ptr() for t in weights],
        gi.data_ptr(), out.data_ptr(), T, B, H, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, f"bigru_masked (B={B}, T={T}, H={H})")
    bigru_masked.launches += 1
    return out


bigru_masked.launches = 0  # wrapper calls that launched K4f
