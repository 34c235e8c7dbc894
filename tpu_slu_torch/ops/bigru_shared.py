"""Shared-stream bidirectional GRU layer (eval forward): wrapper, plain version.

Port of the eval path of ``bigru_apply_shared`` in ``tpu_slu/ops/pallas_gru.py``.
Both directions read ONE natural-order time-major stream made of 1 or 2 part
streams ``(T, B, D_p)`` (the previous layer's ``h_f`` and ``h_b``, or the conv
stack's output), so no flipped copy and no channel concat is ever made. An
optional ceil-mode avg/max pool is fused into the layer, and the outputs come
out at the pooled rate.

On a CUDA tensor :func:`bigru_shared` launches the hand-written kernel in
``tpu_slu_torch/csrc/bigru_shared_fwd.cu``; on a CPU tensor it runs
:func:`bigru_shared_reference`, the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from tpu_slu_torch.ops import _build
from tpu_slu_torch.ops.conv import downsample
from tpu_slu_torch.ops.gru import gru_direction

_DIRS = ("fwd", "bwd")
_NAMES = ("weight_ih", "bias_ih", "weight_hh", "bias_hh")


def _check_args(parts, pool: int, pool_method: str) -> tuple:
    parts = tuple(parts)
    if len(parts) not in (1, 2):
        raise ValueError(f"bigru_shared takes 1 or 2 part streams, got {len(parts)}")
    if pool < 1:
        raise ValueError(f"pool must be >= 1, got {pool}")
    if pool_method not in ("avg", "max"):
        raise ValueError(f"pool_method must be avg or max, got {pool_method!r}")
    return parts


def bigru_shared_reference(params: dict, parts, *, pool: int = 1, pool_method: str = "avg"):
    """The layer in plain PyTorch: a Python loop over t with ``torch.mm``.

    ``params``: ``{"fwd": d, "bwd": d}`` with ``d`` holding ``weight_ih``
    (3H, D), ``weight_hh`` (3H, H), ``bias_ih`` and ``bias_hh`` (3H,), torch
    layout. Returns ``(h_f, h_b)``, each ``(ceil(T/pool), B, H)``, natural time
    order.
    """
    parts = _check_args(parts, pool, pool_method)
    outs = []
    for name in _DIRS:
        p = params[name]
        gi, off = p["bias_ih"], 0
        for x in parts:
            d = x.shape[-1]
            gi = gi + torch.matmul(x, p["weight_ih"][:, off:off + d].t())
            off += d
        h = gru_direction(gi, p["weight_hh"], p["bias_hh"], reverse=name == "bwd")
        outs.append(downsample(h, pool_method, pool, time_axis=0))
    return outs[0], outs[1]


def _check_cuda(params: dict, parts: tuple) -> tuple[int, int, int]:
    dev = parts[0].device
    T, B = parts[0].shape[:2]
    tensors = [(f"part {i}", x) for i, x in enumerate(parts)]
    tensors += [(f"{d}.{n}", params[d][n]) for d in _DIRS for n in _NAMES]
    for name, x in tensors:
        if x.device != dev:
            raise ValueError(f"bigru_shared: {name} is on {x.device}, part 0 on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"bigru_shared: {name} is {x.dtype}; the kernel takes float32")
        if not x.is_contiguous():
            raise ValueError(f"bigru_shared: {name} is not contiguous")
    for i, x in enumerate(parts):
        if x.dim() != 3 or tuple(x.shape[:2]) != (T, B):
            raise ValueError(f"bigru_shared: part {i} has shape {tuple(x.shape)}, want ({T}, {B}, D)")
    D = sum(x.shape[-1] for x in parts)
    H = params["fwd"]["weight_hh"].shape[-1]
    want = {"weight_ih": (3 * H, D), "weight_hh": (3 * H, H), "bias_ih": (3 * H,), "bias_hh": (3 * H,)}
    for d in _DIRS:
        for n, shape in want.items():
            if tuple(params[d][n].shape) != shape:
                raise ValueError(
                    f"bigru_shared: {d}.{n} has shape {tuple(params[d][n].shape)}, want {shape}"
                )
    if T < 1 or B < 1 or H % 4 != 0:
        raise ValueError(f"bigru_shared: kernel needs T, B >= 1 and H % 4 == 0 (T={T}, B={B}, H={H})")
    if 2 * T * B * 3 * H >= 2**31:
        raise ValueError(f"bigru_shared: T*B*H too large for the kernel's int indexing (T={T}, B={B}, H={H})")
    return T, B, H


def bigru_shared(params: dict, parts, *, pool: int = 1, pool_method: str = "avg"):
    """One bidirectional GRU layer over time-major part streams.

    Same contract as the JAX ``bigru_apply_shared`` eval path: returns
    ``(h_f, h_b, pooled)`` with ``h_f``/``h_b`` of shape
    ``(ceil(T/pool), B, H)`` in natural time order and ``pooled`` true when
    the pool ran inside the layer. CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream without synchronising,
    and anything the kernel does not take raises.
    """
    parts = _check_args(parts, pool, pool_method)
    if parts[0].device.type == "cpu":
        h_f, h_b = bigru_shared_reference(params, parts, pool=pool, pool_method=pool_method)
        return h_f, h_b, pool > 1
    if parts[0].device.type != "cuda":
        raise ValueError(f"bigru_shared runs on cpu or cuda tensors, not {parts[0].device}")
    T, B, H = _check_cuda(params, parts)
    lib = _build.library()
    To = -(-T // pool)
    dev = parts[0].device
    gi = torch.empty((2, T, B, 3 * H), device=dev, dtype=torch.float32)
    h_f = torch.empty((To, B, H), device=dev, dtype=torch.float32)
    h_b = torch.empty((To, B, H), device=dev, dtype=torch.float32)
    x2 = parts[1] if len(parts) == 2 else None
    f, b = params["fwd"], params["bwd"]
    err = lib.tsl_bigru_shared_fwd(
        parts[0].data_ptr(), parts[0].shape[-1],
        None if x2 is None else x2.data_ptr(), 0 if x2 is None else x2.shape[-1],
        *[f[n].data_ptr() for n in _NAMES], *[b[n].data_ptr() for n in _NAMES],
        gi.data_ptr(), h_f.data_ptr(), h_b.data_ptr(),
        T, B, H, pool, int(pool_method == "max"),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, f"bigru_shared_fwd (T={T}, B={B}, H={H}, pool={pool})")
    bigru_shared.launches += 1
    return h_f, h_b, pool > 1


bigru_shared.launches = 0  # wrapper calls that launched the kernel
