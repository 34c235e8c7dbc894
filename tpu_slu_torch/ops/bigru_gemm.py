"""The bi-GRU kernels' one f32 GEMM core (``csrc/bigru_gemm.cuh``), layout by layout.

Every product of K1-K6 off the recurrent chain runs on this core inside
the kernels' own launches. These three functions launch it alone, through
``csrc/bigru_gemm.cu``, so that the card tests can hold each of its operand
layouts against an f64 product of the same operands; no model path calls
them. They take CUDA tensors only:

* :func:`gemm_proj`, both operands contiguous along k (gi and gh);
* :func:`gemm_dx`, A along k and B along n (dX);
* :func:`gemm_dw`, both along their output index, the reduction over rows
  cut into chunks and summed in chunk order (dW, db).
"""

from __future__ import annotations

import torch

from tpu_slu_torch.ops import _build


def _check(what: str, tensors) -> torch.device:
    dev = tensors[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{what} launches the GEMM core on cuda tensors, not {dev}")
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, {tensors[0][0]} on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def gemm_proj(x1: torch.Tensor, x2: torch.Tensor | None, w: torch.Tensor,
              b: torch.Tensor | None = None) -> torch.Tensor:
    """``[x1 | x2] w^T + b``: x1 (M, d1), x2 (M, d2) or None, w (N, d1 + d2),
    b (N,) or None -> (M, N)."""
    named = [("x1", x1), ("w", w)] + [(k, t) for k, t in (("x2", x2), ("b", b)) if t is not None]
    dev = _check("gemm_proj", named)
    M, d1 = x1.shape
    d2 = 0 if x2 is None else x2.shape[1]
    N = w.shape[0]
    if tuple(w.shape) != (N, d1 + d2) or (x2 is not None and x2.shape[0] != M) or \
            (b is not None and tuple(b.shape) != (N,)):
        raise ValueError("gemm_proj: shapes do not agree")
    out = torch.empty((M, N), device=dev, dtype=torch.float32)
    err = _build.library().tsl_gemm_proj(
        x1.data_ptr(), d1, None if x2 is None else x2.data_ptr(), d2, w.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), M, N, _stream(dev))
    _build.check(err, f"gemm_proj (M={M}, N={N}, K={d1}+{d2})")
    return out


def gemm_dx(a: torch.Tensor, ws, d1: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``sum_i a[i] ws[i]`` split at column d1: a (ndir, M, K), ws 1 or 2
    tensors (K, D) -> ((M, d1), (M, D - d1))."""
    ws = tuple(ws)
    dev = _check("gemm_dx", [("a", a)] + [(f"ws[{i}]", w) for i, w in enumerate(ws)])
    ndir, M, K = a.shape
    D = ws[0].shape[1]
    if ndir != len(ws) or ndir not in (1, 2) or any(tuple(w.shape) != (K, D) for w in ws) \
            or not 0 < d1 <= D:
        raise ValueError("gemm_dx: shapes do not agree")
    dx1 = torch.empty((M, d1), device=dev, dtype=torch.float32)
    dx2 = torch.empty((M, D - d1), device=dev, dtype=torch.float32)
    err = _build.library().tsl_gemm_dx(
        a.data_ptr(), ndir, ws[0].data_ptr(), ws[-1].data_ptr(), dx1.data_ptr(), d1,
        dx2.data_ptr() if D > d1 else None, D - d1, M, K, _stream(dev))
    _build.check(err, f"gemm_dx (M={M}, K={K}, D={D}, ndir={ndir})")
    return dx1, dx2


def gemm_dw(a: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(a^T [x1 | x2], a.sum(0))``: a (M, K) with K = 3H, x1 (M, d1), x2
    (M, d2) or None -> ((K, d1 + d2), (K,)). Repeated calls agree bit for bit."""
    named = [("a", a), ("x1", x1)] + ([("x2", x2)] if x2 is not None else [])
    dev = _check("gemm_dw", named)
    M, K = a.shape
    d1 = x1.shape[1]
    d2 = 0 if x2 is None else x2.shape[1]
    if K % 3 or x1.shape[0] != M or (x2 is not None and x2.shape[0] != M):
        raise ValueError("gemm_dw: shapes do not agree")
    partial = torch.empty(_build.partial_floats(d1, d2, K // 3, M, 1), device=dev, dtype=torch.float32)
    dw = torch.empty((K, d1 + d2), device=dev, dtype=torch.float32)
    db = torch.empty(K, device=dev, dtype=torch.float32)
    err = _build.library().tsl_gemm_dw(
        a.data_ptr(), K, x1.data_ptr(), d1, None if x2 is None else x2.data_ptr(), d2,
        partial.data_ptr(), dw.data_ptr(), db.data_ptr(), M, _stream(dev))
    _build.check(err, f"gemm_dw (M={M}, K={K}, D={d1}+{d2})")
    return dw, db
