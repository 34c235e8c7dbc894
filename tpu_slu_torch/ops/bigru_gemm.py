"""The bi-GRU kernels' GEMM core (``csrc/bigru_gemm.cuh``), layout by layout.

Every product of K1-K6 off the recurrent chain runs on this core inside
the kernels' own launches. These functions launch it alone, through
``csrc/bigru_gemm.cu``, so that the card tests can hold each of its operand
layouts and modes against an f64 product of the same operands; no model
path calls them. The f32 ones take CUDA tensors only:

* :func:`gemm_proj`, both operands contiguous along k (gi and gh);
* :func:`gemm_dx`, A along k and B along n (dX);
* :func:`gemm_dw`, both along their output index, the reduction over rows
  cut into chunks and summed in chunk order (dW, db).

At ``compute_dtype=bfloat16`` the products whose operands are both bf16 run
on the tensor cores (``gemm_kernel_tc``: bf16 ``mma.sync`` with f32
accumulation, the TPU kernel's ``jnp.dot(bf16, bf16,
preferred_element_type=f32)``, ``tpu_slu/ops/pallas_gru.py`` ``_mxu``):

* :func:`gemm_proj_bf16`, gi and gh: bf16 x parts times the f32 weights
  rounded to bf16, f32 out;
* :func:`gemm_proj_rs_bf16`, K6's row-stacked gi with its bias fold;
* :func:`gemm_dx_bf16`, dX: each direction's dgi and W_ih rounded to bf16,
  its product rounded to bf16, the two directions' sum rounded again.

Each has its plain version (``*_reference``), which the wrapper runs on
CPU tensors. :func:`tc_launches` counts the tensor-core kernel's launches,
whoever makes them (K1-K6 and these entry points).
"""

from __future__ import annotations

import ctypes

import torch

from tpu_slu_torch.ops import _build


BF16 = torch.bfloat16


def _check(what: str, tensors, bf16=()) -> torch.device:
    """The tensors' one CUDA device; each contiguous, bfloat16 if its name is
    in ``bf16``, else float32."""
    dev = tensors[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{what} launches the GEMM core on cuda tensors, not {dev}")
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, {tensors[0][0]} on {dev}")
        want = BF16 if name in bf16 else torch.float32
        if t.dtype != want:
            raise TypeError(f"{what}: {name} is {t.dtype}; the kernel takes {want}")
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


def _tc_count() -> ctypes.c_ulonglong:
    return ctypes.c_ulonglong.in_dll(_build.library(), "tsl_gemm_tc_launches")


def tc_launches() -> int:
    """Launches of the tensor-core kernel (``gemm_kernel_tc``) since the
    library was loaded or :func:`zero_tc_launches`: the bf16 gi, gh and dX
    products of K1-K6, and the bf16 entry points here. Counted in the
    library where it launches the kernel."""
    return _tc_count().value


def zero_tc_launches() -> None:
    _tc_count().value = 0


def _parts(x1: torch.Tensor, x2: torch.Tensor | None) -> torch.Tensor:
    return x1 if x2 is None else torch.cat([x1, x2], 1)


def gemm_proj_bf16_reference(x1: torch.Tensor, x2: torch.Tensor | None, w: torch.Tensor,
                             b: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`gemm_proj_bf16`'s plain version: the bf16 parts times the
    weights rounded to bf16, products and sums in f64, plus b, rounded once
    to f32."""
    out = _parts(x1, x2).to(BF16).double() @ w.to(BF16).double().t()
    return (out if b is None else out + b.double()).float()


def gemm_proj_bf16(x1: torch.Tensor, x2: torch.Tensor | None, w: torch.Tensor,
                   b: torch.Tensor | None = None) -> torch.Tensor:
    """``[x1 | x2] bf16(w)^T + b`` with f32 accumulation: x1 (M, d1) and x2
    (M, d2) or None bf16, contiguous at any 2-byte offset; w (N, d1 + d2) f32,
    rounded to bf16 as the kernel reads it; b (N,) f32 or None -> (M, N) f32.
    CPU tensors: the plain version."""
    if x1.device.type == "cpu":
        return gemm_proj_bf16_reference(x1, x2, w, b)
    named = [("x1", x1), ("w", w)] + [(k, t) for k, t in (("x2", x2), ("b", b)) if t is not None]
    dev = _check("gemm_proj_bf16", named, bf16=("x1", "x2"))
    M, d1 = x1.shape
    d2 = 0 if x2 is None else x2.shape[1]
    N = w.shape[0]
    if tuple(w.shape) != (N, d1 + d2) or (x2 is not None and x2.shape[0] != M) or \
            (b is not None and tuple(b.shape) != (N,)):
        raise ValueError("gemm_proj_bf16: shapes do not agree")
    out = torch.empty((M, N), device=dev, dtype=torch.float32)
    err = _build.library().tsl_gemm_proj_bf16(
        x1.data_ptr(), d1, None if x2 is None else x2.data_ptr(), d2, w.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), M, N, _stream(dev))
    _build.check(err, f"gemm_proj_bf16 (M={M}, N={N}, K={d1}+{d2})")
    return out


def gemm_proj_rs_bf16_reference(x1: torch.Tensor, x2: torch.Tensor | None, ws, bs, folds,
                                T: int, B: int) -> torch.Tensor:
    """:func:`gemm_proj_rs_bf16`'s plain version: each direction's
    :func:`gemm_proj_bf16_reference` with its fold on the first 2N/3
    columns (added in f64), its rows stacked as K6 stacks them."""
    N = ws[0].shape[0]
    out = torch.empty((T, 2 * B, N), dtype=torch.float32, device=x1.device)
    for d, (w, b, fold) in enumerate(zip(ws, bs, folds)):
        bias = b.double().clone()
        bias[:2 * N // 3] += fold[:2 * N // 3].double()
        g = gemm_proj_bf16_reference(x1, x2, w, bias).view(T, B, N)
        out[:, d * B:(d + 1) * B] = g.flip(0) if d else g
    return out


def gemm_proj_rs_bf16(x1: torch.Tensor, x2: torch.Tensor | None, ws, bs, folds, T: int,
                      B: int) -> torch.Tensor:
    """K6's row-stacked projection at bf16: x1 (T B, d1) and x2 (T B, d2) or
    None bf16; ws, bs, folds each the two directions' W_ih (N, d1 + d2),
    b_ih (N,) and b_hh (N,) f32 -> (T, 2B, N) f32, row (t, d B + b) the
    direction-d product of input row (s, b), s = t forward and T - 1 - t
    backward, plus b_ih and, on the first 2N/3 columns, b_hh. CPU tensors:
    the plain version."""
    ws, bs, folds = tuple(ws), tuple(bs), tuple(folds)
    if x1.device.type == "cpu":
        return gemm_proj_rs_bf16_reference(x1, x2, ws, bs, folds, T, B)
    named = [("x1", x1)] + ([("x2", x2)] if x2 is not None else []) + [
        (f"{k}[{d}]", t) for k, ts in (("ws", ws), ("bs", bs), ("folds", folds)) for d, t in enumerate(ts)]
    dev = _check("gemm_proj_rs_bf16", named, bf16=("x1", "x2"))
    M, d1 = x1.shape
    d2 = 0 if x2 is None else x2.shape[1]
    N = ws[0].shape[0]
    if M != T * B or len(ws) != 2 or len(bs) != 2 or len(folds) != 2 or N % 3 or \
            any(tuple(w.shape) != (N, d1 + d2) for w in ws) or any(tuple(t.shape) != (N,) for t in bs + folds) \
            or (x2 is not None and x2.shape[0] != M):
        raise ValueError("gemm_proj_rs_bf16: shapes do not agree")
    out = torch.empty((T, 2 * B, N), device=dev, dtype=torch.float32)
    err = _build.library().tsl_gemm_proj_rs_bf16(
        x1.data_ptr(), d1, None if x2 is None else x2.data_ptr(), d2,
        ws[0].data_ptr(), bs[0].data_ptr(), folds[0].data_ptr(), ws[1].data_ptr(), bs[1].data_ptr(),
        folds[1].data_ptr(), out.data_ptr(), T, B, N, _stream(dev))
    _build.check(err, f"gemm_proj_rs_bf16 (T={T}, B={B}, N={N}, K={d1}+{d2})")
    return out


def gemm_dx_bf16_reference(a: torch.Tensor, ws, d1: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`gemm_dx_bf16`'s plain version: each direction's product of the
    operands rounded to bf16, in f64, rounded to bf16; with two directions
    their sum in f32, rounded to bf16 (``pallas_gru.py:1433-1436, :1536``)."""
    ws = tuple(ws)
    dx = [(a[i].to(BF16).double() @ w.to(BF16).double()).to(BF16) for i, w in enumerate(ws)]
    out = dx[0] if len(dx) == 1 else (dx[0].float() + dx[1].float()).to(BF16)
    return out[:, :d1], out[:, d1:]


def gemm_dx_bf16(a: torch.Tensor, ws, d1: int) -> tuple[torch.Tensor, torch.Tensor]:
    """dX at bf16 split at column d1: a (ndir, M, K) f32 (K3's dgi), ws 1 or
    2 tensors (K, D) f32 (W_ih), both rounded to bf16 as the kernel reads
    them -> ((M, d1), (M, D - d1)) bf16, each direction's product rounded to
    bf16 and, with two, their sum rounded again. CPU tensors: the plain
    version."""
    ws = tuple(ws)
    if a.device.type == "cpu":
        return gemm_dx_bf16_reference(a, ws, d1)
    dev = _check("gemm_dx_bf16", [("a", a)] + [(f"ws[{i}]", w) for i, w in enumerate(ws)])
    ndir, M, K = a.shape
    D = ws[0].shape[1]
    if ndir != len(ws) or ndir not in (1, 2) or any(tuple(w.shape) != (K, D) for w in ws) \
            or not 0 < d1 <= D:
        raise ValueError("gemm_dx_bf16: shapes do not agree")
    dx1 = torch.empty((M, d1), device=dev, dtype=BF16)
    dx2 = torch.empty((M, D - d1), device=dev, dtype=BF16)
    pair = torch.empty((2, M, D) if ndir == 2 else (0,), device=dev, dtype=BF16)
    err = _build.library().tsl_gemm_dx_bf16(
        a.data_ptr(), ndir, ws[0].data_ptr(), ws[-1].data_ptr(), dx1.data_ptr(), d1,
        dx2.data_ptr() if D > d1 else None, D - d1, pair.data_ptr() if ndir == 2 else None, M, K,
        _stream(dev))
    _build.check(err, f"gemm_dx_bf16 (M={M}, K={K}, D={D}, ndir={ndir})")
    return dx1, dx2
