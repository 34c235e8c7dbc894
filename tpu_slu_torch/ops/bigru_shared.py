"""Shared-stream bidirectional GRU layer: kernels' wrappers, plain versions, autograd.

Port of ``bigru_apply_shared`` in ``tpu_slu/ops/pallas_gru.py`` and of the
three kernels under it. Both directions read ONE natural-order time-major
stream made of 1 or 2 part streams ``(T, B, D_p)`` (the previous layer's
``h_f`` and ``h_b``, or the conv stack's output), so no flipped copy and no
channel concat is ever made. A following ceil-mode pool (and, in training,
dropout) is fused into the layer, and the outputs come out at the pooled
rate.

Each kernel has a wrapper, which launches it on a CUDA tensor and runs its
plain PyTorch version on a CPU tensor, and keeps a count of its launches:

* K1, eval/unpooled forward: :func:`bigru_shared_fwd`, counted on
  ``bigru_shared.launches`` (``csrc/bigru_shared_fwd.cu``, its recurrence
  ``csrc/gru_cluster.cuh``, the cluster recurrence K2, K4f, K5f and K6 share);
* K6, the same forward in the row-stacked layout (``layout="rowstack"``:
  both directions' gi in one (T, 2B, 3H) array, the backward rows
  pre-reversed, b_hh's r and z columns folded into b_ih):
  :func:`bigru_shared_fwd`, counted on ``bigru_shared.launches_rowstack``
  (the same source; K1's cluster recurrence with the template's ROWS flag);
* K2, train forward with hash dropout and avg pool: :func:`bigru_trainpool`
  (``csrc/bigru_trainpool_fwd.cu``: K1's cluster recurrence with h_prev
  stored and the dropout applied in its epilogue);
* K3, the backward of both: :func:`bigru_shared_bwd`
  (``csrc/bigru_shared_bwd.cu``).

:func:`bigru_shared` routes a call as the JAX function does, through
``torch.autograd.Function`` s whose forward and backward are those wrappers
whenever a gradient is needed, on either device.

Streams are float32, or bfloat16 (a trainer's ``compute_dtype=bfloat16``):
K1, K2 and K3 and their plain versions then take bf16 parts with the f32
master weights, return bf16 streams (h, h_prev, pooled outputs, dX) and f32
weight gradients, and round where the TPU kernels round at that dtype
(``pallas_gru.py:796-860``, ``:1196-1230``, ``:1384-1441``): W_ih and W_hh
are rounded to bf16, each product accumulates in f32, gi and the carry h
stay f32, h is rounded for the recurrent product only, the backward chain
rounds dgh before its product with W_hh, and a pooled output is rounded
once, after the pool (and dropout) of the f32 h. The plain versions do it
in f32 arithmetic (round to bf16, back to f32, an f32 product: a bf16 x
bf16 product is exact in f32). On the card the wrapper launches the
kernels' bf16 entry points, which round the f32 weights as they read them;
K6 (the row-stacked layout) too, with b_hh's r and z columns folded into
b_ih in f32 (``pallas_gru.py:924-995``, ``:1036-1037``).
"""

from __future__ import annotations

import torch

from tpu_slu_torch.ops import _build
from tpu_slu_torch.ops.conv import downsample
from tpu_slu_torch.ops.dropout import DIR_SALT_B, DIR_SALT_F, keep_mask, keep_threshold
from tpu_slu_torch.ops.gru import gru_direction

_DIRS = ("fwd", "bwd")
_SALTS = {"fwd": DIR_SALT_F, "bwd": DIR_SALT_B}
_NAMES = ("weight_ih", "bias_ih", "weight_hh", "bias_hh")
LAYOUTS = ("split", "rowstack")  # K1's gi layout, K6's


STREAM_DTYPES = (torch.float32, torch.bfloat16)  # what the kernels take (the plain versions: any float)


def _check_args(parts, pool: int, pool_method: str, layout: str = "split") -> tuple:
    parts = tuple(parts)
    if len(parts) not in (1, 2):
        raise ValueError(f"bigru_shared takes 1 or 2 part streams, got {len(parts)}")
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if any(x.dtype != parts[0].dtype for x in parts):
        raise TypeError(f"bigru_shared takes parts of one dtype, got {[x.dtype for x in parts]}")
    if pool < 1:
        raise ValueError(f"pool must be >= 1, got {pool}")
    if pool_method not in ("avg", "max"):
        raise ValueError(f"pool_method must be avg or max, got {pool_method!r}")
    return parts


def _check_drop(drop_p: float, seed) -> None:
    if not 0.0 <= drop_p < 1.0:
        raise ValueError(f"drop_p must be in [0, 1), got {drop_p}")
    if seed is None or not 0 <= int(seed) < 2**32:
        raise ValueError(f"the fused train path needs a uint32 seed, got {seed!r}")


def _weights(params: dict) -> tuple:
    return tuple(params[d][n] for d in _DIRS for n in _NAMES)


def _params(weights) -> dict:
    return {d: dict(zip(_NAMES, weights[4 * k:4 * k + 4])) for k, d in enumerate(_DIRS)}


def _input_projection(p: dict, parts) -> torch.Tensor:
    gi, off = p["bias_ih"], 0
    for x in parts:
        d = x.shape[-1]
        gi = gi + torch.matmul(x, p["weight_ih"][:, off:off + d].t())
        off += d
    return gi


def is_bf16(parts) -> bool:
    """Whether the part streams are bf16 (checked by :func:`_check_args`)."""
    return parts[0].dtype == torch.bfloat16


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest even bf16, back in f32."""
    return t.to(torch.bfloat16).float()


def widen(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor in f32 (exact); any other as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _as_f32(params: dict, parts) -> tuple:
    """The plain versions' operands at bf16: the parts in f32 (exact), and
    W_ih and W_hh rounded to bf16 in f32, the biases as they are."""
    rounded = {d: {n: round_bf16(t) if n.startswith("weight") else t for n, t in params[d].items()}
               for d in params}
    return rounded, tuple(x.float() for x in parts)


def _shift_hp(h_f: torch.Tensor, h_b: torch.Tensor) -> tuple:
    """Each direction's previous-step h at natural t: h_f[t-1] and h_b[t+1],
    zero where the direction's walk starts."""
    zero = h_f.new_zeros((1, *h_f.shape[1:]))
    return torch.cat([zero, h_f[:-1]]), torch.cat([h_b[1:], zero])


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors)
# ---------------------------------------------------------------------------


def bigru_shared_reference(params: dict, parts, *, pool: int = 1, pool_method: str = "avg"):
    """The eval layer in plain PyTorch: a Python loop over t with ``torch.mm``.

    ``params``: ``{"fwd": d, "bwd": d}`` with ``d`` holding ``weight_ih``
    (3H, D), ``weight_hh`` (3H, H), ``bias_ih`` and ``bias_hh`` (3H,), torch
    layout. Returns ``(h_f, h_b)``, each ``(ceil(T/pool), B, H)``, natural time
    order, of the parts' dtype (bf16: rounded after the pool of the f32 h).
    """
    parts = _check_args(parts, pool, pool_method)
    dtype, bf = parts[0].dtype, is_bf16(parts)
    if bf:
        params, parts = _as_f32(params, parts)
    outs = []
    for name in _DIRS:
        p = params[name]
        h = gru_direction(_input_projection(p, parts), p["weight_hh"], p["bias_hh"],
                          reverse=name == "bwd", round_h=bf)
        outs.append(downsample(h, pool_method, pool, time_axis=0).to(dtype))
    return outs[0], outs[1]


def bigru_shared_rowstack_reference(params: dict, parts, *, pool: int = 1, pool_method: str = "avg"):
    """K6's function in plain PyTorch, laid out as K6 lays it out
    (``pallas_gru.py:887-1000``, the bias fold at ``:1034-1037``): the gi of
    both directions in one (T, 2B, 3H) array, forward rows 0:B at t = u and
    backward rows B:2B pre-reversed (row u holds t = T - 1 - u), with b_hh's
    r and z columns folded into b_ih; a loop over u updates the (2B, H)
    carry of both directions, b_hh's n column added to the recurrent product
    inside r * (.). Same contract as :func:`bigru_shared_reference`, bf16
    too (the fold in f32, h rounded for the products)."""
    parts = _check_args(parts, pool, pool_method)
    dtype, bf = parts[0].dtype, is_bf16(parts)
    if bf:
        params, parts = _as_f32(params, parts)
    rnd = round_bf16 if bf else (lambda t: t)
    B = parts[0].shape[1]
    H = params["fwd"]["weight_hh"].shape[1]
    gis = []
    for name in _DIRS:
        p = params[name]
        fold = torch.cat([p["bias_hh"][:2 * H], p["bias_hh"].new_zeros(H)])
        gi = _input_projection({**p, "bias_ih": p["bias_ih"] + fold}, parts)
        gis.append(gi if name == "fwd" else gi.flip(0))
    gi2 = torch.cat(gis, dim=1)  # (T, 2B, 3H)
    bn = torch.cat([params[d]["bias_hh"][2 * H:].expand(B, H) for d in _DIRS])
    h = gi2.new_zeros((2 * B, H))
    out = gi2.new_empty((gi2.shape[0], 2 * B, H))
    for u in range(gi2.shape[0]):
        gh = torch.cat([torch.mm(rnd(h[:B]), params["fwd"]["weight_hh"].t()),
                        torch.mm(rnd(h[B:]), params["bwd"]["weight_hh"].t())])
        g = gi2[u]
        rz = torch.sigmoid(g[:, :2 * H] + gh[:, :2 * H])
        r, z = rz[:, :H], rz[:, H:]
        n = torch.tanh(g[:, 2 * H:] + r * (gh[:, 2 * H:] + bn))
        h = n + z * (h - n)
        out[u] = h
    return (downsample(out[:, :B], pool_method, pool, time_axis=0).to(dtype),
            downsample(out[:, B:].flip(0), pool_method, pool, time_axis=0).to(dtype))


def bigru_trainpool_reference(params: dict, parts, *, pool: int, drop_p: float, seed: int):
    """K2's function in plain PyTorch: the train forward, dropout on h at the
    full frame rate (kept: ``h * (1 / (1 - p))``, :func:`keep_mask` of
    ``seed``), then the ceil avg-pool. Returns ``(hp_f, hp_b, pooled_f,
    pooled_b)``: ``hp_*`` (T, B, H) is each direction's previous-step h at
    natural t, zero where its walk starts; ``pooled_*`` is (ceil(T/pool), B, H).
    All four are of the parts' dtype (bf16: each rounded once, the pooled
    ones after the dropout and the pool of the f32 h).
    """
    parts = _check_args(parts, pool, "avg")
    _check_drop(drop_p, seed)
    dtype, bf = parts[0].dtype, is_bf16(parts)
    if bf:
        params, parts = _as_f32(params, parts)
    hs = {}
    for name in _DIRS:
        p = params[name]
        hs[name] = gru_direction(_input_projection(p, parts), p["weight_hh"], p["bias_hh"],
                                 reverse=name == "bwd", round_h=bf)
    hp_f, hp_b = _shift_hp(hs["fwd"], hs["bwd"])
    pooled = []
    for name in _DIRS:
        h = hs[name]
        if drop_p > 0.0:
            keep = keep_mask(seed, _SALTS[name], 0, h.shape, keep_threshold(drop_p), h.device)
            h = torch.where(keep, h * (1.0 / (1.0 - drop_p)), 0.0)
        pooled.append(downsample(h, "avg", pool, time_axis=0).to(dtype))
    return hp_f.to(dtype), hp_b.to(dtype), pooled[0], pooled[1]


def expand_pooled_cotangent(dy: torch.Tensor, T: int, *, pool: int, drop_p: float, seed,
                            dir_salt: int) -> torch.Tensor:
    """The VJP of K2's dropout + ceil avg-pool: a pooled (ceil(T/pool), B, H)
    cotangent -> the full-rate (T, B, H) one. Divided by each window's
    in-range count, broadcast over the window, cut at T, and masked with the
    keep mask regenerated from ``seed``. A bf16 cotangent is widened to f32
    first: the result is f32."""
    dy = widen(dy)
    B, H = dy.shape[1:]
    cnt = torch.clamp(T - pool * torch.arange(dy.shape[0], device=dy.device), max=pool)
    d = (dy / cnt[:, None, None].to(dy.dtype)).repeat_interleave(pool, dim=0)[:T]
    if drop_p > 0.0:
        keep = keep_mask(seed, dir_salt, 0, (T, B, H), keep_threshold(drop_p), dy.device)
        d = torch.where(keep, d * (1.0 / (1.0 - drop_p)), 0.0)
    return d


def bigru_shared_bwd_reference(params: dict, parts, hp_f, hp_b, dy_f, dy_b, *, pool: int = 1,
                               drop_p: float = 0.0, seed=None):
    """K3's function in plain PyTorch, written out as the kernel computes it
    (``pallas_gru.py:1361-1441``): the gates recomputed from x and h_prev,
    the serial dh chain of each direction, then dX and the weight gradients.

    Plain mode (``pool == 1`` and ``drop_p == 0``): ``dy_*`` are full-rate
    (T, B, H) cotangents of the unpooled forward. Fused mode: they are the
    POOLED cotangents of :func:`bigru_trainpool_reference`, expanded by
    :func:`expand_pooled_cotangent`. Returns ``(dxs, grads)``: one (T, B, D_p)
    gradient per part, of the parts' dtype, and ``{"fwd": {...}, "bwd":
    {...}}`` keyed like ``params``, f32. At bf16 (parts, ``hp_*`` and
    ``dy_*`` bf16) the gates come from bf16 x and h_prev against the rounded
    weights, dgh is rounded for the chain's product, each direction's dX
    (the rounded dgi against the rounded W_ih) is rounded, and so is their
    sum, as the TPU kernel's bf16 outputs and XLA's sum of them are; the
    weight gradients take the f32 dgi and dgh.
    """
    parts = _check_args(parts, pool, "avg")
    fused = pool > 1 or drop_p > 0.0
    if fused:
        _check_drop(drop_p, seed)
    dtype, bf = parts[0].dtype, is_bf16(parts)
    if bf:
        params, parts = _as_f32(params, parts)
        hp_f, hp_b, dy_f, dy_b = (t.float() for t in (hp_f, hp_b, dy_f, dy_b))
    rnd = round_bf16 if bf else (lambda t: t)
    T, B = parts[0].shape[:2]
    x = torch.cat(parts, dim=-1).reshape(T * B, -1)
    dx = 0.0
    grads = {}
    for name, hp, dy in (("fwd", hp_f, dy_f), ("bwd", hp_b, dy_b)):
        p = params[name]
        H = p["weight_hh"].shape[1]
        if fused:
            dy = expand_pooled_cotangent(dy, T, pool=pool, drop_p=drop_p, seed=seed,
                                         dir_salt=_SALTS[name])
        gi = _input_projection(p, parts)
        gh = torch.matmul(hp, p["weight_hh"].t()) + p["bias_hh"]
        rz = torch.sigmoid(gi[..., :2 * H] + gh[..., :2 * H])
        r, z = rz[..., :H], rz[..., H:]
        gh_n = gh[..., 2 * H:]
        n = torch.tanh(gi[..., 2 * H:] + r * gh_n)
        rfac = gh_n * r * (1.0 - r)
        dgi = torch.empty_like(gi)
        dh = hp.new_zeros((B, H))
        for t in (range(T - 1, -1, -1) if name == "fwd" else range(T)):
            d = dh + dy[t]
            dn = d * (1.0 - z[t]) * (1.0 - n[t] * n[t])
            dz = d * (hp[t] - n[t]) * z[t] * (1.0 - z[t])
            dr = dn * rfac[t]
            dgi[t] = torch.cat([dr, dz, dn], dim=-1)
            dh = torch.matmul(rnd(torch.cat([dr, dz, dn * r[t]], dim=-1)), p["weight_hh"]) + d * z[t]
        dgh = torch.cat([dgi[..., :2 * H], dgi[..., 2 * H:] * r], dim=-1).reshape(T * B, 3 * H)
        dgi = dgi.reshape(T * B, 3 * H)
        dx = dx + rnd(torch.matmul(rnd(dgi), p["weight_ih"]))  # bf16: each direction's rounded
        grads[name] = {"weight_ih": torch.matmul(dgi.t(), x), "bias_ih": dgi.sum(0),
                       "weight_hh": torch.matmul(dgh.t(), hp.reshape(T * B, H)),
                       "bias_hh": dgh.sum(0)}
    dxs = torch.split(dx.reshape(T, B, -1), [x.shape[-1] for x in parts], dim=-1)
    return tuple(d.to(dtype).contiguous() for d in dxs), grads  # bf16: their sum rounded


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda(what: str, params: dict, parts: tuple, extra=()) -> tuple[int, int, int]:
    """Shapes, devices and dtypes the kernels take: float32 everything, or
    bfloat16 streams (the parts and ``extra``) with float32 weights."""
    dev = parts[0].device
    T, B = parts[0].shape[:2]
    stream = parts[0].dtype
    tensors = [(f"part {i}", x, stream) for i, x in enumerate(parts)]
    tensors += [(f"{d}.{n}", params[d][n], torch.float32) for d in _DIRS for n in _NAMES]
    tensors += [(name, x, stream) for name, x in extra]
    for name, x, dtype in tensors:
        if x.device != dev:
            raise ValueError(f"{what}: {name} is on {x.device}, part 0 on {dev}")
        if stream not in STREAM_DTYPES or x.dtype != dtype:
            raise TypeError(f"{what}: {name} is {x.dtype}; the kernel takes float32 streams and weights, "
                            f"or bfloat16 streams (parts, h_prev, cotangents) with float32 weights; "
                            f"part 0 is {stream}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    for i, x in enumerate(parts):
        if x.dim() != 3 or tuple(x.shape[:2]) != (T, B):
            raise ValueError(f"{what}: part {i} has shape {tuple(x.shape)}, want ({T}, {B}, D)")
    D = sum(x.shape[-1] for x in parts)
    H = params["fwd"]["weight_hh"].shape[-1]
    want = {"weight_ih": (3 * H, D), "weight_hh": (3 * H, H), "bias_ih": (3 * H,), "bias_hh": (3 * H,)}
    for d in _DIRS:
        for n, shape in want.items():
            if tuple(params[d][n].shape) != shape:
                raise ValueError(f"{what}: {d}.{n} has shape {tuple(params[d][n].shape)}, want {shape}")
    if T < 1 or B < 1 or H % 4 != 0:
        raise ValueError(f"{what}: kernel needs T, B >= 1 and H % 4 == 0 (T={T}, B={B}, H={H})")
    if H > _build.MAX_H:
        raise ValueError(f"{what}: the card's kernels hold W_hh's cluster slices in registers (K1, K2, "
                         f"K6 and K3's chain), for H <= {_build.MAX_H}, got H={H}")
    if 2 * T * B * 4 * H >= 2**31 or T * B * max(D, H) >= 2**31:
        raise ValueError(f"{what}: T*B*H too large for the kernel's int indexing (T={T}, B={B}, H={H})")
    return T, B, H


def _device_of(parts) -> torch.device:
    dev = parts[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"bigru_shared runs on cpu or cuda tensors, not {dev}")
    return dev


def _ptrs(params: dict) -> list[int]:
    return [params[d][n].data_ptr() for d in _DIRS for n in _NAMES]



def _part_ptrs(parts) -> list:
    x2 = parts[1] if len(parts) == 2 else None
    return [parts[0].data_ptr(), parts[0].shape[-1],
            None if x2 is None else x2.data_ptr(), 0 if x2 is None else x2.shape[-1]]


def bigru_cluster_size(B: int) -> int:
    """The CTAs in a cluster of the two-direction recurrence (K1, K2, K4f and K6)
    at batch B on the current card: 4 while both directions' clusters of 4
    (8 B CTAs) fill at most three quarters of its SMs, else 2."""
    C = _build.library().tsl_bigru_shared_cluster_size(B)
    if C < 0:
        raise RuntimeError("tsl_bigru_shared_cluster_size: CUDA error")
    return C


def bigru_shared_fwd(params: dict, parts, *, pool: int = 1, pool_method: str = "avg",
                     layout: str = "split"):
    """K1 (``layout="split"``) or K6 (``"rowstack"``): the eval forward,
    ``(h_f, h_b)`` of shape (ceil(T/pool), B, H).

    CPU tensors take the layout's plain version,
    :func:`bigru_shared_reference` or
    :func:`bigru_shared_rowstack_reference`; CUDA tensors launch the kernel
    on the current stream without synchronising, and anything the kernel
    does not take raises, H past 128 too. Both layouts' recurrence runs on
    thread-block clusters whose size follows the batch
    (:func:`bigru_cluster_size`). Records no autograd graph on CUDA.
    """
    parts = _check_args(parts, pool, pool_method, layout)
    rowstack = layout == "rowstack"
    if _device_of(parts).type == "cpu":
        ref = bigru_shared_rowstack_reference if rowstack else bigru_shared_reference
        return ref(params, parts, pool=pool, pool_method=pool_method)
    T, B, H = _check_cuda("bigru_shared_fwd", params, parts)
    lib = _build.library()
    dev, bf = parts[0].device, is_bf16(parts)
    To = -(-T // pool)
    gi = torch.empty((2, T, B, 3 * H), device=dev, dtype=torch.float32)
    h_f = torch.empty((To, B, H), device=dev, dtype=parts[0].dtype)
    h_b = torch.empty((To, B, H), device=dev, dtype=parts[0].dtype)
    fn = {(False, False): lib.tsl_bigru_shared_fwd, (False, True): lib.tsl_bigru_shared_fwd_bf16,
          (True, False): lib.tsl_bigru_shared_fwd_rs, (True, True): lib.tsl_bigru_shared_fwd_rs_bf16}[
        (rowstack, bf)]
    err = fn(
        *_part_ptrs(parts), *_ptrs(params), gi.data_ptr(), h_f.data_ptr(), h_b.data_ptr(),
        T, B, H, pool, int(pool_method == "max"), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, f"bigru_shared_fwd (layout {layout}, {parts[0].dtype}, T={T}, B={B}, H={H}, "
                      f"pool={pool})")
    if rowstack:
        bigru_shared.launches_rowstack += 1
    else:
        bigru_shared.launches += 1
    bigru_shared.launches_bf16 += bf
    return h_f, h_b


def bigru_trainpool(params: dict, parts, *, pool: int, drop_p: float, seed: int):
    """K2: ``(hp_f, hp_b, pooled_f, pooled_b)`` as :func:`bigru_trainpool_reference`.

    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    current stream without synchronising, and anything the kernel does not
    take raises, H past 128 too. Its recurrence is K1's, on thread-block
    clusters whose size follows the batch as K1's does
    (:func:`bigru_cluster_size`), with each step's h_prev stored and the
    hash dropout applied before the pool in its epilogue. Records no
    autograd graph on CUDA.
    """
    parts = _check_args(parts, pool, "avg")
    _check_drop(drop_p, seed)
    if _device_of(parts).type == "cpu":
        return bigru_trainpool_reference(params, parts, pool=pool, drop_p=drop_p, seed=seed)
    T, B, H = _check_cuda("bigru_trainpool", params, parts)
    lib = _build.library()
    dev, bf, dtype = parts[0].device, is_bf16(parts), parts[0].dtype
    To = -(-T // pool)
    gi = torch.empty((2, T, B, 3 * H), device=dev, dtype=torch.float32)
    hp_f, hp_b = (torch.empty((T, B, H), device=dev, dtype=dtype) for _ in range(2))
    p_f, p_b = (torch.empty((To, B, H), device=dev, dtype=dtype) for _ in range(2))
    fn = lib.tsl_bigru_trainpool_fwd_bf16 if bf else lib.tsl_bigru_trainpool_fwd
    err = fn(
        *_part_ptrs(parts), *_ptrs(params), gi.data_ptr(), hp_f.data_ptr(), hp_b.data_ptr(),
        p_f.data_ptr(), p_b.data_ptr(), T, B, H, pool, int(seed), keep_threshold(drop_p),
        1.0 / (1.0 - drop_p), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, f"bigru_trainpool ({dtype}, T={T}, B={B}, H={H}, pool={pool}, p={drop_p})")
    bigru_trainpool.launches += 1
    bigru_trainpool.launches_bf16 += bf
    return hp_f, hp_b, p_f, p_b


bigru_trainpool.launches = 0  # wrapper calls that launched K2
bigru_trainpool.launches_bf16 = 0  # ... its bf16 instantiation (counted in launches too)


def bigru_shared_bwd(params: dict, parts, hp_f, hp_b, dy_f, dy_b, *, pool: int = 1,
                     drop_p: float = 0.0, seed=None):
    """K3: ``(dxs, grads)`` as :func:`bigru_shared_bwd_reference`.

    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    current stream without synchronising. The weight gradients are summed in
    a fixed order, so repeated calls on one card agree bit for bit. At bf16
    the parts, ``hp_*`` and ``dy_*`` are bf16 and so are the dxs.
    """
    parts = _check_args(parts, pool, "avg")
    fused = pool > 1 or drop_p > 0.0
    if fused:
        _check_drop(drop_p, seed)
    if _device_of(parts).type == "cpu":
        return bigru_shared_bwd_reference(params, parts, hp_f, hp_b, dy_f, dy_b, pool=pool,
                                          drop_p=drop_p, seed=seed)
    T, B = parts[0].shape[:2]
    H = params["fwd"]["weight_hh"].shape[-1]
    To = -(-T // pool) if fused else T
    extra = [("hp_f", hp_f), ("hp_b", hp_b), ("dy_f", dy_f), ("dy_b", dy_b)]
    _check_cuda("bigru_shared_bwd", params, parts, extra)
    for name, x, shape in (("hp_f", hp_f, (T, B, H)), ("hp_b", hp_b, (T, B, H)),
                           ("dy_f", dy_f, (To, B, H)), ("dy_b", dy_b, (To, B, H))):
        if tuple(x.shape) != shape:
            raise ValueError(f"bigru_shared_bwd: {name} has shape {tuple(x.shape)}, want {shape}")
    lib = _build.library()
    dev, bf = parts[0].device, is_bf16(parts)

    def empty(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    dxs = [torch.empty((T, B, x.shape[-1]), device=dev, dtype=x.dtype) for x in parts]
    D = sum(x.shape[-1] for x in parts)
    grads = {d: {"weight_ih": empty(3 * H, D), "bias_ih": empty(3 * H),
                 "weight_hh": empty(3 * H, H), "bias_hh": empty(3 * H)} for d in _DIRS}
    buf_a, buf_b = empty(2, T, B, 3 * H), empty(2, T, B, 3 * H)
    gates = empty(2, T, B, 4 * H)
    dyx = empty(2, T, B, H) if fused or bf else None  # at bf16 the chain reads dY widened to f32
    partial = empty(_build.partial_floats(parts[0].shape[-1], D - parts[0].shape[-1], H, T * B, 2))
    fn = lib.tsl_bigru_shared_bwd_bf16 if bf else lib.tsl_bigru_shared_bwd
    # at bf16 each direction's dX, rounded, before their sum is rounded
    pair = [torch.empty((2, T * B, D), device=dev, dtype=torch.bfloat16).data_ptr()] if bf else []
    err = fn(
        *_part_ptrs(parts), hp_f.data_ptr(), hp_b.data_ptr(), dy_f.data_ptr(), dy_b.data_ptr(),
        *_ptrs(params), dxs[0].data_ptr(), dxs[1].data_ptr() if len(dxs) == 2 else None,
        *[grads[d][n].data_ptr() for d in _DIRS for n in _NAMES],
        buf_a.data_ptr(), buf_b.data_ptr(), gates.data_ptr(),
        None if dyx is None else dyx.data_ptr(), partial.data_ptr(), *pair,
        T, B, H, pool, int(fused), int(seed or 0), keep_threshold(drop_p),
        1.0 / (1.0 - drop_p), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, f"bigru_shared_bwd ({parts[0].dtype}, T={T}, B={B}, H={H}, pool={pool}, "
                      f"p={drop_p})")
    bigru_shared_bwd.launches += 1
    bigru_shared_bwd.launches_bf16 += bf
    return tuple(dxs), grads


bigru_shared_bwd.launches = 0  # wrapper calls that launched K3
bigru_shared_bwd.launches_bf16 = 0  # ... its bf16 instantiation (counted in launches too)


# ---------------------------------------------------------------------------
# Autograd (pallas_gru.py:1540-1690)
# ---------------------------------------------------------------------------


def _grad_outputs(dxs, grads) -> tuple:
    return (*dxs, *[grads[d][n] for d in _DIRS for n in _NAMES])


class _TrainCore(torch.autograd.Function):
    """Unpooled train core (``_shared_train_core_for``): K1 (or K6) forward
    at full rate; backward K3 in plain mode, h_prev made by shifting the
    outputs."""

    @staticmethod
    def forward(ctx, n_parts, layout, *args):
        parts, weights = args[:n_parts], args[n_parts:]
        h_f, h_b = bigru_shared_fwd(_params(weights), parts, layout=layout)
        ctx.n_parts = n_parts
        ctx.save_for_backward(*args, h_f, h_b)
        return h_f, h_b

    @staticmethod
    def backward(ctx, dy_f, dy_b):
        saved = ctx.saved_tensors
        parts, weights, (h_f, h_b) = saved[:ctx.n_parts], saved[ctx.n_parts:-2], saved[-2:]
        hp_f, hp_b = _shift_hp(h_f, h_b)
        dxs, grads = bigru_shared_bwd(_params(weights), parts, hp_f, hp_b,
                                      dy_f.contiguous(), dy_b.contiguous())
        return (None, None, *_grad_outputs(dxs, grads))


class _TrainPoolCore(torch.autograd.Function):
    """Fused train core (``_shared_trainpool_core_for``): K2 forward (dropout
    + ceil avg-pool, h_prev residuals); backward K3 in fused mode on the
    POOLED cotangents. The seed gets no gradient."""

    @staticmethod
    def forward(ctx, n_parts, pool, drop_p, seed, *args):
        parts, weights = args[:n_parts], args[n_parts:]
        hp_f, hp_b, p_f, p_b = bigru_trainpool(_params(weights), parts, pool=pool,
                                               drop_p=drop_p, seed=seed)
        ctx.n_parts, ctx.pool, ctx.drop_p, ctx.seed = n_parts, pool, drop_p, seed
        ctx.save_for_backward(*args, hp_f, hp_b)
        return p_f, p_b

    @staticmethod
    def backward(ctx, dy_f, dy_b):
        saved = ctx.saved_tensors
        parts, weights, (hp_f, hp_b) = saved[:ctx.n_parts], saved[ctx.n_parts:-2], saved[-2:]
        dxs, grads = bigru_shared_bwd(_params(weights), parts, hp_f, hp_b, dy_f.contiguous(),
                                      dy_b.contiguous(), pool=ctx.pool, drop_p=ctx.drop_p,
                                      seed=ctx.seed)
        return (None, None, None, None, *_grad_outputs(dxs, grads))


class _PooledEvalCore(torch.autograd.Function):
    """Pooled eval path with exact gradients on demand
    (``_shared_pooled_core_for``): K1 (or K6) forward at the pooled rate;
    the backward recomputes the full-rate forward through the same kernel,
    takes the VJP of the ceil pool, and runs K3 in plain mode."""

    @staticmethod
    def forward(ctx, n_parts, pool, pool_method, layout, *args):
        parts, weights = args[:n_parts], args[n_parts:]
        ctx.n_parts, ctx.pool, ctx.pool_method, ctx.layout = n_parts, pool, pool_method, layout
        ctx.save_for_backward(*args)
        return bigru_shared_fwd(_params(weights), parts, pool=pool, pool_method=pool_method,
                                layout=layout)

    @staticmethod
    def backward(ctx, dy_f, dy_b):
        saved = ctx.saved_tensors
        parts, weights = saved[:ctx.n_parts], saved[ctx.n_parts:]
        params = _params(weights)
        h_f, h_b = bigru_shared_fwd(params, parts, layout=ctx.layout)
        with torch.enable_grad():  # the pool's VJP in f32, its result in the streams' dtype
            full = [widen(h.detach()).requires_grad_() for h in (h_f, h_b)]
            pooled = [downsample(h, ctx.pool_method, ctx.pool, time_axis=0) for h in full]
            df, db = torch.autograd.grad(pooled, full, (widen(dy_f), widen(dy_b)))
        hp_f, hp_b = _shift_hp(h_f, h_b)
        dxs, grads = bigru_shared_bwd(params, parts, hp_f, hp_b, df.to(h_f.dtype).contiguous(),
                                      db.to(h_f.dtype).contiguous())
        return (None, None, None, None, *_grad_outputs(dxs, grads))


def bigru_shared(params: dict, parts, *, train: bool = False, pool: int = 1,
                 pool_method: str = "avg", drop_p: float = 0.0, seed=None,
                 layout: str = "split"):
    """One bidirectional GRU layer over time-major part streams.

    Same contract as the JAX ``bigru_apply_shared``; returns ``(h_f, h_b,
    pooled)`` in natural time order:

    * ``train`` with ``pool > 1`` or ``drop_p > 0``, ``pool_method == "avg"``
      and a uint32 ``seed``: the fused train path (K2 forward, K3 backward).
      Dropout at the full frame rate and the ceil avg-pool run inside the
      layer; outputs are (ceil(T/pool), B, H) and ``pooled`` is True. The
      caller applies neither again.
    * ``train`` otherwise: full-rate (T, B, H) outputs (K1 forward, K3
      backward); ``pooled`` is False and the caller applies dropout and pool.
    * eval: the pool (avg or max) fuses into K1 when ``pool > 1``; outputs are
      (ceil(T/pool), B, H) and ``pooled`` is ``pool > 1``. When a gradient is
      needed it stays exact: the backward recomputes the full-rate forward.

    ``layout`` picks the kernel of every K1 forward above, as JAX's
    ``_rowstack`` does in ``_shared_fwd_call``: ``"split"`` K1, ``"rowstack"``
    K6; the fused train path (K2) and the backward (K3) take no layout.

    Whenever grad mode is on and a part or a weight requires grad, the call
    goes through an autograd Function whose forward and backward are the
    kernels' wrappers; otherwise the forward wrapper is called alone, as
    decode under ``torch.inference_mode()`` does.
    """
    parts = _check_args(parts, pool, pool_method, layout)
    _device_of(parts)
    weights = _weights(params)
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (*parts, *weights))
    n = len(parts)
    if train and seed is not None and pool_method == "avg" and (pool > 1 or drop_p > 0.0):
        _check_drop(drop_p, seed)
        if needs_grad:
            p_f, p_b = _TrainPoolCore.apply(n, pool, float(drop_p), int(seed), *parts, *weights)
        else:
            p_f, p_b = bigru_trainpool(params, parts, pool=pool, drop_p=drop_p, seed=seed)[2:]
        return p_f, p_b, True
    if train or pool == 1:
        if needs_grad:
            h_f, h_b = _TrainCore.apply(n, layout, *parts, *weights)
        else:
            h_f, h_b = bigru_shared_fwd(params, parts, layout=layout)
        return h_f, h_b, False
    if needs_grad:
        h_f, h_b = _PooledEvalCore.apply(n, pool, pool_method, layout, *parts, *weights)
    else:
        h_f, h_b = bigru_shared_fwd(params, parts, pool=pool, pool_method=pool_method,
                                    layout=layout)
    return h_f, h_b, True


bigru_shared.launches = 0  # wrapper calls that launched K1 (bigru_shared_fwd, layout "split")
bigru_shared.launches_rowstack = 0  # ... that launched K6 (layout "rowstack")
bigru_shared.launches_bf16 = 0  # bf16 calls of either layout (counted above too)
