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

import functools
import math

import torch
import torch.nn.functional as F

from tpu_slu_torch.ops import _build
from tpu_slu_torch.ops.conv import max_pool1d_ceil
from tpu_slu_torch.ops.sinc import sinc_conv, sinc_filters

ACTS = ("leaky_relu", "relu")

# The kernel's fixed shapes (csrc/sinc_frontend.cu): 8 conv rows x 4 filters a
# thread, two waveform windows in the cp.async ring, at most 384 threads a
# CTA, 227 KB of shared memory a CTA (an H100's).
THREAD_ROWS, THREAD_FILTERS = 8, 4
RING = 2
MAX_THREADS = 384
SMEM_LIMIT = 232_448
# The cost model's constants, in FMAs at an SM's rate: an item's fixed cost (barriers, the wait for its
# window), a 128-bit shared-memory load a thread issues, and a pooled output of the epilogue, pooled in
# registers or from each tap group's sums in shared memory. Fitted to the times of every admitted plan at
# the flagship front end on 4 s at B = 1, 16 and 128 on an H100, and checked against the same sweep at
# shapes they were not fitted to, 1 s to 4 s at B = 1 to 64 (tools/torch_cluster_ab.py --k8-plans;
# PERF.md section 6).
ITEM_COST = 250_000
LOAD_COST = 1.2
EPI_REG, EPI_TILE = 75, 450
PLAN_ARGS = ("rows", "ftile", "ksplit", "grid", "smem")  # what tsl_sinc_frontend_fwd takes of a plan


def filter_pitch(ft: int) -> int:
    """Floats between the taps of the resident filter tile: ft, or ft + 4
    where ft / 4 is even, so that the copies' 8 taps x 4 filters fall in 32
    distinct banks."""
    return ft if ft // 4 % 2 else ft + 4


def smem_bytes(rows: int, ft: int, ks: int, K: int, S: int, pool: int) -> int:
    """The kernel's shared memory: the filter tile (taps padded to 4), the
    ring's windows ((rows - 1) S + K samples, padded to 4), and the
    epilogue's tile of ks x ft rows, one float more than the item's pooled
    rows where they are pooled in registers (ks == 1 and pool 1, 2, 4 or 8),
    else than its conv rows."""
    k4 = -(-K // 4) * 4
    win = -(-((rows - 1) * S + k4) // 4) * 4
    pitch = (rows // pool if ks == 1 and THREAD_ROWS % pool == 0 else rows) + 1
    return 4 * (filter_pitch(ft) * k4 + RING * win + ks * ft * pitch)


def frontend_plans(B: int, T: int, F: int, K: int, S: int, pad: int, pool: int, sms: int):
    """Every launch plan of K8 that fits a card of ``sms`` SMs, each a dict
    with its modelled ``cost``: ``rows`` conv rows and ``ftile`` filters a
    work item (``rows`` a multiple of 8 and of ``pool``, so no pooling
    window straddles two items; ``ftile`` a multiple of 4), the taps split
    over ``ksplit`` thread groups, ``threads`` a CTA, ``grid`` CTAs (at most
    one a SM, a multiple of the ``nft`` filter tiles: CTA c keeps filter tile
    c % nft and walks the (example, row tile) items c // nft, c // nft +
    grid // nft, ...) and ``smem`` bytes of shared memory
    (:func:`smem_bytes`). The cost models the time of a CTA's walk at an
    SM's f32 FMA rate: the items it walks times (an item's FMAs, padded
    rows, filters and idle lanes included, plus ``LOAD_COST`` for each
    128-bit shared-memory load, over the share of the rate its warps reach:
    full from 8, and limited by the busiest of the SM's 4 schedulers), its
    epilogue (``EPI_REG`` or ``EPI_TILE`` a pooled output) and ``ITEM_COST``."""
    t_out = (T + 2 * pad - K) // S + 1
    if t_out < 1:
        raise ValueError(f"frontend_plan: no conv row (T={T}, K={K}, S={S}, pad={pad})")
    k4 = -(-K // 4) * 4
    f4 = -(-F // 4) * 4
    unit = math.lcm(THREAD_ROWS, pool)
    # a thread's shared-memory loads an FMA: a quad of taps is 8 loads of x (32
    # a tap at a time where S % 4 != 0) and 4 of the filters, for 128 FMAs
    loads = ((THREAD_ROWS if S % 4 == 0 else 4 * THREAD_ROWS) + 4) / (THREAD_ROWS * THREAD_FILTERS * 4)
    for ft in sorted({min(f4, 16 * i) for i in range(1, -(-f4 // 16) + 1)}):
        nft = -(-F // ft)
        if nft > sms:
            continue
        seen = None
        for rows in range(unit, -(-t_out // unit) * unit + 1, unit):
            nrt = -(-t_out // rows)
            if nrt == seen:  # a smaller tile gives as many items
                continue
            seen = nrt
            if smem_bytes(rows, ft, 1, K, S, pool) > SMEM_LIMIT:
                break  # and every larger tile
            for ks in (1, 2, 4, 8, 16):
                work = ks * (rows // THREAD_ROWS) * (ft // THREAD_FILTERS)
                threads = -(-work // 32) * 32
                smem = smem_bytes(rows, ft, ks, K, S, pool)
                if threads > MAX_THREADS or ks > k4 // 4 or smem > SMEM_LIMIT:
                    break
                items = B * nrt
                per_tile = min(items, sms // nft)
                rounds = -(-items // per_tile)
                warps = threads // 32
                share = min(1.0, warps / 8) * warps / (4 * -(-warps // 4))
                fmas = rows * ft * k4 * threads / work * (1 + LOAD_COST * loads)
                epilogue = (EPI_REG if ks == 1 and THREAD_ROWS % pool == 0 else EPI_TILE) * ft * rows / pool
                cost = rounds * (fmas / share + epilogue + ITEM_COST)
                yield dict(rows=rows, ftile=ft, ksplit=ks, threads=threads, grid=per_tile * nft, smem=smem,
                           nft=nft, nrt=nrt, t_out=t_out, cost=cost)


@functools.lru_cache(maxsize=512)
def frontend_plan(B: int, T: int, F: int, K: int, S: int, pad: int, pool: int, sms: int) -> dict:
    """K8's launch plan (:func:`frontend_plans`): the cheapest by the model,
    then the fewest CTAs and threads. Pure Python, so the CPU tests cover the
    plan the card runs."""
    plans = list(frontend_plans(B, T, F, K, S, pad, pool, sms))
    if not plans:
        raise ValueError(f"frontend_plan: no plan fits {SMEM_LIMIT} bytes of shared memory (F={F}, K={K}, "
                         f"S={S}, pool={pool})")
    return min(plans, key=lambda p: (p["cost"], p["grid"], p["threads"]))


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


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    with torch.no_grad():
        filters = sinc_filters(filt_b1, filt_band, filt_dim, fs).contiguous()  # (F, K)
    n_filt = filters.shape[0]
    t_pool = -(-((T + 2 * padding - filt_dim) // stride + 1) // pool)
    if B * T >= 2**31 or B * n_filt * t_pool >= 2**31:
        raise ValueError(f"sinc_frontend_fused: B={B}, T={T} too large for the kernel's int indexing")
    plan = frontend_plan(B, T, n_filt, filt_dim, stride, padding, pool, _sm_count(x.device))
    out = torch.empty((B, n_filt, t_pool), device=x.device, dtype=torch.float32)
    lib = _build.library()
    err = lib.tsl_sinc_frontend_fwd(x.data_ptr(), filters.data_ptr(), out.data_ptr(), B, T, n_filt,
                                    filt_dim, stride, padding, pool, int(act == "leaky_relu"),
                                    *(plan[k] for k in PLAN_ARGS),
                                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"sinc_frontend_fused (B={B}, T={T}, F={n_filt}, K={filt_dim}, S={stride}, "
                      f"pool={pool}, plan {plan})")
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
