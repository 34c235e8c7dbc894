"""Length-masked bidirectional GRU layer: K4f and K4b, their wrappers, plain versions and autograd.

Port of the length-exact path's bi-GRU, ``gru_apply_masked`` of
``tpu_slu/ops/gru.py``, which on the TPU runs the joint kernel
``_fused_fwd_kernel`` (``tpu_slu/ops/pallas_gru.py:323``) and, in training,
its VJP ``_fused_bwd_kernel`` (``:400``). Batch-major, as the JAX function:
x (B, T, D) and valid lengths n (B,) -> (B, T, 2H), each row equal to the
layer on that example alone at T = n_b, zeros at t >= n_b. With every
n_b = T it is the unmasked ``gru_apply`` of the seq2seq encoder.

Each kernel has a wrapper, which launches it on a CUDA tensor and runs its
plain PyTorch version on a CPU tensor, and keeps a count of its launches
(a call that a CUDA graph captures is no launch: :func:`capturing`):

* K4f, the forward: :func:`bigru_masked_fwd`, counted on
  ``bigru_masked.launches`` (``csrc/bigru_masked_fwd.cu``: the cluster
  recurrence of ``csrc/gru_cluster.cuh`` at two directions, batch-major,
  with the rows' lengths);
* K4b, the backward: :func:`bigru_masked_bwd`, counted on
  ``bigru_masked_bwd.launches`` (``csrc/bigru_masked_bwd.cu``).

:func:`bigru_masked` routes a call through a ``torch.autograd.Function``
whose forward and backward are those wrappers whenever a gradient is needed,
on either device.

x (and the backward's ``out`` and ``dy``) is float32, or bfloat16 (the
seq2seq encoder of a ``compute_dtype=bfloat16`` trainer, its unidirectional
layers): the kernels and their plain versions then take the f32 master
weights, return bf16 streams (the output, dX) and f32 weight gradients, and
round where the TPU kernels round at that dtype (``pallas_gru.py:349-362``,
``:440-495``; K5's ``:154-161``, ``:206-244``): W_ih and W_hh rounded to
bf16, f32 accumulation, h rounded for the recurrent product only, dgh for
the chain's product only, each direction's dX rounded and their sum rounded
again, dW from the f32 dgi and dgh. Each wrapper counts its bf16 launches on
``launches_bf16`` too.
"""

from __future__ import annotations

import torch

from tpu_slu_torch.ops import _build
from tpu_slu_torch.ops.bigru_shared import STREAM_DTYPES, _as_f32, round_bf16
from tpu_slu_torch.ops.gru import gru_apply, gru_apply_masked

_DIRS = ("fwd", "bwd")
_NAMES = ("weight_ih", "bias_ih", "weight_hh", "bias_hh")
BF16 = torch.bfloat16


def bigru_masked_reference(params: dict, x: torch.Tensor, n: torch.Tensor | None) -> torch.Tensor:
    """K4f's function in plain PyTorch: ``gru_apply_masked`` (``reverse_padded``
    plus one forward walk per direction, as the JAX scan branch), or
    ``gru_apply`` with ``n`` None; with ``{"fwd"}`` params K5f's. A bf16 x
    runs on f32 copies with W_ih and W_hh rounded to bf16 and h rounded for
    the recurrent product, its output rounded to bf16 once. Autograd through
    and through."""
    bf = x.dtype == BF16
    if bf:
        params, (x,) = _as_f32(params, (x,))
    out = gru_apply(params, x, round_h=bf) if n is None else gru_apply_masked(params, x, n, round_h=bf)
    return out.to(BF16) if bf else out


def bigru_masked_bwd_reference(params: dict, x: torch.Tensor, out: torch.Tensor, n: torch.Tensor,
                               dy: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """K4b's function in plain PyTorch, written out as the kernel computes it
    (``pallas_gru.py:400-503``): the gates recomputed from x and each
    direction's h_prev, the serial dh chain of each direction, then dX and
    the weight gradients. With ``params`` of one direction (``{"fwd"}``) it
    is K5b's function (``_fused1_bwd_kernel``, ``:189-247``).

    ``out`` (B, T, 2H, or H for one direction) is the forward output of
    :func:`bigru_masked`; each direction's h_prev is read from it,
    ``out[:, t-1, :H]`` (forward) and ``out[:, t+1, H:]`` (backward), zero at
    the direction's first step (t = 0 and t = n_b - 1). ``dy``, shaped as
    ``out``, is the cotangent; at t >= n_b the output is a constant 0, so
    ``dy`` there is ignored and dX there is 0. Returns ``(dx (B, T, D),
    grads)``, ``grads`` keyed like ``params``. At bf16 (x, ``out`` and ``dy``
    bf16) the gates come from bf16 x and h_prev against the rounded weights,
    dgh is rounded for the chain's product, each direction's dX (the rounded
    dgi against the rounded W_ih) is rounded and so is their sum; the
    weight gradients take the f32 dgi and dgh.
    """
    dtype, bf = x.dtype, x.dtype == BF16
    if bf:
        params, (x, out, dy) = _as_f32(params, (x, out, dy))
    rnd = round_bf16 if bf else (lambda t: t)
    B, T, D = x.shape
    H = params["fwd"]["weight_hh"].shape[1]
    t = torch.arange(T, device=x.device)
    valid = (t[None, :] < n.to(x.device)[:, None])[:, :, None]  # (B, T, 1)
    zero = out.new_zeros((B, 1, H))
    hps = {"fwd": torch.cat([zero, out[:, :-1, :H]], dim=1)}
    if "bwd" in params:
        hps["bwd"] = torch.where((t[None, :] + 1 < n.to(x.device)[:, None])[:, :, None],
                                 torch.cat([out[:, 1:, H:], zero], dim=1), 0.0)
    xf = x.reshape(B * T, D)
    dx = 0.0
    grads = {}
    for k, name in enumerate(hps):
        p, hp = params[name], hps[name]
        gi = torch.matmul(x, p["weight_ih"].t()) + p["bias_ih"]
        gh = torch.matmul(hp, p["weight_hh"].t()) + p["bias_hh"]
        rz = torch.sigmoid(gi[..., :2 * H] + gh[..., :2 * H])
        r, z = rz[..., :H], rz[..., H:]
        gh_n = gh[..., 2 * H:]
        ng = torch.tanh(gi[..., 2 * H:] + r * gh_n)
        rfac = gh_n * r * (1.0 - r)
        dyd = torch.where(valid, dy[..., k * H:(k + 1) * H], 0.0)
        dgi = torch.empty_like(gi)
        dh = x.new_zeros((B, H))
        # the forward direction's gradient walks t = T-1..0, the backward's 0..T-1; a row
        # takes part at its valid steps only (its walk starts at t = n_b - 1 and 0)
        for s in (range(T - 1, -1, -1) if name == "fwd" else range(T)):
            v = valid[:, s]
            d = dh + dyd[:, s]
            dn = d * (1.0 - z[:, s]) * (1.0 - ng[:, s] * ng[:, s])
            dz = d * (hp[:, s] - ng[:, s]) * z[:, s] * (1.0 - z[:, s])
            dr = dn * rfac[:, s]
            dgi[:, s] = torch.where(v, torch.cat([dr, dz, dn], dim=-1), 0.0)
            dgh_s = torch.cat([dr, dz, dn * r[:, s]], dim=-1)
            dh = torch.where(v, torch.matmul(rnd(dgh_s), p["weight_hh"]) + d * z[:, s], 0.0)
        dgh = torch.cat([dgi[..., :2 * H], dgi[..., 2 * H:] * r], dim=-1).reshape(B * T, 3 * H)
        dgi = dgi.reshape(B * T, 3 * H)
        dx = dx + rnd(torch.matmul(rnd(dgi), p["weight_ih"]))  # bf16: each direction's rounded
        grads[name] = {"weight_ih": torch.matmul(dgi.t(), xf), "bias_ih": dgi.sum(0),
                       "weight_hh": torch.matmul(dgh.t(), hp.reshape(B * T, H)),
                       "bias_hh": dgh.sum(0)}
    return dx.reshape(B, T, D).to(dtype), grads  # bf16: their sum rounded


def capturing(t: torch.Tensor) -> bool:
    """Whether ``t`` is a CUDA tensor and the current stream is capturing a
    CUDA graph (the length-exact decode's, ``models/decode_graph.py``): a
    wrapper then reads nothing back to the host and counts no launch, since
    the kernel runs only when the graph is replayed."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def check_layer(what: str, params: dict, x: torch.Tensor, n: torch.Tensor | None,
                extra=()) -> tuple[int, int, int, int]:
    """(B, T, D, H) of a CUDA call of the masked layer kernels (K4f, K4b with
    ``params`` of both directions; K5f, K5b with ``{"fwd"}``), or raise with
    the reason the kernel cannot take it; ``extra`` are (name, tensor)
    pairs shaped as the output. ``n`` None: every row has T frames. x and
    ``extra`` are float32, or all bfloat16; the weights float32. The range
    of ``n``, [0, T], is read back and checked on the host, except while
    the current stream captures a CUDA graph (the length-exact decode's,
    whose lengths ``Model.predict_intents`` checked on the host)."""
    if x.dim() != 3:
        raise ValueError(f"{what}: x has shape {tuple(x.shape)}, want (B, T, D)")
    B, T, D = x.shape
    dirs = [d for d in _DIRS if d in params]
    stream = x.dtype
    tensors = [("x", x, stream)] + [(f"{d}.{k}", params[d][k], torch.float32) for d in dirs for k in _NAMES]
    tensors += [(name, t, stream) for name, t in extra]
    for name, t, dtype in tensors:
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on {x.device}")
        if stream not in STREAM_DTYPES or t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}; the kernel takes float32 streams and weights, "
                            f"or bfloat16 streams (x, out, dy) with float32 weights; x is {stream}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    H = params["fwd"]["weight_hh"].shape[-1]
    want = {"weight_ih": (3 * H, D), "weight_hh": (3 * H, H), "bias_ih": (3 * H,), "bias_hh": (3 * H,)}
    for d in dirs:
        for k, shape in want.items():
            if tuple(params[d][k].shape) != shape:
                raise ValueError(f"{what}: {d}.{k} has shape {tuple(params[d][k].shape)}, "
                                 f"want {shape}")
    width = len(dirs) * H
    for name, t in extra:
        if tuple(t.shape) != (B, T, width):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, want {(B, T, width)}")
    if T < 1 or B < 1 or H % 4 != 0:
        raise ValueError(f"{what}: kernel needs T, B >= 1 and H % 4 == 0 (T={T}, B={B}, H={H})")
    if H > _build.MAX_H:
        raise ValueError(f"{what}: the card's kernels hold their slice of W_hh in registers sized for "
                         f"H <= {_build.MAX_H}, got H={H}")
    if len(dirs) * B * T * 3 * H >= 2**31 or B * T * max(D, width) >= 2**31:
        raise ValueError(f"{what}: B*T*H too large for the kernel's int indexing "
                         f"(B={B}, T={T}, H={H})")
    if n is None:
        return B, T, D, H
    if n.device != x.device:
        raise ValueError(f"{what}: n is on {n.device}, x on {x.device}")
    if n.dtype not in (torch.int32, torch.int64) or tuple(n.shape) != (B,):
        raise TypeError(f"{what}: n must be an int32/int64 tensor of shape ({B},), "
                        f"got {n.dtype} {tuple(n.shape)}")
    if capturing(x):
        return B, T, D, H  # a CUDA graph's capture reads nothing back: its caller checked n on the host
    lo, hi = (int(v) for v in torch.aminmax(n))
    if lo < 0 or hi > T:
        raise ValueError(f"{what}: lengths must lie in [0, T={T}], got [{lo}, {hi}]")
    return B, T, D, H


def device_of(what: str, x: torch.Tensor) -> torch.device:
    """x's device, which must be the CPU (plain version) or a GPU (kernel)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {x.device}")
    return x.device


def _weights(params: dict) -> list[torch.Tensor]:
    return [params[d][k] for d in _DIRS for k in _NAMES]


def _params(weights) -> dict:
    return {d: dict(zip(_NAMES, weights[4 * k:4 * k + 4])) for k, d in enumerate(_DIRS)}


def bigru_masked_fwd(params: dict, x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """K4f: ``(B, T, 2H)`` as :func:`bigru_masked_reference`.

    ``params``: ``{"fwd": d, "bwd": d}``, ``d`` holding ``weight_ih`` (3H,
    D), ``weight_hh`` (3H, H), ``bias_ih`` and ``bias_hh`` (3H,), torch
    layout. CPU tensors take the plain version. CUDA tensors launch the
    kernel on the current stream without synchronising (the range check of
    ``n`` reads it on the host, except while the stream captures a CUDA
    graph: :func:`check_layer`); anything the kernel does not take raises,
    H past 128 too. Its recurrence runs both directions on thread-block
    clusters whose size follows the batch as K1's does
    (``bigru_shared.bigru_cluster_size``); each batch tile steps to its
    longest row and writes exact zeros past each row's length. Records no
    autograd graph on CUDA. A bf16 x gives a bf16 output.
    """
    if device_of("bigru_masked", x).type == "cpu":
        return bigru_masked_reference(params, x, n)
    B, T, D, H = check_layer("bigru_masked", params, x, n)
    lib = _build.library()
    bf = x.dtype == BF16
    lengths = n.to(torch.int64).contiguous()
    gi = torch.empty((2, B, T, 3 * H), device=x.device, dtype=torch.float32)
    out = torch.empty((B, T, 2 * H), device=x.device, dtype=x.dtype)
    fn = lib.tsl_bigru_masked_fwd_bf16 if bf else lib.tsl_bigru_masked_fwd
    err = fn(
        x.data_ptr(), D, lengths.data_ptr(), *[t.data_ptr() for t in _weights(params)],
        gi.data_ptr(), out.data_ptr(), T, B, H, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, f"bigru_masked ({x.dtype}, B={B}, T={T}, H={H})")
    if not capturing(x):
        bigru_masked.launches += 1
        bigru_masked.launches_bf16 += bf
    return out


def bigru_masked_bwd(params: dict, x: torch.Tensor, out: torch.Tensor, n: torch.Tensor,
                     dy: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """K4b: ``(dx, grads)`` as :func:`bigru_masked_bwd_reference`.

    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    current stream without synchronising, and anything the kernel does not
    take raises. The weight gradients are summed in a fixed order, so
    repeated calls on one card agree bit for bit. At bf16 (x, ``out`` and
    ``dy`` bf16) dx is bf16, the weight gradients f32.
    """
    if device_of("bigru_masked", x).type == "cpu":
        return bigru_masked_bwd_reference(params, x, out, n, dy)
    B, T, D, H = check_layer("bigru_masked", params, x, n, [("out", out), ("dy", dy)])
    lib = _build.library()
    lengths = n.to(torch.int64).contiguous()
    bf = x.dtype == BF16

    def empty(*shape):
        return torch.empty(shape, device=x.device, dtype=torch.float32)

    dx = torch.empty((B, T, D), device=x.device, dtype=x.dtype)
    grads = {d: {"weight_ih": empty(3 * H, D), "bias_ih": empty(3 * H),
                 "weight_hh": empty(3 * H, H), "bias_hh": empty(3 * H)} for d in _DIRS}
    scratch = bwd_scratch(x, 2, H)
    fn = lib.tsl_bigru_masked_bwd_bf16 if bf else lib.tsl_bigru_masked_bwd
    err = fn(
        x.data_ptr(), D, lengths.data_ptr(), out.data_ptr(), dy.data_ptr(),
        *[t.data_ptr() for t in _weights(params)],
        dx.data_ptr(), *[grads[d][k].data_ptr() for d in _DIRS for k in _NAMES],
        *[t.data_ptr() for t in scratch], T, B, H, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, f"bigru_masked_bwd ({x.dtype}, B={B}, T={T}, H={H})")
    bigru_masked_bwd.launches += 1
    bigru_masked_bwd.launches_bf16 += bf
    return dx, grads


def bwd_scratch(x: torch.Tensor, ndir: int, H: int) -> list[torch.Tensor]:
    """The workspaces of K4b (``ndir`` 2) or K5b (1) for x (B, T, D), in the
    entry points' order: hp, buf_a, buf_b, gates and partial (f32), and for
    a bf16 x also hp16 (bf16), dyx (f32) and, with two directions, pair
    (bf16). Hold them until the launch has run: it writes them by address."""
    B, T, D = x.shape

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, device=x.device, dtype=dtype)

    scratch = [empty(ndir, B, T, H), empty(ndir, B, T, 3 * H), empty(ndir, B, T, 3 * H),
               empty(ndir, B, T, 4 * H), empty(_build.partial_floats(D, 0, H, B * T, ndir))]
    if x.dtype == BF16:
        scratch += [empty(ndir, B, T, H, dtype=BF16), empty(ndir, B, T, H)]
        if ndir == 2:
            scratch.append(empty(2, B * T, D, dtype=BF16))
    return scratch


bigru_masked_bwd.launches = 0  # wrapper calls that launched K4b
bigru_masked_bwd.launches_bf16 = 0  # ... its bf16 instantiation (counted in launches too)


class _MaskedCore(torch.autograd.Function):
    """The layer under autograd (``_bigru_seq_for``'s custom VJP): K4f
    forward, saving x, n, the output and the weights; K4b backward, h_prev
    read from the saved output. ``n`` gets no gradient."""

    @staticmethod
    def forward(ctx, x, n, *weights):
        out = bigru_masked_fwd(_params(weights), x, n)
        ctx.save_for_backward(x, n, out, *weights)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, n, out, *weights = ctx.saved_tensors
        dx, grads = bigru_masked_bwd(_params(weights), x, out, n, dy.contiguous())
        return (dx, None, *_weights(grads))


def bigru_masked(params: dict, x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The layer, ``(B, T, 2H)`` as :func:`bigru_masked_reference`.

    Whenever grad mode is on and x or a weight requires grad, the call goes
    through an autograd Function whose forward is K4f's wrapper and whose
    backward is K4b's (on a CPU tensor, their plain versions); otherwise
    K4f's wrapper is called alone, as decode under
    ``torch.inference_mode()`` does. On CUDA it never returns a detached
    output of a call that needs a gradient.
    """
    device_of("bigru_masked", x)
    weights = _weights(params)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *weights)):
        return _MaskedCore.apply(x, n, *weights)
    return bigru_masked_fwd(params, x, n)


bigru_masked.launches = 0  # wrapper calls that launched K4f (bigru_masked_fwd), a graph's capture not
bigru_masked.launches_bf16 = 0  # ... its bf16 instantiation (counted in launches too)
