"""Unidirectional GRU layer: K5f and K5b, their wrappers, plain versions and autograd.

Port of the JAX package's unidirectional layer: ``gru_apply`` and
``gru_apply_masked`` on ``{"fwd": ...}`` params, which on the TPU run
``_fused1_fwd_kernel`` (``tpu_slu/ops/pallas_gru.py:138``, through
``_run_direction`` and the custom VJP ``_gru1_seq_for``) and, in training,
its VJP ``_fused1_bwd_kernel`` (``:189``). Batch-major: x (B, T, D) and
optional valid lengths n (B,) -> (B, T, H), h0 = 0; each row equals the
layer on that example alone at T = n_b, zeros at t >= n_b. Without ``n``
every row has T frames, the TPU kernel's function.

Each kernel has a wrapper, which launches it on a CUDA tensor and runs its
plain PyTorch version on a CPU tensor, and keeps a count of its launches:

* K5f, the forward: :func:`gru1_fwd`, counted on ``gru1.launches``
  (``csrc/bigru_masked_fwd.cu`` ``gru1_cluster_kernel``: a thread-block
  cluster a batch tile, W_hh split by hidden units over its CTAs, the
  cluster's size chosen from the batch, :func:`gru1_cluster_size`);
* K5b, the backward: :func:`gru1_bwd`, counted on ``gru1_bwd.launches``
  (``csrc/bigru_masked_bwd.cu``, the one-direction instantiation of K4b).

:func:`gru1` routes a call through a ``torch.autograd.Function`` whose
forward and backward are those wrappers whenever a gradient is needed, on
either device. x is float32, or bfloat16 (a ``compute_dtype=bfloat16``
trainer's), as :mod:`~tpu_slu_torch.ops.bigru_masked` takes it, with the TPU
kernels' rounding points at that dtype; each wrapper counts its bf16
launches on ``launches_bf16`` too.
"""

from __future__ import annotations

import torch

from tpu_slu_torch.ops import _build
from tpu_slu_torch.ops.bigru_masked import (
    BF16,
    bigru_masked_bwd_reference,
    bigru_masked_reference,
    bwd_scratch,
    check_layer,
    device_of,
)

_NAMES = ("weight_ih", "bias_ih", "weight_hh", "bias_hh")


def gru1_reference(params: dict, x: torch.Tensor, n: torch.Tensor | None = None) -> torch.Tensor:
    """K5f's function in plain PyTorch: ``gru_apply_masked`` on ``{"fwd"}``
    (``gru_apply`` without ``n``; at bf16 with the kernel's rounding points,
    :func:`~tpu_slu_torch.ops.bigru_masked.bigru_masked_reference`); autograd
    through and through."""
    return bigru_masked_reference({"fwd": params["fwd"]}, x, n)


def gru1_bwd_reference(params: dict, x: torch.Tensor, out: torch.Tensor, n: torch.Tensor | None,
                       dy: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """K5b's function in plain PyTorch, written out as the kernel computes it
    (``pallas_gru.py:189-247``): the gates recomputed from x and h_prev =
    ``out[:, t-1]`` (0 at t = 0), the serial dh chain over each row's valid
    steps t = n_b-1..0, then dX and the weight gradients
    (:func:`~tpu_slu_torch.ops.bigru_masked.bigru_masked_bwd_reference` with
    one direction; at bf16 its dX rounded once). ``dy`` past n_b is ignored
    and dX there is 0. Returns ``(dx (B, T, D), {"fwd": grads})``."""
    if n is None:
        n = torch.full((x.shape[0],), x.shape[1], dtype=torch.int64, device=x.device)
    return bigru_masked_bwd_reference({"fwd": params["fwd"]}, x, out, n, dy)


def _lengths(n: torch.Tensor | None) -> tuple[torch.Tensor | None, int | None]:
    """The kernels' lengths: n as int64, and its pointer (None, a null
    pointer, for T frames in every row). Hold the tensor until the launch."""
    if n is None:
        return None, None
    n = n.to(torch.int64).contiguous()
    return n, n.data_ptr()


def gru1_cluster_size(B: int) -> int:
    """The CTAs in a cluster of K5f's recurrence at batch B on the current
    card: 4 while every row gets a cluster of its own in one wave of its
    SMs, else 2."""
    C = _build.library().tsl_gru1_cluster_size(B)
    if C < 0:
        raise RuntimeError("tsl_gru1_cluster_size: CUDA error")
    return C


def gru1_fwd(params: dict, x: torch.Tensor, n: torch.Tensor | None = None) -> torch.Tensor:
    """K5f: ``(B, T, H)`` as :func:`gru1_reference`.

    ``params``: ``{"fwd": d}`` (a ``"bwd"`` entry is refused), ``d`` holding
    ``weight_ih`` (3H, D), ``weight_hh`` (3H, H), ``bias_ih`` and
    ``bias_hh`` (3H,), torch layout. CPU tensors take the plain version.
    CUDA tensors launch the kernel on the current stream without
    synchronising; ``n`` None reads nothing on the host, a given ``n`` is
    range-checked there. Anything the kernel does not take raises, H past
    128 too. Records no autograd graph on CUDA. A bf16 x gives a bf16
    output.
    """
    if device_of("gru1", x).type == "cpu":
        return gru1_reference(params, x, n)
    if "bwd" in params:
        raise ValueError("gru1: params hold a backward direction; a bidirectional layer is bigru_masked's")
    B, T, D, H = check_layer("gru1", params, x, n)
    lib = _build.library()
    p = params["fwd"]
    bf = x.dtype == BF16
    lengths, lengths_ptr = _lengths(n)
    gi = torch.empty((B, T, 3 * H), device=x.device, dtype=torch.float32)
    out = torch.empty((B, T, H), device=x.device, dtype=x.dtype)
    fn = lib.tsl_gru1_fwd_bf16 if bf else lib.tsl_gru1_fwd
    err = fn(
        x.data_ptr(), D, lengths_ptr, *[p[k].data_ptr() for k in _NAMES],
        gi.data_ptr(), out.data_ptr(), T, B, H, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, f"gru1 ({x.dtype}, B={B}, T={T}, H={H})")
    gru1.launches += 1
    gru1.launches_bf16 += bf
    return out


def gru1_bwd(params: dict, x: torch.Tensor, out: torch.Tensor, n: torch.Tensor | None,
             dy: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """K5b: ``(dx, {"fwd": grads})`` as :func:`gru1_bwd_reference`.

    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    current stream without synchronising, and anything the kernel does not
    take raises. The weight gradients are summed in a fixed order, so
    repeated calls on one card agree bit for bit. At bf16 (x, ``out`` and
    ``dy`` bf16) dx is bf16, the weight gradients f32.
    """
    if device_of("gru1", x).type == "cpu":
        return gru1_bwd_reference(params, x, out, n, dy)
    if "bwd" in params:
        raise ValueError("gru1_bwd: params hold a backward direction; a bidirectional layer is "
                         "bigru_masked_bwd's")
    B, T, D, H = check_layer("gru1_bwd", params, x, n, [("out", out), ("dy", dy)])
    lib = _build.library()
    bf = x.dtype == BF16

    def empty(*shape):
        return torch.empty(shape, device=x.device, dtype=torch.float32)

    dx = torch.empty((B, T, D), device=x.device, dtype=x.dtype)
    grads = {"weight_ih": empty(3 * H, D), "bias_ih": empty(3 * H), "weight_hh": empty(3 * H, H),
             "bias_hh": empty(3 * H)}
    scratch = bwd_scratch(x, 1, H)
    p = params["fwd"]
    lengths, lengths_ptr = _lengths(n)
    fn = lib.tsl_gru1_bwd_bf16 if bf else lib.tsl_gru1_bwd
    err = fn(
        x.data_ptr(), D, lengths_ptr, out.data_ptr(), dy.data_ptr(),
        *[p[k].data_ptr() for k in _NAMES], dx.data_ptr(), *[grads[k].data_ptr() for k in _NAMES],
        *[t.data_ptr() for t in scratch], T, B, H, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, f"gru1_bwd ({x.dtype}, B={B}, T={T}, H={H})")
    gru1_bwd.launches += 1
    gru1_bwd.launches_bf16 += bf
    return dx, {"fwd": grads}


gru1_bwd.launches = 0  # wrapper calls that launched K5b
gru1_bwd.launches_bf16 = 0  # ... its bf16 instantiation (counted in launches too)


class _Gru1Core(torch.autograd.Function):
    """The layer under autograd (``_gru1_seq_for``'s custom VJP): K5f
    forward, saving x, the output and the weights; K5b backward, h_prev read
    from the saved output. ``n`` gets no gradient."""

    @staticmethod
    def forward(ctx, x, n, *weights):
        params = {"fwd": dict(zip(_NAMES, weights))}
        out = gru1_fwd(params, x, n)
        ctx.n = n
        ctx.save_for_backward(x, out, *weights)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, out, *weights = ctx.saved_tensors
        dx, grads = gru1_bwd({"fwd": dict(zip(_NAMES, weights))}, x, out, ctx.n, dy.contiguous())
        return (dx, None, *[grads["fwd"][k] for k in _NAMES])


def gru1(params: dict, x: torch.Tensor, n: torch.Tensor | None = None) -> torch.Tensor:
    """The layer, ``(B, T, H)`` as :func:`gru1_reference`.

    Whenever grad mode is on and x or a weight requires grad, the call goes
    through an autograd Function whose forward is K5f's wrapper and whose
    backward is K5b's (on a CPU tensor, their plain versions); otherwise
    K5f's wrapper is called alone, as decode under
    ``torch.inference_mode()`` does. On CUDA it never returns a detached
    output of a call that needs a gradient.
    """
    device_of("gru1", x)
    weights = [params["fwd"][k] for k in _NAMES]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *weights)):
        return _Gru1Core.apply(x, n, *weights)
    return gru1_fwd(params, x, n)


gru1.launches = 0  # wrapper calls that launched K5f (gru1_fwd)
gru1.launches_bf16 = 0  # ... its bf16 instantiation (counted in launches too)
