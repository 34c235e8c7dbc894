"""GRU gate math and a plain GRU layer (bidirectional or not), in PyTorch.

Port of ``tpu_slu/ops/gru.py``. Gate order along the stacked 3H axis is
(r, z, n), with PyTorch's two biases kept separate:

    r = sigmoid(gi_r + gh_r)
    z = sigmoid(gi_z + gh_z)
    n = tanh(gi_n + r * gh_n)
    h' = n + z * (h - n)

where gi = x W_ih^T + b_ih and gh = h W_hh^T + b_hh. Weights are in
``torch.nn.GRU`` layout: W_ih (3H, D), W_hh (3H, H). A direction's params
are ``{"weight_ih", "weight_hh", "bias_ih", "bias_hh"}``; a layer's are
``{"fwd": ..., "bwd": ...}``, or ``{"fwd": ...}`` for a unidirectional one.
"""

from __future__ import annotations

import torch


def gate_update(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU update from precomputed gi, gh (B, 3H) and h (B, H)."""
    H = h.shape[-1]
    rz = torch.sigmoid(gi[:, : 2 * H] + gh[:, : 2 * H])
    r, z = rz[:, :H], rz[:, H:]
    n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
    return n + z * (h - n)


def gru_cell_step(p: dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRUCell update (a direction's params, torch layout): x (B, D),
    h (B, H) -> h' (B, H)."""
    gi = torch.addmm(p["bias_ih"], x, p["weight_ih"].t())
    gh = torch.addmm(p["bias_hh"], h, p["weight_hh"].t())
    return gate_update(gi, gh, h)


def gru_direction(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                  reverse: bool, round_h: bool = False) -> torch.Tensor:
    """Recurrence over time-major gi (T, B, 3H) -> (T, B, H), h0 = 0.

    ``reverse`` walks t = T-1..0; outputs stay in natural time order.
    ``round_h`` rounds h to bf16 (and back to f32) for the recurrent product
    only, the carry staying f32: the bf16 kernels' product.
    """
    T, B, _ = gi.shape
    H = w_hh.shape[1]
    h = gi.new_zeros((B, H))
    out = gi.new_empty((T, B, H))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gh = torch.addmm(b_hh, h.to(torch.bfloat16).float() if round_h else h, w_hh.t())
        h = gate_update(gi[t], gh, h)
        out[t] = h
    return out


def _direction(p: dict, x: torch.Tensor, reverse: bool, round_h: bool = False) -> torch.Tensor:
    """One direction over batch-major x (B, T, D) -> (B, T, H)."""
    gi = torch.matmul(x.transpose(0, 1), p["weight_ih"].t()) + p["bias_ih"]
    return gru_direction(gi, p["weight_hh"], p["bias_hh"], reverse, round_h).transpose(0, 1)


def gru_apply(params: dict, x: torch.Tensor, round_h: bool = False) -> torch.Tensor:
    """GRU over batch-major x (B, T, D) -> (B, T, 2H), or (B, T, H) for a
    unidirectional layer (``params`` without ``"bwd"``). ``round_h`` as
    :func:`gru_direction`."""
    out_f = _direction(params["fwd"], x, False, round_h)
    if "bwd" not in params:
        return out_f
    return torch.cat([out_f, _direction(params["bwd"], x, True, round_h)], dim=-1)


def reverse_padded(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Per-example time reversal of the valid prefix. x: (B, T, C), n: (B,).

    Row b becomes [x[b, n_b-1], ..., x[b, 0], 0, 0, ...]: a forward walk
    over the result equals a backward walk over the exact-shape (T = n_b)
    input.
    """
    T = x.shape[1]
    t = torch.arange(T, device=x.device)
    idx = torch.clamp(n[:, None] - 1 - t[None, :], 0, T - 1)  # (B, T)
    out = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    return torch.where((t[None, :] < n[:, None])[:, :, None], out, 0.0)


def gru_apply_masked(params: dict, x: torch.Tensor, n: torch.Tensor,
                     round_h: bool = False) -> torch.Tensor:
    """Length-aware GRU over x (B, T, D) with valid lengths n (B,) -> (B, T,
    H or 2H): each row equals :func:`gru_apply` on the example cropped to
    its own length, and frames >= n_b are 0. ``round_h`` as
    :func:`gru_direction`.

    The forward direction is exact for valid frames as it is (h0 = 0, the
    padding sits after the prefix); the backward direction walks the
    per-example reversed prefix (:func:`reverse_padded`) forward and is
    reversed back: the structure of the JAX package's scan branch
    (``tpu_slu/ops/gru.py`` ``gru_apply_masked``).
    """
    t = torch.arange(x.shape[1], device=x.device)
    valid = (t[None, :] < n[:, None])[:, :, None]
    out_f = torch.where(valid, _direction(params["fwd"], x, False, round_h), 0.0)
    if "bwd" not in params:
        return out_f
    out_b = reverse_padded(_direction(params["bwd"], reverse_padded(x, n), False, round_h), n)
    return torch.cat([out_f, out_b], dim=-1)
