"""GRU gate math and a plain bidirectional GRU, in PyTorch.

Port of ``tpu_slu/ops/gru.py``. Gate order along the stacked 3H axis is
(r, z, n), with PyTorch's two biases kept separate:

    r = sigmoid(gi_r + gh_r)
    z = sigmoid(gi_z + gh_z)
    n = tanh(gi_n + r * gh_n)
    h' = n + z * (h - n)

where gi = x W_ih^T + b_ih and gh = h W_hh^T + b_hh. Weights are in
``torch.nn.GRU`` layout: W_ih (3H, D), W_hh (3H, H). A direction's params
are ``{"weight_ih", "weight_hh", "bias_ih", "bias_hh"}``; a layer's are
``{"fwd": ..., "bwd": ...}``.
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


def gru_direction(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                  reverse: bool) -> torch.Tensor:
    """Recurrence over time-major gi (T, B, 3H) -> (T, B, H), h0 = 0.

    ``reverse`` walks t = T-1..0; outputs stay in natural time order.
    """
    T, B, _ = gi.shape
    H = w_hh.shape[1]
    h = gi.new_zeros((B, H))
    out = gi.new_empty((T, B, H))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gh = torch.addmm(b_hh, h, w_hh.t())
        h = gate_update(gi[t], gh, h)
        out[t] = h
    return out


def gru_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Bidirectional GRU over batch-major x (B, T, D) -> (B, T, 2H)."""
    xt = x.transpose(0, 1)
    outs = []
    for name, reverse in (("fwd", False), ("bwd", True)):
        p = params[name]
        gi = torch.matmul(xt, p["weight_ih"].t()) + p["bias_ih"]
        outs.append(gru_direction(gi, p["weight_hh"], p["bias_hh"], reverse))
    return torch.cat(outs, dim=-1).transpose(0, 1)
