"""Masked Adam with per-parameter step counts, and global-norm clipping.

Port of ``tpu_slu/training/optim.py``. The reference freezes layers by
flipping ``requires_grad`` and hands every parameter to ``torch.optim.Adam``,
whose lazy per-parameter state gives a layer unfrozen at epoch k fresh
moments and bias-correction step 1. The JAX package reproduces that with a
0/1 mask inside the optimizer, and so does this one: a masked parameter keeps
its value, moments and step count untouched, every parameter keeps
``requires_grad`` (so frozen layers' gradients are computed and count in the
clipping norm, as in the JAX train step), and freezing changes no graph.
"""

from __future__ import annotations

from collections import defaultdict

import torch


class MaskedAdam(torch.optim.Optimizer):
    """Adam over named parameters, applied where :meth:`set_mask` says 1.

    Per parameter: ``step += 1; m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
    p -= lr m_hat / (sqrt(v_hat) + eps)`` with ``m_hat = m / (1 - b1^t)``,
    ``v_hat = v / (1 - b2^t)`` and ``t = max(step, 1)``. A parameter with no
    gradient (it took no part in the loss) steps with a zero gradient, as the
    JAX package's does. The updates run as ``torch._foreach`` ops over the
    parameters that share a step count.
    """

    def __init__(self, named_params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        named = list(named_params)
        self.names = [n for n, _ in named]
        super().__init__([p for _, p in named], {"lr": lr, "betas": betas, "eps": eps})
        self._on = [True] * len(named)

    def set_mask(self, mask: dict[str, float]) -> None:
        """``mask``: parameter name -> 0/1 (``Model.trainable_mask()``)."""
        missing = set(self.names) - set(mask)
        if missing:
            raise KeyError(f"mask has no entry for {sorted(missing)[:3]}")
        self._on = [mask[n] > 0.0 for n in self.names]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("MaskedAdam.step takes no closure")
        group = self.param_groups[0]
        lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
        by_step = defaultdict(list)
        for p, on in zip(group["params"], self._on):
            if not on:
                continue
            st = self.state[p]
            if not st:
                st.update(step=0, m=torch.zeros_like(p), v=torch.zeros_like(p))
            st["step"] += 1
            by_step[st["step"]].append(p)
        for t, ps in by_step.items():
            gs = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
            ms = [self.state[p]["m"] for p in ps]
            vs = [self.state[p]["v"] for p in ps]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, gs, alpha=1.0 - b1)
            torch._foreach_mul_(vs, b2)
            torch._foreach_addcmul_(vs, gs, gs, value=1.0 - b2)
            m_hat = torch._foreach_div(ms, 1.0 - b1 ** t)
            denom = torch._foreach_sqrt(torch._foreach_div(vs, 1.0 - b2 ** t))
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(m_hat, denom)
            torch._foreach_mul_(upd, lr)
            torch._foreach_sub_(ps, upd)


def clip_grad_norm(params, max_norm: float) -> None:
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-9))``, the norm
    taken over all of them (the JAX train step's clip); a no-op for
    ``max_norm <= 0``. Stays on the device: no synchronisation."""
    if max_norm <= 0.0:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    torch._foreach_mul_(grads, scale)
