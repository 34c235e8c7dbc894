"""Masked Adam with per-parameter step counts, and global-norm clipping.

Port of ``tpu_slu/training/optim.py``. The reference freezes layers by
flipping ``requires_grad`` and hands every parameter to ``torch.optim.Adam``,
whose lazy per-parameter state gives a layer unfrozen at epoch k fresh
moments and bias-correction step 1. The JAX package reproduces that with a
0/1 mask inside the optimizer, and so does this one: a masked parameter keeps
its value, moments and step count untouched, every parameter keeps
``requires_grad`` (so frozen layers' gradients are computed and count in the
clipping norm, as in the JAX train step), and freezing changes no graph.

Its state goes to and comes from a checkpoint as the JAX package's flat
Adam state (``flat_adam_init``): ``m``, ``v`` and ``step``, each one (P,)
vector over every parameter in ``ravel_pytree``'s leaf order of the JAX
param tree, each leaf laid out as JAX lays it (a GRU or Linear weight
transposed), ``step`` int32 per element. Under ``model_parallel`` > 1 the
JAX Trainer keeps the per-leaf state of ``adam_init`` instead (the same
arithmetic): ``m`` and ``v`` trees shaped like the param tree, ``step`` an
int32 scalar a leaf (:meth:`MaskedAdam.export_tree`).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch
import torch.distributed as dist

from tpu_slu_torch.models.convert import flatten, jax_leaf, params_from_jax, params_to_jax


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

    def _jax_order(self) -> list[tuple[torch.Tensor, bool]]:
        """(parameter, transposed in JAX) in the leaf order of JAX's flat
        vector: the JAX paths' components sorted level by level, as jax
        flattens dicts (layer "10" before "2")."""
        leaves = []
        for name, p in zip(self.names, self.param_groups[0]["params"]):
            path, transposed = jax_leaf(name, p.ndim)
            leaves.append((path.split("/"), p, transposed))
        leaves.sort(key=lambda e: e[0])
        return [(p, t) for _, p, t in leaves]

    def export_flat(self) -> dict[str, np.ndarray]:
        """The JAX flat Adam state ``{"m", "v": float32 (P,), "step": int32 (P,)}``;
        a parameter that never stepped has zeros."""
        out = {"m": [], "v": [], "step": []}
        for p, transposed in self._jax_order():
            st = self.state.get(p, {})
            for k in ("m", "v"):
                a = st[k].detach().cpu().numpy() if st else np.zeros(tuple(p.shape), np.float32)
                out[k].append((a.T if transposed else a).reshape(-1))
            out["step"].append(np.full(p.numel(), st.get("step", 0), np.int32))
        return {k: np.concatenate(v) if v else np.zeros(0, np.float32 if k != "step" else np.int32)
                for k, v in out.items()}

    def import_flat(self, flat: dict) -> None:
        """Take the state :meth:`export_flat` (or the JAX Trainer) wrote. A
        parameter whose steps are 0 gets no state; the others resume from
        their saved step. Raises, changing nothing, on a wrong length or a
        step that varies within a parameter."""
        order = self._jax_order()
        total = sum(p.numel() for p, _ in order)
        arrays = {k: np.asarray(flat[k]) for k in ("m", "v", "step")}
        for k, a in arrays.items():
            if a.shape != (total,):
                raise ValueError(f"optimizer state {k!r} has shape {a.shape}, want ({total},)")
        states, pos = [], 0
        for p, transposed in order:
            n, seg = p.numel(), slice(pos, pos + p.numel())
            pos += n
            steps = arrays["step"][seg]
            if n and (steps != steps[0]).any():
                raise ValueError("optimizer step counts vary within one parameter")
            step = int(steps[0]) if n else 0
            if step == 0:
                states.append((p, {}))
                continue
            shape = tuple(p.shape)[::-1] if transposed else tuple(p.shape)
            mv = {k: torch.from_numpy(np.ascontiguousarray(
                arrays[k][seg].reshape(shape).T if transposed else arrays[k][seg].reshape(shape))).to(p)
                for k in ("m", "v")}
            states.append((p, {"step": step, **mv}))
        self.state.clear()
        for p, st in states:
            if st:
                self.state[p].update(st)

    def export_tree(self, full=None) -> dict:
        """JAX's per-leaf Adam state ``{"m", "v": param trees, "step": a tree of
        int32 scalars}``, each leaf at its JAX path and layout
        (:func:`~tpu_slu_torch.models.convert.params_to_jax`); a parameter
        that never stepped has zeros. ``full(name, t)`` gives the whole leaf
        of a parameter's moment ``t`` (the gathered columns of a sharded
        head; it is called for every parameter, in order, on every rank)."""
        named = {"m": {}, "v": {}, "step": {}}
        for name, p in zip(self.names, self.param_groups[0]["params"]):
            st = self.state.get(p, {})
            for k in ("m", "v"):
                t = st[k] if st else torch.zeros_like(p)
                named[k][name] = full(name, t) if full else t
            named["step"][name] = np.asarray(st.get("step", 0), np.int32)
        return {k: params_to_jax(v) for k, v in named.items()}

    def import_tree(self, tree: dict, take=None) -> None:
        """Take the state :meth:`export_tree` (or the JAX Trainer at
        ``model_parallel`` > 1) wrote; ``take(name, t)`` gives this rank's part
        of a whole leaf (a sharded head's columns). A parameter whose step is 0
        gets no state. Raises, changing nothing, on a missing leaf or a
        wrong shape."""
        named = {k: params_from_jax(tree[k]) for k in ("m", "v")}
        steps = flatten(tree["step"])  # as int32, not params_from_jax's float32
        states = []
        for name, p in zip(self.names, self.param_groups[0]["params"]):
            mv = {k: (take(name, named[k][name]) if take else named[k][name]).to(p) for k in ("m", "v")}
            for k, t in mv.items():
                if t.shape != p.shape:
                    raise ValueError(f"optimizer state {k!r} of {name} has shape {tuple(t.shape)}, "
                                     f"want {tuple(p.shape)}")
            step = int(steps[jax_leaf(name, p.ndim)[0]])
            states.append((p, {"step": step, **mv} if step else {}))
        self.state.clear()
        for p, st in states:
            if st:
                self.state[p].update(st)

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


def clip_grad_norm(params, max_norm: float, shards=(), group=None) -> None:
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-9))``, the norm
    taken over all of them (the JAX train step's clip); a no-op for
    ``max_norm <= 0``. Stays on the device: no synchronisation. ``shards``
    are parameters that hold this rank's part of a parameter column-sharded
    over the model ``group``: their squares are summed over the group, the
    others' taken once, so the norm is the whole tree's, as JAX's
    ``clip_grads`` sees it."""
    if max_norm <= 0.0:
        return
    params = list(params)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    if shards:
        sharded = {id(p) for p in shards}
        squares = {True: [], False: []}
        for p in params:
            if p.grad is not None:
                squares[id(p) in sharded].append(torch.sum(p.grad * p.grad))
        own = torch.stack(squares[True]).sum().reshape(1) if squares[True] else grads[0].new_zeros(1)
        dist.all_reduce(own, group=group)
        norm = torch.sqrt(torch.stack(squares[False] + [own[0]]).sum())
    else:
        norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    torch._foreach_mul_(grads, scale)
