"""Column-parallel vocab heads and their frame loss, over a model group of ranks.

JAX shards ``word_linear``/``phoneme_linear``'s ``w`` (in, out) on ``out``
over the mesh's model axis and lets XLA compute ``_masked_frame_ce``
(``tpu_slu/models/encoder.py:548-566``) over the sharded logits. The port
writes those collectives out: a rank holds the columns ``[m V/mp, (m + 1)
V/mp)`` of a head (:class:`ColumnParallelLinear`), computes its logits
locally, and :func:`vocab_parallel_frame_ce` makes the loss and the
accuracy of the whole vocabulary from the shards:

1. an all-reduce MAX of each frame's largest local logit;
2. one all-reduce SUM of each frame's ``sum exp(logit - max)`` and of its
   label's logit, added by the shard that owns the label;
3. a backward ``(softmax_local - onehot_local) valid / denom`` with no
   collective.

The accuracy's argmax is the global one under ``jnp.argmax``'s tie rule
(the lowest index wins): each shard offers its first argmax where its
largest logit is the frame's maximum (step 1's), and an all-reduce MIN
picks the lowest. The products are plain ``F.linear``, as JAX's are plain
products outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce SUM backward over the model group: each
    shard's ``dh`` is its columns' share, and the encoder below takes their sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class ColumnParallelLinear(nn.Module):
    """The rank's columns of a vocab head: ``weight`` (V/mp, in) and ``bias``
    (V/mp,), rows ``[start, start + V/mp)`` of the full head's, under the
    full head's parameter names. Its forward gives the rank's columns of the
    logits; the input's gradient is summed over ``group``."""

    def __init__(self, full: nn.Linear, model_parallel: int, model_index: int, group):
        super().__init__()
        n = full.out_features // model_parallel
        self.in_features, self.out_features = full.in_features, full.out_features
        self.start = model_index * n
        self.group = group
        with torch.no_grad():
            self.weight = nn.Parameter(full.weight[self.start:self.start + n].clone())
            self.bias = nn.Parameter(full.bias[self.start:self.start + n].clone())

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return F.linear(_CopyToModel.apply(h, self.group), self.weight, self.bias)


class _VocabParallelCE(torch.autograd.Function):
    """The summed, weighted frame NLL over the whole vocabulary from this
    shard's logits (steps 1-3 of the module's docstring)."""

    @staticmethod
    def forward(ctx, logits, m, local_y, own, valid, denom, group):
        e = torch.exp(logits.detach() - m[..., None])
        label = torch.where(own, logits.detach().gather(-1, local_y[..., None])[..., 0], 0.0)
        sums = torch.stack([e.sum(-1), label])
        dist.all_reduce(sums, group=group)
        nll = torch.log(sums[0]) + m - sums[1]
        soft = e.div_(sums[0][..., None])
        ctx.save_for_backward(soft, local_y, own, valid)
        ctx.denom = denom
        return (nll * valid).sum() / denom

    @staticmethod
    def backward(ctx, grad):
        soft, local_y, own, valid = ctx.saved_tensors
        g = soft.scatter_add(-1, local_y[..., None], -own.to(soft.dtype)[..., None])
        return g * (valid * (grad / ctx.denom))[..., None], None, None, None, None, None, None


def vocab_parallel_frame_ce(logits: torch.Tensor, y: torch.Tensor, head: ColumnParallelLinear,
                            weights: torch.Tensor | None = None,
                            denom: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`~tpu_slu_torch.models.encoder.masked_frame_ce` of the full
    logits, given this rank's columns ``logits`` (B, T, V/mp) of ``head``:
    (mean loss, accuracy) over the valid weighted frames, equal on every rank
    of the model group. ``y`` (B, T) holds global label ids, -1 where
    ignored; ``weights`` and ``denom`` as in ``masked_frame_ce``."""
    valid = (y != -1).to(logits.dtype)
    if weights is not None:
        valid = valid * weights.to(logits.dtype)[:, None]
    y_safe = torch.where(y != -1, y, 0).long()
    n = logits.shape[-1]
    local = y_safe - head.start
    own = (local >= 0) & (local < n)
    local = local.clamp(0, n - 1)
    denom = torch.clamp(valid.sum(), min=1.0) if denom is None else max(float(denom), 1.0)
    with torch.no_grad():
        best, idx = logits.max(-1)
        top = best.clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=head.group)
    loss = _VocabParallelCE.apply(logits, top, local, own, valid, denom, head.group)
    with torch.no_grad():
        pred = torch.where(best == top, idx + head.start, head.out_features)
        dist.all_reduce(pred, op=dist.ReduceOp.MIN, group=head.group)
        acc = ((pred == y_safe).to(logits.dtype) * valid).sum() / denom
    return loss, acc
