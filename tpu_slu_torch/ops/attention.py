"""Single-query scaled dot-product attention of the seq2seq decoder.

Port of ``tpu_slu/ops/attention.py`` (the reference ``Attention``): linear
key, query and value projections, a softmax over the encoder frames, the
context as the weighted sum of the values. ``attn`` is any module holding
the three ``nn.Linear`` projections as ``key_linear``, ``query_linear`` and
``value_linear`` (the reference's names).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def attention_kv(attn, encoder_states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Encoder states (B, T, E) -> (keys (B, T, K), values (B, T, V)),
    projected once: they are the same at every decode step. bf16 states (a
    bf16 trainer's encoder) are widened to the weights' dtype by each
    projection, where JAX promotes them (``tpu_slu/ops/attention.py:33-34``):
    so each projection's gradient is rounded to bf16 before the two are
    summed, as JAX's two promotions transpose."""
    keys = F.linear(_promoted(encoder_states, attn.key_linear.weight), attn.key_linear.weight,
                    attn.key_linear.bias)
    values = F.linear(_promoted(encoder_states, attn.value_linear.weight), attn.value_linear.weight,
                      attn.value_linear.bias)
    return keys, values


def _promoted(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """A bf16 x in the weight's dtype; any other x as it is."""
    return x.to(weight.dtype) if x.dtype == torch.bfloat16 else x


def attend_kv(attn, keys: torch.Tensor, values: torch.Tensor, decoder_state: torch.Tensor,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """One attention read: decoder_state (B, D) -> context (B, V). Scores
    are scaled by 1/sqrt(K) of the keys' width; ``mask`` (B, T), True on
    valid frames, gives the others a score of -inf."""
    query = F.linear(decoder_state, attn.query_linear.weight, attn.query_linear.bias)
    scores = torch.einsum("btk,bk->bt", keys, query) / math.sqrt(keys.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("bt,btv->bv", torch.softmax(scores, dim=1), values)
