"""Beam search of the seq2seq decoder, in plain PyTorch: K7's plain version.

Port of ``tpu_slu/ops/beam.py`` (``beam_search``) and of the decoder step it
drives (``_decoder_step`` of ``tpu_slu/models/slu.py``), with the search's
reference quirks: the previous-token input at u = 0 is all zeros (not a
one-hot ``<sos>``), at u = 0 only beam 0's extensions compete (all beams are
equal there), the search runs a fixed ``max_len`` steps with no EOS exit, and
among equal extensions the one with the smaller ``beam * V + token`` index
ranks first (``lax.top_k``'s first occurrence; ``torch.topk`` promises no
order among ties, so a stable descending sort takes its place).

:func:`beam_search_reference` is the function that K7
(``tpu_slu_torch/ops/beam_fused.py``) computes in one launch.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from tpu_slu_torch.ops.attention import attend_kv
from tpu_slu_torch.ops.gru import gru_cell_step

_CELL = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


def decoder_cells(dec) -> list[dict]:
    """The decoder's GRUCells as :func:`gru_cell_step` params, in layer order
    (``dec.rnn.layers`` holds [cell, dropout] per layer)."""
    return [{n: getattr(cell, n) for n in _CELL} for cell in dec.rnn.layers[0::2]]


def decoder_step(dec, keys: torch.Tensor, values: torch.Tensor, state: torch.Tensor,
                 y_prev: torch.Tensor, mask: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step, eval mode: attend with the top layer's state, embed
    the previous token, run the stacked GRUCells, log-softmax the labels.

    ``dec``: a module with ``embed`` and ``linear`` (``nn.Linear``),
    ``attention`` (see :mod:`~tpu_slu_torch.ops.attention`) and ``rnn.layers``.
    state (B, layers, H); y_prev (B, L) one-hot or zeros; keys (B, T, K) and
    values (B, T, V) from ``attention_kv``; ``mask`` (B, T) valid frames.
    Returns (new state (B, layers, H), log-probabilities (B, L)).
    """
    context = attend_kv(dec.attention, keys, values, state[:, -1], mask=mask)
    h_in = torch.cat([F.linear(y_prev, dec.embed.weight, dec.embed.bias), context], dim=1)
    new_states = []
    for li, cell in enumerate(decoder_cells(dec)):
        h_in = gru_cell_step(cell, h_in, state[:, li])
        new_states.append(h_in)
    new_state = torch.stack(new_states, dim=1)
    logits = F.linear(new_state[:, -1], dec.linear.weight, dec.linear.bias)
    return new_state, torch.log_softmax(logits, dim=1)


def beam_search(step_fn: Callable, init_state: torch.Tensor, batch_size: int, vocab_size: int,
                max_len: int, beam_width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The search of ``tpu_slu/ops/beam.py`` as a loop over the steps.

    ``step_fn(state (batch, ...), y_prev (batch, V)) -> (state, logp (batch, V))``
    runs once per beam and step. Returns (scores (beam, batch) best-first,
    tokens (beam, batch, max_len) int64).
    """
    W, B, V = beam_width, batch_size, vocab_size
    dev = init_state.device
    tokens = torch.zeros((W, B, max_len), dtype=torch.int64, device=dev)
    scores = init_state.new_zeros((W, B))
    states = init_state[None].expand((W,) + tuple(init_state.shape))

    def gather_beam(a: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
        idx = origin.reshape((W, B) + (1,) * (a.dim() - 2)).expand_as(a)
        return torch.gather(a, 0, idx)

    for u in range(max_len):
        if u == 0:
            y_prev = scores.new_zeros((W, B, V))
        else:
            y_prev = F.one_hot(tokens[:, :, u - 1], V).to(scores.dtype)
        stepped = [step_fn(states[w], y_prev[w]) for w in range(W)]
        new_states = torch.stack([s for s, _ in stepped])
        ext = scores[:, :, None] + torch.stack([lp for _, lp in stepped])  # (W, B, V)
        if u == 0:
            ext[1:] = float("-inf")
        flat = ext.permute(1, 0, 2).reshape(B, W * V)
        top_scores, top_idx = torch.sort(flat, dim=1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :W].t(), top_idx[:, :W].t()  # (W, B)
        origin = top_idx // V
        tokens = gather_beam(tokens, origin)
        tokens[:, :, u] = top_idx % V
        states = gather_beam(new_states, origin)
        scores = top_scores
    return scores, tokens


def beam_search_reference(dec, keys: torch.Tensor, values: torch.Tensor,
                          n_valid: torch.Tensor | None, beam_width: int, max_len: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's plain version: :func:`beam_search` over :func:`decoder_step`
    from the decoder's learned initial state. ``n_valid`` (B,) counts each
    row's valid frames, a prefix (None: all T). Returns (scores (W, B),
    tokens (W, B, max_len) int64)."""
    B, T, _ = keys.shape
    mask = None
    if n_valid is not None:
        mask = torch.arange(T, device=keys.device)[None, :] < n_valid.to(keys.device)[:, None]
    init = dec.initial_state[None].expand((B,) + tuple(dec.initial_state.shape))

    def step_fn(state, y_prev):
        return decoder_step(dec, keys, values, state, y_prev, mask=mask)

    return beam_search(step_fn, init, B, dec.linear.out_features, max_len, beam_width)
