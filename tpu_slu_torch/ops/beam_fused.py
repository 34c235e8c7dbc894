"""Fused beam search of the seq2seq decoder (K7): the kernel's wrapper.

Port of ``tpu_slu/ops/pallas_beam.py`` (``beam_decode_pallas``, the TPU
kernel ``_mk_beam_kernel``): the whole width-W, ``max_len``-step search in
one launch of ``csrc/beam_decode.cu``, counted on ``beam_decode.launches``.
Each utterance runs on a thread-block cluster of C CTAs (1 to 8, the
largest whose clusters of the batch fit on the card at once:
:func:`beam_cluster_size`), the decoder's weights split between them by
hidden unit. Its attention is the TPU kernel's blocked mode at every length
(keys and values, in shared memory where they fit and else in global memory,
walked in frame blocks with an online softmax), so its plan does not depend
on the frames. The plan lies in shared
memory where it fits a block, and in a workspace in device memory otherwise
(wide beams, long searches), counted also on ``beam_decode.launches_global``:
any beam width and any ``max_len`` run on the card. A CPU tensor runs the
plain version, :func:`~tpu_slu_torch.ops.beam.beam_search_reference`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_slu_torch.ops import _build
from tpu_slu_torch.ops.beam import beam_search_reference, decoder_cells

# Bytes of shared memory one block may use on Hopper (227 KB): a plan whose
# shared memory (``tsl_beam_decode_smem_bytes``: the plan and a one-CTA
# cluster's bias slices) fits lies in shared memory, a larger one in the
# workspace. At the flagship decoder of experiments/all_real_seq2seq.cfg (2
# cells of H = 256, keys 100, values 200, 102 labels, 200 steps) a beam
# takes 2,155 + 2 W words and the bias slices 9,008 bytes: 25 beams fit
# (229,568 bytes), 26 do not (238,592).
SMEM_LIMIT = 232448


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def _layout(dec) -> dict[str, torch.Tensor]:
    """The decoder's weights in the kernel's layout: the cells packed layer
    by layer as w_ih, w_hh, b_ih, b_hh in torch layout, each row padded with
    zeros to a multiple of 4 floats (layer 0's w_ih as [embedding columns,
    padded | context columns, padded], the kernel's [embedding | context]
    row), each bias to a multiple of 4; the head [query projection | label
    projection] (K + L, H) likewise; the embedding (L, H) row-major."""
    nl, H = dec.initial_state.shape
    Hp = _up4(H)

    def pad(t, width):
        return F.pad(t, (0, width - t.shape[-1]))

    blocks = []
    for li, c in enumerate(decoder_cells(dec)):
        w_ih = c["weight_ih"]
        if li == 0:
            w_ih = torch.cat([pad(w_ih[:, :H], Hp), pad(w_ih[:, H:], _up4(w_ih.shape[1] - H))], dim=1)
        else:
            w_ih = pad(w_ih, Hp)
        blocks += [w_ih, pad(c["weight_hh"], Hp), pad(c["bias_ih"], _up4(3 * H)),
                   pad(c["bias_hh"], _up4(3 * H))]
    q, o = dec.attention.query_linear, dec.linear
    return {
        "we": dec.embed.weight.t().contiguous(),
        "be": dec.embed.bias.contiguous(),
        "cells": torch.cat([t.reshape(-1) for t in blocks]),
        "head": pad(torch.cat([q.weight, o.weight]), Hp).contiguous(),
        "head_b": torch.cat([q.bias, o.bias]).contiguous(),
        "init": dec.initial_state.contiguous(),
    }


def beam_cluster_size(B: int, T: int, W: int, nl: int, H: int, K: int, V: int, L: int, U: int) -> int:
    """The CTAs a cluster of K7 at batch B and T frames on the current card
    (1 to 8): the largest whose B clusters are all resident at once."""
    C = _build.library().tsl_beam_cluster_size(B, T, W, nl, H, K, V, L, U)
    if C < 0:
        raise RuntimeError("tsl_beam_cluster_size: CUDA error")
    return C


def _check_cuda(dec, keys: torch.Tensor, values: torch.Tensor, n_valid: torch.Tensor,
                beam_width: int, max_len: int) -> dict[str, int]:
    if keys.dim() != 3 or values.dim() != 3 or keys.shape[:2] != values.shape[:2]:
        raise ValueError(f"beam_decode: keys {tuple(keys.shape)} and values {tuple(values.shape)} "
                         "must be (B, T, K) and (B, T, V)")
    B, T, K = keys.shape
    V = values.shape[-1]
    nl, H = dec.initial_state.shape
    L = dec.linear.out_features
    tensors = [("keys", keys), ("values", values)] + [(n, p) for n, p in dec.named_parameters()]
    for name, t in tensors:
        if t.device != keys.device:
            raise ValueError(f"beam_decode: {name} is on {t.device}, keys on {keys.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"beam_decode: {name} is {t.dtype}; the kernel takes float32")
    for name, t in (("keys", keys), ("values", values)):
        if not t.is_contiguous():
            raise ValueError(f"beam_decode: {name} is not contiguous")
    q, e, o = dec.attention.query_linear, dec.embed, dec.linear
    want = [("query weight", q.weight, (K, H)), ("query bias", q.bias, (K,)),
            ("embed weight", e.weight, (H, L)), ("embed bias", e.bias, (H,)),
            ("linear weight", o.weight, (L, H)), ("linear bias", o.bias, (L,))]
    cells = decoder_cells(dec)
    for li, c in enumerate(cells):
        want += [(f"cell {li} {n}", c[n], shape) for n, shape in (
            ("weight_ih", (3 * H, H + V if li == 0 else H)), ("weight_hh", (3 * H, H)),
            ("bias_ih", (3 * H,)), ("bias_hh", (3 * H,)))]
    for name, t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"beam_decode: {name} has shape {tuple(t.shape)}, want {shape}")
    if len(cells) != nl:
        raise ValueError(f"beam_decode: {len(cells)} cells but an initial state of {nl} layers")
    if nl > 15:
        raise ValueError(f"beam_decode: the kernel takes at most 15 decoder layers, got {nl}")
    if beam_width < 1 or max_len < 1 or min(B, T) < 1:
        raise ValueError(f"beam_decode: the kernel takes beam_width, max_len, B and T >= 1 "
                         f"(beam_width={beam_width}, max_len={max_len}, B={B}, T={T})")
    if max(B * T * max(K, V), beam_width * B * max_len, beam_width * L) >= 2**31:
        raise ValueError(f"beam_decode: too large for the kernel's int indexing (B={B}, T={T})")
    if n_valid.device != keys.device or n_valid.dtype not in (torch.int32, torch.int64) \
            or tuple(n_valid.shape) != (B,):
        raise TypeError(f"beam_decode: n_valid must be an int tensor of shape ({B},) on {keys.device}, "
                        f"got {n_valid.dtype} {tuple(n_valid.shape)} on {n_valid.device}")
    lo, hi = (int(v) for v in torch.aminmax(n_valid))
    if lo < 1 or hi > T:
        raise ValueError(f"beam_decode: valid frame counts must lie in [1, T={T}], got [{lo}, {hi}]")
    return {"B": B, "T": T, "W": beam_width, "nl": nl, "H": H, "K": K, "V": V, "L": L, "U": max_len}


def beam_decode(dec, keys: torch.Tensor, values: torch.Tensor, n_valid: torch.Tensor | None,
                beam_width: int, max_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: (scores (W, B) best-first, tokens (W, B, max_len) int64), as
    :func:`~tpu_slu_torch.ops.beam.beam_search_reference`.

    ``dec``: the seq2seq decoder (``embed``, ``attention``, ``rnn.layers``,
    ``initial_state``, ``linear``); keys (B, T, K) and values (B, T, V) from
    ``attention_kv``; ``n_valid`` (B,) each row's valid frames, a prefix in
    [1, T] (None: all T). CPU tensors take the plain version. CUDA tensors
    launch the kernel on the current stream, with the weights laid out anew
    for the call (the range check of ``n_valid`` reads it on the host) and
    the plan in shared memory if it fits a block, else in a workspace of B x
    C plans in device memory; anything the kernel does not take raises, and so
    does a call with grad mode on and a weight or input that requires grad:
    the search has no gradient.
    """
    if keys.device.type == "cpu":
        return beam_search_reference(dec, keys, values, n_valid, beam_width, max_len)
    if keys.device.type != "cuda":
        raise ValueError(f"beam_decode runs on cpu or cuda tensors, not {keys.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (keys, values, *dec.parameters())):
        raise NotImplementedError(
            "beam_decode has no gradient; call it under torch.no_grad() or torch.inference_mode()")
    if n_valid is None:
        n_valid = torch.full((keys.shape[0],), keys.shape[1], dtype=torch.int64, device=keys.device)
    d = _check_cuda(dec, keys, values, n_valid, beam_width, max_len)
    lib = _build.library()
    w = _layout(dec)
    n = n_valid.to(torch.int64).contiguous()
    scores = torch.empty((d["W"], d["B"]), device=keys.device, dtype=torch.float32)
    tokens = torch.empty((d["W"], d["B"], d["U"]), device=keys.device, dtype=torch.int64)
    dims = [d[k] for k in ("B", "T", "W", "nl", "H", "K", "V", "L", "U")]
    plan = lib.tsl_beam_decode_smem_bytes(*[d[k] for k in ("W", "nl", "H", "K", "V", "L", "U")])
    ws = None
    if plan > SMEM_LIMIT:  # the global plan: a slice a CTA in device memory
        C = beam_cluster_size(*dims)
        ws = torch.empty((d["B"] * C, plan // 4), device=keys.device, dtype=torch.float32)
    err = lib.tsl_beam_decode(
        keys.data_ptr(), values.data_ptr(), n.data_ptr(),
        *[w[k].data_ptr() for k in ("we", "be", "cells", "head", "head_b", "init")],
        scores.data_ptr(), tokens.data_ptr(), None if ws is None else ws.data_ptr(), *dims, torch.cuda.current_stream(keys.device).cuda_stream,
    )
    _build.check(err, f"beam_decode (B={d['B']}, T={d['T']}, W={d['W']}, U={d['U']}, "
                      f"{'global' if ws is not None else 'smem'} plan of {plan} bytes)")
    beam_decode.launches += 1
    if ws is not None:
        beam_decode.launches_global += 1
    return scores, tokens


beam_decode.launches = 0  # wrapper calls that launched K7, either plan
beam_decode.launches_global = 0  # ... of them with the plan in device memory
