"""End-to-end SLU model: encoder + fixed-slot intent head OR seq2seq decoder.

Port of ``tpu_slu/models/slu.py``. Both heads decode (``Model.decode_intents``
at the input's exact shape, or length-exact over a padded batch with
``lengths=``/``bucket=True``) and train (``Model.forward``/``loss``, the
ULMFiT trainable mask): the fixed-slot head (bi-GRU + Linear + max over
time) and the seq2seq head (bi-GRU encoder, attention, stacked GRUCells;
beam search to decode, the teacher-forced :func:`seq2seq_log_prob` to
train). The :class:`Model` module's ``state_dict`` keys are the reference
``Model``'s (``pretrained_model.*``, and ``intent_layers.*`` or
``encoder.*`` and ``decoder.*``).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from tpu_slu_torch.data.loader import WAVE_BUCKET_QUANT, pad_to_bucket
from tpu_slu_torch.models.convert import params_from_jax, read_npz
from tpu_slu_torch.models.encoder import (
    DEFAULT_FRONTEND,
    DEFAULT_GRU_LAYOUT,
    LayerSpec,
    PartsTM,
    PretrainedModel,
    apply_stack,
    dropout,
    encoder_features,
    frames_through,
    make_layer,
    make_layers,
    make_linear,
    parts_to_btc,
    rnn_block_specs,
)
from tpu_slu_torch.ops.attention import attend_kv, attention_kv
from tpu_slu_torch.ops.beam import decoder_cells
from tpu_slu_torch.ops.beam_fused import beam_decode
from tpu_slu_torch.ops.bigru_masked import bigru_masked
from tpu_slu_torch.ops.gru import gru_cell_step
from tpu_slu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class IntentArch:
    """Fixed-intent head: bi-GRU stack -> Linear -> max over time.

    ``linear_index`` is the ModuleList position of the final classifier.
    """

    layers: tuple[LayerSpec, ...]
    linear_index: int
    feat_dim: int
    values_per_slot: tuple[int, ...]

    @staticmethod
    def from_config(config, in_dim: int) -> "IntentArch":
        specs, i, out_dim = rnn_block_specs(
            "intent", 0, in_dim,
            config.intent_rnn_num_hidden, config.intent_rnn_drop,
            config.intent_downsample_type, config.intent_downsample_len,
            config.intent_rnn_bidirectional,
        )
        return IntentArch(
            layers=tuple(specs),
            linear_index=i,
            feat_dim=out_dim,
            values_per_slot=tuple(config.require("values_per_slot")),
        )


def intent_logits(layers: nn.ModuleList, arch: IntentArch, feats: torch.Tensor,
                  frame_mask: torch.Tensor | None = None, *, train: bool = False,
                  generator: torch.Generator | None = None,
                  n_frames: torch.Tensor | None = None,
                  gru_layout: str = DEFAULT_GRU_LAYOUT) -> torch.Tensor:
    """feats (B, T, C) encoder features -> (B, sum(values_per_slot)) logits.

    ``frame_mask`` (B, T_out) marks frames that come from real audio; the
    others are left out of the max over time. ``train`` applies dropout
    (masks from ``generator``), as :func:`~tpu_slu_torch.models.encoder.apply_stack`.

    ``n_frames`` (B,) valid feature frames select the length-exact path: the
    head's GRU and downsamples compute as if each example were cropped to
    its own length, and the max over time covers its valid frames only,
    their count clipped to [1, T_out] (a batch-fill row stays finite).
    ``gru_layout`` is the bidirectional layers' kernel layout (K1 or K6).
    bf16 features (a bf16 trainer's) run the head's GRU layers at bf16, as
    JAX's do by inheritance; the linear takes them in its weight's dtype
    (f32: where JAX promotes at ``slu.py:101``), so the logits are f32.
    """
    out = apply_stack(layers, arch.layers, feats, train=train, generator=generator, n=n_frames,
                      gru_layout=gru_layout)
    if isinstance(out, PartsTM):
        out = parts_to_btc(out)
    lin = layers[arch.linear_index]
    out = F.linear(out.to(lin.weight.dtype), lin.weight, lin.bias)
    if n_frames is not None:
        n = torch.clamp(frames_through(arch.layers, n_frames), 1, out.shape[1])
        frame_mask = torch.arange(out.shape[1], device=out.device)[None, :] < n[:, None]
    if frame_mask is not None:
        out = out.masked_fill(~frame_mask[:, :, None], float("-inf"))
    return out.amax(dim=1)


def valid_frames(encoder_arch, lengths: torch.Tensor, t_frames: int,
                 intent_arch: IntentArch | None = None) -> torch.Tensor:
    """(B,) waveform sample counts -> (B,) valid frame counts in [1, t_frames]."""
    n = encoder_arch.num_frames(torch.clamp(lengths, min=1))
    if intent_arch is not None:
        n = frames_through(intent_arch.layers, n)
    return torch.clamp(n, 1, t_frames)


def frame_mask_from_lengths(encoder_arch, lengths: torch.Tensor, t_frames: int,
                            intent_arch: IntentArch | None = None) -> torch.Tensor:
    """(B,) waveform sample counts -> (B, t_frames) bool valid-frame mask,
    with at least one valid frame per row."""
    n = valid_frames(encoder_arch, lengths, t_frames, intent_arch)
    return torch.arange(t_frames, device=lengths.device)[None, :] < n[:, None]


def intent_loss_acc(logits: torch.Tensor, y_intent: torch.Tensor, values_per_slot,
                    weights: torch.Tensor | None = None,
                    denom: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot cross-entropy summed over slots, and the all-slots-correct
    accuracy, both as means over the examples weighted by ``weights`` (B,)
    (1 for a real example, 0 for batch padding; all ones by default).
    ``denom``, the weight sum of a larger batch this one is a part of (a
    data-parallel step's global batch), takes the place of ``w.sum()``: the
    results are then this part's shares of that batch's means. At least 1."""
    w = logits.new_ones(logits.shape[0]) if weights is None else weights.to(logits.dtype)
    denom = torch.clamp(w.sum(), min=1.0) if denom is None else max(float(denom), 1.0)
    loss = logits.new_zeros(())
    correct = None
    for slot, sub in enumerate(logits.split(list(values_per_slot), dim=1)):
        y = y_intent[:, slot:slot + 1].long()
        nll = -torch.gather(F.log_softmax(sub, dim=-1), 1, y)[:, 0]
        loss = loss + (nll * w).sum() / denom
        ok = sub.argmax(dim=1) == y[:, 0]
        correct = ok if correct is None else correct & ok
    return loss, (correct.to(w.dtype) * w).sum() / denom


def intent_predictions(logits: torch.Tensor, values_per_slot) -> torch.Tensor:
    """Per-slot argmax -> (B, num_slots) int64."""
    return torch.stack([s.argmax(dim=1) for s in logits.split(list(values_per_slot), dim=1)], dim=1)


# ---------------------------------------------------------------------------
# Seq2seq head (reference models.py:381-651)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Seq2SeqArch:
    """The seq2seq head's widths. ``max_decode_len`` is the beam search's
    fixed step count (the reference's true_U). Training knobs of the JAX
    package's config: ``dropout`` (``seq2seq_dropout``, 0.5 as the reference
    hardcodes) after each encoder layer and between the decoder's cells;
    ``zeros_start`` (``seq2seq_zeros_start``) feeds step 0 of teacher
    forcing the zeros vector beam search feeds, where the reference feeds a
    one-hot ``<sos>``."""

    num_labels: int
    num_encoder_layers: int
    encoder_dim: int
    num_decoder_layers: int
    decoder_dim: int
    key_dim: int
    value_dim: int
    sos: int
    max_decode_len: int = 200
    dropout: float = 0.5
    zeros_start: bool = False

    @staticmethod
    def from_config(config, sos: int, num_labels: int) -> "Seq2SeqArch":
        return Seq2SeqArch(
            num_labels=num_labels,
            num_encoder_layers=config.num_intent_encoder_layers,
            encoder_dim=config.intent_encoder_dim,
            num_decoder_layers=config.num_intent_decoder_layers,
            decoder_dim=config.intent_decoder_dim,
            key_dim=config.intent_decoder_key_dim,
            value_dim=config.intent_decoder_value_dim,
            sos=sos,
            max_decode_len=getattr(config, "seq2seq_max_decode_len", 200),
            dropout=getattr(config, "seq2seq_dropout", 0.5),
            zeros_start=getattr(config, "seq2seq_zeros_start", False),
        )


class Seq2SeqEncoder(nn.Module):
    """``layers``: [bi-GRU, select, dropout] per layer, the GRU at 3i."""

    def __init__(self, arch: Seq2SeqArch, in_dim: int, gen: torch.Generator):
        super().__init__()
        layers = []
        for idx in range(arch.num_encoder_layers):
            d = in_dim if idx == 0 else 2 * arch.encoder_dim
            layers += [make_layer(LayerSpec("gru", 3 * idx, f"encoder{idx}", (d, arch.encoder_dim, True)),
                                  gen), nn.Identity(), nn.Identity()]
        self.layers = nn.ModuleList(layers)


class Attention(nn.Module):
    """The key, query and value projections (:mod:`tpu_slu_torch.ops.attention`)."""

    def __init__(self, encoder_dim: int, decoder_dim: int, key_dim: int, value_dim: int,
                 gen: torch.Generator):
        super().__init__()
        self.key_linear = make_linear(encoder_dim, key_dim, gen)
        self.query_linear = make_linear(decoder_dim, key_dim, gen)
        self.value_linear = make_linear(encoder_dim, value_dim, gen)


class DecoderRNN(nn.Module):
    """``layers``: [GRUCell, dropout] per layer, the cell at 2i; layer 0
    takes [embedding | context]."""

    def __init__(self, arch: Seq2SeqArch, gen: torch.Generator):
        super().__init__()
        layers = []
        for idx in range(arch.num_decoder_layers):
            d = arch.decoder_dim + arch.value_dim if idx == 0 else arch.decoder_dim
            cell = skip_init(nn.GRUCell, d, arch.decoder_dim)
            with torch.no_grad():
                for p in cell.parameters():
                    p.uniform_(-1.0 / math.sqrt(arch.decoder_dim), 1.0 / math.sqrt(arch.decoder_dim),
                               generator=gen)
            layers += [cell, nn.Identity()]
        self.layers = nn.ModuleList(layers)


class Seq2SeqDecoder(nn.Module):
    """Label embedding, attention, stacked GRUCells from a learned initial
    state (layers, H), and the output projection over the labels."""

    def __init__(self, arch: Seq2SeqArch, gen: torch.Generator):
        super().__init__()
        self.embed = make_linear(arch.num_labels, arch.decoder_dim, gen)
        self.attention = Attention(2 * arch.encoder_dim, arch.decoder_dim, arch.key_dim,
                                   arch.value_dim, gen)
        self.rnn = DecoderRNN(arch, gen)
        self.initial_state = nn.Parameter(
            torch.randn((arch.num_decoder_layers, arch.decoder_dim), generator=gen))
        self.linear = make_linear(arch.decoder_dim, arch.num_labels, gen)


def seq2seq_encode(encoder: Seq2SeqEncoder, arch: Seq2SeqArch, feats: torch.Tensor,
                   n_frames: torch.Tensor | None = None, *, train: bool = False,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """The encoder's bi-GRU layers over feats (B, T, C). ``n_frames`` (B,)
    valid frames select the length-exact path; without it every row has T.
    Each layer is :func:`bigru_masked` (K4f forward and K4b backward on the
    card, the TPU's route too; their plain versions on the CPU). ``train``
    applies dropout of rate ``arch.dropout`` after each layer (JAX
    ``slu.py:251-255``), its masks drawn from ``generator``. bf16 feats (a
    bf16 trainer's) run the layers and their dropout at bf16."""
    B, T, _ = feats.shape
    n = n_frames if n_frames is not None else torch.full((B,), T, dtype=torch.int64,
                                                         device=feats.device)
    out = feats
    for idx in range(arch.num_encoder_layers):
        out = bigru_masked(encoder.layers[3 * idx].params(), out.contiguous(), n)
        if train and arch.dropout > 0.0:
            out = dropout(out, arch.dropout, generator)
    return out


def seq2seq_log_prob(encoder: Seq2SeqEncoder, decoder: Seq2SeqDecoder, arch: Seq2SeqArch,
                     feats: torch.Tensor, y_onehot: torch.Tensor, *, train: bool = False,
                     generator: torch.Generator | None = None,
                     enc_mask: torch.Tensor | None = None,
                     num_steps: torch.Tensor | None = None) -> torch.Tensor:
    """Teacher-forced log p(y|x) per example, (B,): the batched path of JAX
    ``seq2seq_log_prob`` (``slu.py:289-356``) in plain PyTorch.

    ``y_onehot`` (B, U, L) are the EOS-padded one-hot targets. Step u embeds
    y_{u-1}, and step 0 ``<sos>`` one-hot (the zeros vector with
    ``arch.zeros_start``), all up front; the serial loop holds only the
    attention read and the stacked GRUCells, with dropout between the cells
    when training (masks from ``generator``, after the encoder's); one
    output projection and one log-softmax follow it. ``enc_mask`` (B, T)
    marks the encoder frames attention sees; ``num_steps`` (a 0-d tensor)
    leaves steps u >= num_steps out of the sum.
    """
    keys, values = attention_kv(decoder.attention,
                                seq2seq_encode(encoder, arch, feats, train=train, generator=generator))
    B, U, L = y_onehot.shape
    if arch.zeros_start:
        y_sos = y_onehot.new_zeros((B, L))
    else:
        y_sos = F.one_hot(torch.full((B,), arch.sos, device=y_onehot.device), L).to(y_onehot.dtype)
    y_prev = torch.cat([y_sos[:, None], y_onehot[:, :-1]], dim=1)
    embs = F.linear(y_prev, decoder.embed.weight, decoder.embed.bias)  # (B, U, E)
    cells = decoder_cells(decoder)
    states = list(decoder.initial_state[None].expand((B,) + tuple(decoder.initial_state.shape)).unbind(1))
    tops = []
    for u in range(U):
        h_in = torch.cat([embs[:, u], attend_kv(decoder.attention, keys, values, states[-1],
                                                mask=enc_mask)], dim=1)
        for li, cell in enumerate(cells):
            states[li] = gru_cell_step(cell, h_in, states[li])
            h_in = states[li]
            # JAX also draws a mask after the top cell; its output is never read
            if train and arch.dropout > 0.0 and li + 1 < len(cells):
                h_in = dropout(h_in, arch.dropout, generator)
        tops.append(states[-1])
    logits = F.linear(torch.stack(tops, dim=1), decoder.linear.weight, decoder.linear.bias)
    step_lp = (F.log_softmax(logits, dim=2) * y_onehot).sum(dim=2)  # (B, U)
    if num_steps is not None:
        step_lp = torch.where(torch.arange(U, device=step_lp.device)[None, :] < num_steps, step_lp, 0.0)
    return step_lp.sum(dim=1)


def seq2seq_beam_infer(encoder: Seq2SeqEncoder, decoder: Seq2SeqDecoder, arch: Seq2SeqArch,
                       feats: torch.Tensor, beam_width: int = 4, *,
                       n_valid: torch.Tensor | None = None,
                       n_frames: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam-search decode of encoder features: (scores (W, B), tokens (W,
    B, max_decode_len)). ``n_valid`` (B,) counts the frames attention sees
    (a prefix; None: all); ``n_frames`` as :func:`seq2seq_encode`. The
    search is K7 on the card, one launch (:func:`beam_decode`). Spans
    ``decode.encode`` and ``decode.search`` while a profiler runs."""
    with span("decode.encode"):
        keys, values = attention_kv(decoder.attention, seq2seq_encode(encoder, arch, feats, n_frames))
    with span("decode.search"):
        return beam_decode(decoder, keys, values, n_valid, beam_width, arch.max_decode_len)


# ---------------------------------------------------------------------------
# ULMFiT unfreezing schedule -> trainable masks
# ---------------------------------------------------------------------------

PARAM_KINDS = ("sinc", "conv", "gru")


def walk_unfrozen(arch, unfreezing_type: int, count: int) -> set:
    """The (group, index) layers with parameters that are unfrozen once the
    reference's walk, from the end of ``word_layers`` backwards (and on
    through ``phoneme_layers`` for type 2), has unfrozen ``count`` of them."""
    unfrozen: set = set()
    if unfreezing_type == 0 or count <= 0:
        return unfrozen
    groups = ["word_layers"] + (["phoneme_layers"] if unfreezing_type == 2 else [])
    for group in groups:
        for spec in reversed(getattr(arch, group)):
            if spec.kind in PARAM_KINDS:
                unfrozen.add((group, spec.index))
                if len(unfrozen) == count:
                    return unfrozen
    return unfrozen


def num_walkable(arch, unfreezing_type: int) -> int:
    groups = ["word_layers"] + (["phoneme_layers"] if unfreezing_type == 2 else [])
    return sum(1 for g in groups for s in getattr(arch, g) if s.kind in PARAM_KINDS)


class Model(nn.Module):
    """End-to-end SLU model (reference ``Model``): the fixed-slot head, or
    the seq2seq head when the config's ``seq2seq`` is on.

    Weights are drawn from a ``torch.Generator`` seeded with ``seed`` (the
    config's seed by default) in the reference's distributions; they differ
    from the JAX package's draws for the same seed.

    Freezing follows the JAX package: every parameter keeps
    ``requires_grad``, and :meth:`trainable_mask` gives the 0/1 mask of the
    ULMFiT schedule that the optimizer applies
    (:class:`~tpu_slu_torch.training.optim.MaskedAdam`).

    ``frontend`` and ``gru_layout`` are the exact-shape eval path's routes,
    kept on ``pretrained_model`` (:class:`PretrainedModel`); ``gru_layout``
    also serves the intent head's bidirectional layers.
    """

    def __init__(self, config, seed: int | None = None, load_pretrained: bool = True, *,
                 frontend: str = DEFAULT_FRONTEND, gru_layout: str = DEFAULT_GRU_LAYOUT):
        super().__init__()
        self.config = config
        self.Sy_intent = config.require("Sy_intent")
        self.seq2seq = config.seq2seq
        self.unfreezing_type = config.unfreezing_type
        self.unfreezing_index = config.starting_unfreezing_index
        self._unfrozen_count = 0
        self._frozen_base = config.pretraining_type != 0
        self._generator = torch.Generator().manual_seed(config.seed)  # forward(training=True)
        gen = torch.Generator().manual_seed(config.seed if seed is None else seed)
        self.pretrained_model = PretrainedModel(config, generator=gen, frontend=frontend,
                                                gru_layout=gru_layout)
        self.encoder_arch = self.pretrained_model.arch
        in_dim = self.encoder_arch.word_feat_dim
        if not self.seq2seq:
            self.intent_arch = IntentArch.from_config(config, in_dim)
            self.values_per_slot = self.intent_arch.values_per_slot
            self.intent_layers = make_layers(self.intent_arch.layers, gen)
            self.intent_layers.append(
                make_linear(self.intent_arch.feat_dim, sum(self.values_per_slot), gen)
            )
        else:
            self.SOS = self.Sy_intent.index("<sos>")
            self.num_labels = len(self.Sy_intent)
            self.seq2seq_arch = Seq2SeqArch.from_config(config, self.SOS, self.num_labels)
            self.encoder = Seq2SeqEncoder(self.seq2seq_arch, in_dim, gen)
            self.decoder = Seq2SeqDecoder(self.seq2seq_arch, gen)

        if config.pretraining_type != 0 and load_pretrained:
            pre_dir = os.path.join(config.folder, "pretraining")
            npz = os.path.join(pre_dir, "model_state.npz")
            pth = os.path.join(pre_dir, "model_state.pth")
            if os.path.isfile(npz):
                state = params_from_jax(read_npz(npz))
            elif os.path.isfile(pth):
                state = torch.load(pth, map_location="cpu")
            else:
                raise FileNotFoundError(
                    f"pretraining_type={config.pretraining_type} but no checkpoint at "
                    f"{npz} or {pth}; set pretraining_type=0 or load_pretrained=False"
                )
            self.pretrained_model.load_state_dict(state, strict=True)

    def vocab_dict(self) -> dict:
        """The inference vocabulary as JSON (``vocab.json``), which
        :meth:`attach_vocab` reads back (JAX ``slu.py:806``)."""
        return {
            "seq2seq": self.seq2seq,
            "Sy_intent": self.Sy_intent,
            "values_per_slot": None if self.seq2seq else list(self.values_per_slot),
            "num_phonemes": self.encoder_arch.num_phonemes,
        }

    @staticmethod
    def attach_vocab(config, vocab: dict):
        """Apply a saved vocab dict (``vocab.json``) to a config in place of the dataset."""
        config.Sy_intent = vocab["Sy_intent"]
        config.num_phonemes = vocab["num_phonemes"]
        if not vocab["seq2seq"]:
            config.values_per_slot = vocab["values_per_slot"]
        return config

    def load_native_checkpoint(self, path: str) -> "Model":
        """Load the JAX package's ``.npz`` checkpoint of the whole model."""
        self.load_state_dict(params_from_jax(read_npz(path)), strict=True)
        return self

    @property
    def device(self) -> torch.device:
        """The device the model's parameters lie on."""
        return next(self.parameters()).device

    def loss(self, x: torch.Tensor, y_intent: torch.Tensor, *, train: bool,
             weights: torch.Tensor | None = None, lengths: torch.Tensor | None = None,
             generator: torch.Generator | None = None,
             y_len: torch.Tensor | None = None,
             denom: float | None = None,
             compute_dtype: torch.dtype | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """(loss, acc) of a batch on the model's device: the JAX Trainer's
        loss (``trainer.py:280-326``), the mean over the examples weighted by
        ``weights`` (B,) (all ones by default); with ``denom`` (the weight
        sum of a data-parallel step's global batch) in place of the weights'
        sum, this batch's shares of the global means. ``lengths`` (B,) sample
        counts leave the frames of batch padding out when the config's
        ``mask_padding`` is on: out of the max over time (fixed-slot), out of
        attention (seq2seq).

        Fixed-slot: ``y_intent`` (B, n_slots) int, the per-slot cross-entropy
        and the all-slots-correct accuracy. Seq2seq: ``y_intent`` (B, U, L)
        one-hot targets, ``-log p(y|x)`` of :func:`seq2seq_log_prob` with
        the steps past ``max(y_len)`` masked when ``y_len`` (B,) is given,
        and an accuracy of 0 (the JAX Trainer's; ``Trainer.test`` adds the
        decode's exact match). Its encoder layer runs unmasked (n = T), as
        the JAX train path runs it.

        ``compute_dtype`` (``torch.bfloat16`` under a bf16 trainer) runs the
        encoder's GRU layers on bf16 streams (:func:`~tpu_slu_torch.models.encoder.apply_stack`);
        the heads' GRU layers then take the bf16 features as they are (the
        seq2seq encoder's too, K4f and K4b at bf16), as JAX's do by
        inheritance, and each head's linears widen them to f32 where JAX
        promotes, so the loss is f32."""
        feats = encoder_features(self.pretrained_model, x, train=train, generator=generator,
                                 compute_dtype=compute_dtype)
        mask_padding = getattr(self.config, "mask_padding", True) and lengths is not None
        if self.seq2seq:
            enc_mask = (frame_mask_from_lengths(self.encoder_arch, lengths, feats.shape[1])
                        if mask_padding else None)
            log_p = seq2seq_log_prob(self.encoder, self.decoder, self.seq2seq_arch, feats, y_intent,
                                     train=train, generator=generator, enc_mask=enc_mask,
                                     num_steps=None if y_len is None else y_len.max())
            w = log_p.new_ones(log_p.shape[0]) if weights is None else weights.to(log_p.dtype)
            d = torch.clamp(w.sum(), min=1.0) if denom is None else max(float(denom), 1.0)
            return -(log_p * w).sum() / d, log_p.new_zeros(())
        fm = None
        if mask_padding:
            t_out = frames_through(self.intent_arch.layers, feats.shape[1])
            fm = frame_mask_from_lengths(self.encoder_arch, lengths, t_out, self.intent_arch)
        logits = intent_logits(self.intent_layers, self.intent_arch, feats, frame_mask=fm,
                               train=train, generator=generator,
                               gru_layout=self.pretrained_model.gru_layout)
        return intent_loss_acc(logits, y_intent, self.values_per_slot, weights, denom)

    def forward(self, x, y_intent, training: bool = False, *, weights=None, lengths=None,
                y_len=None, generator: torch.Generator | None = None):
        """(loss, acc) for a batch (reference ``Model.forward``). ``training``
        applies dropout, its masks and seeds drawn from ``generator`` (the
        model's own, seeded with the config's seed, by default). Without
        ``weights``, ``lengths`` and ``y_len`` the seq2seq loss is JAX
        ``forward``'s, ``-log_p.mean()``."""
        dev = self.device

        def put(a, dtype):
            return None if a is None else torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                                                          dtype=dtype, device=dev)

        x = put(x, torch.float32)
        return self.loss(x, put(y_intent, torch.float32 if self.seq2seq else torch.int64), train=training,
                         weights=put(weights, torch.float32), lengths=put(lengths, torch.int64),
                         y_len=put(y_len, torch.int64),
                         generator=(generator or self._generator) if training else None)

    # -- freezing (reference models.py:738-795) -------------------------------

    def freeze_all_layers(self):
        self._frozen_base = True
        self._unfrozen_count = 0

    def unfreeze_one_layer(self):
        """Advance the ULMFiT schedule by one epoch."""
        if self.unfreezing_type == 0:
            return
        total = num_walkable(self.encoder_arch, self.unfreezing_type)
        self._unfrozen_count = min(self.unfreezing_index, total)
        if self.unfreezing_index <= total:
            self.unfreezing_index += 1

    def trainable_mask(self) -> dict[str, float]:
        """Parameter name -> 1.0 (trains now) or 0.0 (frozen). The encoder's
        ``phoneme_linear`` and ``word_linear`` and the head always train."""
        unfrozen = walk_unfrozen(self.encoder_arch, self.unfreezing_type, self._unfrozen_count)
        mask = {}
        for name, _ in self.named_parameters():
            parts = name.split(".")
            frozen = (self._frozen_base and parts[0] == "pretrained_model"
                      and parts[1] in ("phoneme_layers", "word_layers")
                      and (parts[1], int(parts[2])) not in unfrozen)
            mask[name] = 0.0 if frozen else 1.0
        return mask

    def print_frozen(self):
        unfrozen = walk_unfrozen(self.encoder_arch, self.unfreezing_type, self._unfrozen_count)
        for group in ("phoneme_layers", "word_layers"):
            for spec in getattr(self.encoder_arch, group):
                if spec.kind in PARAM_KINDS:
                    on = not self._frozen_base or (group, spec.index) in unfrozen
                    print(f"{spec.name}: {'unfrozen' if on else 'frozen'}")

    @torch.inference_mode()
    def predict_intents(self, x, bucket: bool = False, beam_width: int = 4, lengths=None):
        """Waveform(s) (T,) or (B, T) -> (logits (B, S), per-slot predictions
        (B, 3)), or for the seq2seq head (scores (W, B) best-first, tokens
        (W, B, max_decode_len)) of a ``beam_width``-wide search (1: greedy),
        on the device the model lies on, with the JAX package's rules:

        * by default, at the input's exact shape;
        * ``lengths=`` (B,) true sample counts of an already padded batch, or
          ``bucket=True`` (zero-pads the input to the next 0.5 s boundary
          after taking its true length): the length-exact path, each row
          equal to its example decoded alone at its exact shape;
        * with the config's ``mask_padding=False`` the exact path is off
          (strict reference emulation: the padding leaks).

        While a profiler runs, its parts are spans one after another:
        ``decode.h2d`` (the input's copy to the device), ``decode.frontend``
        (the features and their valid frames), ``decode.encode`` (the intent
        encoder, the seq2seq head's keys and values, or the fixed-slot head)
        and the seq2seq head's ``decode.search``.
        """
        dev = self.device
        with span("decode.h2d"):
            x = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
                                dtype=torch.float32, device=dev)
            if x.dim() == 1:
                x = x[None, :]
            exact = lengths is not None
            if lengths is None:
                lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int64, device=dev)
            else:
                lengths = torch.as_tensor(np.asarray(lengths) if not torch.is_tensor(lengths) else lengths,
                                          dtype=torch.int64, device=dev)
            if bucket:
                t_pad = pad_to_bucket(x.shape[1], WAVE_BUCKET_QUANT)
                if t_pad != x.shape[1]:
                    x = F.pad(x, (0, t_pad - x.shape[1]))
                exact = True
        mask_padding = getattr(self.config, "mask_padding", True)
        exact = exact and mask_padding
        if self.seq2seq:
            with span("decode.frontend"):
                feats = encoder_features(self.pretrained_model, x, lengths=lengths if exact else None)
                n_valid = valid_frames(self.encoder_arch, lengths, feats.shape[1]) if mask_padding else None
                n_frames = self.encoder_arch.num_frames(lengths) if exact else None
            return seq2seq_beam_infer(self.encoder, self.decoder, self.seq2seq_arch, feats, beam_width,
                                      n_valid=n_valid, n_frames=n_frames)
        with span("decode.frontend"):
            if exact:
                feats = encoder_features(self.pretrained_model, x, lengths=lengths)
                head = {"n_frames": self.encoder_arch.num_frames(lengths)}
            else:
                feats = encoder_features(self.pretrained_model, x)
                fm = None
                if mask_padding:
                    t_out = frames_through(self.intent_arch.layers, feats.shape[1])
                    fm = frame_mask_from_lengths(self.encoder_arch, lengths, t_out, self.intent_arch)
                head = {"frame_mask": fm, "gru_layout": self.pretrained_model.gru_layout}
        with span("decode.encode"):
            logits = intent_logits(self.intent_layers, self.intent_arch, feats, **head)
            return logits, intent_predictions(logits, self.values_per_slot)

    def decode_intents(self, x, bucket: bool = False, lengths=None) -> list:
        """Waveform(s) -> one list of slot-value strings per example, or for
        the seq2seq head one semantics string per example, from the best
        beam (``bucket``/``lengths`` as :meth:`predict_intents`). A
        ``decode`` span while a profiler runs, over those of
        :meth:`predict_intents`, ``decode.readback`` (the answer's copy to
        the host) and ``decode.strings``."""
        with span("decode"):
            _, predicted = self.predict_intents(x, bucket=bucket, lengths=lengths)
            with span("decode.readback"):
                predicted = (predicted[0] if self.seq2seq else predicted).cpu().numpy()
            with span("decode.strings"):
                if self.seq2seq:
                    return [self.ids_to_string(ids, self.Sy_intent) for ids in predicted]
                intents = []
                for prediction in predicted:
                    intent = []
                    for idx, slot in enumerate(self.Sy_intent):
                        for value in self.Sy_intent[slot]:
                            if prediction[idx] == self.Sy_intent[slot][value]:
                                intent.append(value)
                    intents.append(intent)
                return intents

    @staticmethod
    def ids_to_string(ids, S) -> str:
        """Token ids -> string, with the reference's strip quirk:
        ``.lstrip("<sos>").rstrip("<eos>")`` strips by character set."""
        return "".join(S[int(c)] for c in ids).lstrip("<sos>").rstrip("<eos>")

    @staticmethod
    def one_hot_to_string(one_hot_seq, S) -> str:
        """One-hot targets (U, L) -> string, as :meth:`ids_to_string`."""
        return Model.ids_to_string(np.asarray(one_hot_seq).argmax(axis=-1), S)
