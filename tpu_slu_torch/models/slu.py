"""End-to-end SLU model, fixed-slot intent head: encoder + bi-GRU + Linear + max over time.

Port of the fixed-slot part of ``tpu_slu/models/slu.py`` on the exact-shape
decode path (``Model.decode_intents`` without ``lengths``/``bucket``). The
:class:`Model` module's ``state_dict`` keys are the reference ``Model``'s
(``pretrained_model.*``, ``intent_layers.*``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_slu_torch.models.convert import params_from_jax, read_npz
from tpu_slu_torch.models.encoder import (
    LayerSpec,
    PartsTM,
    PretrainedModel,
    apply_stack,
    encoder_features,
    frames_through,
    make_layers,
    make_linear,
    parts_to_btc,
    rnn_block_specs,
)


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
                  frame_mask: torch.Tensor | None = None) -> torch.Tensor:
    """feats (B, T, C) encoder features -> (B, sum(values_per_slot)) logits.

    ``frame_mask`` (B, T_out) marks frames that come from real audio; the
    others are left out of the max over time.
    """
    out = apply_stack(layers, arch.layers, feats)
    if isinstance(out, PartsTM):
        out = parts_to_btc(out)
    lin = layers[arch.linear_index]
    out = F.linear(out, lin.weight, lin.bias)
    if frame_mask is not None:
        out = out.masked_fill(~frame_mask[:, :, None], float("-inf"))
    return out.amax(dim=1)


def frame_mask_from_lengths(encoder_arch, lengths: torch.Tensor, t_frames: int,
                            intent_arch: IntentArch | None = None) -> torch.Tensor:
    """(B,) waveform sample counts -> (B, t_frames) bool valid-frame mask,
    with at least one valid frame per row."""
    n = encoder_arch.num_frames(torch.clamp(lengths, min=1))
    if intent_arch is not None:
        n = frames_through(intent_arch.layers, n)
    n = torch.clamp(n, 1, t_frames)
    return torch.arange(t_frames, device=lengths.device)[None, :] < n[:, None]


def intent_predictions(logits: torch.Tensor, values_per_slot) -> torch.Tensor:
    """Per-slot argmax -> (B, num_slots) int64."""
    return torch.stack([s.argmax(dim=1) for s in logits.split(list(values_per_slot), dim=1)], dim=1)


class Model(nn.Module):
    """End-to-end SLU model with the fixed-slot head (reference ``Model``).

    Weights are drawn from a ``torch.Generator`` seeded with ``seed`` (the
    config's seed by default) in the reference's distributions; they differ
    from the JAX package's draws for the same seed.
    """

    def __init__(self, config, seed: int | None = None, load_pretrained: bool = True):
        super().__init__()
        if config.seq2seq:
            raise NotImplementedError("the seq2seq head is not ported yet")
        self.config = config
        self.Sy_intent = config.require("Sy_intent")
        gen = torch.Generator().manual_seed(config.seed if seed is None else seed)
        self.pretrained_model = PretrainedModel(config, generator=gen)
        self.encoder_arch = self.pretrained_model.arch
        self.intent_arch = IntentArch.from_config(config, self.encoder_arch.word_feat_dim)
        self.values_per_slot = self.intent_arch.values_per_slot
        self.intent_layers = make_layers(self.intent_arch.layers, gen)
        self.intent_layers.append(
            make_linear(self.intent_arch.feat_dim, sum(self.values_per_slot), gen)
        )

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

    @torch.inference_mode()
    def predict_intents(self, x, bucket: bool = False, lengths=None):
        """Waveform(s) (T,) or (B, T) -> (logits (B, S), per-slot predictions (B, 3)).

        Runs at the input's exact shape on the device the model lies on.
        """
        if bucket or lengths is not None:
            raise NotImplementedError("the length-exact path (lengths=, bucket=True) is not ported yet")
        dev = self.intent_layers[self.intent_arch.linear_index].weight.device
        x = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
                            dtype=torch.float32, device=dev)
        if x.dim() == 1:
            x = x[None, :]
        feats = encoder_features(self.pretrained_model, x)
        fm = None
        if getattr(self.config, "mask_padding", True):
            t_out = frames_through(self.intent_arch.layers, feats.shape[1])
            lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int64, device=dev)
            fm = frame_mask_from_lengths(self.encoder_arch, lengths, t_out, self.intent_arch)
        logits = intent_logits(self.intent_layers, self.intent_arch, feats, frame_mask=fm)
        return logits, intent_predictions(logits, self.values_per_slot)

    def decode_intents(self, x, bucket: bool = False, lengths=None) -> list[list[str]]:
        """Waveform(s) -> one list of slot-value strings per example."""
        _, predicted = self.predict_intents(x, bucket=bucket, lengths=lengths)
        intents = []
        for prediction in predicted.cpu().numpy():
            intent = []
            for idx, slot in enumerate(self.Sy_intent):
                for value in self.Sy_intent[slot]:
                    if prediction[idx] == self.Sy_intent[slot][value]:
                        intent.append(value)
            intents.append(intent)
        return intents
