"""ASR pre-training encoder: SincNet/conv front end + hierarchical bi-GRUs.

Port of the eval path of ``tpu_slu/models/encoder.py``. The architecture is a
flat list of :class:`LayerSpec` whose ``index`` fields follow the reference
``PretrainedModel``'s ``nn.ModuleList`` construction order, so the
:class:`PretrainedModel` module's ``state_dict`` keys (e.g.
``phoneme_layers.10.weight_ih_l0``) are the reference checkpoint's keys.

Between bidirectional GRU layers the activations travel as time-major part
streams (:class:`PartsTM`): each layer reads the previous layer's ``h_f`` and
``h_b`` as two parts, and the following ceil-mode downsample is fused into
the layer (``ops/bigru_shared.py``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn.utils import skip_init

from tpu_slu_torch.ops.bigru_shared import bigru_shared
from tpu_slu_torch.ops.conv import conv1d, downsample, leaky_relu, max_pool1d_ceil
from tpu_slu_torch.ops.sinc import mel_init, sinc_conv


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str  # sinc|conv|abs|pool|act|dropout|ncl2nlc|gru|select|downsample
    index: int  # ModuleList position (checkpoint key index)
    name: str
    h: tuple  # static hyperparameters, kind-specific


def _conv_block_specs(config, start: int) -> tuple[list[LayerSpec], int]:
    """Front-end conv stack specs (reference models.py:180-225)."""
    specs: list[LayerSpec] = []
    i = start
    for idx in range(len(config.cnn_N_filt)):
        if idx == 0:
            if config.use_sincnet:
                specs.append(LayerSpec(
                    "sinc", i, f"sinc{idx}",
                    (config.cnn_N_filt[idx], config.cnn_len_filt[idx], config.fs,
                     config.cnn_stride[idx], config.cnn_len_filt[idx] // 2),
                ))
            else:
                specs.append(LayerSpec(
                    "conv", i, f"conv{idx}",
                    (1, config.cnn_N_filt[idx], config.cnn_len_filt[idx],
                     config.cnn_stride[idx], config.cnn_len_filt[idx] // 2),
                ))
            i += 1
            specs.append(LayerSpec("abs", i, f"abs{idx}", ()))
            i += 1
        else:
            specs.append(LayerSpec(
                "conv", i, f"conv{idx}",
                (config.cnn_N_filt[idx - 1], config.cnn_N_filt[idx],
                 config.cnn_len_filt[idx], config.cnn_stride[idx],
                 config.cnn_len_filt[idx] // 2),
            ))
            i += 1
        specs.append(LayerSpec("pool", i, f"pool{idx}", (config.cnn_max_pool_len[idx],)))
        i += 1
        specs.append(LayerSpec("act", i, f"act{idx}", (config.cnn_act[idx],)))
        i += 1
        specs.append(LayerSpec("dropout", i, f"dropout{idx}", (config.cnn_drop[idx],)))
        i += 1
    return specs, i


def rnn_block_specs(prefix: str, start: int, in_dim: int, hiddens, drops, ds_types, ds_lens,
                    bidirectional) -> tuple[list[LayerSpec], int, int]:
    """bi-GRU -> select -> dropout -> downsample blocks (reference models.py:230-285)."""
    specs: list[LayerSpec] = []
    i = start
    out_dim = in_dim
    for idx, hidden in enumerate(hiddens):
        specs.append(LayerSpec("gru", i, f"{prefix}_rnn{idx}", (out_dim, hidden, bidirectional)))
        i += 1
        out_dim = hidden * (2 if bidirectional else 1)
        specs.append(LayerSpec("select", i, f"{prefix}_rnn_select{idx}", ()))
        i += 1
        specs.append(LayerSpec("dropout", i, f"{prefix}_dropout{idx}", (drops[idx],)))
        i += 1
        specs.append(LayerSpec("downsample", i, f"{prefix}_downsample{idx}", (ds_types[idx], ds_lens[idx])))
        i += 1
    return specs, i, out_dim


@dataclasses.dataclass(frozen=True)
class EncoderArch:
    """Static architecture description derived from a Config."""

    phoneme_layers: tuple[LayerSpec, ...]
    word_layers: tuple[LayerSpec, ...]
    phoneme_feat_dim: int
    word_feat_dim: int
    num_phonemes: int
    vocabulary_size: int
    pretraining_type: int

    @staticmethod
    def from_config(config) -> "EncoderArch":
        conv_specs, i = _conv_block_specs(config, 0)
        conv_specs.append(LayerSpec("ncl2nlc", i, "ncl2nlc", ()))
        i += 1
        rnn_specs, i, phone_dim = rnn_block_specs(
            "phone", i, config.cnn_N_filt[-1],
            config.phone_rnn_num_hidden, config.phone_rnn_drop,
            config.phone_downsample_type, config.phone_downsample_len,
            config.phone_rnn_bidirectional,
        )
        word_specs, _, word_dim = rnn_block_specs(
            "word", 0, phone_dim,
            config.word_rnn_num_hidden, config.word_rnn_drop,
            config.word_downsample_type, config.word_downsample_len,
            config.word_rnn_bidirectional,
        )
        return EncoderArch(
            phoneme_layers=tuple(conv_specs + rnn_specs),
            word_layers=tuple(word_specs),
            phoneme_feat_dim=phone_dim,
            word_feat_dim=word_dim,
            num_phonemes=int(config.require("num_phonemes")),
            vocabulary_size=config.vocabulary_size,
            pretraining_type=config.pretraining_type,
        )

    def num_frames(self, t, upto: str = "word"):
        """Exact output frame count for a waveform of ``t`` samples (int or tensor)."""
        specs = self.phoneme_layers if upto == "phoneme" else self.phoneme_layers + self.word_layers
        return frames_through(specs, t)


def frames_through(specs, t):
    """Length arithmetic of a LayerSpec chain: conv floor, ceil pools and downsamples."""
    for spec in specs:
        if spec.kind in ("sinc", "conv"):
            if spec.kind == "sinc":
                _, k, _, stride, pad = spec.h
            else:
                _, _, k, stride, pad = spec.h
            t = (t + 2 * pad - k) // stride + 1
        elif spec.kind == "pool":
            t = -(-t // spec.h[0])
        elif spec.kind == "downsample":
            _, factor = spec.h
            if factor > 1:
                t = -(-t // factor)
    return t


# ---------------------------------------------------------------------------
# Modules (parameter holders named like the reference's)
# ---------------------------------------------------------------------------


class SincLayer(nn.Module):
    """Sinc band-pass filterbank parameters: ``filt_b1`` and ``filt_band``."""

    def __init__(self, n_filt: int, fs: int):
        super().__init__()
        b1, band = mel_init(n_filt, fs)
        self.filt_b1 = nn.Parameter(torch.from_numpy(b1))
        self.filt_band = nn.Parameter(torch.from_numpy(band))


class BiGRULayer(nn.Module):
    """Bidirectional GRU parameters in ``torch.nn.GRU`` naming and layout:
    ``weight_ih_l0`` (3H, D), ``weight_hh_l0`` (3H, H), ``bias_ih_l0``,
    ``bias_hh_l0`` (3H,), and the same with ``_reverse``."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        for sfx in ("_l0", "_l0_reverse"):
            for name, shape in (("weight_ih", (3 * hidden, in_dim)), ("weight_hh", (3 * hidden, hidden)),
                                ("bias_ih", (3 * hidden,)), ("bias_hh", (3 * hidden,))):
                self.register_parameter(name + sfx, nn.Parameter(torch.empty(shape)))

    def params(self) -> dict:
        """``{"fwd": {...}, "bwd": {...}}`` as :func:`bigru_shared` takes them."""
        return {
            d: {n: getattr(self, n + sfx) for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
            for d, sfx in (("fwd", "_l0"), ("bwd", "_l0_reverse"))
        }


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


def make_layer(spec: LayerSpec, gen: torch.Generator) -> nn.Module:
    """The module at ``spec.index``, initialised as the JAX package initialises
    it (torch defaults) from ``gen``; layers without parameters are identities."""
    if spec.kind == "sinc":
        n_filt, _, fs, _, _ = spec.h
        return SincLayer(n_filt, fs)
    if spec.kind == "conv":
        cin, cout, k, stride, pad = spec.h
        m = skip_init(nn.Conv1d, cin, cout, k, stride=stride, padding=pad)
        bound = 1.0 / (cin * k) ** 0.5
    elif spec.kind == "gru":
        in_dim, hidden, bidir = spec.h
        if not bidir:
            raise NotImplementedError("unidirectional GRU layers are not ported yet")
        m = BiGRULayer(in_dim, hidden)
        bound = 1.0 / hidden ** 0.5
    else:
        return nn.Identity()
    for p in m.parameters():
        _uniform_(p, bound, gen)
    return m


def make_linear(in_dim: int, out_dim: int, gen: torch.Generator) -> nn.Linear:
    """torch Linear default init: U(-1/sqrt(in), 1/sqrt(in)) for weight and bias."""
    m = skip_init(nn.Linear, in_dim, out_dim)
    for p in m.parameters():
        _uniform_(p, 1.0 / in_dim ** 0.5, gen)
    return m


def make_layers(specs, gen: torch.Generator) -> nn.ModuleList:
    for pos, spec in enumerate(specs):
        if spec.index != pos:
            raise ValueError(f"layer {spec.name} has index {spec.index} at position {pos}")
    return nn.ModuleList(make_layer(s, gen) for s in specs)


# ---------------------------------------------------------------------------
# Apply (eval, exact-shape path)
# ---------------------------------------------------------------------------


class PartsTM(tuple):
    """Marker type: time-major (T, B, C) part streams between chained
    bidirectional GRU layers. The h_f/h_b halves of a layer stay separate
    tensors, so the channel concat between stacked layers is never made."""


def parts_to_btc(parts: PartsTM) -> torch.Tensor:
    """Finalise part streams to one batch-major (B, T, C) tensor."""
    h = parts[0] if len(parts) == 1 else torch.cat(tuple(parts), dim=-1)
    return h.transpose(0, 1)


def apply_stack(layers: nn.ModuleList, specs, out):
    """Run a LayerSpec stack. Conv specs take (B, C, T); a GRU takes
    time-major parts (or (B, T, C), which it turns time-major); the rest of
    the RNN specs take (B, T, C). Returns a tensor or a :class:`PartsTM`."""
    specs = list(specs)
    idx = 0
    while idx < len(specs):
        spec = specs[idx]
        layer = layers[spec.index]
        idx += 1
        if spec.kind == "gru":
            if not isinstance(out, PartsTM):
                out = PartsTM((out.transpose(0, 1).contiguous(),))
            # RNN blocks are [gru, select, dropout, downsample] (rnn_block_specs):
            # consume the trailing three so that the downsample fuses into the layer
            method, factor = "none", 1
            if [s.kind for s in specs[idx:idx + 3]] == ["select", "dropout", "downsample"]:
                method, factor = specs[idx + 2].h
                idx += 3
            fused = factor > 1 and method in ("avg", "max")
            h_f, h_b, _ = bigru_shared(
                layer.params(), out, pool=factor if fused else 1,
                pool_method=method if fused else "avg",
            )
            parts = [h_f, h_b]
            if factor > 1 and not fused:
                parts = [downsample(p, method, factor, time_axis=0).contiguous() for p in parts]
            out = PartsTM(parts)
            continue
        if isinstance(out, PartsTM):
            out = parts_to_btc(out)
        if spec.kind == "sinc":
            _, filt_dim, fs, stride, pad = spec.h
            out = sinc_conv(layer.filt_b1, layer.filt_band, out, filt_dim, fs, stride, pad)
        elif spec.kind == "conv":
            _, _, _, stride, pad = spec.h
            out = conv1d(out, layer.weight, layer.bias, stride=stride, padding=pad)
        elif spec.kind == "abs":
            out = out.abs()
        elif spec.kind == "pool":
            out = max_pool1d_ceil(out, spec.h[0])
        elif spec.kind == "act":
            out = leaky_relu(out, 0.2) if spec.h[0] == "leaky_relu" else torch.relu(out)
        elif spec.kind in ("dropout", "select"):
            pass  # dropout is the identity in eval; the GRU returns its sequence
        elif spec.kind == "ncl2nlc":
            out = PartsTM((out.permute(2, 0, 1).contiguous(),))  # (B, C, T) -> (T, B, C)
        elif spec.kind == "downsample":
            method, factor = spec.h
            out = downsample(out, method, factor, time_axis=1)
        else:
            raise ValueError(spec.kind)
    return out


def encoder_features(encoder: "PretrainedModel", x: torch.Tensor) -> torch.Tensor:
    """(B, T) waveform -> (B, T/word_ds, word_feat_dim) word-rate features
    (reference ``PretrainedModel.compute_features``)."""
    arch = encoder.arch
    out = apply_stack(encoder.phoneme_layers, arch.phoneme_layers, x[:, None, :])
    out = apply_stack(encoder.word_layers, arch.word_layers, out)
    return parts_to_btc(out) if isinstance(out, PartsTM) else out


class PretrainedModel(nn.Module):
    """The encoder's parameters, named like the reference ``PretrainedModel``:
    ``phoneme_layers`` and ``word_layers`` ModuleLists indexed as the
    reference builds them, plus ``phoneme_linear`` and ``word_linear``."""

    def __init__(self, config, generator: torch.Generator | None = None):
        super().__init__()
        if not hasattr(config, "num_phonemes"):
            config.num_phonemes = 42  # the JAX package's default head size
        gen = generator if generator is not None else torch.Generator().manual_seed(config.seed)
        self.arch = EncoderArch.from_config(config)
        self.phoneme_layers = make_layers(self.arch.phoneme_layers, gen)
        self.word_layers = make_layers(self.arch.word_layers, gen)
        self.phoneme_linear = make_linear(self.arch.phoneme_feat_dim, self.arch.num_phonemes, gen)
        self.word_linear = make_linear(self.arch.word_feat_dim, self.arch.vocabulary_size, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return encoder_features(self, x)
