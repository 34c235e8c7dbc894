"""ASR pre-training encoder: SincNet/conv front end + hierarchical bi-GRUs.

Port of the eval and train paths of ``tpu_slu/models/encoder.py``, at the
input's exact shape and length-exact over a padded batch (``lengths=``,
:func:`_apply_stack_masked`). The architecture is a
flat list of :class:`LayerSpec` whose ``index`` fields follow the reference
``PretrainedModel``'s ``nn.ModuleList`` construction order, so the
:class:`PretrainedModel` module's ``state_dict`` keys (e.g.
``phoneme_layers.10.weight_ih_l0``) are the reference checkpoint's keys.

Between bidirectional GRU layers the activations travel as time-major part
streams (:class:`PartsTM`): each layer reads the previous layer's ``h_f`` and
``h_b`` as two parts, and the following ceil-mode downsample is fused into
the layer (``ops/bigru_shared.py``). A unidirectional GRU layer (a config's
``*_rnn_bidirectional=False``) takes and returns batch-major (B, T, C)
(``ops/gru1.py``); its dropout and downsample run after it, as in JAX.

``compute_dtype=torch.bfloat16`` (a trainer's ``compute_dtype=bfloat16``)
casts each GRU layer's input to bf16, as JAX's ``_apply_stack`` does on the
TPU's Pallas path (``encoder.py:361-362``, ``:464-465``): the bidirectional
layers then run K1 (or K6), K2 and K3 on bf16 streams, the unidirectional
ones K5f and K5b, the length-exact branch K4f and K5f; the dropout and the
pools after a layer act on its bf16 output, as XLA's do; the front end
stays f32, and the heads widen their input to their weights' dtype, where
JAX promotes.

Two routes of the exact-shape eval path are settings of
:class:`PretrainedModel`, passed down to :func:`apply_stack` by its
callers: ``frontend`` (``"fused"``: the sinc conv, |.|, max pool and
activation in one launch of K8, ``ops/frontend_fused.py``; ``"composed"``:
the cuDNN conv and three PyTorch ops) and ``gru_layout`` (``"split"``: K1;
``"rowstack"``: K6). Both compute the same function; their defaults are
the routes measured faster on the card (PERF.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.nn.utils import skip_init

from tpu_slu_torch.ops.bigru_masked import bigru_masked
from tpu_slu_torch.ops.bigru_shared import bigru_shared
from tpu_slu_torch.ops.conv import (
    conv1d,
    downsample,
    leaky_relu,
    masked_avg_pool1d_ceil,
    masked_max_pool1d_ceil,
    max_pool1d_ceil,
)
from tpu_slu_torch.ops.frontend_fused import sinc_frontend_fused
from tpu_slu_torch.ops.gru1 import gru1
from tpu_slu_torch.ops.sinc import mel_init, sinc_conv
from tpu_slu_torch.parallel.vocab import ColumnParallelLinear, vocab_parallel_frame_ce

FRONTENDS = ("fused", "composed")
# the routes of the exact-shape eval path that a PretrainedModel takes unless
# told otherwise, chosen by chip_smoke.py's same-process A/B `[ab-frontend]`
# and `[ab-layout]` (turns P, C, C, P) on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md section 6): K8's route beat the composed one alone on 4 s by graph
# replay, 0.0805, 0.0764 against 0.0996, 0.1085 ms at B = 1, 0.1240, 0.1227
# against 0.1680, 0.1653 at B = 16, 0.3245, 0.3216 against 0.7266, 0.7245 at
# B = 128, and in the warm decode's device time, 1.0019, 1.0022 against
# 1.0241, 1.0242 ms at B = 1, 1.2601, 1.2605 against 1.3048, 1.3032 at B = 16,
# and took no more of the host's time to enqueue (0.7888, 0.7512 against
# 1.2942, 0.6820 ms at B = 1, 0.7232, 0.6972 against 0.7682, 0.8106 at B = 16);
# K6 tied K1 in the warm decode (1.0039, 1.0039 against 1.0023, 1.0023 ms at
# B = 1; 1.2513, 1.2421 against 1.2600, 1.2603 at B = 16), so the layout stays
# K1's
DEFAULT_FRONTEND = "fused"
DEFAULT_GRU_LAYOUT = "split"


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


class GRULayer(nn.Module):
    """Unidirectional GRU parameters in ``torch.nn.GRU`` naming and layout:
    ``weight_ih_l0`` (3H, D), ``weight_hh_l0`` (3H, H), ``bias_ih_l0``,
    ``bias_hh_l0`` (3H,)."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        for name, shape in (("weight_ih", (3 * hidden, in_dim)), ("weight_hh", (3 * hidden, hidden)),
                            ("bias_ih", (3 * hidden,)), ("bias_hh", (3 * hidden,))):
            self.register_parameter(name + "_l0", nn.Parameter(torch.empty(shape)))

    def params(self) -> dict:
        """``{"fwd": {...}}`` as :func:`~tpu_slu_torch.ops.gru1.gru1` takes them."""
        return {"fwd": {n: getattr(self, n + "_l0")
                        for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}}


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
        m = (BiGRULayer if bidir else GRULayer)(in_dim, hidden)
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
# Apply (exact-shape path)
# ---------------------------------------------------------------------------


class PartsTM(tuple):
    """Marker type: time-major (T, B, C) part streams between chained
    bidirectional GRU layers. The h_f/h_b halves of a layer stay separate
    tensors, so the channel concat between stacked layers is never made."""


def parts_to_btc(parts: PartsTM) -> torch.Tensor:
    """Finalise part streams to one batch-major (B, T, C) tensor."""
    h = parts[0] if len(parts) == 1 else torch.cat(tuple(parts), dim=-1)
    return h.transpose(0, 1)


def draw_seed(generator: torch.Generator) -> int:
    """A fresh uint32 dropout seed for one layer, drawn on the host."""
    return int(torch.randint(0, 2**32, (1,), generator=generator, dtype=torch.int64))


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with a Bernoulli keep mask drawn from ``generator``
    on the generator's device (so a card run and a CPU run with equal
    generators drop the same elements): ``where(keep, x / (1 - p), 0)``,
    1 - p in x's dtype (a bf16 x divides by it rounded to bf16, as JAX's
    weakly typed ``x / keep_p`` does)."""
    if generator is None:
        raise ValueError(f"dropout of rate {p} in training needs a generator")
    keep = torch.rand(x.shape, generator=generator, device=generator.device) < 1.0 - p
    return torch.where(keep.to(x.device), x / torch.tensor(1.0 - p, dtype=x.dtype), 0.0)


def _gru_block(layer, tail, out, *, train: bool, generator, layout: str,
               compute_dtype: torch.dtype | None = None):
    """One bi-GRU block ([gru] + ``tail``, the trailing [select, dropout,
    downsample] when present) over part streams; returns the next parts.
    ``compute_dtype`` casts the input streams first (JAX ``encoder.py:361``).

    Eval: a ceil avg/max downsample fuses into the layer (K1). Train: a ceil
    avg downsample and the block's dropout fuse into the layer (K2 forward,
    K3 backward) with a fresh uint32 seed from ``generator`` (seed 0 without
    a generator, allowed only when the rate is 0); otherwise the layer
    returns full-rate streams (K1, K3) and the dropout (a Bernoulli mask from
    ``generator``) and the downsample follow it.
    """
    if compute_dtype is not None:
        out = PartsTM(p.to(compute_dtype) for p in out)
    drop_p, method, factor = 0.0, "none", 1
    if tail:
        drop_p = tail[1].h[0]
        method, factor = tail[2].h
    if train:
        want_pool = factor > 1 and method == "avg"
        seed = None
        if want_pool:
            if generator is not None:
                seed = draw_seed(generator)
            elif drop_p == 0.0:
                seed = 0
        h_f, h_b, pooled = bigru_shared(layer.params(), out, train=True,
                                        pool=factor if want_pool else 1, drop_p=drop_p,
                                        seed=seed, layout=layout)
    else:
        fused = factor > 1 and method in ("avg", "max")
        h_f, h_b, pooled = bigru_shared(layer.params(), out, pool=factor if fused else 1,
                                        pool_method=method if fused else "avg", layout=layout)
    parts = [h_f, h_b]
    if train and drop_p > 0.0 and not pooled:
        h = dropout(torch.cat(parts, dim=-1), drop_p, generator)
        parts = [h[..., :h_f.shape[-1]], h[..., h_f.shape[-1]:]]
    if factor > 1 and not pooled:
        parts = [downsample(p, method, factor, time_axis=0) for p in parts]
    return PartsTM(p.contiguous() for p in parts)


def zero_time_tail(out: torch.Tensor, n: torch.Tensor, time_axis: int) -> torch.Tensor:
    """Zero frames >= n_b along ``time_axis`` (1 or 2) of a (B, ., .) tensor."""
    valid = torch.arange(out.shape[time_axis], device=out.device)[None, :] < n[:, None]
    return torch.where(valid[:, None, :] if time_axis == 2 else valid[:, :, None], out, 0.0)


def _apply_stack_masked(layers: nn.ModuleList, specs, out, n: torch.Tensor, *, train: bool,
                        generator: torch.Generator | None, compute_dtype: torch.dtype | None = None):
    """The length-exact branch of :func:`apply_stack` (the JAX
    ``_apply_stack`` with ``n``): every op computes as if each example were
    cropped to its own ``n_b`` valid samples (before the convs) or frames
    (after them). Conv tails are zeroed, the ceil pools take the
    per-example partial-window divisor, and each bi-GRU runs K4f
    (:func:`bigru_masked`), each unidirectional GRU K5f (:func:`gru1`); the
    shared-stream chain is not taken. Conv specs
    take (B, C, T), RNN specs (B, T, C); returns (B, T, C). The counts
    follow :func:`frames_through`, spec by spec, with ``//`` flooring on
    int64 tensors as JAX's does (a row with n_b = 0 stays at 0 frames).
    ``compute_dtype`` casts each GRU layer's input (JAX ``encoder.py:464``)."""
    if isinstance(out, PartsTM):
        out = parts_to_btc(out)
    for spec in specs:
        layer = layers[spec.index]
        n_in, n = n, frames_through((spec,), n)
        if spec.kind == "sinc":
            _, filt_dim, fs, stride, pad = spec.h
            out = zero_time_tail(sinc_conv(layer.filt_b1, layer.filt_band, out, filt_dim, fs, stride, pad),
                                 n, 2)
        elif spec.kind == "conv":
            _, _, _, stride, pad = spec.h
            out = zero_time_tail(conv1d(out, layer.weight, layer.bias, stride=stride, padding=pad), n, 2)
        elif spec.kind == "abs":
            out = out.abs()
        elif spec.kind == "pool":
            out = masked_max_pool1d_ceil(out, spec.h[0], n_in)
        elif spec.kind == "act":
            out = leaky_relu(out, 0.2) if spec.h[0] == "leaky_relu" else torch.relu(out)
        elif spec.kind == "dropout":
            if train and spec.h[0] > 0.0:
                out = dropout(out, spec.h[0], generator)
        elif spec.kind == "ncl2nlc":
            out = out.transpose(1, 2)  # (B, C, T) -> (B, T, C)
        elif spec.kind == "gru":
            if compute_dtype is not None:
                out = out.to(compute_dtype)
            out = (bigru_masked if spec.h[2] else gru1)(layer.params(), out.contiguous(), n)
        elif spec.kind == "select":
            pass  # the GRU returns its sequence
        elif spec.kind == "downsample":
            method, factor = spec.h
            if factor > 1 and method == "none":
                out = out[:, ::factor]
            elif factor > 1:
                pool = masked_max_pool1d_ceil if method == "max" else masked_avg_pool1d_ceil
                out = pool(out.transpose(1, 2), factor, n_in).transpose(1, 2)
        else:
            raise ValueError(spec.kind)
    return out


def _fuses_frontend(spec: LayerSpec, tail) -> bool:
    """JAX's gate of the fused front end (``encoder.py:327-332``): a sinc
    conv whose stride is above 1 and below its taps, followed by [abs, pool,
    act, dropout]."""
    if spec.kind != "sinc":
        return False
    _, filt_dim, _, stride, _ = spec.h
    return stride > 1 and filt_dim > stride and [s.kind for s in tail] == ["abs", "pool", "act", "dropout"]


def apply_stack(layers: nn.ModuleList, specs, out, *, train: bool = False,
                generator: torch.Generator | None = None, n: torch.Tensor | None = None,
                frontend: str = DEFAULT_FRONTEND, gru_layout: str = DEFAULT_GRU_LAYOUT,
                compute_dtype: torch.dtype | None = None):
    """Run a LayerSpec stack. Conv specs take (B, C, T); a bidirectional GRU
    takes time-major parts (or (B, T, C), which it turns time-major); a
    unidirectional GRU and the rest of the RNN specs take (B, T, C), parts
    finalised first. Returns a tensor or a :class:`PartsTM`.

    ``train`` applies dropout, its masks and seeds drawn from ``generator``
    in layer order (needed whenever a rate is above 0). ``n`` (B,) int64
    valid counts of ``out`` select the length-exact branch
    (:func:`_apply_stack_masked`); the counts of its output are
    ``frames_through(specs, n)``.

    In eval at the exact shape, ``frontend="fused"`` runs a sinc conv and the
    [abs, pool, act, dropout] after it as one K8 call (dropout is a no-op in
    eval), where JAX's gate allows; ``gru_layout`` is every bidirectional
    layer's ``bigru_shared`` layout. The length-exact branch and training
    keep the composed front end, as in JAX.

    ``compute_dtype`` (None or ``torch.bfloat16``) casts every GRU layer's
    input to it, bidirectional or not, on either branch; the specs after a
    layer act on its output in that dtype, the front end keeps its own."""
    if frontend not in FRONTENDS:
        raise ValueError(f"frontend must be one of {FRONTENDS}, got {frontend!r}")
    if n is not None:
        return _apply_stack_masked(layers, specs, out, n, train=train, generator=generator,
                                   compute_dtype=compute_dtype)
    specs = list(specs)
    idx = 0
    while idx < len(specs):
        spec = specs[idx]
        layer = layers[spec.index]
        idx += 1
        if spec.kind == "gru" and spec.h[2]:
            if not isinstance(out, PartsTM):
                out = PartsTM((out.transpose(0, 1).contiguous(),))
            # RNN blocks are [gru, select, dropout, downsample] (rnn_block_specs):
            # consume the trailing three so that the downsample fuses into the layer
            tail = specs[idx:idx + 3]
            if [s.kind for s in tail] == ["select", "dropout", "downsample"]:
                idx += 3
            else:
                tail = []
            out = _gru_block(layer, tail, out, train=train, generator=generator, layout=gru_layout,
                             compute_dtype=compute_dtype)
            continue
        if isinstance(out, PartsTM):
            out = parts_to_btc(out)
        if frontend == "fused" and not train and _fuses_frontend(spec, specs[idx:idx + 4]):
            _, filt_dim, fs, stride, pad = spec.h
            pool, act = specs[idx + 1].h[0], specs[idx + 2].h[0]
            idx += 4
            out = sinc_frontend_fused(layer.filt_b1, layer.filt_band, out[:, 0, :], filt_dim=filt_dim,
                                      fs=fs, stride=stride, padding=pad, pool=pool,
                                      act="leaky_relu" if act == "leaky_relu" else "relu")
            out = out.transpose(1, 2)  # (B, F, t_pool), contiguous: K8 writes channels-first
            continue
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
        elif spec.kind == "dropout":
            if train and spec.h[0] > 0.0:
                out = dropout(out, spec.h[0], generator)
        elif spec.kind == "gru":  # unidirectional: JAX's generic gru_apply branch
            if compute_dtype is not None:
                out = out.to(compute_dtype)
            out = gru1(layer.params(), out.contiguous())
        elif spec.kind == "select":
            pass  # the GRU returns its sequence
        elif spec.kind == "ncl2nlc":
            out = PartsTM((out.permute(2, 0, 1).contiguous(),))  # (B, C, T) -> (T, B, C)
        elif spec.kind == "downsample":
            method, factor = spec.h
            out = downsample(out, method, factor, time_axis=1)
        else:
            raise ValueError(spec.kind)
    return out


def _btc(out) -> torch.Tensor:
    return parts_to_btc(out) if isinstance(out, PartsTM) else out


def encoder_phoneme_features(encoder: "PretrainedModel", x: torch.Tensor, *, train: bool = False,
                             generator: torch.Generator | None = None,
                             lengths: torch.Tensor | None = None,
                             compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(B, T) waveform -> (B, T/phone_ds, phoneme_feat_dim) phoneme-rate
    features; ``train``, ``lengths`` and ``compute_dtype`` as
    :func:`encoder_features`."""
    return _btc(apply_stack(encoder.phoneme_layers, encoder.arch.phoneme_layers, x[:, None, :],
                            train=train, generator=generator, n=lengths, compute_dtype=compute_dtype,
                            **encoder.routes()))


def encoder_features(encoder: "PretrainedModel", x: torch.Tensor, *, train: bool = False,
                     generator: torch.Generator | None = None,
                     lengths: torch.Tensor | None = None,
                     compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(B, T) waveform -> (B, T/word_ds, word_feat_dim) word-rate features
    (reference ``PretrainedModel.compute_features``); ``train`` and
    ``compute_dtype`` as :func:`apply_stack` (at bf16 the features are bf16).

    ``lengths`` (B,) int64 sample counts select the length-exact path: row
    b's features equal, frame for frame, those of the example alone at
    T = lengths_b, and its frames past ``arch.num_frames(lengths_b)`` are 0.
    """
    arch = encoder.arch
    out = apply_stack(encoder.phoneme_layers, arch.phoneme_layers, x[:, None, :], train=train,
                      generator=generator, n=lengths, compute_dtype=compute_dtype, **encoder.routes())
    n = None if lengths is None else frames_through(arch.phoneme_layers, lengths)
    return _btc(apply_stack(encoder.word_layers, arch.word_layers, out, train=train, generator=generator,
                            n=n, compute_dtype=compute_dtype, **encoder.routes()))


def encoder_posteriors(encoder: "PretrainedModel", x: torch.Tensor, *,
                       lengths: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(phoneme_logits (B, t_phone, num_phonemes), word_logits (B, t_word,
    vocabulary_size)) in eval mode (reference ``compute_posteriors``). The
    phoneme head reads the phoneme stack's output; the word stack takes its
    parts as they are."""
    arch = encoder.arch
    out = apply_stack(encoder.phoneme_layers, arch.phoneme_layers, x[:, None, :], n=lengths,
                      **encoder.routes())
    phoneme_logits = encoder.phoneme_linear(_btc(out))
    n = None if lengths is None else frames_through(arch.phoneme_layers, lengths)
    out = apply_stack(encoder.word_layers, arch.word_layers, out, n=n, **encoder.routes())
    return phoneme_logits, encoder.word_linear(_btc(out))


def masked_frame_ce(logits: torch.Tensor, y: torch.Tensor, weights: torch.Tensor | None = None,
                    denom: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Frame-wise cross-entropy with ignore index -1 (JAX
    ``_masked_frame_ce``): ``logits`` (B, T, C), ``y`` (B, T) int, ``weights``
    (B,) per example (weight-0 rows take no part in the loss, the accuracy or
    the gradient). Returns (mean loss, accuracy) over the valid weighted
    frames; ``denom`` (the valid frames of a data-parallel step's global
    batch) in place of their count makes them this batch's shares of the
    global means. The loss is ``logsumexp - logit of the label``: one pass over
    the logits, no log-softmax tensor and no one-hot."""
    valid = (y != -1).to(logits.dtype)
    if weights is not None:
        valid = valid * weights.to(logits.dtype)[:, None]
    y_safe = torch.where(y != -1, y, 0).long()
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, y_safe[..., None])[..., 0]
    denom = torch.clamp(valid.sum(), min=1.0) if denom is None else max(float(denom), 1.0)
    loss = (nll * valid).sum() / denom
    acc = ((logits.detach().argmax(-1) == y_safe).to(logits.dtype) * valid).sum() / denom
    return loss, acc


def head_frame_ce(head: nn.Module, h: torch.Tensor, y: torch.Tensor, weights: torch.Tensor | None = None,
                  denom: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`masked_frame_ce` of a vocab head's logits of ``h`` (B, T, in),
    the input widened to the head's dtype; a head column-sharded over a
    model group (``parallel/vocab.py``, ``model_parallel`` > 1) takes the
    vocabulary-parallel loss, equal on every rank of the group."""
    logits = head(h.to(head.weight.dtype))
    if isinstance(head, ColumnParallelLinear):
        return vocab_parallel_frame_ce(logits, y, head, weights, denom)
    return masked_frame_ce(logits, y, weights, denom)


def encoder_loss(encoder: "PretrainedModel", x: torch.Tensor, y_phoneme: torch.Tensor,
                 y_word: torch.Tensor, *, train: bool = False, generator: torch.Generator | None = None,
                 weights: torch.Tensor | None = None, denoms: tuple[float, float] | None = None,
                 compute_dtype: torch.dtype | None = None):
    """ASR pre-training losses (JAX ``encoder_loss``, reference
    ``PretrainedModel.forward``): (phoneme_loss, word_loss, phoneme_acc,
    word_acc). ``y_phoneme`` (B, t_p) and ``y_word`` (B, t_w) are frame labels
    at the two stacks' rates, -1 where ignored; each head is trimmed to the
    shorter of its frames and its labels. ``denoms``, the (phoneme, word)
    valid frames of a data-parallel step's global batch, make the four
    values this batch's shares of the global ones (:func:`masked_frame_ce`;
    a column-sharded head, :func:`head_frame_ce`).
    At ``pretraining_type == 1`` the word stack does not run and its loss and accuracy are 0. The stacks run
    unmasked (every row at the batch's T), as JAX's do; ``train``,
    ``generator`` and ``compute_dtype`` as :func:`apply_stack`. The heads
    take their input in their weights' dtype (at bf16 it is widened, where
    JAX promotes: ``encoder.py:592``, ``:605``), so the losses are f32."""
    arch = encoder.arch
    out = apply_stack(encoder.phoneme_layers, arch.phoneme_layers, x[:, None, :], train=train,
                      generator=generator, compute_dtype=compute_dtype, **encoder.routes())
    h = _btc(out)
    t = min(h.shape[1], y_phoneme.shape[1])
    dp, dw = (None, None) if denoms is None else denoms
    phoneme_loss, phoneme_acc = head_frame_ce(encoder.phoneme_linear, h[:, :t], y_phoneme[:, :t], weights, dp)
    if arch.pretraining_type == 1:
        zero = phoneme_loss.new_zeros(())
        return phoneme_loss, zero, phoneme_acc, zero
    h = _btc(apply_stack(encoder.word_layers, arch.word_layers, out, train=train, generator=generator,
                         compute_dtype=compute_dtype, **encoder.routes()))
    t = min(h.shape[1], y_word.shape[1])
    word_loss, word_acc = head_frame_ce(encoder.word_linear, h[:, :t], y_word[:, :t], weights, dw)
    return phoneme_loss, word_loss, phoneme_acc, word_acc


class PretrainedModel(nn.Module):
    """The encoder's parameters, named like the reference ``PretrainedModel``:
    ``phoneme_layers`` and ``word_layers`` ModuleLists indexed as the
    reference builds them, plus ``phoneme_linear`` and ``word_linear``.

    ``frontend`` and ``gru_layout`` are the routes of the exact-shape eval
    path (:func:`apply_stack`); plain attributes, which a caller may also
    set after construction. Without a ``num_phonemes`` on the config (no
    ``phonemes.txt`` read yet) the phoneme head has the JAX package's 42."""

    def __init__(self, config, generator: torch.Generator | None = None, *,
                 frontend: str = DEFAULT_FRONTEND, gru_layout: str = DEFAULT_GRU_LAYOUT):
        super().__init__()
        self.frontend, self.gru_layout = frontend, gru_layout
        if not hasattr(config, "num_phonemes"):
            config.num_phonemes = 42  # the JAX package's default head size
        gen = generator if generator is not None else torch.Generator().manual_seed(config.seed)
        self.arch = EncoderArch.from_config(config)
        self.phoneme_layers = make_layers(self.arch.phoneme_layers, gen)
        self.word_layers = make_layers(self.arch.word_layers, gen)
        self.phoneme_linear = make_linear(self.arch.phoneme_feat_dim, self.arch.num_phonemes, gen)
        self.word_linear = make_linear(self.arch.word_feat_dim, self.arch.vocabulary_size, gen)

    def routes(self) -> dict:
        return {"frontend": self.frontend, "gru_layout": self.gru_layout}

    @property
    def device(self) -> torch.device:
        return self.phoneme_linear.weight.device

    def _put(self, a, dtype):
        return torch.as_tensor(a if torch.is_tensor(a) else np.asarray(a), dtype=dtype, device=self.device)

    def compute_features(self, x) -> torch.Tensor:
        """(B, T) waveform -> word-rate features, eval mode."""
        return encoder_features(self, self._put(x, torch.float32))

    def compute_posteriors(self, x) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, T) waveform -> (phoneme_logits, word_logits), eval mode."""
        return encoder_posteriors(self, self._put(x, torch.float32))

    def forward(self, x, y_phoneme, y_word):
        """(phoneme_loss, word_loss, phoneme_acc, word_acc) of a batch in
        eval mode, as JAX's ``PretrainedModel.__call__``."""
        return encoder_loss(self, self._put(x, torch.float32), self._put(y_phoneme, torch.int64),
                            self._put(y_word, torch.int64))
