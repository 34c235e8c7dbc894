"""The plain reference of the benchmark's seq2seq model, in PyTorch alone.

It imports no module of the program under test (nor jax): every function
here is written out again, from the architecture of Lugosch et al. 2019 as
the configuration file states it. Weights come in as a dict of tensors
keyed like the program's ``state_dict``, made by the benchmark from the seed
(``slubench/weights.py``); the reference works out for itself whatever the
program derives from them. Run it with TF32 off (:func:`f32_matmuls`); its
lower-precision control turns TF32 on.

* :func:`param_specs`: the name, shape and initial distribution of every
  parameter of a configuration.
* :func:`seq2seq_features`: one utterance at its exact length through the
  encoder and the intent encoder, to attention keys and values.
* :func:`teacher_force`: the beam-search decoder teacher-forced along
  token sequences: each step's log-probabilities.
* :func:`beam_search`: width-W search with the program's conventions (the
  lower-precision control and the selection fault run it in the program's
  place).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Architecture from the configuration's sections
# ---------------------------------------------------------------------------


def _ints(s):
    return [int(v) for v in str(s).split(",")]


class Arch:
    """The sizes the reference reads from a configuration file's ``cfg``
    sections (the .cfg format of the source repository, values as strings),
    with ``num_phonemes`` and the seq2seq ``labels`` beside them."""

    def __init__(self, conf: dict):
        c = {k.lower(): v for sec in conf["cfg"].values() for k, v in sec.items()}  # .cfg keys are case-blind
        self.fs = int(c["fs"])
        self.n_filt = _ints(c["cnn_n_filt"])
        self.len_filt = _ints(c["cnn_len_filt"])
        self.stride = _ints(c["cnn_stride"])
        self.max_pool = _ints(c["cnn_max_pool_len"])
        self.act = str(c["cnn_act"]).split(",")
        if c.get("use_sincnet", "True") != "True":
            raise ValueError("the reference takes a SincNet front end")
        self.rnn = []  # (group, index, hidden, pool) of each bi-GRU block
        self.n_phone = len(_ints(c["phone_rnn_num_hidden"]))  # blocks before the phoneme head
        for group, prefix in (("phoneme_layers", "phone"), ("word_layers", "word")):
            if c[f"{prefix}_rnn_bidirectional"] != "True":
                raise ValueError("the reference takes bidirectional GRU stacks")
            hid = _ints(c[f"{prefix}_rnn_num_hidden"])
            kinds, lens = str(c[f"{prefix}_downsample_type"]).split(","), _ints(c[f"{prefix}_downsample_len"])
            start = 5 + 4 * (len(self.n_filt) - 1) + 1 if group == "phoneme_layers" else 0
            for i, h in enumerate(hid):
                if lens[i] > 1 and kinds[i] != "avg":
                    raise ValueError("the reference takes avg downsamples")
                self.rnn.append((group, start + 4 * i, h, lens[i]))
        self.vocabulary_size = int(c["vocabulary_size"])
        self.num_phonemes = int(conf.get("num_phonemes", 42))
        self.seq2seq = c.get("seq2seq", "False") == "True"
        if self.seq2seq:
            self.enc_layers = int(c["num_intent_encoder_layers"])
            self.enc_dim = int(c["intent_encoder_dim"])
            self.dec_layers = int(c["num_intent_decoder_layers"])
            self.dec_dim = int(c["intent_decoder_dim"])
            self.key_dim = int(c["intent_decoder_key_dim"])
            self.value_dim = int(c["intent_decoder_value_dim"])
            self.labels = list(conf["labels"])

    def conv_index(self, i: int) -> int:
        """ModuleList index of front-end conv ``i`` (the sinc conv is 0)."""
        return 0 if i == 0 else 5 + 4 * (i - 1)

    def frames(self, t):
        """Frames after the front end and after each bi-GRU block, for a
        waveform of ``t`` samples (int or int64 tensor): conv floor, ceil pools."""
        for i in range(len(self.n_filt)):
            k, s = self.len_filt[i], self.stride[i]
            t = (t + 2 * (k // 2) - k) // s + 1
            t = -(-t // self.max_pool[i])
        out = [t]
        for *_, pool in self.rnn:
            t = -(-t // pool)
            out.append(t)
        return out


def param_specs(arch: Arch) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, kind, scale) of every parameter, in the program's
    ``state_dict`` naming: ``kind`` ``"uniform"`` draws U(-scale, scale)
    (the torch defaults: 1/sqrt(fan in) for convs and linears, 1/sqrt(H)
    for GRU weights), ``"normal"`` N(0, 1) (the decoder's initial state),
    ``"mel_b1"``/``"mel_band"`` the SincNet mel initialisation."""
    pre = "pretrained_model." if arch.seq2seq else ""
    out = [(f"{pre}phoneme_layers.0.filt_b1", (arch.n_filt[0],), "mel_b1", 0.0),
           (f"{pre}phoneme_layers.0.filt_band", (arch.n_filt[0],), "mel_band", 0.0)]
    for i in range(1, len(arch.n_filt)):
        cin, cout, k = arch.n_filt[i - 1], arch.n_filt[i], arch.len_filt[i]
        b = 1.0 / math.sqrt(cin * k)
        out += [(f"{pre}phoneme_layers.{arch.conv_index(i)}.weight", (cout, cin, k), "uniform", b),
                (f"{pre}phoneme_layers.{arch.conv_index(i)}.bias", (cout,), "uniform", b)]
    d = arch.n_filt[-1]
    for group, idx, h, _ in arch.rnn:
        out += _gru_specs(f"{pre}{group}.{idx}", d, h, ("_l0", "_l0_reverse"))
        d = 2 * h
    out += _linear_specs(f"{pre}phoneme_linear", 2 * arch.rnn[arch.n_phone - 1][2], arch.num_phonemes)
    out += _linear_specs(f"{pre}word_linear", d, arch.vocabulary_size)
    if arch.seq2seq:
        for i in range(arch.enc_layers):
            out += _gru_specs(f"encoder.layers.{3 * i}", d, arch.enc_dim, ("_l0", "_l0_reverse"))
            d = 2 * arch.enc_dim
        L, H = len(arch.labels), arch.dec_dim
        out += _linear_specs("decoder.embed", L, H)
        out += _linear_specs("decoder.attention.key_linear", d, arch.key_dim)
        out += _linear_specs("decoder.attention.query_linear", H, arch.key_dim)
        out += _linear_specs("decoder.attention.value_linear", d, arch.value_dim)
        for i in range(arch.dec_layers):
            din = H + arch.value_dim if i == 0 else H
            out += _gru_specs(f"decoder.rnn.layers.{2 * i}", din, H, ("",))
        out.append(("decoder.initial_state", (arch.dec_layers, H), "normal", 1.0))
        out += _linear_specs("decoder.linear", H, L)
    return out


def _gru_specs(prefix, d, h, sfxs):
    b = 1.0 / math.sqrt(h)
    return [(f"{prefix}.{n}{s}", shape, "uniform", b) for s in sfxs
            for n, shape in (("weight_ih", (3 * h, d)), ("weight_hh", (3 * h, h)),
                             ("bias_ih", (3 * h,)), ("bias_hh", (3 * h,)))]


def _linear_specs(prefix, din, dout):
    b = 1.0 / math.sqrt(din)
    return [(f"{prefix}.weight", (dout, din), "uniform", b), (f"{prefix}.bias", (dout,), "uniform", b)]


def mel_init(n_filt: int, fs: int) -> tuple[np.ndarray, np.ndarray]:
    """SincNet's mel-spaced (filt_b1, filt_band), normalised by fs."""
    mel = np.linspace(80.0, 2595.0 * np.log10(1.0 + (fs / 2.0) / 700.0), n_filt)
    f_cos = 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    b1, b2 = np.roll(f_cos, 1), np.roll(f_cos, -1)
    b1[0], b2[-1] = 30.0, (fs / 2.0) - 100.0
    return (b1 / fs).astype(np.float32), ((b2 - b1) / fs).astype(np.float32)


@contextlib.contextmanager
def f32_matmuls(tf32: bool = False):
    """Products and convolutions in f32 with TF32 off (``tf32=True``: on,
    the lower-precision control), restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def sinc_filters(b1: torch.Tensor, band: torch.Tensor, n: int, fs: int) -> torch.Tensor:
    """SincNet's Hamming-windowed band-pass bank (F, n), peak-normalised,
    with the source's two grids: ``t_right = linspace(1, (n-1)/2, (n-1)/2) /
    fs`` and the window on the inclusive ``linspace(0, n, n)``."""
    beg = b1.abs() + 50.0 / fs
    end = beg + band.abs() + 50.0 / fs
    t_right = torch.linspace(1.0, (n - 1) / 2.0, (n - 1) // 2, device=b1.device) / fs

    def low_pass(cut):
        arg = 2.0 * math.pi * (cut[:, None] * fs) * t_right[None, :]
        y = torch.sin(arg) / arg
        return 2.0 * cut[:, None] * torch.cat([y.flip(1), torch.ones_like(cut)[:, None], y], dim=1)

    bp = low_pass(end) - low_pass(beg)
    bp = bp / bp.amax(dim=1, keepdim=True)
    grid = torch.linspace(0.0, float(n), n, device=b1.device)
    return bp * (0.54 - 0.46 * torch.cos(2.0 * math.pi * grid / n))


def front_end(p: dict, arch: Arch, x: torch.Tensor, pre: str = "") -> torch.Tensor:
    """Waveforms (B, T) -> (B, T', C): the sinc conv, |.|, then each conv;
    after each a ceil max pool and a leaky ReLU of slope 0.2 (the configs'
    front-end dropout is 0)."""
    out = x[:, None, :]
    for i in range(len(arch.n_filt)):
        k = arch.len_filt[i]
        if i == 0:
            w = sinc_filters(p[f"{pre}phoneme_layers.0.filt_b1"], p[f"{pre}phoneme_layers.0.filt_band"],
                             k, arch.fs)[:, None, :]
            out = F.conv1d(out, w, None, stride=arch.stride[0], padding=k // 2).abs()
        else:
            j = arch.conv_index(i)
            out = F.conv1d(out, p[f"{pre}phoneme_layers.{j}.weight"], p[f"{pre}phoneme_layers.{j}.bias"],
                           stride=arch.stride[i], padding=k // 2)
        if arch.max_pool[i] > 1:
            out = F.max_pool1d(out, arch.max_pool[i], ceil_mode=True)
        out = F.leaky_relu(out, 0.2) if arch.act[i] == "leaky_relu" else torch.relu(out)
    return out.transpose(1, 2)


def bigru(p: dict, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """A bidirectional GRU layer (h0 = 0, gates r, z, n with torch's two
    biases) over (B, T, D) -> (B, T, 2H): both directions in one loop of T
    steps, the backward one over the time-reversed input."""
    w_ih = torch.stack([p[f"{prefix}.weight_ih_l0"], p[f"{prefix}.weight_ih_l0_reverse"]])
    w_hh = torch.stack([p[f"{prefix}.weight_hh_l0"], p[f"{prefix}.weight_hh_l0_reverse"]])
    b_ih = torch.stack([p[f"{prefix}.bias_ih_l0"], p[f"{prefix}.bias_ih_l0_reverse"]])
    b_hh = torch.stack([p[f"{prefix}.bias_hh_l0"], p[f"{prefix}.bias_hh_l0_reverse"]])
    xs = torch.stack([x, x.flip(1)])  # (2, B, T, D)
    gi = torch.matmul(xs, w_ih.transpose(1, 2)[:, None]) + b_ih[:, None, None, :]
    B, T, H = x.shape[0], x.shape[1], w_hh.shape[2]
    h = x.new_zeros((2, B, H))
    hs = []
    for t in range(T):
        gh = torch.baddbmm(b_hh[:, None, :], h, w_hh.transpose(1, 2))
        g = gi[:, :, t]
        r = torch.sigmoid(g[..., :H] + gh[..., :H])
        z = torch.sigmoid(g[..., H:2 * H] + gh[..., H:2 * H])
        n = torch.tanh(g[..., 2 * H:] + r * gh[..., 2 * H:])
        h = (1.0 - z) * n + z * h
        hs.append(h)
    out = torch.stack(hs, dim=2)  # (2, B, T, H)
    return torch.cat([out[0], out[1].flip(1)], dim=-1)


def gru_block(p: dict, prefix: str, x: torch.Tensor, pool: int) -> torch.Tensor:
    """A bi-GRU block in eval mode: the layer, then the ceil avg pool over
    time (a trailing partial window divided by its frames inside the input)."""
    out = bigru(p, prefix, x)
    if pool > 1:
        out = F.avg_pool1d(out.transpose(1, 2), pool, ceil_mode=True).transpose(1, 2)
    return out


# ---------------------------------------------------------------------------
# Seq2seq head
# ---------------------------------------------------------------------------


def seq2seq_features(p: dict, arch: Arch, wav: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One utterance (T,) alone at its exact length, in eval mode -> its
    attention (keys (T', K), values (T', V)): the encoder, the intent
    encoder's bi-GRU layers, the key and value projections."""
    h = front_end(p, arch, wav[None, :], "pretrained_model.")
    for group, idx, _, pool in arch.rnn:
        h = gru_block(p, f"pretrained_model.{group}.{idx}", h, pool)
    for i in range(arch.enc_layers):
        h = bigru(p, f"encoder.layers.{3 * i}", h)
    att = "decoder.attention."
    keys = F.linear(h, p[att + "key_linear.weight"], p[att + "key_linear.bias"])
    values = F.linear(h, p[att + "value_linear.weight"], p[att + "value_linear.bias"])
    return keys[0], values[0]


def decoder_step(p: dict, arch: Arch, keys, values, mask, state, y_prev):
    """One decoder step for rows of hypotheses: attention with the top
    cell's state (scores over sqrt(K), -inf past each row's frames), the
    previous token's embedding (``y_prev`` (N,) ids, -1 for the all-zeros
    input of the first step) beside the context, the stacked GRUCells, the
    label projection's log-softmax. state (N, layers, H) -> (state, (N, L))."""
    att = "decoder.attention."
    q = F.linear(state[:, -1], p[att + "query_linear.weight"], p[att + "query_linear.bias"])
    scores = torch.einsum("ntk,nk->nt", keys, q) / math.sqrt(keys.shape[-1])
    ctx = torch.einsum("nt,ntv->nv", torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=1), values)
    we = p["decoder.embed.weight"]
    emb = torch.where((y_prev >= 0)[:, None], we.t()[y_prev.clamp(min=0)], 0.0) + p["decoder.embed.bias"]
    h_in = torch.cat([emb, ctx], dim=1)
    new = []
    for i in range(arch.dec_layers):
        c = f"decoder.rnn.layers.{2 * i}."
        gi = F.linear(h_in, p[c + "weight_ih"], p[c + "bias_ih"])
        gh = F.linear(state[:, i], p[c + "weight_hh"], p[c + "bias_hh"])
        H = arch.dec_dim
        r = torch.sigmoid(gi[:, :H] + gh[:, :H])
        z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
        h_in = (1.0 - z) * n + z * state[:, i]
        new.append(h_in)
    logits = F.linear(h_in, p["decoder.linear.weight"], p["decoder.linear.bias"])
    return torch.stack(new, dim=1), torch.log_softmax(logits, dim=1)


def pad_kv(feats: list[tuple[torch.Tensor, torch.Tensor]]):
    """Per-utterance (keys, values) -> padded (N, T, K), (N, T, V) and the
    (N, T) mask of each one's frames."""
    T = max(k.shape[0] for k, _ in feats)
    keys = torch.stack([F.pad(k, (0, 0, 0, T - k.shape[0])) for k, _ in feats])
    values = torch.stack([F.pad(v, (0, 0, 0, T - v.shape[0])) for _, v in feats])
    n = torch.tensor([k.shape[0] for k, _ in feats], device=keys.device)
    return keys, values, torch.arange(T, device=keys.device)[None, :] < n[:, None]


def teacher_force(p: dict, arch: Arch, keys, values, mask, tokens: torch.Tensor) -> torch.Tensor:
    """Log-probabilities (N, U, L) of every step of the searches' decoder
    along ``tokens`` (N, U): step u sees tokens[:, :u] (step 0 the zeros
    input) from the learned initial state."""
    N, U = tokens.shape
    state = p["decoder.initial_state"][None].expand(N, -1, -1)
    y_prev = torch.full((N,), -1, dtype=torch.int64, device=tokens.device)
    out = []
    for u in range(U):
        state, lp = decoder_step(p, arch, keys, values, mask, state, y_prev)
        out.append(lp)
        y_prev = tokens[:, u]
    return torch.stack(out, dim=1)


def beam_search(p: dict, arch: Arch, keys, values, mask, W: int, U: int,
                skip_best_at: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Width-W search over U steps with the program's conventions: no early
    exit at <eos>, the zeros input at step 0 where only one hypothesis
    extends, ties to the smaller ``beam * L + token``. Returns (scores (W,
    N) best first, tokens (W, N, U)). ``skip_best_at``: a planted selection
    fault, the step at which the best extension is dropped (ranks 2 to W + 1
    kept)."""
    N, L = keys.shape[0], len(arch.labels)
    rows = lambda t: t.repeat_interleave(W, dim=0)  # noqa: E731  (N W, ...) row n*W + w
    k, v, mk = rows(keys), rows(values), rows(mask)
    state = p["decoder.initial_state"][None].expand(N * W, -1, -1)
    y_prev = torch.full((N * W,), -1, dtype=torch.int64, device=keys.device)
    scores = keys.new_zeros((N, W))
    tokens = torch.zeros((N, W, U), dtype=torch.int64, device=keys.device)
    for u in range(U):
        state, lp = decoder_step(p, arch, k, v, mk, state, y_prev)
        ext = scores[:, :, None] + lp.view(N, W, L)
        if u == 0:
            ext[:, 1:] = float("-inf")
        top, idx = torch.sort(ext.reshape(N, W * L), dim=1, descending=True, stable=True)
        first = 1 if u == skip_best_at else 0
        top, idx = top[:, first:first + W], idx[:, first:first + W]
        origin, tok = idx // L, idx % L
        tokens = torch.gather(tokens, 1, origin[:, :, None].expand(-1, -1, U)).clone()
        tokens[:, :, u] = tok
        state = state.view(N, W, *state.shape[1:])
        state = torch.gather(state, 1, origin[:, :, None, None].expand(-1, -1, *state.shape[2:]))
        state = state.reshape(N * W, *state.shape[2:])
        y_prev, scores = tok.reshape(-1), top
    return scores.t(), tokens.transpose(0, 1)


def ids_to_string(ids, labels) -> str:
    """The served answer of a token sequence: the labels joined, with the
    source's strip quirk (``lstrip("<sos>")`` and ``rstrip("<eos>")`` strip
    by character set)."""
    return "".join(labels[int(c)] for c in ids).lstrip("<sos>").rstrip("<eos>")
