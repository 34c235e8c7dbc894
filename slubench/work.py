"""The yardstick's arithmetic: peaks, bounds, and the operations and bytes
of each piece of work, from shapes alone.

Peaks are NVIDIA's published ones for one H100 SXM (dense, no sparsity):
67 TFLOP/s in f32 outside the tensor cores, 3.35 TB/s of HBM. The configs
compute in f32 with TF32 off, so the f32 rate is the peak. A bound is the
larger of the operations over the peak rate and the bytes over the memory
rate, each input read once and each output written once; it ignores the
serial chains of the recurrences. Model FLOPs count the products (2 per
multiply-add) and ``GATE_OPS`` per GRU gate element; pools, activations and
softmaxes are left out.
"""

from __future__ import annotations

from slubench.reference.model import Arch

PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
GATE_OPS = 20  # f32 operations per gate element and direction: 2 sigmoids, a tanh, ~8 adds and products


def bound_s(flops: float, nbytes: float) -> float:
    """The least time in seconds the card could take."""
    return max(flops / PEAK_F32, nbytes / PEAK_BYTES)


def gru_fwd_flops(rows: float, D: int, H: int, dirs: int = 2) -> float:
    """A GRU layer's forward over ``rows`` (t, b) rows: per row and
    direction the input and recurrent products and the gate math."""
    return dirs * rows * (2 * 3 * H * (D + H) + GATE_OPS * H)


def encoder_fwd_flops(arch: Arch, n: int) -> float:
    """Forward model FLOPs of one utterance of ``n`` samples at its own
    length: the front end's convs and the bi-GRU blocks (a decode reads no
    frame head)."""
    t = n
    flops = 0.0
    cin = 1
    for i in range(len(arch.n_filt)):
        k, s = arch.len_filt[i], arch.stride[i]
        t = (t + 2 * (k // 2) - k) // s + 1
        flops += 2.0 * arch.n_filt[i] * cin * k * t
        t = -(-t // arch.max_pool[i])
        cin = arch.n_filt[i]
    d = cin
    for _, _, h, pool in arch.rnn:
        flops += gru_fwd_flops(t, d, h)
        t, d = -(-t // pool), 2 * h
    return flops


def k7_work(T: int, W: int, U: int, nl: int, H: int, K: int, V: int, L: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one utterance's width-W, U-step beam search over T
    valid frames: per step and hypothesis the query, the scores and context
    over T frames, the cells, the label projection and its log-softmax; in:
    keys, values and the decoder weights; out: scores and int64 tokens."""
    cells = sum(2 * 3 * H * ((H + V if li == 0 else H) + H) + GATE_OPS * H for li in range(nl))
    row = 2 * H * K + 2 * T * (K + V) + 4 * T + cells + 2 * H * L + 4 * L
    weights = H * K + K + L * H + H + sum(3 * H * ((H + V if li == 0 else H) + H) + 6 * H
                                          for li in range(nl)) + H * L + L + nl * H
    return float(row) * W * U, 4.0 * (T * (K + V) + weights + W) + 8.0 * W * U


def decode_flops(arch: Arch, n: int, W: int, U: int) -> float:
    """Useful FLOPs of decoding one utterance of ``n`` samples at its own
    length: the encoder without its heads, the intent encoder's bi-GRU
    layers, the key and value projections, and every step of the search."""
    t = arch.frames(n)[-1]
    d = 2 * arch.rnn[-1][2]
    flops = encoder_fwd_flops(arch, n)
    for _ in range(arch.enc_layers):
        flops += gru_fwd_flops(t, d, arch.enc_dim)
        d = 2 * arch.enc_dim
    flops += 2.0 * t * d * (arch.key_dim + arch.value_dim)
    return flops + k7_work(t, W, U, arch.dec_layers, arch.dec_dim, arch.key_dim, arch.value_dim,
                           len(arch.labels))[0]


def k7_call_bound_s(arch: Arch, lengths, W: int, U: int) -> float:
    """K7's bound for one call: the real rows' (``lengths`` > 0) work summed,
    each over its own valid frames."""
    flops = nbytes = 0.0
    for n in lengths:
        if n > 0:
            f, b = k7_work(arch.frames(int(n))[-1], W, U, arch.dec_layers, arch.dec_dim, arch.key_dim,
                           arch.value_dim, len(arch.labels))
            flops, nbytes = flops + f, nbytes + b
    return bound_s(flops, nbytes)
