"""The port's seq2seq training path vs the JAX package, on the CPU.

K4b's plain version (``bigru_masked_bwd_reference``) and the autograd of
``bigru_masked`` (on the CPU the same ``torch.autograd.Function`` the card
runs, with the plain versions inside) are held against ``jax.vjp`` through
the TPU kernel K4b itself (``gru_apply_pallas`` and the masked joint kernel,
in interpret mode on the CPU) and through the scan GRU. Then
``seq2seq_log_prob``, the JAX Trainer's seq2seq loss with every gradient,
and two epochs of both Trainers on the synthetic FSC fixture, all at
dropout 0 on weights carried from the JAX model with ``params_from_jax``.
Inputs come from numpy seeds. Tolerances are stated where they are used.
"""

import copy
import csv
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import fixtures
from tests.test_torch_bigru_shared import make_params
from tests.test_torch_seq2seq import small_seq2seq_config
from tpu_slu import ops as jops
from tpu_slu import read_config
from tpu_slu.data.datasets import get_SLU_datasets
from tpu_slu.models import encoder as jenc
from tpu_slu.models import slu as jslu
from tpu_slu.ops.pallas_gru import TIME_BLOCK, gru_apply_pallas
from tpu_slu.training.trainer import Trainer as JaxTrainer
from tpu_slu_torch.models.convert import params_from_jax
from tpu_slu_torch.models.slu import (
    Model,
    Seq2SeqArch,
    Seq2SeqDecoder,
    Seq2SeqEncoder,
    seq2seq_encode,
    seq2seq_log_prob,
)
from tpu_slu_torch.ops.bigru_masked import (
    bigru_masked,
    bigru_masked_bwd,
    bigru_masked_bwd_reference,
    bigru_masked_reference,
)
from tpu_slu_torch.training import Trainer

GRAD_TOL = 1e-4  # of each tensor's largest element: f32 sums over B*T rows in another order
# The attention's key bias shifts every frame's score by the same q . b, which the
# softmax cancels: its gradient is 0 in exact arithmetic, rounding noise on both
# sides. It is held against the scale of the key weight's gradient instead.
KEY_BIAS, KEY_WEIGHT = "decoder.attention.key_linear.bias", "decoder.attention.key_linear.weight"
_JAX_NAMES = {"weight_ih": "w_ih", "weight_hh": "w_hh", "bias_ih": "b_ih", "bias_hh": "b_hh"}


def _close(got, want, tol=GRAD_TOL, what="", scale=None):
    """|got - want| within ``tol`` of ``scale`` (want's largest element by default)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = np.abs(want).max() if scale is None else scale
    assert err <= tol * max(scale, 1e-6), (what, err, scale)


def _compare_layer_grads(dx, grads, jdx, jgrads):
    _close(dx, jdx, what="dx")
    for d in ("fwd", "bwd"):
        for n, j in _JAX_NAMES.items():
            want = np.asarray(jgrads[d][j])
            _close(grads[d][n], want.T if n.startswith("weight") else want, what=f"{d}.{n}")


def _port_grads(route, tp, x, n, cot):
    """(out, dx, grads) of the port's layer at cotangent ``cot``: K4b's plain
    version called on the forward's output, or autograd of ``bigru_masked``."""
    x, n, cot = torch.from_numpy(x), torch.from_numpy(n), torch.from_numpy(cot)
    if route == "reference":
        out = bigru_masked_reference(tp, x, n)
        dx, grads = bigru_masked_bwd_reference(tp, x, out, n, cot)
        return out, dx, grads
    leaves = {d: {k: v.clone().requires_grad_() for k, v in tp[d].items()} for d in tp}
    xl = x.clone().requires_grad_()
    out = bigru_masked(leaves, xl, n)
    assert out.grad_fn is not None and out.grad_fn.__class__.__name__ == "_MaskedCoreBackward"
    out.backward(cot)
    return out.detach(), xl.grad, {d: {k: v.grad for k, v in leaves[d].items()} for d in leaves}


# ---------------------------------------------------------------------------
# K4b
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _layer_case(B, T, against, lengths=None):
    """Seeded weights, input, lengths and cotangent, and JAX's output and VJP:
    ``pallas`` through the TPU kernels K4f/K4b (interpret mode on the CPU),
    ``scan`` through the scan GRU; with ``lengths``, ``gru_apply_masked``."""
    rng = np.random.default_rng(B * 100 + T)
    D, H = 6, 8
    jp, tp = make_params(rng, D, H)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    cot = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    n = np.full(B, T, np.int64) if lengths is None else np.array(lengths, np.int64)
    if lengths is None:
        fn = gru_apply_pallas if against == "pallas" else (lambda p, xx: jops.gru_apply(p, xx, impl="scan"))
    else:
        def fn(p, xx):
            return jops.gru_apply_masked(p, xx, jnp.asarray(n, jnp.int32), impl=against)
    def vjp_at(p, xx, c):
        out, f_vjp = jax.vjp(fn, p, xx)
        return out, f_vjp(c)

    out, (jgrads, jdx) = jax.jit(vjp_at)(jp, jnp.asarray(x), jnp.asarray(cot))
    return tp, x, n, cot, np.asarray(out), np.asarray(jdx), jax.tree.map(np.asarray, jgrads)


@pytest.mark.parametrize("route", ["reference", "autograd"])
@pytest.mark.parametrize("against", ["pallas", "scan"])
@pytest.mark.parametrize("B,T", [(1, 5), (3, TIME_BLOCK + 5), (3, 1)])
def test_k4b_matches_jax_on_the_unmasked_layer(B, T, against, route):
    """n = T, the seq2seq train path: the VJP of ``gru_apply``, T not a
    multiple of the kernel's time block of 16."""
    tp, x, n, cot, jout, jdx, jgrads = _layer_case(B, T, against)
    out, dx, grads = _port_grads(route, tp, x, n, cot)
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-6)
    _compare_layer_grads(dx, grads, jdx, jgrads)


@pytest.mark.parametrize("route", ["reference", "autograd"])
@pytest.mark.parametrize("against", ["pallas", "scan"])
@pytest.mark.parametrize("B,T,lengths", [(5, 13, (0, 1, 13, 7, 12)), (4, 21, (21, 20, 2, 0)),
                                         (3, 1, (0, 1, 1))])
def test_k4b_matches_jax_with_mixed_lengths(monkeypatch, B, T, lengths, against, route):
    """Against ``jax.vjp`` of ``gru_apply_masked``: the scan branch, and the
    joint Pallas kernels over the per-example reversed stream. The
    cotangent is nonzero past each length, where the output is a constant 0:
    it must not leak, and dX there is exactly 0."""
    monkeypatch.setenv("TPU_SLU_PALLAS_INTERPRET", "1")
    tp, x, n, cot, jout, jdx, jgrads = _layer_case(B, T, against, lengths)
    out, dx, grads = _port_grads(route, tp, x, n, cot)
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-6)
    _compare_layer_grads(dx, grads, jdx, jgrads)
    for b, nb in enumerate(lengths):
        assert (dx[b, nb:] == 0).all()


def test_k4b_wrapper_on_the_cpu_is_the_plain_version():
    tp, x, n, cot, *_ = _layer_case(4, 21, "scan", (21, 20, 2, 0))
    x, n, cot = torch.from_numpy(x), torch.from_numpy(n), torch.from_numpy(cot)
    out = bigru_masked_reference(tp, x, n)
    before = (bigru_masked.launches, bigru_masked_bwd.launches)
    dx, grads = bigru_masked_bwd(tp, x, out, n, cot)
    rdx, rgrads = bigru_masked_bwd_reference(tp, x, out, n, cot)
    assert (bigru_masked.launches, bigru_masked_bwd.launches) == before  # counts kernel launches only
    assert torch.equal(dx, rdx)
    assert all(torch.equal(grads[d][k], rgrads[d][k]) for d in grads for k in grads[d])


def test_bigru_masked_dispatch_takes_the_function_only_when_grad_is_needed():
    tp, x, n, *_ = _layer_case(4, 21, "scan", (21, 20, 2, 0))
    x, n = torch.from_numpy(x), torch.from_numpy(n)
    assert bigru_masked(tp, x, n).grad_fn is None  # no input needs a gradient
    leaves = {d: {k: v.clone().requires_grad_() for k, v in tp[d].items()} for d in tp}
    assert type(bigru_masked(leaves, x, n).grad_fn).__name__ == "_MaskedCoreBackward"
    with torch.no_grad():
        assert bigru_masked(leaves, x, n).grad_fn is None


# ---------------------------------------------------------------------------
# seq2seq_log_prob and dropout
# ---------------------------------------------------------------------------


def _head(seed, zeros_start=False, dropout=0.0):
    """A small JAX seq2seq head and the port's encoder and decoder holding its weights."""
    arch = jslu.Seq2SeqArch(num_labels=11, num_encoder_layers=2, encoder_dim=8, num_decoder_layers=2,
                            decoder_dim=12, key_dim=6, value_dim=10, sos=0, dropout=dropout,
                            zeros_start=zeros_start)
    jp = jslu.init_seq2seq_params(jax.random.PRNGKey(seed), arch, 10)
    tarch = Seq2SeqArch(**{f: getattr(arch, f) for f in arch.__dataclass_fields__})
    gen = torch.Generator().manual_seed(0)
    enc, dec = Seq2SeqEncoder(tarch, 10, gen), Seq2SeqDecoder(tarch, gen)
    state = params_from_jax(jax.tree.map(np.asarray, jp))
    for prefix, module in (("encoder.", enc), ("decoder.", dec)):
        module.load_state_dict({k.removeprefix(prefix): v for k, v in state.items() if k.startswith(prefix)},
                               strict=True)
    return arch, jp, tarch, enc, dec


def _targets(rng, B, U, L):
    ids = rng.integers(1, L, (B, U))
    return np.eye(L, dtype=np.float32)[ids]


@pytest.mark.parametrize("zeros_start,masked,steps", [(False, False, False), (True, False, False),
                                                      (False, True, False), (False, False, True),
                                                      (True, True, True)])
def test_seq2seq_log_prob_matches_jax(zeros_start, masked, steps):
    """Values to 1e-5 relative, and the gradient wrt the features to 1e-4 of
    its largest element: f32, sums in another order."""
    arch, jp, tarch, enc, dec = _head(1, zeros_start)
    rng = np.random.default_rng(2)
    B, T, U = 4, 9, 6
    feats = rng.standard_normal((B, T, 10)).astype(np.float32)
    y = _targets(rng, B, U, arch.num_labels)
    mask = np.arange(T)[None, :] < np.array([9, 1, 5, 7])[:, None] if masked else None
    num_steps = np.int32(4) if steps else None
    wts = rng.standard_normal(B).astype(np.float32)

    def jfn(f):
        lp = jslu.seq2seq_log_prob(jp, arch, f, jnp.asarray(y), gru_impl="scan",
                                   enc_mask=None if mask is None else jnp.asarray(mask),
                                   num_steps=None if num_steps is None else jnp.asarray(num_steps))
        return (lp * wts).sum(), lp

    (_, jlp), jgf = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jnp.asarray(feats))
    tf = torch.from_numpy(feats).requires_grad_()
    lp = seq2seq_log_prob(enc, dec, tarch, tf, torch.from_numpy(y),
                          enc_mask=None if mask is None else torch.from_numpy(mask),
                          num_steps=None if num_steps is None else torch.tensor(int(num_steps)))
    (lp * torch.from_numpy(wts)).sum().backward()
    assert lp.shape == (B,)
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    _close(tf.grad, jgf, what="d feats")


def test_seq2seq_dropout_is_the_generators_with_its_rate_and_scale():
    """Equal generators drop equal elements in the encoder and the decoder;
    a kept element is scaled by exactly 1/(1-p), a dropped one is 0, and the
    share dropped is p within 5 binomial standard deviations."""
    p = 0.3
    _, _, tarch, enc, dec = _head(3, dropout=p)
    arch1 = Seq2SeqArch(**{**tarch.__dict__, "num_encoder_layers": 1})
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.standard_normal((8, 40, 10)).astype(np.float32))
    with torch.no_grad():
        ref = seq2seq_encode(enc, arch1, feats)
        a = seq2seq_encode(enc, arch1, feats, train=True, generator=torch.Generator().manual_seed(5))
        b = seq2seq_encode(enc, arch1, feats, train=True, generator=torch.Generator().manual_seed(5))
        c = seq2seq_encode(enc, arch1, feats, train=True, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    torch.testing.assert_close(a[kept], ref[kept] / (1.0 - p), rtol=0, atol=0)
    share = 1.0 - kept.float().mean().item()
    sd = (p * (1 - p) / a.numel()) ** 0.5
    assert abs(share - p) <= 5 * sd, (share, p)
    with pytest.raises(ValueError, match="generator"):
        seq2seq_encode(enc, arch1, feats, train=True)
    # the decoder's dropout: reproducible, and off at eval
    y = torch.from_numpy(_targets(rng, 8, 5, tarch.num_labels))
    with torch.no_grad():
        runs = [seq2seq_log_prob(enc, dec, tarch, feats, y, train=True,
                                 generator=torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
        evals = [seq2seq_log_prob(enc, dec, tarch, feats, y) for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert torch.equal(evals[0], evals[1]) and not torch.equal(evals[0], runs[0])


# ---------------------------------------------------------------------------
# the model and the Trainer
# ---------------------------------------------------------------------------


def _no_dropout(config):
    config.cnn_drop = [0.0] * len(config.cnn_drop)
    for k in ("phone_rnn_drop", "word_rnn_drop", "intent_rnn_drop"):
        setattr(config, k, [0.0] * len(getattr(config, k)))
    config.seq2seq_dropout = 0.0
    config.gru_impl = "scan"
    return config


def _port_of(jmodel, config):
    tmodel = Model(config, load_pretrained=False)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)), strict=True)
    return tmodel


def test_forward_loss_and_every_gradient_match_the_jax_trainers(tmp_path):
    """``Model.forward(training=True)`` with weights, lengths and y_len
    against ``jax.value_and_grad`` of the JAX Trainer's seq2seq loss
    (``trainer.py:302-326``: attention mask, step mask, weighted mean).
    Loss to 1e-5 relative, acc 0 on both; each gradient to 1e-4 of its
    tensor's largest element (f32 sums through six GRU layers and the
    decoder loop in another order); the key bias's, of the key weight's."""
    config = _no_dropout(small_seq2seq_config(str(tmp_path)))
    config.num_intent_encoder_layers = 2
    jmodel = jslu.Model(config, seed=3)
    tmodel = _port_of(jmodel, config)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4000)).astype(np.float32)
    y = _targets(rng, 3, 7, len(config.Sy_intent))
    w = np.array([1.0, 1.0, 0.0], np.float32)
    lengths = np.array([4000, 3100, 2500], np.int32)
    y_len = np.array([5, 6, 3], np.int32)
    earch, sarch = jmodel.encoder_arch, jmodel.seq2seq_arch
    r1, r2 = jax.random.split(jax.random.PRNGKey(0))

    def jloss(p):  # the JAX Trainer's seq2seq loss_fn, train=True
        feats = jenc.encoder_features(p["pretrained_model"], earch, jnp.asarray(x), train=True, rng=r1,
                                      gru_impl="scan")
        enc_mask = jslu.frame_mask_from_lengths(earch, jnp.asarray(lengths), feats.shape[1])
        log_p = jslu.seq2seq_log_prob(p, sarch, feats, jnp.asarray(y), train=True, rng=r2, gru_impl="scan",
                                      enc_mask=enc_mask, num_steps=jnp.max(jnp.asarray(y_len)))
        return -(log_p * w).sum() / jnp.maximum(w.sum(), 1.0), jnp.zeros((), jnp.float32)

    (jl, ja), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jmodel.params)
    tmodel.zero_grad(set_to_none=True)
    loss, acc = tmodel(x, y, training=True, weights=w, lengths=lengths, y_len=y_len)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert acc.item() == float(ja) == 0.0
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    for name, p in tmodel.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)  # unused: JAX gives zeros
        scale = np.abs(want[KEY_WEIGHT].numpy()).max() if name == KEY_BIAS else None
        _close(got, want[name], what=name, scale=scale)
    # without weights, lengths and y_len: JAX Model.forward's -log_p.mean()
    jf, _ = jmodel.forward(x, y, training=True)
    with torch.no_grad():
        tf, _ = tmodel(x, y, training=True)
    np.testing.assert_allclose(tf.item(), float(jf), rtol=1e-5)


class _Batches:
    """A dataset whose ``.loader`` replays recorded batches."""

    def __init__(self, batches):
        self.loader = batches


def test_two_epoch_seq2seq_trainer_matches_jax(tmp_path):
    """Both Trainers from shared weights on the same recorded seq2seq
    batches of the synthetic FSC fixture (one-hot ``y_intent``, ``y_len``),
    frozen base with unfreezing type 1, dropout 0, decode accuracy from
    epoch 1. Per-epoch train and valid loss to 1e-4 relative, accuracies
    equal; final parameters within 1e-4 of each tensor's largest element
    (Adam steps of lr 3e-3 on gradients that agree to f32 rounding), but for
    the key bias: Adam normalises its rounding-noise gradient, so each step
    moves it by up to lr on either side, and it is held within steps x lr.
    The same ``log.csv`` header and rows."""
    root = fixtures.make_slu_dataset(str(tmp_path / "fsc"), n_train=16, n_valid=8, n_test=8)
    cfg = fixtures.write_cfg(str(tmp_path / "exp.cfg"), folder=str(tmp_path / "jax"), slu_path=root,
                             seq2seq=True, pretraining_type=2, unfreezing_type=1,
                             extra="decode_acc_from_epoch=1\n")
    config = _no_dropout(read_config(cfg))
    fixtures.write_phonemes_txt(config.folder)
    config.n_devices = 1
    config.seq2seq_max_decode_len = 9
    train, valid, _ = get_SLU_datasets(config)
    epochs = [_Batches(list(train.loader)) for _ in range(2)]
    valid = _Batches(list(valid.loader))
    assert epochs[0].loader[0]["y_intent"].ndim == 3 and "y_len" in epochs[0].loader[0]

    jmodel = jslu.Model(config, load_pretrained=False)
    tconfig = copy.copy(config)
    tconfig.folder = str(tmp_path / "port")
    tmodel = _port_of(jmodel, tconfig)
    jt, tt = JaxTrainer(jmodel, config), Trainer(tmodel, tconfig)
    for ds in epochs:
        (ja, jl), (ta, tl) = jt.train(ds), tt.train(ds)
        assert ta == ja == 0.0
        assert tl == pytest.approx(jl, rel=1e-4)
        (ja, jl), (ta, tl) = jt.test(valid), tt.test(valid)
        assert ta == pytest.approx(ja, abs=1e-6)
        assert tl == pytest.approx(jl, rel=1e-4)
    want = params_from_jax(jax.tree.map(np.asarray, jmodel.params))
    steps = sum(len(ds.loader) for ds in epochs)
    for name, p in tmodel.named_parameters():
        if name == KEY_BIAS:
            assert (p.detach() - want[name]).abs().max().item() <= steps * config.training_lr
        else:
            _close(p.detach(), want[name], what=name)

    def header(folder):
        with open(os.path.join(folder, "training", "log.csv")) as f:
            return next(csv.reader(f)), len(f.readlines())

    assert header(tconfig.folder) == header(config.folder)
