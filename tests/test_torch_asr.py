"""The port's ASR pre-training against the JAX package's: the frame CE, the
losses and their gradients at each ``pretraining_type``, the posteriors and
phoneme features, and two Trainer epochs on the synthetic LibriSpeech tree.

The small config of ``__graft_entry__._make_config(small=True)``, built in
JAX and carried into the port with ``params_from_jax``; dropout 0 and JAX's
``scan`` GRU, so both sides compute the same function. Tolerances are
stated where they are used.
"""

import copy
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_config
from tests import fixtures
from tpu_slu import read_config as jax_read_config
from tpu_slu.data.datasets import get_ASR_datasets
from tpu_slu.models import encoder as jenc
from tpu_slu.training.trainer import Trainer as JaxTrainer
from tpu_slu_torch.models.convert import params_from_jax
from tpu_slu_torch.models.encoder import (
    PretrainedModel,
    encoder_loss,
    encoder_phoneme_features,
    encoder_posteriors,
    masked_frame_ce,
)
from tpu_slu_torch.training import Trainer


def _no_dropout(config):
    config.cnn_drop = [0.0] * len(config.cnn_drop)
    for k in ("phone_rnn_drop", "word_rnn_drop", "intent_rnn_drop"):
        setattr(config, k, [0.0] * len(getattr(config, k)))
    config.gru_impl = "scan"
    config.n_devices = 1
    return config


def _pair(tmp, ptype=2):
    config = _no_dropout(_make_config(tmp, small=True))
    config.pretraining_type = ptype
    jmodel = jenc.PretrainedModel(config, seed=3)
    tmodel = PretrainedModel(config)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)), strict=True)
    return config, jmodel, tmodel


def _close(got, want, tol, what=""):
    """|got - want| within ``tol`` of want's largest element."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(np.abs(want).max() if want.size else 0.0, 1e-12), (what, err)


def test_masked_frame_ce_matches_jax():
    """Ignore index -1 (a row all -1), weights with a 0, ties in the argmax:
    loss within 1e-6 relative, accuracy equal."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 7, 11)).astype(np.float32)
    logits[0, 0, :] = 0.5  # an argmax tie: the first index wins on both sides
    y = rng.integers(-1, 11, (4, 7)).astype(np.int32)
    y[2] = -1
    w = np.array([1.0, 0.0, 1.0, 0.5], np.float32)
    for weights in (None, w):
        jl, ja = jenc._masked_frame_ce(jnp.asarray(logits), jnp.asarray(y),
                                       None if weights is None else jnp.asarray(weights))
        tl, ta = masked_frame_ce(torch.from_numpy(logits), torch.from_numpy(y).long(),
                                 None if weights is None else torch.from_numpy(weights))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
        assert ta.item() == pytest.approx(float(ja), abs=1e-7)


def _batch(config, B=4, T=4000, phone_extra=1, word_extra=-1, seed=0):
    """Seeded waveforms and labels with -1 frames and a weight-0 row; the
    label streams one frame longer (phoneme) and shorter (word) than the
    encoder's, so that each head trims."""
    rng = np.random.default_rng(seed)
    arch = jenc.EncoderArch.from_config(config)
    tp = int(arch.num_frames(T, upto="phoneme")) + phone_extra
    tw = int(arch.num_frames(T)) + word_extra
    x = (0.1 * rng.standard_normal((B, T))).astype(np.float32)
    yp = rng.integers(-1, config.num_phonemes, (B, tp)).astype(np.int32)
    yw = rng.integers(-1, config.vocabulary_size, (B, tw)).astype(np.int32)
    w = np.array([1.0] * (B - 1) + [0.0], np.float32)
    return x, yp, yw, w


@pytest.mark.parametrize("ptype", [1, 2, 3])
def test_encoder_loss_and_gradients_match_jax(ptype, tmp_path):
    """``encoder_loss(train=True)`` and the gradient of the Trainer's loss of
    each type against ``jax.value_and_grad`` of JAX's: the four values within
    1e-5 relative (accuracies equal), each gradient within 1e-4 of its
    tensor's largest element (f32 sums through four GRU layers in another
    order); a parameter outside the loss gets no gradient where JAX's is 0.
    At type 1 the word values are 0."""
    config, jmodel, tmodel = _pair(str(tmp_path), ptype)
    x, yp, yw, w = _batch(config)

    def jloss(p):
        out = jenc.encoder_loss(p, jmodel.arch, jnp.asarray(x), jnp.asarray(yp), jnp.asarray(yw),
                                train=True, rng=jax.random.PRNGKey(0), gru_impl="scan",
                                weights=jnp.asarray(w))
        return {1: out[0], 2: out[0] + out[1], 3: out[1]}[ptype], out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jmodel.params)
    out = encoder_loss(tmodel, torch.from_numpy(x), torch.from_numpy(yp).long(), torch.from_numpy(yw).long(),
                       train=True, weights=torch.from_numpy(w))
    {1: out[0], 2: out[0] + out[1], 3: out[1]}[ptype].backward()
    for what, t, j in zip(("phone_loss", "word_loss", "phone_acc", "word_acc"), out, jout):
        np.testing.assert_allclose(t.item(), float(j), rtol=1e-5, err_msg=what)
    if ptype == 1:
        assert out[1].item() == out[3].item() == 0.0
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    for name, p in tmodel.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        _close(got.numpy(), want[name].numpy(), 1e-4, name)


def test_posteriors_and_phoneme_features_match_jax(tmp_path):
    """``compute_posteriors`` and ``encoder_phoneme_features`` against JAX's,
    at the exact shape and length-exact (``lengths=``), within 1e-5 of the
    largest element; ``forward`` equals JAX's ``__call__`` (eval losses)
    within 1e-5 relative."""
    config, jmodel, tmodel = _pair(str(tmp_path))
    tmodel.eval()
    x, yp, yw, _ = _batch(config, B=3, T=4800)
    lengths = np.array([4800, 3100, 2000], np.int32)
    with torch.no_grad():
        tp, tw = tmodel.compute_posteriors(x)
        jp, jw = jmodel.compute_posteriors(x)
        _close(tp.numpy(), jp, 1e-5, "phoneme logits")
        _close(tw.numpy(), jw, 1e-5, "word logits")
        tp, tw = encoder_posteriors(tmodel, torch.from_numpy(x), lengths=torch.from_numpy(lengths).long())
        jp, jw = jenc.encoder_posteriors(jmodel.params, jmodel.arch, jnp.asarray(x), gru_impl="scan",
                                         lengths=jnp.asarray(lengths))
        _close(tp.numpy(), jp, 1e-5, "phoneme logits, length-exact")
        _close(tw.numpy(), jw, 1e-5, "word logits, length-exact")
        for n in (None, lengths):
            tf = encoder_phoneme_features(tmodel, torch.from_numpy(x),
                                          lengths=None if n is None else torch.from_numpy(n).long())
            jf = jenc.encoder_phoneme_features(jmodel.params, jmodel.arch, jnp.asarray(x), gru_impl="scan",
                                               lengths=None if n is None else jnp.asarray(n))
            _close(tf.numpy(), jf, 1e-5, "phoneme features")
        _close(tmodel.compute_features(x).numpy(), jmodel.compute_features(x), 1e-5, "features")
        for t, j in zip(tmodel(x, yp, yw), jmodel(x, yp, yw)):
            np.testing.assert_allclose(t.item(), float(j), rtol=1e-5)


def _log_rows(folder):
    with open(os.path.join(folder, "pretraining", "log.csv")) as f:
        return list(csv.DictReader(f))


def test_two_asr_epochs_match_the_jax_trainer(tmp_path):
    """Both Trainers from shared weights on the same recorded batches of the
    synthetic LibriSpeech tree (``pretraining_type`` 2, B = 8, weight-0 rows
    in the last batch): the returned 4-tuples and every ``log.csv`` metric
    within 1e-5, the columns equal (``examples_per_sec`` and the step timer's
    are wall-clock and only present). The first conv (a plain conv here: JAX's
    sinc filters have odd lengths) has an even length, 30 taps, so the
    encoder gives one frame more than the collated labels at every bucket,
    and both heads trim."""
    root = fixtures.make_asr_dataset(str(tmp_path / "asr"), n_per_split=6)
    cfg = fixtures.write_cfg(str(tmp_path / "exp.cfg"), folder=str(tmp_path / "jax"), asr_path=root,
                             pretraining_type=2, use_sincnet=False,
                             replace={"cnn_len_filt=31,3": "cnn_len_filt=30,3"})
    config = _no_dropout(jax_read_config(cfg))
    train, valid, _ = get_ASR_datasets(config)
    arch = jenc.EncoderArch.from_config(config)
    for ds in (train, valid):
        ds.loader.num_threads = 1

    def recorded(ds):  # JAX's Trainer dispatches on the dataset's class
        out = copy.copy(ds)
        out.loader = list(ds.loader)
        return out

    epochs, valid = [recorded(train) for _ in range(2)], recorded(valid)
    assert any(b["w"].min() == 0.0 for b in epochs[0].loader)
    for b in epochs[0].loader:
        t_pad = b["x"].shape[1]
        assert int(arch.num_frames(t_pad, upto="phoneme")) == b["y_phoneme"].shape[1] + 1
        assert int(arch.num_frames(t_pad)) == b["y_word"].shape[1] + 1

    jmodel = jenc.PretrainedModel(config, seed=3)
    tconfig = copy.copy(config)
    tconfig.folder = str(tmp_path / "port")
    tmodel = PretrainedModel(tconfig)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)), strict=True)
    jt, tt = JaxTrainer(jmodel, config), Trainer(tmodel, tconfig)
    for ds in epochs:
        for j, t in ((jt.train(ds), tt.train(ds)), (jt.test(valid), tt.test(valid))):
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)
    jrows, trows = _log_rows(config.folder), _log_rows(tconfig.folder)
    assert len(jrows) == len(trows) == 4
    for j, t in zip(jrows, trows):
        assert list(j) == list(t)
        assert j["set"] == t["set"]
        for k in ("phone_loss", "phone_acc", "word_loss", "word_acc"):
            assert abs(float(t[k]) - float(j[k])) <= 1e-5, (k, t[k], j[k])


@pytest.mark.parametrize("ptype", [0, 4])
def test_a_pretraining_type_without_a_loss_raises(ptype, tmp_path):
    """The port's Trainer refuses it with the JAX Trainer's message."""
    config = _make_config(str(tmp_path), small=True)
    config.pretraining_type, config.n_devices = ptype, 1
    with pytest.raises(ValueError) as jerr:
        JaxTrainer(jenc.PretrainedModel(config), config)
    with pytest.raises(ValueError) as terr:
        Trainer(PretrainedModel(config), config)
    assert str(terr.value) == str(jerr.value)
