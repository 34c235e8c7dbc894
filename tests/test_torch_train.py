"""The port's train step (model, masked Adam, ULMFiT walk, Trainer) vs the JAX package.

The small fixed-slot model (``__graft_entry__._make_config(small=True)``) is
built in JAX and carried into the port with ``params_from_jax``. Dropout
rates are 0, so both sides compute the same function; the JAX side takes its
``scan`` GRU (the Pallas kernels' agreement with the port's layer is checked
in ``test_torch_bigru_train.py``). Tolerances are stated where they are used.
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
from tpu_slu import read_config
from tpu_slu.data.datasets import get_SLU_datasets
from tpu_slu.models import encoder as jenc
from tpu_slu.models import slu as jslu
from tpu_slu.training.optim import adam_init, adam_update
from tpu_slu.training.trainer import Trainer as JaxTrainer
from tpu_slu_torch.models.convert import params_from_jax
from tpu_slu_torch.models.slu import Model
from tpu_slu_torch.training import MaskedAdam, Trainer, clip_grad_norm
from tpu_slu_torch.training.trainer import write_log_csv


def _no_dropout(config):
    config.cnn_drop = [0.0] * len(config.cnn_drop)
    for k in ("phone_rnn_drop", "word_rnn_drop", "intent_rnn_drop"):
        setattr(config, k, [0.0] * len(getattr(config, k)))
    config.gru_impl = "scan"
    return config


def _port_of(jmodel, config):
    tmodel = Model(config, load_pretrained=False)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)), strict=True)
    return tmodel


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    config = _no_dropout(_make_config(str(tmp_path_factory.mktemp("train")), small=True))
    jmodel = jslu.Model(config, seed=3)
    return config, jmodel, _port_of(jmodel, config)


def test_forward_loss_and_every_gradient_match_jax(pair):
    """``Model.forward(training=True)`` against ``jax.value_and_grad`` of the
    JAX Trainer's loss (``trainer.py:280-297``), frame mask and example
    weights on. Loss to 1e-5 relative; each gradient to 1e-4 of its tensor's
    largest element (f32 sums through five GRU layers in another order)."""
    config, jmodel, tmodel = pair
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4000)).astype(np.float32)
    y = np.stack([rng.integers(0, n, 3) for n in tmodel.values_per_slot], 1).astype(np.int32)
    w = np.array([1.0, 1.0, 0.0], np.float32)
    lengths = np.array([4000, 3100, 2500], np.int32)
    earch, iarch = jmodel.encoder_arch, jmodel.intent_arch
    r1, r2 = jax.random.split(jax.random.PRNGKey(0))

    def jloss(p):  # the JAX Trainer's loss_fn, train=True
        feats = jenc.encoder_features(p["pretrained_model"], earch, jnp.asarray(x), train=True,
                                      rng=r1, gru_impl="scan")
        t_out = jenc.frames_through(iarch.layers, feats.shape[1])
        fm = jslu.frame_mask_from_lengths(earch, jnp.asarray(lengths), t_out, iarch)
        logits = jslu.intent_logits(p["intent_layers"], iarch, feats, train=True, rng=r2,
                                    gru_impl="scan", frame_mask=fm)
        return jslu.intent_loss_acc(logits, jnp.asarray(y), iarch.values_per_slot, jnp.asarray(w))

    (jl, ja), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jmodel.params)
    tmodel.zero_grad(set_to_none=True)
    loss, acc = tmodel(x, y, training=True, weights=w, lengths=lengths)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert acc.item() == float(ja)
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    for name, p in tmodel.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)  # unused: JAX gives zeros
        scale = max(want[name].abs().max().item(), 1e-12)
        err = (got - want[name]).abs().max().item()
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.parametrize("unfreezing_type", [0, 1, 2])
def test_unfreeze_walk_matches_jax(unfreezing_type, tmp_path, capsys):
    """Frozen base (pretraining_type 2): at each epoch the trainable names and
    ``print_frozen`` equal the JAX Model's."""
    config = _make_config(str(tmp_path), small=True)
    config.pretraining_type, config.unfreezing_type = 2, unfreezing_type
    jmodel = jslu.Model(config, seed=0, load_pretrained=False)
    tmodel = Model(config, load_pretrained=False)
    n_walk = jslu._num_walkable(jmodel.encoder_arch, unfreezing_type)
    for _ in range(n_walk + 2):
        jmask = params_from_jax(jax.tree.map(np.asarray, jmodel.trainable_mask()))
        assert {k: float(v) for k, v in jmask.items()} == tmodel.trainable_mask()
        jmodel.print_frozen()
        want = capsys.readouterr().out
        tmodel.print_frozen()
        assert capsys.readouterr().out == want
        jmodel.unfreeze_one_layer()
        tmodel.unfreeze_one_layer()
        assert (tmodel.unfreezing_index, tmodel._unfrozen_count) == (
            jmodel.unfreezing_index, jmodel._unfrozen_count)


def test_masked_adam_matches_jax():
    """Six steps, the mask changing between them (frozen -> unfrozen and back),
    gradients clipped at global norm 1: step counts equal the JAX
    ``adam_update``'s (with the JAX Trainer's clip), m and v to f32 rounding,
    params to 1e-4 of lr per step: JAX takes the bias corrections 1 - b^t in
    float32, where 1 - 0.999^t keeps ~4 digits; the port takes them in
    double, as ``torch.optim.Adam`` does."""
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    masks = [{"a": 1, "b": 0, "c": 0}, {"a": 1, "b": 0, "c": 0}, {"a": 1, "b": 1, "c": 0},
             {"a": 0, "b": 1, "c": 1}, {"a": 1, "b": 1, "c": 1}, {"a": 1, "b": 0, "c": 1}]
    lr, clip = 0.01, 1.0

    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = adam_init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = MaskedAdam(tp.items(), lr)
    for i, mask in enumerate(masks):
        grads = {k: (rng.standard_normal(s) * (3.0 if i % 2 else 0.01)).astype(np.float32)
                 for k, s in shapes.items()}
        jg = {k: jnp.asarray(v) for k, v in grads.items()}
        gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g)) for g in jax.tree.leaves(jg)))
        jg = jax.tree.map(lambda g: g * jnp.minimum(1.0, clip / (gnorm + 1e-9)), jg)
        jp, state = adam_update(jp, jg, state, {k: float(v) for k, v in mask.items()}, lr)

        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        clip_grad_norm(tp.values(), clip)
        opt.set_mask({k: float(v) for k, v in mask.items()})
        opt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=1e-4 * lr * (i + 1))
            st = opt.state[p]
            assert st.get("step", 0) == int(state["step"][k])
            if st:  # f32 rounding of the clip scale and of m, v (1e-6 of the largest element)
                for mom in ("m", "v"):
                    want = np.asarray(state[mom][k])
                    np.testing.assert_allclose(st[mom].numpy(), want, rtol=1e-6,
                                               atol=1e-6 * np.abs(want).max())
            else:  # never unmasked yet: JAX's moments are still zero
                assert not np.asarray(state["m"][k]).any() and not np.asarray(state["v"][k]).any()


def test_log_csv_is_pandas_layout(tmp_path):
    import pandas as pd

    rows = [{"intent_loss": 1.5, "intent_acc": 0.25, "set": "train", "steps": 4, "step_ms_p50": 2.0},
            {"intent_loss": 1.25, "intent_acc": 0.5, "set": "valid"},
            {"intent_loss": 1.0, "intent_acc": 0.75, "set": "train", "steps": 4, "step_ms_p50": 3.5}]
    write_log_csv(str(tmp_path / "ours.csv"), rows)
    pd.DataFrame(rows).to_csv(str(tmp_path / "pandas.csv"))
    assert (tmp_path / "ours.csv").read_text() == (tmp_path / "pandas.csv").read_text()


class _Batches:
    """A dataset whose ``.loader`` replays recorded batches."""

    def __init__(self, batches):
        self.loader = batches


def test_two_epoch_trainer_matches_jax(tmp_path):
    """Both Trainers from shared weights, on the same recorded batches of the
    synthetic FSC fixture, frozen base with unfreezing type 2 (the walk
    unfreezes a layer after each epoch), dropout 0. Per-epoch train and valid
    loss to 1e-4 relative, accuracy equal; final parameters within 1e-4 of
    each tensor's largest element (four Adam steps of lr 3e-3 on gradients
    that agree to f32 rounding)."""
    root = fixtures.make_slu_dataset(str(tmp_path / "fsc"), n_train=16, n_valid=8, n_test=8,
                                     seq2seq_too=False)
    cfg = fixtures.write_cfg(str(tmp_path / "exp.cfg"), folder=str(tmp_path / "jax"), slu_path=root,
                             pretraining_type=2, unfreezing_type=2)
    config = _no_dropout(read_config(cfg))
    fixtures.write_phonemes_txt(config.folder)
    config.n_devices = 1
    train, valid, _ = get_SLU_datasets(config)
    epochs = [_Batches(list(train.loader)) for _ in range(2)]
    valid = _Batches(list(valid.loader))

    jmodel = jslu.Model(config, load_pretrained=False)
    tconfig = copy.copy(config)
    tconfig.folder = str(tmp_path / "port")
    tmodel = _port_of(jmodel, tconfig)
    jt, tt = JaxTrainer(jmodel, config), Trainer(tmodel, tconfig)
    for ds in epochs:
        (ja, jl), (ta, tl) = jt.train(ds), tt.train(ds)
        assert ta == pytest.approx(ja, abs=1e-6)
        assert tl == pytest.approx(jl, rel=1e-4)
        (ja, jl), (ta, tl) = jt.test(valid), tt.test(valid)
        assert ta == pytest.approx(ja, abs=1e-6)
        assert tl == pytest.approx(jl, rel=1e-4)
    want = params_from_jax(jax.tree.map(np.asarray, jmodel.params))
    for name, p in tmodel.named_parameters():
        err = (p.detach() - want[name]).abs().max().item()
        assert err <= 1e-4 * max(want[name].abs().max().item(), 1e-6), (name, err)

    def header(folder):
        with open(os.path.join(folder, "training", "log.csv")) as f:
            return next(csv.reader(f)), len(f.readlines())

    assert header(tconfig.folder) == header(config.folder)
