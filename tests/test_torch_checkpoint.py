"""The port's checkpoints against the JAX package's: the param map both ways,
the ``.npz`` files each package writes and reads, the trainer state, a
resumed run, a trained model served by the other package, and the fall-backs.

Small configs (``__graft_entry__._make_config(small=True)``); dropout 0 where
runs are compared. Every comparison here is bit for bit unless it says
otherwise.
"""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from __graft_entry__ import _make_config
from tests import fixtures
from tests.test_torch_seq2seq import small_seq2seq_config
from tpu_slu import read_config as jax_read_config
from tpu_slu.models import encoder as jenc
from tpu_slu.models import slu as jslu
from tpu_slu.serving import load_trained_model as jax_load_trained_model
from tpu_slu.training import checkpoint as jckpt
from tpu_slu.training.trainer import Trainer as JaxTrainer
from tpu_slu_torch.config import read_config
from tpu_slu_torch.data.audio import read_wav
from tpu_slu_torch.models.convert import flatten, params_from_jax, params_to_jax
from tpu_slu_torch.models.encoder import PretrainedModel
from tpu_slu_torch.models.slu import Model
from tpu_slu_torch.serving import load_trained_model
from tpu_slu_torch.training import Trainer
from tpu_slu_torch.training.checkpoint import load_pytree, save_pytree


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _uni(config):
    config.phone_rnn_bidirectional = config.word_rnn_bidirectional = False
    config.intent_rnn_bidirectional = False
    return config


def _jax_tree(kind, tmp):
    """A JAX param tree of each kind the port maps."""
    if kind == "seq2seq":
        return _np(jslu.Model(small_seq2seq_config(tmp), seed=2).params)
    config = _make_config(tmp, small=True)
    if kind == "encoder":
        return _np(jenc.PretrainedModel(config, seed=2).params)
    if kind == "unidirectional":
        config = _uni(config)
    return _np(jslu.Model(config, seed=2).params)


def _assert_trees_equal(got, want):
    fg, fw = flatten(got), flatten(want)
    assert list(fg) == list(fw)
    for k, w in fw.items():
        assert fg[k].dtype == w.dtype and fg[k].shape == w.shape, k
        assert np.array_equal(fg[k], w), k


@pytest.mark.parametrize("kind", ["fixed_slot", "seq2seq", "unidirectional", "encoder"])
def test_params_to_jax_inverts_params_from_jax(kind, tmp_path):
    """``params_to_jax(params_from_jax(t)) == t`` bit for bit; the bare
    encoder tree (``pretraining/model_state.npz``) has no prefix."""
    tree = _jax_tree(kind, str(tmp_path))
    _assert_trees_equal(params_to_jax(params_from_jax(tree)), tree)
    if kind == "encoder":
        assert "pretrained_model" not in tree and "phoneme_linear" in tree


def test_each_package_reads_the_npz_the_other_writes(tmp_path):
    """Port ``save_pytree`` -> JAX ``load_pytree`` and JAX ``save_pytree`` ->
    port ``load_pytree``, equal arrays; the two files hold the same keys in
    the same (sorted) order."""
    config = _make_config(str(tmp_path), small=True)
    jmodel = jslu.Model(config, seed=1)
    tmodel = Model(config, load_pretrained=False)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_pytree(ours, params_to_jax(tmodel.state_dict()))
    jckpt.save_pytree(theirs, jmodel.params)
    _assert_trees_equal(_np(jckpt.load_pytree(ours, jmodel.params)), params_to_jax(tmodel.state_dict()))
    _assert_trees_equal(load_pytree(theirs, params_to_jax(tmodel.state_dict())), _np(jmodel.params))
    with np.load(ours) as a, np.load(theirs) as b:
        assert a.files == b.files == sorted(a.files, key=lambda k: k.split("/"))


def test_load_pytree_raises_on_a_missing_key_or_a_wrong_shape(tmp_path):
    path = str(tmp_path / "t.npz")
    save_pytree(path, {"a": np.zeros((2, 3), np.float32), "b": {"c": np.ones(4, np.float32)}})
    with pytest.raises(KeyError, match="missing key 'b/d'"):
        load_pytree(path, {"a": np.zeros((2, 3)), "b": {"d": np.zeros(4)}})
    with pytest.raises(ValueError, match="shape"):
        load_pytree(path, {"a": np.zeros((3, 2)), "b": {"c": np.zeros(4)}})


def _no_dropout(config):
    config.cnn_drop = [0.0] * len(config.cnn_drop)
    for k in ("phone_rnn_drop", "word_rnn_drop", "intent_rnn_drop"):
        setattr(config, k, [0.0] * len(getattr(config, k)))
    config.gru_impl = "scan"
    config.n_devices = 1
    return config


class _Batches:
    def __init__(self, batches):
        self.loader = batches


def _slu_batches(rng, config, n=2, B=4, T=4000):
    return [{"x": (0.1 * rng.standard_normal((B, T))).astype(np.float32),
             "y_intent": np.stack([rng.integers(0, v, B) for v in config.values_per_slot], 1).astype(np.int32),
             "w": np.array([1.0] * (B - 1) + [0.0], np.float32), "len": np.full(B, T, np.int32)}
            for _ in range(n)]


def _asr_batches(rng, config, n=2, B=4, T=4000):
    tp, tw = -(-T // config.phone_downsample_factor), -(-T // config.word_downsample_factor)
    out = []
    for _ in range(n):
        yp = rng.integers(-1, config.num_phonemes, (B, tp)).astype(np.int32)
        yw = rng.integers(-1, config.vocabulary_size, (B, tw)).astype(np.int32)
        out.append({"x": (0.1 * rng.standard_normal((B, T))).astype(np.float32), "y_phoneme": yp,
                    "y_word": yw, "w": np.array([1.0] * (B - 1) + [0.0], np.float32),
                    "len": np.full(B, T, np.int32)})
    return out


def test_trainer_state_round_trips_both_ways_in_ravel_order(tmp_path):
    """A JAX SLU Trainer's ``trainer_state.npz`` after a step, loaded by the
    port's Trainer, exports bit-equal ``opt/{m,v,step}``; the port's saved
    file, loaded by a fresh JAX Trainer, gives that state back bit-equal. Then the
    order: with every parameter's moments set to the parameter itself, the
    exported ``m`` is ``ravel_pytree`` of the JAX param tree (transposes
    included, layer "10" before "2")."""
    config = _no_dropout(_make_config(str(tmp_path / "jax"), small=True))
    config.pretraining_type, config.unfreezing_type = 2, 2  # frozen layers: steps of 0 and 1
    jmodel = jslu.Model(config, seed=1, load_pretrained=False)
    jt = JaxTrainer(jmodel, config)
    jt.train(_Batches(_slu_batches(np.random.default_rng(0), config, n=1)))
    jt.save_checkpoint()
    jstate = _np(jt.opt_state)
    assert 0 < int(jstate["step"].max()) and int(jstate["step"].min()) == 0

    tconfig = copy.copy(config)
    tmodel = Model(tconfig, load_pretrained=False)
    tt = Trainer(tmodel, tconfig)
    tt.load_checkpoint()  # the JAX run's folder
    assert tt.epoch == 1 and (tmodel.unfreezing_index, tmodel._unfrozen_count) == (
        jmodel.unfreezing_index, jmodel._unfrozen_count)
    _assert_trees_equal(tt.optimizer.export_flat(), jstate)
    _assert_trees_equal(params_to_jax(tmodel.state_dict()), _np(jmodel.params))

    tt.save_checkpoint()  # over the JAX run's files
    jt2 = JaxTrainer(jslu.Model(config, seed=5, load_pretrained=False), config)
    jt2.load_checkpoint()
    assert jt2.epoch == 1
    _assert_trees_equal(_np(jt2.opt_state), jstate)

    for p in tmodel.parameters():  # the order and the layouts
        tt.optimizer.state[p].update(step=1, m=p.detach().clone(), v=p.detach().clone())
    flat, _ = ravel_pytree(params_to_jax(tmodel.state_dict()))
    assert np.array_equal(tt.optimizer.export_flat()["m"], np.asarray(flat))
    names = [k.split("/") for k in flatten(params_to_jax(tmodel.state_dict()))]
    layers = [int(n[2]) for n in names if n[:2] == ["pretrained_model", "phoneme_layers"]]
    assert max(layers) >= 10 and layers.index(10) < layers.index(max(i for i in layers if i < 10))


@pytest.mark.parametrize("kind", ["slu", "asr"])
def test_resumed_run_equals_uninterrupted_run(kind, tmp_path):
    """Two epochs in one Trainer against one epoch, ``save_checkpoint``, a
    fresh model and Trainer, ``load_checkpoint``, one more epoch: equal
    parameters, optimizer state and second-epoch log row, bit for bit, at
    dropout 0 over the same batches (a resumed loader would reshuffle from
    ``seed + 0``, as JAX's does). The SLU run walks the ULMFiT schedule."""
    def build(folder):
        config = _no_dropout(_make_config(str(folder), small=True))
        if kind == "asr":
            config.pretraining_type = 2
            return config, PretrainedModel(config)
        config.pretraining_type, config.unfreezing_type = 2, 2
        return config, Model(config, load_pretrained=False)

    make = _asr_batches if kind == "asr" else _slu_batches
    config, model = build(tmp_path / "whole")
    data = _Batches(make(np.random.default_rng(1), config))
    whole = Trainer(model, config)
    whole.train(data)
    whole.train(data)

    config, model = build(tmp_path / "resumed")
    first = Trainer(model, config)
    first.train(data)
    first.save_checkpoint()
    config, model = build(tmp_path / "resumed")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)  # the checkpoint, not the seed, must decide
    resumed = Trainer(model, config)
    resumed.load_checkpoint()
    assert resumed.epoch == 1
    resumed.train(data)
    _assert_trees_equal(params_to_jax(resumed.model.state_dict()), params_to_jax(whole.model.state_dict()))
    _assert_trees_equal(resumed.optimizer.export_flat(), whole.optimizer.export_flat())
    if kind == "slu":
        assert (resumed.model.unfreezing_index, resumed.model._unfrozen_count) == (
            whole.model.unfreezing_index, whole.model._unfrozen_count)
    keys = [k for k in whole._rows[1] if k in ("intent_loss", "intent_acc", "phone_loss", "phone_acc",
                                                    "word_loss", "word_acc")]
    assert len(keys) in (2, 4)
    assert {k: resumed._rows[0][k] for k in keys} == {k: whole._rows[1][k] for k in keys}


@pytest.fixture(scope="module")
def fsc(tmp_path_factory):
    root = tmp_path_factory.mktemp("fsc")
    fixtures.make_slu_dataset(str(root / "data"), n_train=8, n_valid=4, n_test=4)
    return str(root / "data")


@pytest.mark.parametrize("saver", ["jax", "port"])
@pytest.mark.parametrize("seq2seq", [False, True])
def test_each_package_serves_what_the_other_saved(saver, seq2seq, fsc, tmp_path):
    """One package's Trainer saves ``training/`` (model, vocab, trainer
    state); each package's ``load_trained_model`` decodes the fixture's
    test wavs from it, and the decodes are equal."""
    cfg = fixtures.write_cfg(str(tmp_path / "exp.cfg"), folder=str(tmp_path / "exp"), slu_path=fsc,
                             seq2seq=seq2seq)
    jconfig = jax_read_config(cfg)
    fixtures.write_phonemes_txt(jconfig.folder)
    from tpu_slu.data.datasets import get_SLU_datasets

    get_SLU_datasets(jconfig)
    if saver == "jax":
        jconfig.n_devices = 1
        JaxTrainer(jslu.Model(jconfig, seed=3), jconfig).save_checkpoint()
    else:
        tconfig = read_config(cfg)
        Model.attach_vocab(tconfig, jslu.Model(jconfig, seed=3).vocab_dict())
        Trainer(Model(tconfig, seed=3), tconfig).save_checkpoint()
    files = sorted(os.listdir(os.path.join(str(tmp_path / "exp"), "training")))
    assert files == ["model_state.npz", "trainer_state.npz", "vocab.json"]
    jc, tc = jax_read_config(cfg), read_config(cfg)
    jc.seq2seq_max_decode_len = tc.seq2seq_max_decode_len = 12  # random weights: no EOS for long
    jmodel, tmodel = jax_load_trained_model(jc), load_trained_model(tc, device="cpu")
    for i in range(4):
        wav, _ = read_wav(os.path.join(fsc, "wavs", f"test_{i}.wav"))
        assert tmodel.decode_intents(wav[None, :]) == list(jmodel.decode_intents(wav[None, :]))
    with open(os.path.join(str(tmp_path / "exp"), "training", "vocab.json")) as f:
        assert json.load(f) == jmodel.vocab_dict() == tmodel.vocab_dict()


def test_starting_from_scratch(tmp_path, capsys):
    """JAX's fall-backs: no model file; a model file that does not fit (it
    keeps its own weights); a readable model but an unreadable trainer state
    (the weights load, the optimizer starts fresh). An orbax backend raises."""
    config = _no_dropout(_make_config(str(tmp_path), small=True))
    model = Model(config, load_pretrained=False)
    trainer = Trainer(model, config)
    trainer.load_checkpoint()
    assert capsys.readouterr().out == "No previous model; starting from scratch\n"

    before = params_to_jax(model.state_dict())
    other = copy.copy(config)
    other.intent_rnn_num_hidden = [5]
    save_pytree(trainer._model_ckpt, params_to_jax(Model(other, load_pretrained=False).state_dict()))
    trainer.load_checkpoint()
    assert capsys.readouterr().out.startswith("Could not load previous model; starting from scratch (")
    _assert_trees_equal(params_to_jax(model.state_dict()), before)

    saved = Model(config, seed=9, load_pretrained=False)
    save_pytree(trainer._model_ckpt, params_to_jax(saved.state_dict()))
    save_pytree(trainer._trainer_ckpt, {"opt": {"m": np.zeros(3, np.float32)}, "epoch": np.int32(4)})
    trainer.load_checkpoint()
    assert capsys.readouterr().out.startswith("Could not load trainer state; optimizer starts fresh (")
    _assert_trees_equal(params_to_jax(model.state_dict()), params_to_jax(saved.state_dict()))
    assert trainer.epoch == 0 and not trainer.optimizer.state

    config.checkpoint_backend = "orbax"
    with pytest.raises(ValueError, match="orbax"):
        Trainer(model, config)
