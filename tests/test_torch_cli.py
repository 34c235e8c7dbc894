"""``python -m tpu_slu_torch.cli`` end to end on the CPU: ``--pretrain``, then
``--train``, then ``--train --restart``, then ``--decode``, on the synthetic
FSC and LibriSpeech trees of ``tests/fixtures.py``. The files it writes are
the ones the JAX package writes, by name and by key, and the JAX package
reads them: ``load_pytree``, ``Trainer.load_checkpoint`` and
``load_trained_model``, which decodes the test wavs to the port's strings.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests import fixtures
from tpu_slu import read_config as jax_read_config
from tpu_slu.models import encoder as jenc
from tpu_slu.models import slu as jslu
from tpu_slu.serving import load_trained_model as jax_load_trained_model
from tpu_slu.training import checkpoint as jckpt
from tpu_slu.training.trainer import Trainer as JaxTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "tpu_slu_torch.cli", *args, "--device", "cpu"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The four legs, one after the other, on one experiment folder."""
    tmp = tmp_path_factory.mktemp("cli")
    fsc = fixtures.make_slu_dataset(str(tmp / "fsc"), n_train=16, n_valid=4, n_test=4, seq2seq_too=False)
    asr = fixtures.make_asr_dataset(str(tmp / "asr"), n_per_split=4)
    cfg = fixtures.write_cfg(str(tmp / "exp.cfg"), folder=str(tmp / "exp"), slu_path=fsc, asr_path=asr,
                             pretraining_type=2,
                             replace={"pretraining_num_epochs=2": "pretraining_num_epochs=1",
                                      "training_num_epochs=4": "training_num_epochs=1"})
    folder = str(tmp / "exp")
    outs = {"pretrain": _cli("--pretrain", "--config_path", cfg)}
    outs["pretrain_npz"] = _npz(os.path.join(folder, "pretraining", "model_state.npz"))
    outs["train"] = _cli("--train", "--config_path", cfg)
    outs["train_npz"] = _npz(os.path.join(folder, "training", "model_state.npz"))
    outs["restart"] = _cli("--train", "--restart", "--config_path", cfg)
    wavs = [os.path.join(fsc, "wavs", f"test_{i}.wav") for i in range(4)]
    outs["decode"] = [_cli("--decode", "--wav", w, "--config_path", cfg).strip().splitlines()[-1] for w in wavs]
    return cfg, folder, wavs, outs


def test_pretrain_writes_what_jax_reads(run):
    """``pretraining/``: the vocabulary files, ``log.csv`` with JAX's ASR
    columns, and checkpoints that JAX's ``load_pytree`` and
    ``Trainer.load_checkpoint`` read (epoch 1 back), with JAX's keys."""
    cfg, folder, _, outs = run
    pre = os.path.join(folder, "pretraining")
    assert sorted(os.listdir(pre)) == ["log.csv", "model_state.npz", "phonemes.txt", "trainer_state.npz",
                                       "words.txt"]
    assert "Getting vocabulary..." in outs["pretrain"] and "*phonemes*| train accuracy" in outs["pretrain"]
    with open(os.path.join(pre, "log.csv")) as f:
        header = f.readline().strip()
    assert header.startswith(",phone_loss,phone_acc,word_loss,word_acc,set,examples_per_sec,steps")
    config = jax_read_config(cfg)
    with open(os.path.join(pre, "phonemes.txt")) as f:
        config.num_phonemes = len([line for line in f if line.strip()])
    config.n_devices = 1
    jmodel = jenc.PretrainedModel(config)
    loaded = jckpt.load_pytree(os.path.join(pre, "model_state.npz"), jmodel.params)
    assert list(outs["pretrain_npz"]) == list(jckpt._flatten(loaded))
    trainer = JaxTrainer(jmodel, config)
    trainer.load_checkpoint()
    assert trainer.epoch == 1
    state = _npz(os.path.join(pre, "trainer_state.npz"))
    assert sorted(state) == ["epoch", "opt/m", "opt/step", "opt/v", "unfreezing_index", "unfrozen_count"]
    assert (state["opt/step"] == int(state["epoch"]) * 1).all()  # one step: 4 utterances, batch 8


def test_train_loads_the_pretrained_encoder_and_restart_resumes(run):
    """``--train`` builds the model on the pre-trained encoder (frozen at
    ``unfreezing_type`` 0, so ``training/``'s encoder layers are
    ``pretraining/``'s) and writes JAX's four files; ``--restart`` reads
    epoch 1 back and saves epoch 2; JAX's Trainer reads the result."""
    cfg, folder, _, outs = run
    train = os.path.join(folder, "training")
    assert sorted(os.listdir(train)) == ["log.csv", "model_state.npz", "trainer_state.npz", "vocab.json"]
    pre, tr = outs["pretrain_npz"], outs["train_npz"]
    layers = [k for k in pre if k.startswith(("phoneme_layers/", "word_layers/"))]
    assert layers and all(np.array_equal(tr["pretrained_model/" + k], pre[k]) for k in layers)
    assert "No previous model" not in outs["restart"] and "Could not" not in outs["restart"]
    assert int(_npz(os.path.join(train, "trainer_state.npz"))["epoch"]) == 2
    with open(os.path.join(train, "log.csv")) as f:
        assert [r["set"] for r in csv.DictReader(f)] == ["train", "valid", "test"]
    config = jax_read_config(cfg)
    with open(os.path.join(train, "vocab.json")) as f:
        jslu.Model.attach_vocab(config, json.load(f))
    config.n_devices = 1
    trainer = JaxTrainer(jslu.Model(config, load_pretrained=False), config)
    trainer.load_checkpoint()
    assert trainer.epoch == 2


def test_decode_equals_the_jax_package_on_the_trained_folder(run):
    """``--decode`` prints, for each test wav, what JAX's
    ``load_trained_model`` decodes from the same folder."""
    cfg, _, wavs, outs = run
    from tpu_slu.data.audio import read_wav

    jmodel = jax_load_trained_model(jax_read_config(cfg))
    want = [str(jmodel.decode_intents(read_wav(w)[0][None, :])[0]) for w in wavs]
    assert outs["decode"] == want


def test_files_match_the_jax_trainers_by_name_and_key(run, tmp_path):
    """The JAX Trainer's ``save_checkpoint`` on models of the same config
    writes the same files with the same keys and shapes."""
    cfg, folder, _, _ = run
    config = jax_read_config(cfg)
    config.folder = str(tmp_path / "jax")
    config.n_devices = 1
    with open(os.path.join(folder, "training", "vocab.json")) as f:
        vocab = json.load(f)
    jslu.Model.attach_vocab(config, vocab)
    JaxTrainer(jenc.PretrainedModel(config), config).save_checkpoint()
    JaxTrainer(jslu.Model(config, load_pretrained=False), config).save_checkpoint()
    for sub in ("pretraining", "training"):
        for name in ("model_state.npz", "trainer_state.npz"):
            ours, theirs = _npz(os.path.join(folder, sub, name)), _npz(os.path.join(config.folder, sub, name))
            assert list(ours) == list(theirs), (sub, name)
            assert {k: (v.shape, v.dtype) for k, v in ours.items()} == {
                k: (v.shape, v.dtype) for k, v in theirs.items()}, (sub, name)
    with open(os.path.join(config.folder, "training", "vocab.json")) as f:
        assert json.load(f) == vocab
