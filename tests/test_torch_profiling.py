"""``profile_dir`` in the port: ``utils/profiling.py`` ``profile_trace`` and the Trainer's first-epoch traces.

The JAX Trainer traces its first epoch's train pass into the config's
``profile_dir`` with ``jax.profiler`` (``tpu_slu/training/trainer.py``
``_train_asr``, ``_train_slu``) and no test pass; the port writes a
``torch.profiler`` Chrome trace of the same pass, one file a rank. On the CPU the
trace holds the CPU activity (a card run adds the kernels: ``chip_smoke.py``
phase 13). The small fixed-slot model of ``__graft_entry__._make_config``.
"""

import csv
import json
import os

import numpy as np
import pytest

from __graft_entry__ import _make_config
from tpu_slu.utils.profiling import profile_trace as jax_profile_trace
from tpu_slu_torch.models.slu import Model
from tpu_slu_torch.training import Trainer
from tpu_slu_torch.training import trainer as trainer_module
from tpu_slu_torch.utils import profiling
from tpu_slu_torch.utils.profiling import StepTimer, profile_trace


@pytest.mark.parametrize("logdir", [None, ""])
def test_a_falsy_logdir_traces_nothing(logdir, tmp_path, monkeypatch):
    """Both packages' ``profile_trace`` are no-ops for a falsy directory."""
    monkeypatch.chdir(tmp_path)
    ran = []
    with jax_profile_trace(logdir):
        ran.append("jax")
    with profile_trace(logdir, "train") as prof:
        ran.append("port")
    assert ran == ["jax", "port"] and prof is None
    assert os.listdir(tmp_path) == []


def test_a_trace_is_a_chrome_trace_named_by_rank_and_pass(tmp_path):
    import torch

    with profile_trace(str(tmp_path / "p"), "valid"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.listdir(tmp_path / "p") == ["rank0.valid.pt.trace.json"]
    with open(tmp_path / "p" / "rank0.valid.pt.trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_the_step_timer_moved_and_is_re_exported():
    assert trainer_module.StepTimer is profiling.StepTimer is StepTimer


class _Batches:
    def __init__(self, batches):
        self.loader = batches


def test_the_trainer_traces_epoch_0s_passes_and_not_epoch_1s(tmp_path):
    """A test before any training, then two epochs of train and test, on a
    CPU Trainer with ``profile_dir``: epoch 0's train pass writes the one
    trace, no test pass writes one (as in the JAX Trainer, whose
    ``profile_trace`` wraps only the train loops), epoch 1 writes none
    (epoch 0's file stays as it was), and ``log.csv`` keeps
    ``step_ms_p50`` and ``examples_per_sec``."""
    config = _make_config(str(tmp_path / "exp"), small=True)
    config.profile_dir = str(tmp_path / "profile")
    os.makedirs(config.folder, exist_ok=True)
    model = Model(config, load_pretrained=False)
    rng = np.random.default_rng(0)
    data = _Batches([{"x": rng.standard_normal((2, 4000)).astype(np.float32),
                      "y_intent": np.zeros((2, len(model.values_per_slot)), np.int64),
                      "w": np.ones(2, np.float32), "len": np.full(2, 4000)} for _ in range(2)])
    trainer = Trainer(model, config)
    trainer.test(data)
    assert not os.path.exists(config.profile_dir)
    trainer.train(data)
    trainer.test(data)
    names = ["rank0.train.pt.trace.json"]
    assert sorted(os.listdir(config.profile_dir)) == names
    stamps = {n: os.stat(os.path.join(config.profile_dir, n)).st_mtime_ns for n in names}
    trainer.train(data)
    trainer.test(data)
    assert sorted(os.listdir(config.profile_dir)) == names
    assert stamps == {n: os.stat(os.path.join(config.profile_dir, n)).st_mtime_ns for n in names}
    with open(os.path.join(config.folder, "training", "log.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["set"] for r in rows] == ["valid", "train", "valid", "train", "valid"]
    for r in rows[1::2]:
        assert float(r["step_ms_p50"]) > 0 and float(r["examples_per_sec"]) > 0
