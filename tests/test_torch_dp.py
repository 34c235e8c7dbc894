"""The port's data parallelism (``tpu_slu_torch.parallel``) against the JAX package, on the CPU.

Two ranks run as processes of their own (``tests/torch_dp_ranks.py``: torch
and the port only, a gloo group through a ``file://`` rendezvous, an init
and a join timeout); the JAX references run here. The defining property: a
step on W ranks at per-rank batch B is the single-device step on the union
of their batches, so a 2-rank epoch at B equals the JAX Trainer's epoch at
2B on the same dataset. Dropout is 0 but where named. The data keep every
batch in one wave bucket: the train path runs the encoder unmasked, so a
rank whose batch padded to a shorter bucket than the global batch would see
other features (the JAX package's hosts have the same property).
Tolerances are stated where they are used.
"""

import copy
import csv
import glob
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests import fixtures
from tests.torch_dp_ranks import golden_dataset, golden_seq2seq, join, launch, start
from tpu_slu import read_config as jax_read_config
from tpu_slu.data.datasets import get_ASR_datasets as jax_ASR_datasets
from tpu_slu.data.datasets import get_SLU_datasets as jax_SLU_datasets
from tpu_slu.data.loader import BatchLoader as JaxBatchLoader
from tpu_slu.models import encoder as jenc
from tpu_slu.models import slu as jslu
from tpu_slu.training.trainer import Trainer as JaxTrainer
from tpu_slu.training.trainer import _all_hosts_sum
from tpu_slu_torch.config import read_config
from tpu_slu_torch.data.audio import read_wav, write_wav
from tpu_slu_torch.data.datasets import get_SLU_datasets
from tpu_slu_torch.models.convert import params_from_jax
from tpu_slu_torch.models.encoder import encoder_features
from tpu_slu_torch.models.slu import Model
from tpu_slu_torch.ops import _build
from tpu_slu_torch.parallel import all_hosts_sum
from tpu_slu_torch.training import Trainer

B = 4  # per-rank batch; the JAX Trainer takes 2B
PARAM_TOL = 1e-4  # of each tensor's largest element: Adam steps on gradients equal to f32 rounding
KEY_BIAS = "decoder.attention.key_linear.bias"  # its gradient is rounding noise (test_torch_seq2seq_train)


def _no_dropout(config):
    config.cnn_drop = [0.0] * len(config.cnn_drop)
    for k in ("phone_rnn_drop", "word_rnn_drop", "intent_rnn_drop"):
        setattr(config, k, [0.0] * len(getattr(config, k)))
    config.seq2seq_dropout = 0.0
    config.gru_impl = "scan"
    config.n_devices = 1
    return config


def _one_bucket(root: str, n_max: int = 7600) -> None:
    """Cut every wav of an FSC fixture to at most 0.475 s: every batch, a
    rank's or the global one, pads to the one 8000-sample bucket."""
    for path in glob.glob(os.path.join(root, "wavs", "*.wav")):
        x, fs = read_wav(path)
        write_wav(path, x[:n_max], fs)


def _jax_params(jmodel) -> dict:
    return params_from_jax(jax.tree.map(np.asarray, jmodel.params))


def _rows(folder: str) -> list[dict]:
    with open(os.path.join(folder, "training", "log.csv")) as f:
        return list(csv.DictReader(f))


def _ranks_agree(ranks) -> None:
    """Every rank ends the epoch with rank 0's parameters and Adam state, bit for bit."""
    for other in ranks[1:]:
        for k, v in ranks[0]["params"].items():
            assert torch.equal(v, other["params"][k]), k
        for k, v in ranks[0]["opt"].items():
            np.testing.assert_array_equal(v, other["opt"][k], err_msg=k)
        assert other["modules"] == [], other["modules"]


def _near(params: dict, want: dict, skip=()) -> None:
    for name, p in params.items():
        if name not in skip:
            err = (p - want[name]).abs().max().item()
            assert err <= PARAM_TOL * max(want[name].abs().max().item(), 1e-6), (name, err)


@pytest.mark.parametrize("pcount", [1, 3])
def test_all_hosts_sum_matches_jax(pcount):
    """The same fake allgather (host p holds (p + 1) x the local scalars)
    through both: equal sums, in float64 here; at one process both return
    the scalars themselves."""

    def fake_allgather(stacked):
        local = np.asarray(stacked)
        return np.stack([(p + 1) * local for p in range(pcount)])

    vals = [1.0, 10.0, 0.5]
    got = all_hosts_sum(vals, process_count=pcount, allgather=fake_allgather)
    want = _all_hosts_sum(vals, process_count=pcount, allgather=fake_allgather)
    np.testing.assert_allclose(got, want, rtol=1e-7)
    if pcount == 1:
        assert got is vals and want is vals


def test_all_hosts_sum_refuses_a_gather_without_the_host_axis():
    def bad(stacked):
        return np.asarray(stacked)

    with pytest.raises(AssertionError):
        _all_hosts_sum([1.0], process_count=2, allgather=bad)
    with pytest.raises(ValueError, match="expected"):
        all_hosts_sum([1.0], process_count=2, allgather=bad)


def _slu_case(tmp_path, n_train: int, seq2seq: bool, unfreezing_type: int):
    """(JAX config at batch 2B with its dataset and model, the cfg, the
    init file, the ranks' directory) on a one-bucket FSC fixture."""
    root = fixtures.make_slu_dataset(str(tmp_path / "fsc"), n_train=n_train, n_valid=4, n_test=4,
                                     seq2seq_too=seq2seq)
    _one_bucket(root)
    cfg = fixtures.write_cfg(str(tmp_path / "exp.cfg"), folder=str(tmp_path / "jax"), slu_path=root,
                             seq2seq=seq2seq, pretraining_type=2, unfreezing_type=unfreezing_type)
    config = _no_dropout(jax_read_config(cfg))
    config.training_batch_size = 2 * B
    out = str(tmp_path / "ranks")
    for folder in (config.folder, os.path.join(out, "rank0"), os.path.join(out, "rank1")):
        fixtures.write_phonemes_txt(folder)
    train, _, _ = jax_SLU_datasets(config)
    jmodel = jslu.Model(config, load_pretrained=False)
    init = str(tmp_path / "init.pt")
    torch.save(_jax_params(jmodel), init)
    return config, train, jmodel, cfg, init, out


def test_two_rank_fixed_slot_epoch_equals_the_jax_trainer_at_twice_the_batch(tmp_path):
    """21 examples: each rank's shard holds 11, rank 1's last batch a wrapped
    duplicate of weight 0, and the global batches are the JAX Trainer's at
    2B = 8 (8, 8 and 5 examples). Frozen base (unfreezing type 2). The train
    row of ``log.csv`` (loss to 1e-4 relative, accuracy to 1e-6) and every
    parameter after the epoch (``PARAM_TOL``) equal the JAX Trainer's; the
    ranks agree bit for bit; only rank 0 wrote ``log.csv`` and the
    checkpoints; a fresh Trainer on each rank resumes from them to the state
    a one-process Trainer resumes to, bit for bit."""
    config, train, jmodel, cfg, init, out = _slu_case(tmp_path, 21, seq2seq=False, unfreezing_type=2)
    assert len(train) % (2 * B) and len(train) % 2  # the last step is short and carries a duplicate
    ranks = launch("slu", {"out": out, "cfg": cfg, "init": init, "restart": True,
                           "overrides": {"training_batch_size": B}})
    ja, jl = JaxTrainer(jmodel, config).train(train)
    assert [r["n_batches"] for r in ranks] == [3, 3]
    _ranks_agree(ranks)
    ta, tl = ranks[0]["train"]
    assert tl == pytest.approx(jl, rel=1e-4) and ta == pytest.approx(ja, abs=1e-6)
    row = _rows(os.path.join(out, "rank0"))[0]
    assert row["set"] == "train" and float(row["intent_loss"]) == pytest.approx(tl, rel=1e-12)
    assert float(row["intent_acc"]) == pytest.approx(ta, abs=1e-12)
    _near(ranks[0]["params"], _jax_params(jmodel))

    assert sorted(os.listdir(os.path.join(out, "rank0", "training"))) == [
        "log.csv", "model_state.npz", "trainer_state.npz", "vocab.json"]
    assert os.listdir(os.path.join(out, "rank1", "training")) == []
    pconfig = read_config(cfg)
    pconfig.folder = os.path.join(out, "rank0")
    get_SLU_datasets(pconfig)
    single = Trainer(Model(pconfig, seed=5, load_pretrained=False), pconfig)
    single.load_checkpoint()
    for r in ranks:
        resumed = r["resumed"]
        assert (resumed["epoch"], resumed["unfreezing_index"]) == (1, single.model.unfreezing_index)
        for k, v in single.model.state_dict().items():
            assert torch.equal(resumed["params"][k], v) and torch.equal(r["params"][k], v), k
        for k, v in single.optimizer.export_flat().items():
            np.testing.assert_array_equal(resumed["opt"][k], v, err_msg=k)
            np.testing.assert_array_equal(r["opt"][k], v, err_msg=k)


def test_two_rank_seq2seq_epoch_equals_the_jax_trainer_at_twice_the_batch(tmp_path):
    """13 examples (global batches of 8 and 5, each rank's last of 3 with a
    duplicate of weight 0), every label 8 steps long (the loss pads each
    batch's targets to its longest), frozen base with unfreezing type 1: the
    train loss to 1e-4 relative and every parameter within ``PARAM_TOL``
    of the JAX Trainer's, but the key bias, whose gradient is rounding
    noise that Adam normalises (within steps x lr); the ranks agree bit for
    bit."""
    config, train, jmodel, cfg, init, out = _slu_case(tmp_path, 13, seq2seq=True, unfreezing_type=1)
    ranks = launch("slu", {"out": out, "cfg": cfg, "init": init,
                           "overrides": {"training_batch_size": B, "seq2seq_dropout": 0.0}})
    ja, jl = JaxTrainer(jmodel, config).train(train)
    _ranks_agree(ranks)
    ta, tl = ranks[0]["train"]
    assert ta == ja == 0.0 and tl == pytest.approx(jl, rel=1e-4)
    want = _jax_params(jmodel)
    _near(ranks[0]["params"], want, skip=(KEY_BIAS,))
    steps = ranks[0]["n_batches"]
    assert (ranks[0]["params"][KEY_BIAS] - want[KEY_BIAS]).abs().max().item() <= steps * config.training_lr


def test_two_rank_asr_epoch_equals_the_jax_trainer_at_twice_the_batch(tmp_path):
    """ASR at ``pretraining_type`` 2 on the synthetic LibriSpeech tree: the
    JAX loader's batches of 2B = 8 recorded once (its crops are random), rank
    r taking rows ``r::2`` of each, as its shard would; the ranks' valid
    frames differ, and the last batch has weight-0 rows. The epoch's and the
    test pass's four values within 1e-5 and every parameter within
    ``PARAM_TOL`` of the JAX Trainer's; the ranks agree bit for bit."""
    root = fixtures.make_asr_dataset(str(tmp_path / "asr"), n_per_split=10)
    cfg = fixtures.write_cfg(str(tmp_path / "exp.cfg"), folder=str(tmp_path / "jax"), asr_path=root,
                             pretraining_type=2, use_sincnet=False,
                             replace={"cnn_len_filt=31,3": "cnn_len_filt=30,3"})
    config = _no_dropout(jax_read_config(cfg))
    config.pretraining_batch_size = 2 * B
    train, valid, _ = jax_ASR_datasets(config)

    def recorded(ds):  # JAX's Trainer dispatches on the dataset's class
        ds.loader.num_threads = 1
        out = copy.copy(ds)
        out.loader = list(ds.loader)
        return out

    train, valid = recorded(train), recorded(valid)
    assert min(b["w"].min() for b in train.loader) == 0.0
    out = str(tmp_path / "ranks")
    batches = str(tmp_path / "batches.pt")
    torch.save({"train": train.loader, "valid": valid.loader}, batches)
    jmodel = jenc.PretrainedModel(config, seed=3)
    init = str(tmp_path / "init.pt")
    torch.save(_jax_params(jmodel), init)
    ranks = launch("asr", {"out": out, "cfg": cfg, "init": init, "batches": batches,
                           "overrides": {"pretraining_batch_size": B, "num_phonemes": config.num_phonemes}})
    jt = JaxTrainer(jmodel, config)
    jtrain, jtest = jt.train(train), jt.test(valid)
    _ranks_agree(ranks)
    assert any(a[1:] != b[1:] for a, b in zip(*(r["counts"] for r in ranks)))  # unequal valid frames
    for r in ranks:
        np.testing.assert_allclose(r["train"], jtrain, rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["test"], jtest, rtol=0, atol=1e-5)
    _near(ranks[0]["params"], _jax_params(jmodel))


def test_group_shards_refusals_dropout_and_dp_inference(tmp_path):
    """In a 2-rank group: (1) ``BatchLoader`` without a shard takes the
    rank's and the world's, equal to the JAX loader's at that
    ``process_index``/``process_count`` over two epochs, weights included,
    and explicit arguments win; (2) the Trainer refuses ``data_parallel``
    False and ``n_devices`` 3, ``train_step`` refuses a batch without its
    global totals, and at ``model_parallel`` 2 the Trainer lays the two
    ranks out as a (1, 2) grid, whose one data index reads every batch; (3) at dropout 0.5 the
    ranks' encoder features of one input differ, and rank 0's equal a
    one-process Trainer's at the same seed bit for bit; (4) ``dp_infer``
    decodes the golden seq2seq wavs to ``expected.json`` and to the
    one-process decode, and its gathered features are the one-process
    features (to 1e-5 of the largest); (5) a 2-rank ``Trainer.test`` of the
    golden model at ``decode_acc_from_epoch`` 0 has accuracy 1 and the
    one-process test's loss at batch 2B, to 1e-5 relative."""
    out = str(tmp_path / "ranks")
    ranks = launch("group", {"out": out, "n": 10, "batch": 2})

    def collate(items):
        return {"i": np.asarray(items), "w": np.ones(len(items), np.float32)}

    for r, got in enumerate(ranks):
        assert (got["rank"], got["world"]) == (r, 2)
        jloader = JaxBatchLoader(list(range(10)), 3, collate, seed=5, process_index=r, process_count=2)
        want = [[(b["i"].tolist(), b["w"].tolist()) for b in jloader] for _ in range(2)]
        assert got["loader"] == want
        assert got["explicit"] == [b["i"].tolist() for b in JaxBatchLoader(
            list(range(10)), 3, collate, seed=5, process_index=0, process_count=1)]
        assert set(got["refusals"]) == {"data_parallel", "n_devices", "totals"}
        assert "host_all_reduce" in got["refusals"]["totals"]
        assert got["grid"] == (0, r, 1, 2) and got["grid_loader"] == got["explicit"]
        assert "--nproc_per_node=3" in got["refusals"]["n_devices"]
        assert got["modules"] == []

    config, model, wavs, semantics = golden_seq2seq(str(tmp_path / "single"), batch=4)
    drop = copy.copy(config)
    drop.cnn_drop, drop.phone_rnn_drop, drop.word_rnn_drop = [0.5] * 2, [0.5] * 2, [0.5] * 2
    dmodel = Model(drop, seed=0, load_pretrained=False)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 6000)).astype(np.float32))
    single = encoder_features(dmodel.pretrained_model, x, train=True, generator=Trainer(dmodel, drop).generator)
    assert torch.equal(ranks[0]["dropped"], single)
    assert not torch.equal(ranks[1]["dropped"][0], ranks[0]["dropped"][0])

    from tpu_slu_torch.data.loader import pad_wave_batch

    xb, _, lengths = pad_wave_batch(wavs, len(wavs), 8000)
    assert model.decode_intents(xb, lengths=lengths) == semantics
    features = model.pretrained_model.compute_features(xb)
    acc, loss = Trainer(model, config).test(golden_dataset(model, wavs, semantics, 4))
    assert acc == 1.0
    for got in ranks:
        assert got["decoded"] == semantics
        assert (got["features"] - features).abs().max().item() <= 1e-5 * features.abs().max().item()
        assert got["test"][0] == 1.0 and got["test"][1] == pytest.approx(loss, rel=1e-5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_trains_on_two_ranks_and_each_traces_its_first_epoch(tmp_path):
    """``python -m tpu_slu_torch.cli --train --device cpu`` in two processes
    with ``RANK``/``WORLD_SIZE`` and an ``env://`` rendezvous, one epoch,
    ``profile_dir`` set: one ``log.csv`` (train, valid, test rows, the
    train row with ``step_ms_p50`` and ``examples_per_sec``), the
    checkpoints, and one trace of the train pass for each rank (the valid
    and test passes after it are not traced, as in the JAX Trainer)."""
    root = fixtures.make_slu_dataset(str(tmp_path / "fsc"), n_train=9, n_valid=4, n_test=4, seq2seq_too=False)
    profile = str(tmp_path / "profile")
    cfg = fixtures.write_cfg(str(tmp_path / "exp.cfg"), folder=str(tmp_path / "exp"), slu_path=root,
                             extra=f"profile_dir={profile}\n",
                             replace={"training_num_epochs=4": "training_num_epochs=1"})
    out = str(tmp_path / "ranks")
    argv = [sys.executable, "-m", "tpu_slu_torch.cli", "--train", "--config_path", cfg, "--device", "cpu"]
    join(start(argv, 2, out, env={"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}), out)
    assert sorted(os.listdir(tmp_path / "exp" / "training")) == [
        "log.csv", "model_state.npz", "trainer_state.npz", "vocab.json"]
    rows = _rows(str(tmp_path / "exp"))
    assert [r["set"] for r in rows] == ["train", "valid", "test"]
    assert float(rows[0]["step_ms_p50"]) > 0 and float(rows[0]["examples_per_sec"]) > 0
    assert sorted(os.listdir(profile)) == [f"rank{r}.train.pt.trace.json" for r in (0, 1)]
    for path in glob.glob(os.path.join(profile, "*.json")):
        with open(path) as f:
            assert json.load(f)["traceEvents"], path


STUB_NVCC = r"""#!{python}
import sys, time
with open({log!r}, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\n")
time.sleep(1.0)
open(sys.argv[sys.argv.index("-o") + 1], "w").close()
"""

BUILD = r"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location("_build", sys.argv[1])
b = importlib.util.module_from_spec(spec)
spec.loader.exec_module(b)
b.BUILD_DIR, b._nvcc = sys.argv[2], lambda: sys.argv[3]
print(b.build())
"""


def test_processes_that_build_at_once_compile_once(tmp_path):
    """Two processes call ``_build.build()`` together, ``nvcc`` a stub that
    logs each call and takes a second: one set of compiles runs (one per
    ``.cu`` source and one link), and both return the same library."""
    log, stub = str(tmp_path / "calls.log"), tmp_path / "nvcc"
    stub.write_text(STUB_NVCC.format(python=sys.executable, log=log))
    stub.chmod(0o755)
    argv = [sys.executable, "-c", BUILD, _build.__file__, str(tmp_path / "build"), str(stub)]
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE, text=True) for _ in range(2)]
    paths = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    with open(log) as f:
        calls = f.read().splitlines()
    n_cu = len(glob.glob(os.path.join(_build.CSRC, "*.cu")))
    assert sum(" -c " in c for c in calls) == n_cu and sum("-shared" in c for c in calls) == 1, calls
    assert paths[0] == paths[1] and os.path.isfile(paths[0])
