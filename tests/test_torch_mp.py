"""The port's model parallelism (``tpu_slu_torch.parallel``'s ``mesh`` and
``vocab``) against the JAX package, on the CPU.

The ranks run as processes of their own over gloo (``tests/torch_dp_ranks.py``);
the JAX Trainer runs here on the 8 virtual devices of ``tests/conftest.py``.
At ``model_parallel=2`` JAX's Trainer builds a (1, 2) mesh over 2 devices
and a (2, 2) mesh over 4; the port lays 2 and 4 ranks out as the same grids.
The defining property: a step on a grid of D data indices at per-index batch
B is JAX's step on its mesh at batch D B, the vocab heads column-sharded
where their width divides the model axis and the Adam state kept per leaf.
Dropout is 0 where the two are compared. Tolerances are stated where they
are used.
"""

import copy
import csv
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import fixtures
from tests.test_torch_dp import _free_port, _jax_params, _near, _no_dropout, _one_bucket, _ranks_agree
from tests.torch_dp_ranks import join, launch, start
from tpu_slu import read_config as jax_read_config
from tpu_slu.data.datasets import get_ASR_datasets as jax_ASR_datasets
from tpu_slu.data.datasets import get_SLU_datasets as jax_SLU_datasets
from tpu_slu.models import encoder as jenc
from tpu_slu.models import slu as jslu
from tpu_slu.parallel.mesh import param_shardings
from tpu_slu.training.optim import adam_init
from tpu_slu.training.trainer import Trainer as JaxTrainer
from tpu_slu_torch.config import read_config
from tpu_slu_torch.models.convert import flatten, params_to_jax
from tpu_slu_torch.models.encoder import PretrainedModel, masked_frame_ce
from tpu_slu_torch.training import Trainer
from tpu_slu_torch.training.optim import MaskedAdam

B = 4  # rows of a data index's batch
CLIP = 0.1  # gradient_clip_norm: below every step's norm here, so each step clips by the whole tree's norm


def _jax_opt(trainer) -> dict:
    return flatten(jax.tree.map(np.asarray, trainer.opt_state))


@pytest.mark.parametrize("world, mp", [(2, 2), (4, 2), (2, 3)], ids=["1x2", "2x2", "mp3-on-2"])
def test_asr_on_a_grid_equals_the_jax_trainer_and_checkpoints_go_both_ways(tmp_path, capsys, world, mp):
    """ASR at ``pretraining_type`` 2 on the synthetic LibriSpeech tree, the
    JAX loader's batches recorded once and data index d taking rows ``d::D``
    of each: at ``model_parallel`` 2, 2 ranks form a (1, 2) grid (the
    fixture's 5 phonemes: the phoneme head replicated, the word head of 8
    sharded) and 4 ranks a (2, 2) grid (6 phonemes: both heads sharded);
    ``model_parallel`` 3 on 2 ranks prints JAX's "disabled" line and trains
    as data parallelism. The epoch's and the test pass's four values within
    1e-5 and every parameter within ``PARAM_TOL`` (``test_torch_dp``) of the
    JAX Trainer's on the same layout; exactly the heads JAX's ``param_shardings`` shards are
    sharded; every rank ends with the same parameters and Adam state, bit
    for bit. Then JAX's checkpoint resumes in the port, and the port's in
    JAX, bit for bit (the per-leaf Adam state of ``adam_init`` at
    ``model_parallel`` 2, the flat one where it is disabled), and a run of
    the other form reads the model but not the trainer state, with JAX's
    line. At dropout 0.5 the ranks of a data index draw the same features,
    and data indices differ. Every step clips at ``CLIP``."""
    D = world // mp if world % mp == 0 else world
    root = fixtures.make_asr_dataset(str(tmp_path / "asr"), n_per_split=10)
    cfg = fixtures.write_cfg(str(tmp_path / "exp.cfg"), folder=str(tmp_path / "jax"), asr_path=root,
                             pretraining_type=2, use_sincnet=False,
                             replace={"cnn_len_filt=31,3": "cnn_len_filt=30,3"})
    config = _no_dropout(jax_read_config(cfg))
    config.pretraining_batch_size = D * B
    config.model_parallel, config.n_devices = mp, world
    config.gradient_clip_norm = CLIP
    train, valid, _ = jax_ASR_datasets(config)
    assert (config.num_phonemes, config.vocabulary_size) == (5, 8)
    if world == 4:
        config.num_phonemes = 6  # an even phoneme head: both heads sharded

    def recorded(ds):  # JAX's Trainer dispatches on the dataset's class
        ds.loader.num_threads = 1
        out = copy.copy(ds)
        out.loader = list(ds.loader)
        return out

    train, valid = recorded(train), recorded(valid)
    assert min(b["w"].min() for b in train.loader) == 0.0
    batches = str(tmp_path / "batches.pt")
    torch.save({"train": train.loader, "valid": valid.loader}, batches)
    jmodel = jenc.PretrainedModel(config, seed=3)
    init = str(tmp_path / "init.pt")
    torch.save(_jax_params(jmodel), init)

    capsys.readouterr()
    jt = JaxTrainer(jmodel, config)
    printed = capsys.readouterr().out
    jtrain, jtest = jt.train(train), jt.test(valid)
    jt.save_checkpoint()
    assert jt.mesh.devices.shape == (D, world // D)
    specs = flatten(jax.tree.map(lambda s: str(s.spec), param_shardings(jt.mesh, jmodel.params)))
    want_sharded = {f"{head}.{'weight' if leaf == 'w' else 'bias'}" for head, leaf in
                    (k.split("/") for k, v in specs.items() if "model" in str(v))}
    assert want_sharded == ({"word_linear.weight", "word_linear.bias"} if world == 2 and mp == 2 else
                            {f"{h}.{n}" for h in ("phoneme_linear", "word_linear") for n in ("weight", "bias")}
                            if world == 4 else set())

    out = str(tmp_path / "ranks")
    ranks = launch("asr", {"out": out, "cfg": cfg, "init": init, "batches": batches, "resume": config.folder,
                           "overrides": {"pretraining_batch_size": B, "num_phonemes": config.num_phonemes,
                                         "model_parallel": mp, "gradient_clip_norm": CLIP}}, world=world)
    mp_run = world // D
    assert [r["grid"] for r in ranks] == [(r // mp_run, r % mp_run, D, mp_run) for r in range(world)]
    with open(os.path.join(out, "rank0.log")) as f:
        log = f.read()
    if mp_run == 1:
        line = f"model_parallel={mp} disabled: {world} devices not divisible"
        assert line in printed and line in log
    _ranks_agree(ranks)
    for r in ranks:
        np.testing.assert_allclose(r["train"], jtrain, rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["test"], jtest, rtol=0, atol=1e-5)
    want = _jax_params(jmodel)
    _near(ranks[0]["params"], want)
    for r in ranks:
        assert set(r["sharded"]) == want_sharded
        for n, shape in r["local_shapes"].items():
            assert shape == ((want[n].shape[0] // mp_run,) + tuple(want[n].shape[1:]) if n in want_sharded
                             else tuple(want[n].shape)), n

    # JAX's checkpoint in the port: every rank resumes JAX's parameters and Adam state
    jopt = _jax_opt(jt)
    assert ("step/word_linear/w" in jopt) == (mp_run > 1)
    for r in ranks:
        resumed = r["resumed"]
        assert resumed["epoch"] == 1 and set(resumed["opt"]) == set(jopt)
        for k, v in jopt.items():
            np.testing.assert_array_equal(resumed["opt"][k], v, err_msg=k)
        for k, v in want.items():
            assert torch.equal(resumed["params"][k], v), k

    # the port's checkpoint in JAX, on the same layout
    rconfig = copy.copy(config)
    rconfig.folder = os.path.join(out, "rank0")
    back = JaxTrainer(jenc.PretrainedModel(rconfig, seed=9), rconfig)
    back.load_checkpoint()
    assert back.epoch == 1
    got = _jax_opt(back)
    assert set(got) == set(ranks[0]["opt"])
    for k, v in got.items():
        np.testing.assert_array_equal(v, ranks[0]["opt"][k], err_msg=k)
    for k, v in _jax_params(back.model).items():
        assert torch.equal(v, ranks[0]["params"][k]), k

    # a run of the other form (one process: model_parallel ignored) keeps the model, not the optimizer
    pconfig = read_config(cfg)
    pconfig.folder, pconfig.num_phonemes, pconfig.model_parallel = rconfig.folder, config.num_phonemes, mp
    capsys.readouterr()
    other = Trainer(PretrainedModel(pconfig), pconfig)
    other.load_checkpoint()
    printed = capsys.readouterr().out
    assert f"model_parallel={mp} ignored: single device" in printed
    assert ("Could not load trainer state; optimizer starts fresh" in printed) == (mp_run > 1)
    for k, v in other.model.state_dict().items():
        assert torch.equal(v, ranks[0]["params"][k]), k

    # dropout: one draw a data index
    for r, got in enumerate(ranks):
        first = ranks[(r // mp_run) * mp_run]["dropped"]
        assert torch.equal(got["dropped"], first)
        if r // mp_run:
            assert not torch.equal(got["dropped"], ranks[0]["dropped"])


def test_slu_epoch_on_a_1x2_grid_equals_the_jax_trainer_and_checkpoints_go_both_ways(tmp_path):
    """The fixed-slot SLU Trainer at ``model_parallel`` 2 on 2 ranks, each
    reading the whole dataset through the loader's default shard (the grid's
    one data index), frozen base (unfreezing type 2): the encoder's unused
    word head (8) is sharded, its phoneme head (5) not. The train loss to
    1e-4 relative, the accuracy to 1e-6 and every parameter within
    ``PARAM_TOL`` of the JAX Trainer's on its (1, 2) mesh; the ranks agree
    bit for bit. The checkpoint holds JAX's per-leaf Adam state: a fresh
    Trainer on each rank resumes it bit for bit, and so does the JAX
    Trainer, with the epoch and the unfreezing index."""
    root = fixtures.make_slu_dataset(str(tmp_path / "fsc"), n_train=9, n_valid=4, n_test=4, seq2seq_too=False)
    _one_bucket(root)
    cfg = fixtures.write_cfg(str(tmp_path / "exp.cfg"), folder=str(tmp_path / "jax"), slu_path=root,
                             pretraining_type=2, unfreezing_type=2)
    config = _no_dropout(jax_read_config(cfg))
    config.training_batch_size, config.model_parallel, config.n_devices = B, 2, 2
    out = str(tmp_path / "ranks")
    for folder in (config.folder, os.path.join(out, "rank0"), os.path.join(out, "rank1")):
        fixtures.write_phonemes_txt(folder)
    train, _, _ = jax_SLU_datasets(config)
    jmodel = jslu.Model(config, load_pretrained=False)
    init = str(tmp_path / "init.pt")
    torch.save(_jax_params(jmodel), init)
    ranks = launch("slu", {"out": out, "cfg": cfg, "init": init, "restart": True,
                           "overrides": {"training_batch_size": B, "model_parallel": 2}})
    ja, jl = JaxTrainer(jmodel, config).train(train)
    assert [r["n_batches"] for r in ranks] == [len(train.loader)] * 2
    assert all(r["sharded"] == ["pretrained_model.word_linear.bias", "pretrained_model.word_linear.weight"]
               for r in ranks)
    _ranks_agree(ranks)
    ta, tl = ranks[0]["train"]
    assert tl == pytest.approx(jl, rel=1e-4) and ta == pytest.approx(ja, abs=1e-6)
    _near(ranks[0]["params"], _jax_params(jmodel))
    for r in ranks:
        resumed = r["resumed"]
        assert (resumed["epoch"], resumed["unfreezing_index"]) == (1, r["unfreezing_index"])
        for k, v in r["params"].items():
            assert torch.equal(resumed["params"][k], v), k
        assert "step/pretrained_model/word_linear/w" in resumed["opt"]
        for k, v in r["opt"].items():
            np.testing.assert_array_equal(resumed["opt"][k], v, err_msg=k)

    rconfig = copy.copy(config)
    rconfig.folder = os.path.join(out, "rank0")
    back = JaxTrainer(jslu.Model(rconfig, load_pretrained=False), rconfig)
    back.load_checkpoint()
    assert (back.epoch, back.model.unfreezing_index) == (1, ranks[0]["unfreezing_index"])
    for k, v in _jax_opt(back).items():
        np.testing.assert_array_equal(v, ranks[0]["opt"][k], err_msg=k)


def test_vocab_parallel_frame_ce_equals_jax_on_the_whole_logits(tmp_path):
    """A head of 8 columns sharded over 2 ranks, its columns 1 and 5 (one on
    each rank) equal, so that many frames' maximum ties across the shards:
    the loss of each rank equals JAX's ``_masked_frame_ce`` of the whole
    logits within 1e-6 relative, and the accuracy JAX's exactly, which takes
    the lower index of a tie (``jnp.argmax``); the input's gradient on each
    rank and the rank's columns of the weight and bias gradients equal the
    port's one-process ``masked_frame_ce`` through the whole head, within
    1e-5 of each largest element."""
    ranks = launch("vocab", {"out": str(tmp_path)})
    logits = torch.cat([r["logits"] for r in ranks], -1)
    y, w = ranks[0]["y"], ranks[0]["w"]
    top = logits.max(-1).values
    tied = (logits[..., 1] == top) & (logits[..., 5] == top)
    assert tied[:2].sum() >= 3 and ((y == 5) & tied)[:2].any()
    jl, ja = jenc._masked_frame_ce(jnp.asarray(logits.numpy()), jnp.asarray(y.numpy()), jnp.asarray(w.numpy()))
    for r in ranks:
        assert float(r["loss"]) == pytest.approx(float(jl), rel=1e-6)
        assert float(r["acc"]) == float(ja)

    full = ranks[0]["full"]
    h = ranks[0]["h"].clone().requires_grad_()
    weight, bias = (full[k].clone().requires_grad_() for k in ("weight", "bias"))
    loss, _ = masked_frame_ce(torch.nn.functional.linear(h, weight, bias), y, w)
    loss.backward()

    def close(got, ref):
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()

    for r, got in enumerate(ranks):
        close(got["dh"], h.grad)
        close(got["dw"], weight.grad[4 * r:4 * (r + 1)])
        close(got["db"], bias.grad[4 * r:4 * (r + 1)])


def test_per_leaf_adam_state_has_jax_adam_init_form_and_round_trips(tmp_path):
    """``MaskedAdam.export_tree`` after two steps has the leaves, shapes and
    dtypes of JAX's ``adam_init`` state of the same param tree (a scalar
    step a leaf), and ``import_tree`` into a fresh optimizer gives back the
    same export, bit for bit; the head columns it takes through ``take``
    are the rows that ``full`` gathered."""
    root = fixtures.make_asr_dataset(str(tmp_path / "asr"), n_per_split=2)
    cfg = fixtures.write_cfg(str(tmp_path / "exp.cfg"), folder=str(tmp_path / "exp"), asr_path=root,
                             pretraining_type=2)
    config = read_config(cfg)
    config.num_phonemes = 6
    model = PretrainedModel(config)
    opt = MaskedAdam(model.named_parameters(), 1e-3)
    for _ in range(2):
        for p in model.parameters():
            p.grad = torch.randn_like(p)
        opt.step()
    tree = opt.export_tree()
    want = flatten(jax.tree.map(np.asarray, adam_init(params_to_jax(model.state_dict()))))
    got = flatten(tree)
    assert set(got) == set(want)
    for k, v in want.items():
        assert (got[k].shape, got[k].dtype) == (v.shape, v.dtype), k
    assert all(int(v) == 2 for k, v in got.items() if k.startswith("step/"))

    fresh = MaskedAdam(model.named_parameters(), 1e-3)
    fresh.import_tree(tree)
    for k, v in flatten(fresh.export_tree()).items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)
    half = MaskedAdam([("word_linear.weight", torch.nn.Parameter(model.word_linear.weight[:4].detach()))], 1e-3)
    half.import_tree({k: {"word_linear": {"w": tree[k]["word_linear"]["w"]}} for k in tree},
                     take=lambda name, t: t[:4])
    np.testing.assert_array_equal(half.export_tree()["m"]["word_linear"]["w"], tree["m"]["word_linear"]["w"][:, :4])


def test_cli_pretrains_on_a_2x2_grid(tmp_path):
    """``python -m tpu_slu_torch.cli --pretrain --device cpu`` in four
    processes with ``RANK``/``WORLD_SIZE`` and ``model_parallel=2`` in
    ``[training]``, one epoch: a (2, 2) grid over gloo, whose ranks build the
    vocabulary files at once; ``pretraining/`` holds one ``log.csv`` (a train
    and a valid row), ``model_state.npz`` with the whole heads, and
    ``trainer_state.npz`` with JAX's per-leaf Adam state, which a JAX
    Trainer at ``model_parallel=2`` on 4 devices resumes."""
    root = fixtures.make_asr_dataset(str(tmp_path / "asr"), n_per_split=6)
    folder = str(tmp_path / "exp")
    cfg = fixtures.write_cfg(str(tmp_path / "exp.cfg"), folder=folder, asr_path=root, pretraining_type=2,
                             extra="model_parallel=2\n",
                             replace={"pretraining_num_epochs=2": "pretraining_num_epochs=1"})
    out = str(tmp_path / "ranks")
    argv = [sys.executable, "-m", "tpu_slu_torch.cli", "--pretrain", "--config_path", cfg, "--device", "cpu"]
    join(start(argv, 4, out, env={"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}), out)
    pre = os.path.join(folder, "pretraining")
    assert sorted(os.listdir(pre)) == ["log.csv", "model_state.npz", "phonemes.txt", "trainer_state.npz",
                                       "words.txt"]
    with open(os.path.join(pre, "log.csv")) as f:
        assert [r["set"] for r in csv.DictReader(f)] == ["train", "valid"]
    with np.load(os.path.join(pre, "model_state.npz")) as z:
        assert z["word_linear/w"].shape == (24, 8)
    with np.load(os.path.join(pre, "trainer_state.npz")) as z:
        assert z["opt/step/word_linear/w"].shape == () and int(z["epoch"]) == 1

    config = jax_read_config(cfg)
    config.n_devices = 4
    jax_ASR_datasets(config)
    jt = JaxTrainer(jenc.PretrainedModel(config), config)
    jt.load_checkpoint()
    assert jt.mesh.devices.shape == (2, 2) and jt.epoch == 1
