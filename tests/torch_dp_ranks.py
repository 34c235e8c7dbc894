"""The rank processes of the port's data- and model-parallel tests
(``tests/test_torch_dp.py``, ``tests/test_torch_mp.py``).

A rank is a fresh interpreter, ``python -m tests.torch_dp_ranks <case>
<args.json>``, started with ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` as
``torchrun`` sets them; it joins a gloo group on the CPU through a
``file://`` rendezvous under the test's directory (a fixed port would
collide between test workers) and writes what it computed to
``<out>/rank<r>.pt``. This module imports torch and the port only, never
jax or ``tpu_slu``: the JAX references run in the test process.
"""

from __future__ import annotations

import copy
import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIT_TIMEOUT = datetime.timedelta(seconds=90)  # the group's: joining it and each collective
JOIN_TIMEOUT = 300.0  # seconds a test waits for all its ranks to exit


def start(argv, world: int, out: str, env: dict | None = None) -> list[subprocess.Popen]:
    """Start ``world`` processes of ``argv`` in the repo's root, rank r's
    output in ``<out>/rank<r>.log``."""
    os.makedirs(out, exist_ok=True)
    procs = []
    for r in range(world):
        penv = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        penv.update({"RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r), "OMP_NUM_THREADS": "2"},
                    **(env or {}))
        log = open(os.path.join(out, f"rank{r}.log"), "w")
        procs.append(subprocess.Popen(argv, cwd=REPO, env=penv, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def join(procs: list[subprocess.Popen], out: str, timeout: float = JOIN_TIMEOUT) -> None:
    """Wait for every process; raise, after killing the others, as soon as
    one fails or the time is up (a rank that skipped a collective leaves the
    rest waiting)."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        logs = []
        for r in range(len(procs)):
            with open(os.path.join(out, f"rank{r}.log")) as f:
                logs.append(f"--- rank {r} (exit {codes[r]}) ---\n{f.read()[-4000:]}")
        raise AssertionError("ranks failed or timed out:\n" + "\n".join(logs))


def launch(case: str, args: dict, world: int = 2) -> list[dict]:
    """Run ``case`` on ``world`` ranks (``args["out"]`` their directory) and
    return each rank's results."""
    out = args["out"]
    os.makedirs(out, exist_ok=True)
    args = {**args, "rdv": os.path.join(out, f"{case}.rendezvous")}
    if os.path.exists(args["rdv"]):
        os.remove(args["rdv"])
    path = os.path.join(out, f"{case}.json")
    with open(path, "w") as f:
        json.dump(args, f)
    join(start([sys.executable, "-m", "tests.torch_dp_ranks", case, path], world, out), out)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(world)]


# -- the ranks ------------------------------------------------------------------


class Batches:
    """A dataset whose ``.loader`` replays batches."""

    def __init__(self, batches):
        self.loader = batches


def _state(trainer) -> dict:
    """The model's parameters (heads whole) and the optimizer's state as the
    checkpoint holds it, ``/``-flattened: ``m``, ``v``, ``step`` at
    ``model_parallel`` 1, ``m/<path>`` ... above it."""
    from tpu_slu_torch.models.convert import flatten

    return {"params": {k: v.detach().clone() for k, v in trainer.full_state_dict().items()},
            "opt": flatten(trainer.optimizer_state()), "epoch": trainer.epoch,
            "unfreezing_index": getattr(trainer.model, "unfreezing_index", 0)}


def _config(args: dict, folder: str):
    from tpu_slu_torch.config import read_config

    config = read_config(args["cfg"])
    config.folder = folder
    for k, v in args.get("overrides", {}).items():
        setattr(config, k, v)
    return config


def case_slu(args: dict, r: int) -> dict:
    """One epoch of the SLU Trainer on this rank's shard of the config's
    dataset (the loader's default shard), from the weights in
    ``args["init"]`` (rank 0's, broadcast by the Trainer; the other ranks
    start from other seeds); then, with ``args["restart"]``, a fresh
    Trainer on each rank that resumes from rank 0's checkpoint."""
    from tpu_slu_torch.data.datasets import get_SLU_datasets
    from tpu_slu_torch.models.slu import Model
    from tpu_slu_torch.training import Trainer

    config = _config(args, os.path.join(args["out"], f"rank{r}"))
    train, _, _ = get_SLU_datasets(config)
    model = Model(config, seed=100 + r, load_pretrained=False)
    if r == 0:
        model.load_state_dict(torch.load(args["init"]), strict=True)
    trainer = Trainer(model, config)
    out = {"train": trainer.train(train), **_state(trainer), "n_batches": len(train.loader),
           "sharded": sorted(trainer.sharded)}
    if args.get("restart"):
        trainer.save_checkpoint()
        rconfig = copy.copy(config)
        rconfig.folder = os.path.join(args["out"], "rank0")
        resumed = Trainer(Model(rconfig, seed=200 + r, load_pretrained=False), rconfig)
        resumed.load_checkpoint()
        out["resumed"] = _state(resumed)
    return out


def case_asr(args: dict, r: int) -> dict:
    """One ASR epoch and a test pass on rank r's rows ``[d::D]`` of each
    recorded global batch, d its data index and D the data size (the rows
    the loader's shard gives the rank; at ``model_parallel`` 1, ``[r::world]``).
    With ``args["resume"]`` (``model_parallel`` > 1): also the grid, the
    sharded parameters and their local shapes, the checkpoint written, a
    fresh Trainer resumed from the folder ``args["resume"]``, and the
    encoder features of one input at dropout 0.5 under the Trainer's generator."""
    from tpu_slu_torch.models.encoder import PretrainedModel, encoder_features
    from tpu_slu_torch.training import Trainer

    config = _config(args, os.path.join(args["out"], f"rank{r}"))
    model = PretrainedModel(config, generator=torch.Generator().manual_seed(100 + r))
    if r == 0:
        model.load_state_dict(torch.load(args["init"]), strict=True)
    trainer = Trainer(model, config)
    d, D = trainer.grid.data_index, trainer.grid.data_size
    recorded = torch.load(args["batches"], weights_only=False)
    mine = {k: [{n: a[d::D] for n, a in b.items()} for b in v] for k, v in recorded.items()}
    out = {"train": trainer.train(Batches(mine["train"])), **_state(trainer)}
    out["test"] = trainer.test(Batches(mine["valid"]))
    out["counts"] = [trainer.counts(b).tolist() for b in mine["train"]]
    if args.get("resume"):
        g = trainer.grid
        out["grid"] = (g.data_index, g.model_index, g.data_size, g.model_parallel)
        out["sharded"] = sorted(trainer.sharded)
        out["local_shapes"] = {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}
        trainer.save_checkpoint()
        rconfig = copy.copy(config)
        rconfig.folder = args["resume"]
        resumed = Trainer(PretrainedModel(rconfig, generator=torch.Generator().manual_seed(200 + r)), rconfig)
        resumed.load_checkpoint()
        out["resumed"] = _state(resumed)
        drop = copy.copy(config)
        drop.cnn_drop, drop.phone_rnn_drop, drop.word_rnn_drop = [0.5] * 2, [0.5] * 2, [0.5] * 2
        dtrainer = Trainer(PretrainedModel(drop), drop)
        x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 6000)).astype(np.float32))
        out["dropped"] = encoder_features(dtrainer.model, x, train=True, generator=dtrainer.generator)
    return out


def case_vocab(args: dict, r: int) -> dict:
    """The vocabulary-parallel frame loss of a head (6 -> 8) column-sharded
    over every rank: this rank's logits, the loss and the accuracy, and the
    gradients of the input and of the rank's columns. Columns 1 and 5 (one
    in each half) are equal and large, so that many frames' maximum is a
    tie across the shards; labels 1 and 5 are frequent, and row 2 has
    weight 0."""
    from torch import nn

    from tpu_slu_torch import parallel
    from tpu_slu_torch.parallel.vocab import ColumnParallelLinear, vocab_parallel_frame_ce

    grid = parallel.make_grid(parallel.world())
    gen = torch.Generator().manual_seed(0)
    full = nn.Linear(6, 8)
    with torch.no_grad():
        full.weight.copy_(torch.randn(8, 6, generator=gen))
        full.bias.copy_(torch.randn(8, generator=gen))
        full.weight[1] *= 3.0
        full.weight[5], full.bias[5] = full.weight[1], full.bias[1]
    head = ColumnParallelLinear(full, grid.model_parallel, grid.model_index, grid.model_group)
    h = torch.randn(3, 7, 6, generator=gen).requires_grad_()
    y = torch.randint(-1, 8, (3, 7), generator=gen)
    y[:, ::3], y[:, 1::3] = 5, 1
    w = torch.tensor([1.0, 1.0, 0.0])
    logits = head(h)
    loss, acc = vocab_parallel_frame_ce(logits, y, head, w)
    loss.backward()
    return {"logits": logits.detach(), "loss": loss.detach(), "acc": acc, "h": h.detach(), "y": y, "w": w,
            "dh": h.grad, "dw": head.weight.grad, "db": head.bias.grad,
            "full": {k: v.detach().clone() for k, v in full.state_dict().items()}}


def golden_seq2seq(folder: str, batch: int | None = None):
    """(config, model on the CPU, wavs, semantics) of the committed golden
    seq2seq checkpoint, its files copied into ``folder``."""
    import shutil

    from tpu_slu_torch import read_config, read_wav
    from tpu_slu_torch.serving import load_trained_model

    golden = os.path.join(REPO, "tests", "assets", "golden_seq2seq")
    with open(os.path.join(golden, "experiment.cfg.template")) as f:
        template = f.read()
    os.makedirs(folder, exist_ok=True)
    cfg = os.path.join(folder, "exp.cfg")
    with open(cfg, "w") as f:
        f.write(template.replace("__GOLDEN_FOLDER__", folder))
    config = read_config(cfg)
    with open(os.path.join(golden, "expected.json")) as f:
        meta = json.load(f)
    config.seq2seq_max_decode_len = meta["max_decode_len"]
    config.decode_acc_from_epoch = 0
    if batch is not None:
        config.training_batch_size = batch
    for name in ("model_state.npz", "vocab.json"):
        shutil.copyfile(os.path.join(golden, name), os.path.join(folder, "training", name))
    model = load_trained_model(config, device="cpu")
    wavs = [read_wav(os.path.join(golden, c["wav"]))[0] for c in meta["expected"]]
    return config, model, wavs, [c["semantics"] for c in meta["expected"]]


def golden_dataset(model, wavs, semantics, batch: int):
    """The golden wavs and their semantics as a seq2seq test set in the
    loader's format, every batch padded to one bucket (the longest wav's):
    the encoder runs unmasked in the loss, so a rank's batch padded to a
    shorter bucket than the global batch would change its loss."""
    from tpu_slu_torch.data.datasets import CollateWavsSLU
    from tpu_slu_torch.data.loader import BatchLoader, pad_to_bucket

    labels = model.Sy_intent
    items = [(w, [labels.index("<sos>")] + [labels.index(c) for c in s] + [labels.index("<eos>")])
             for w, s in zip(wavs, semantics)]
    collate = CollateWavsSLU(labels, True, batch)
    t_pad = pad_to_bucket(max(len(w) for w in wavs), 8000)

    def one_bucket(chunk):
        b = collate(chunk)
        return {**b, "x": np.pad(b["x"], ((0, 0), (0, t_pad - b["x"].shape[1])))}

    return Batches(BatchLoader(items, batch, one_bucket, shuffle=False))


def case_group(args: dict, r: int) -> dict:
    """Inside a 2-rank group: the loader's default and explicit shards, the
    Trainer's refusals (a ``train_step`` without the batch's global totals
    among them), the grid and sharded heads of a Trainer at
    ``model_parallel`` 2, the ranks' dropout draws, ``dp_infer`` on the
    golden seq2seq wavs and a data-parallel ``Trainer.test`` of the golden
    model."""
    from tpu_slu_torch import parallel
    from tpu_slu_torch.data.loader import BatchLoader, pad_wave_batch
    from tpu_slu_torch.models.encoder import encoder_features
    from tpu_slu_torch.models.slu import Model
    from tpu_slu_torch.training import Trainer

    def collate(items):
        return {"i": np.asarray(items), "w": np.ones(len(items), np.float32)}

    out = {"rank": parallel.rank(), "world": parallel.world()}
    default = BatchLoader(list(range(args["n"])), 3, collate, seed=5)
    explicit = BatchLoader(list(range(args["n"])), 3, collate, seed=5, process_index=0, process_count=1)
    out["loader"] = [[(b["i"].tolist(), b["w"].tolist()) for b in loader] for loader in (default, default)]
    out["explicit"] = [b["i"].tolist() for b in explicit]

    config, model, wavs, semantics = golden_seq2seq(os.path.join(args["out"], f"golden{r}"), batch=args["batch"])
    refusals = {}
    for key, value in (("data_parallel", False), ("n_devices", 3)):
        c = copy.copy(config)
        setattr(c, key, value)
        try:
            Trainer(model, c)
        except ValueError as e:
            refusals[key] = str(e)
    try:
        Trainer(model, config).train_step({})
    except ValueError as e:
        refusals["totals"] = str(e)
    out["refusals"] = refusals
    c = copy.copy(config)
    c.model_parallel = 2
    g = Trainer(copy.deepcopy(model), c).grid
    out["grid"] = (g.data_index, g.model_index, g.data_size, g.model_parallel)
    out["grid_loader"] = [b["i"].tolist() for b in BatchLoader(list(range(args["n"])), 3, collate, seed=5)]

    drop = copy.copy(config)
    drop.cnn_drop, drop.phone_rnn_drop, drop.word_rnn_drop = [0.5] * 2, [0.5] * 2, [0.5] * 2
    dmodel = Model(drop, seed=0, load_pretrained=False)
    trainer = Trainer(dmodel, drop)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 6000)).astype(np.float32))
    out["dropped"] = encoder_features(dmodel.pretrained_model, x, train=True, generator=trainer.generator)

    x, _, lengths = pad_wave_batch(wavs, len(wavs), 8000)
    out["decoded"] = parallel.dp_infer(lambda xb, lb: model.decode_intents(xb, lengths=lb), x, lengths)
    out["features"] = parallel.dp_infer(model.pretrained_model.compute_features, x)
    out["test"] = Trainer(model, config).test(golden_dataset(model, wavs, semantics, args["batch"]))
    return out


def main() -> None:
    case, path = sys.argv[1], sys.argv[2]
    with open(path) as f:
        args = json.load(f)
    from tpu_slu_torch import parallel

    parallel.init_from_env("cpu", init_method="file://" + args["rdv"], timeout=INIT_TIMEOUT)
    try:
        r = parallel.rank()
        cases = {"case_slu": case_slu, "case_asr": case_asr, "case_group": case_group, "case_vocab": case_vocab}
        out = cases[f"case_{case}"](args, r)
        out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpu_slu"))
        torch.save(out, os.path.join(args["out"], f"rank{r}.pt"))
        parallel.barrier()
    finally:
        parallel.destroy()


if __name__ == "__main__":
    main()
