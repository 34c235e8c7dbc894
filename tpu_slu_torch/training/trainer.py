"""Training engine: ASR pre-training and both SLU heads, on one device or data-parallel.

Port of ``tpu_slu/training/trainer.py``. ``Trainer(model, config)`` takes a
:class:`~tpu_slu_torch.models.encoder.PretrainedModel` (ASR pre-training:
``pretraining_lr``, the ``pretraining/`` folder, the loss of
``pretraining_type`` 1, 2 or 3, every parameter trained) or a
:class:`~tpu_slu_torch.models.slu.Model` (SLU training: ``training_lr``,
the ``training/`` folder, masked Adam over the ULMFiT schedule and
``unfreeze_one_layer()`` at the end of each training epoch). Each pass
writes a ``log.csv`` row with the JAX Trainer's columns. For a seq2seq
model the test pass adds, from epoch ``decode_acc_from_epoch`` on (default
2), the exact-match accuracy of beam-search decodes against the targets.

A dataset is a ``data.datasets`` dataset, or anything whose ``.loader``
yields batches in its ``BatchLoader`` format: dicts of numpy arrays ``x``
(B, T) float32, ``w`` (B,) float32 (1 for a real example, 0 for batch
padding), ``len`` (B,) sample counts, and the labels: ``y_phoneme`` and
``y_word`` (B, t) int frame labels (-1 ignored) for ASR; ``y_intent`` (B,
n_slots) int for the fixed-slot model, (B, U, L) float32 one-hot targets
with ``y_len`` (B,) their true lengths for the seq2seq model.

Checkpoints are the JAX Trainer's files, which either package reads:
``model_state.npz`` (the param tree), ``trainer_state.npz`` (the flat Adam
state ``opt/{m,v,step}``, or at ``model_parallel`` > 1 the per-leaf one
``opt/{m,v,step}/<path>``; ``epoch``, ``unfreezing_index``,
``unfrozen_count``) and, for an SLU model, ``vocab.json``. As in JAX, a
resumed run restores neither the step count nor the loader's epoch: its
first epoch reshuffles from ``seed + 0``, and so equals the uninterrupted
run's epoch only over the same batches (and at dropout 0, whose masks come
from ``generator``).

``compute_dtype=bfloat16`` in the config's ``[training]`` (any other value
is f32, as in JAX) runs the train step's and the test pass's GRU layers on
bf16 streams (``models/encoder.py`` ``apply_stack``), as JAX's Trainer
passes ``compute_dtype`` to every loss (``trainer.py:209-213``), for every
model it takes: fixed-slot, seq2seq and ASR, with bidirectional or
unidirectional layers in any mix, on either ``gru_layout``. On the card
every GRU kernel of those paths runs its bf16 instantiation: K1 (or K6),
K2 and K3 for the bidirectional layers, K5f and K5b for the unidirectional
ones, K4f and K4b for the seq2seq encoder. The master weights, the Adam
state, the checkpoints, the losses and the front end stay f32; decoding
(``decode_intents``, the server, the seq2seq test pass's beam search)
ignores the setting.

Data parallelism (``tpu_slu_torch.parallel``, one process a GPU under
``torchrun``): with a process group of W ranks up, each rank reads its
shard of every epoch at the config's batch size, and a step is the
single-device step on the union of the ranks' batches. The host counts of
the step's denominators (the weight sum; for ASR also each head's valid
label frames) are summed over the ranks in one small host all-reduce; each
rank's loss is its rows' share of the global batch's loss (its sum over
the global denominator), and one flat all-reduce sums the gradients, so
the clip sees the global gradient and ``MaskedAdam`` steps alike on every
rank. The model is broadcast from rank 0 at construction, each rank's
dropout generator is seeded from (``seed``, rank), rank 0 keeping
``seed``, and the epoch metrics are summed over the ranks. Only rank 0
writes ``log.csv`` and the checkpoints; every rank reads them.

Model parallelism (``model_parallel`` > 1 in ``[training]``, JAX's
``trainer.py:96-135``): the ranks form a (data, model) grid
(``parallel/mesh.py``) where ``model_parallel`` divides them; where it
does not, or on one rank, the Trainer prints JAX's line and trains as
above. The mp ranks of a data index read the same batches, draw the same
dropout (the generator is seeded from the data index) and hold the column
shards of the vocab heads whose width divides ``model_parallel``, a
``Model``'s unused encoder heads too (JAX's ``param_shardings`` rule); the
heads' frame loss is vocabulary-parallel (``parallel/vocab.py``). Everything
said above of ranks then holds of data indices: the host counts and
metrics are summed over the data group, a head shard's gradient is
all-reduced over it, a replicated one over every rank and divided by
``model_parallel`` (so the copies of a data index agree bit for bit where
the card's conv backward does not), and the clip's norm adds the shards'
squares over the model group to the replicated ones'. The checkpoints hold
the gathered heads and JAX's per-leaf Adam state, which a run at
``model_parallel`` 1 does not read (nor this one a flat state): the model
loads and the optimizer starts fresh, as in JAX.
"""

from __future__ import annotations

import csv
import json
import os
import time

import numpy as np
import torch

from tpu_slu_torch import parallel
from tpu_slu_torch.models.convert import params_from_jax, params_to_jax
from tpu_slu_torch.models.encoder import PretrainedModel, encoder_loss
from tpu_slu_torch.models.slu import Model
from tpu_slu_torch.parallel.mesh import gather_rows, take_rows
from tpu_slu_torch.training.checkpoint import check_backend, load_pytree, save_pytree
from tpu_slu_torch.training.optim import MaskedAdam, clip_grad_norm
from tpu_slu_torch.utils.profiling import StepTimer, profile_trace

__all__ = ["StepTimer", "Trainer", "write_log_csv"]

ASR_METRICS = ("phone_loss", "phone_acc", "word_loss", "word_acc")


def _weighted_mean(total, count):
    return total / max(count, 1e-9)


def compute_dtype_of(config) -> torch.dtype | None:
    """``torch.bfloat16`` when the config's ``compute_dtype`` is
    ``"bfloat16"``, else None (f32), as JAX's Trainer reads it."""
    return torch.bfloat16 if getattr(config, "compute_dtype", "float32") == "bfloat16" else None


def data_seed(seed: int, data_index: int) -> int:
    """The dropout seed of a data index (a rank at ``model_parallel`` 1):
    ``seed`` itself at index 0 (so one rank trains as one process does), else
    a draw from ``SeedSequence([seed, data_index])``."""
    return seed if data_index == 0 else int(np.random.SeedSequence([seed, data_index]).generate_state(1)[0])


def write_log_csv(path: str, rows: list[dict]) -> None:
    """``rows`` as ``pandas.DataFrame(rows).to_csv(path)`` writes them: a
    leading index column, the columns in order of first appearance, empty
    cells where a row has no value, and a column with gaps written as floats."""
    cols = list(dict.fromkeys(k for r in rows for k in r))
    gappy = {c for c in cols if any(c not in r for r in rows)}

    def cell(col, v):
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return v
        return repr(float(v)) if (col in gappy or isinstance(v, float)) else str(v)

    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + cols)
        for i, r in enumerate(rows):
            w.writerow([i] + [cell(c, r[c]) if c in r else "" for c in cols])


class Trainer:
    """``Trainer(model, config).train(dataset)`` / ``.test(dataset)`` on the
    device the model lies on, data-parallel over the ranks when a process
    group is up, on a (data, model) grid at ``model_parallel`` > 1. Dropout
    masks and seeds come from ``generator`` (a CPU generator seeded with
    :func:`data_seed` of the config's seed by default)."""

    def __init__(self, model, config, generator: torch.Generator | None = None):
        check_backend(config)
        self.world, self.rank = parallel.world(), parallel.rank()
        if self.world > 1:
            if not getattr(config, "data_parallel", True):
                raise ValueError(f"data_parallel=False with {self.world} ranks: each rank would train its "
                                 "own replica; set data_parallel=True or run one process")
            n_devices = int(getattr(config, "n_devices", 0) or 0)
            if n_devices and n_devices != self.world:
                raise ValueError(f"n_devices={n_devices} but {self.world} ranks are running; launch "
                                 f"torchrun --nproc_per_node={n_devices}, or drop n_devices")
        self.grid = parallel.grid_for(config)
        self.model = model
        self.config = config
        self.is_pretraining = isinstance(model, PretrainedModel)
        if self.is_pretraining:
            if config.pretraining_type not in (1, 2, 3):
                raise ValueError(
                    f"pretraining_type={config.pretraining_type} has no pre-training loss; use "
                    "1 (phoneme), 2 (phoneme+word) or 3 (word), or skip --pretrain")
            self.lr = config.pretraining_lr
            self.checkpoint_path = os.path.join(config.folder, "pretraining")
        elif isinstance(model, Model):
            self.lr = config.training_lr
            self.checkpoint_path = os.path.join(config.folder, "training")
        else:
            raise TypeError(f"the Trainer trains a PretrainedModel or a Model, not {type(model).__name__}")
        self.compute_dtype = compute_dtype_of(config)
        os.makedirs(self.checkpoint_path, exist_ok=True)
        self._model_ckpt = os.path.join(self.checkpoint_path, "model_state.npz")
        self._trainer_ckpt = os.path.join(self.checkpoint_path, "trainer_state.npz")
        self.epoch = 0
        self._rows: list[dict] = []
        if generator is None:
            generator = torch.Generator().manual_seed(data_seed(config.seed, self.grid.data_index))
        self.generator = generator
        self.clip = getattr(config, "gradient_clip_norm", 0.0)
        self.device = model.device
        if self.world > 1:
            parallel.broadcast_module(model)
        self.sharded = parallel.shard_vocab_heads(model, self.grid)
        self.optimizer = MaskedAdam(model.named_parameters(), self.lr)

    def _to_device(self, batch: dict) -> dict:
        seq2seq = not self.is_pretraining and self.model.seq2seq
        dtypes = {"x": torch.float32, "y_intent": torch.float32 if seq2seq else torch.int64,
                  "y_phoneme": torch.int64, "y_word": torch.int64,
                  "w": torch.float32, "len": torch.int64, "y_len": torch.int64}
        return {k: torch.as_tensor(np.asarray(batch[k]), dtype=dt).to(self.device, non_blocking=True)
                for k, dt in dtypes.items() if k in batch}

    def counts(self, batch: dict) -> np.ndarray:
        """The host counts behind a batch's means: its weight sum, and for
        ASR each head's weighted valid label frames after the loss's trim to
        the encoder's frames (``encoder_loss``). Read from the batch's host
        arrays, before the copy to the device, so the count syncs nothing."""
        w = np.asarray(batch["w"], np.float64)
        if not self.is_pretraining:
            return np.array([w.sum()])
        t_wave, arch = np.shape(batch["x"])[1], self.model.arch
        out = [w.sum()]
        for key, upto in (("y_phoneme", "phoneme"), ("y_word", "word")):
            y = np.asarray(batch[key])
            y = y[:, :min(int(arch.num_frames(t_wave, upto=upto)), y.shape[1])]
            out.append(float(((y != -1) * w[:, None]).sum()))
        return np.array(out)

    def _batches(self, dataset):
        """(this rank's weight sum, the global batch's, the batch's counts
        summed over the data group or None with one data index, device batch)
        of each batch of ``dataset``. A step's values are weighted by the
        global sum: on several data indices they are this rank's shares of the
        global means."""
        for batch in dataset.loader:
            counts = self.counts(batch)
            totals = self.global_counts(counts) if self.grid.data_size > 1 else None
            bs = float(counts[0])
            yield bs, bs if totals is None else float(totals[0]), totals, self._to_device(batch)

    def global_counts(self, counts: np.ndarray) -> np.ndarray:
        """A batch's :meth:`counts` summed over the data group: the ``totals``
        of :meth:`train_step` on several data indices."""
        return parallel.host_all_reduce(counts, group=self.grid.host_data_group)

    def _losses(self, batch: dict, totals, train: bool):
        """The ASR values or the SLU (loss, acc) of a device batch; with the
        global ``totals`` (:meth:`counts` summed over the ranks), its shares
        of the global batch's."""
        if self.is_pretraining:
            return encoder_loss(self.model, batch["x"], batch["y_phoneme"], batch["y_word"], train=train,
                                generator=self.generator if train else None, weights=batch.get("w"),
                                denoms=None if totals is None else (totals[1], totals[2]),
                                compute_dtype=self.compute_dtype)
        return self.model.loss(batch["x"], batch["y_intent"], train=train, weights=batch["w"],
                               lengths=batch.get("len"), y_len=batch.get("y_len"),
                               generator=self.generator if train else None,
                               denom=None if totals is None else totals[0],
                               compute_dtype=self.compute_dtype)

    def train_step(self, batch: dict, totals: np.ndarray | None = None) -> tuple[torch.Tensor, ...]:
        """One Adam step on a device batch; returns, detached on the device,
        (loss, acc) for an SLU model and (phone_loss, word_loss, phone_acc,
        word_acc) for ASR. The ASR loss is the phoneme loss, their sum or
        the word loss at ``pretraining_type`` 1, 2 or 3, every parameter
        trained; the SLU step is masked by the ULMFiT schedule. Both clip the
        gradients' global norm at ``gradient_clip_norm``. With several data
        indices the values are this rank's shares of the global batch's,
        ``totals`` (required there) the batch's :meth:`counts` of its host
        arrays summed over the data group (:meth:`global_counts`); the
        gradients are summed over the data group before the clip."""
        if self.grid.data_size > 1 and totals is None:
            raise ValueError(f"train_step on {self.grid.data_size} data indices needs the batch's totals: "
                             "trainer.global_counts(trainer.counts(host_batch)), parallel.host_all_reduce "
                             "over the data group")
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        out = self._losses(batch, totals, train=True)
        if self.is_pretraining:
            pl, wl = out[0], out[1]
            loss = {1: pl, 2: pl + wl, 3: wl}[self.config.pretraining_type]
        else:
            loss = out[0]
        loss.backward()
        shards = self._shard_params()
        if self.grid.model_parallel > 1:
            self._reduce_model_parallel_grads(shards)
        elif self.grid.data_size > 1:
            parallel.all_reduce_grads(self.model.parameters(), group=self.grid.data_group)
        clip_grad_norm(self.model.parameters(), self.clip, shards, self.grid.model_group)
        self.optimizer.step()
        return tuple(t.detach() for t in out)

    def _reduce_model_parallel_grads(self, shards: list) -> None:
        """Sum each gradient over the data indices. A head shard's goes over
        its data group. A replicated parameter's is the same on the mp ranks
        of a data index only up to the card's kernels that are not bit for
        bit deterministic (the conv backward), so it goes over every rank and
        is divided by ``model_parallel``: the mp copies agree bit for bit, and
        the ranks keep equal replicas."""
        ids = {id(p) for p in shards}
        rest = [p for p in self.model.parameters() if id(p) not in ids]
        parallel.all_reduce_grads(rest)
        torch._foreach_div_([p.grad for p in rest if p.grad is not None], float(self.grid.model_parallel))
        if self.grid.data_size > 1:
            parallel.all_reduce_grads(shards, group=self.grid.data_group)

    def log(self, results: dict) -> None:
        self._rows.append(results)
        if self.rank == 0:
            write_log_csv(os.path.join(self.checkpoint_path, "log.csv"), self._rows)

    # -- checkpoints (JAX trainer.py:383-442) ----------------------------------

    def _shard_params(self) -> list:
        return [p for n, p in self.model.named_parameters() if n in self.sharded]

    def _full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of parameter ``name``'s ``t`` (a sharded head's
        gathered over the model group; collective there)."""
        return gather_rows(t, self.grid) if name in self.sharded else t

    def _take(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return take_rows(t, self.grid) if name in self.sharded else t

    def full_state_dict(self) -> dict[str, torch.Tensor]:
        """The model's ``state_dict`` with every sharded head whole. Collective
        over the model group at ``model_parallel`` > 1: every rank calls it."""
        return {n: self._full(n, t) for n, t in self.model.state_dict().items()}

    def _jax_params(self) -> dict:
        return params_to_jax(self.full_state_dict())

    def optimizer_state(self) -> dict:
        """The optimizer's state as ``trainer_state.npz`` holds it: JAX's flat
        Adam state, or its per-leaf one at ``model_parallel`` > 1 (collective
        there, as :meth:`full_state_dict`)."""
        if self.grid.model_parallel > 1:
            return self.optimizer.export_tree(self._full)
        return self.optimizer.export_flat()

    def _trainer_tree(self) -> dict:
        return {
            "opt": self.optimizer_state(),
            "epoch": np.asarray(self.epoch, np.int32),
            "unfreezing_index": np.asarray(getattr(self.model, "unfreezing_index", 0), np.int32),
            "unfrozen_count": np.asarray(getattr(self.model, "_unfrozen_count", 0), np.int32),
        }

    def load_checkpoint(self) -> None:
        """Resume from the folder's checkpoint, as the JAX Trainer does: with
        no model file, or one that does not fit the model, say so and start
        from scratch; with a model but an unreadable trainer state (one of
        the other ``model_parallel`` form among them), keep the model and
        start the optimizer fresh. Every rank calls it: at ``model_parallel``
        > 1 each takes its columns of the heads and of their Adam state."""
        if not os.path.exists(self._model_ckpt):
            print("No previous model; starting from scratch")
            return
        try:
            tree = load_pytree(self._model_ckpt, self._jax_params())
            self.model.load_state_dict({n: self._take(n, t) for n, t in params_from_jax(tree).items()},
                                       strict=True)
        except Exception as e:  # the reference's semantics: fall back to scratch
            print(f"Could not load previous model; starting from scratch ({e})")
            return
        if os.path.exists(self._trainer_ckpt):
            try:
                state = load_pytree(self._trainer_ckpt, self._trainer_tree())
                if self.grid.model_parallel > 1:
                    self.optimizer.import_tree(state["opt"], self._take)
                else:
                    self.optimizer.import_flat(state["opt"])
                self.epoch = int(state["epoch"])
                if not self.is_pretraining:
                    self.model.unfreezing_index = int(state["unfreezing_index"])
                    self.model._unfrozen_count = int(state["unfrozen_count"])
            except Exception as e:
                print(f"Could not load trainer state; optimizer starts fresh ({e})")

    def save_checkpoint(self) -> None:
        """Write ``model_state.npz``, ``vocab.json`` (an SLU model) and
        ``trainer_state.npz``; a failure is printed, not raised (JAX's).
        Rank 0 writes; every rank then waits for it. At ``model_parallel`` > 1
        every rank gathers the heads and their Adam state first."""
        if self.rank == 0 or self.grid.model_parallel > 1:
            try:
                params, state = self._jax_params(), self._trainer_tree()
                if self.rank == 0:
                    save_pytree(self._model_ckpt, params)
                    if not self.is_pretraining:
                        with open(os.path.join(self.checkpoint_path, "vocab.json"), "w") as f:
                            json.dump(self.model.vocab_dict(), f)
                    save_pytree(self._trainer_ckpt, state)
            except Exception as e:
                print(f"Could not save model ({e})")
        if self.world > 1:
            parallel.barrier()

    # -- epochs ------------------------------------------------------------------

    def train(self, dataset, print_interval: int = 100):
        """One epoch; returns (phone_acc, phone_loss, word_acc, word_loss) for
        ASR, (intent_acc, intent_loss) for SLU. The branch is the model's: the
        dataset must hold batches of that kind. The first epoch (``epoch``
        0) runs under :func:`profile_trace` when the config sets
        ``profile_dir``."""
        logdir = getattr(self.config, "profile_dir", None) if self.epoch == 0 else None
        with profile_trace(logdir, "train", self.device):
            if self.is_pretraining:
                return self._train_asr(dataset, print_interval)
            return self._train_slu(dataset, print_interval)

    def _sum(self, values) -> list:
        """``values`` summed over the data group (each data index's shares)."""
        return parallel.all_hosts_sum(values, group=self.grid.host_data_group)

    def _print_step(self, names, values) -> None:
        """The JAX Trainer's progress lines, of the global batch's values
        (summed over the data group: each rank's are its shares), from rank 0."""
        values = self._sum([float(v) for v in values])
        if self.rank == 0:
            for name, v in zip(names, values):
                print(f"{name}: {float(v)}")

    def _train_asr(self, dataset, print_interval):
        totals = dict.fromkeys(ASR_METRICS, 0.0)
        num_examples = 0.0
        t0 = time.time()
        timer = StepTimer(self.device)
        for idx, (bs, g, counts, batch) in enumerate(self._batches(dataset)):
            num_examples += bs
            with timer.step():
                pl, wl, pa, wa = self.train_step(batch, counts)
            for k, v in zip(ASR_METRICS, (pl, pa, wl, wa)):
                totals[k] = totals[k] + v * g
            if idx % print_interval == 0:
                self._print_step(("phoneme loss", "word loss", "phoneme acc", "word acc"), (pl, wl, pa, wa))
        *sums, num_examples = self._sum(list(totals.values()) + [num_examples])
        results = {k: _weighted_mean(float(v), num_examples) for k, v in zip(totals, sums)}
        results["set"] = "train"
        results["examples_per_sec"] = num_examples / max(time.time() - t0, 1e-9)
        results.update(timer.summary())
        self.log(results)
        self.epoch += 1
        return results["phone_acc"], results["phone_loss"], results["word_acc"], results["word_loss"]

    def _train_slu(self, dataset, print_interval):
        total_loss = total_acc = 0.0
        num_examples = 0.0
        t0 = time.time()
        timer = StepTimer(self.device)
        if self.rank == 0:
            self.model.print_frozen()
        self.optimizer.set_mask(self.model.trainable_mask())
        for idx, (bs, g, counts, batch) in enumerate(self._batches(dataset)):
            num_examples += bs
            with timer.step():
                loss, acc = self.train_step(batch, counts)
            total_loss = total_loss + loss * g
            total_acc = total_acc + acc * g
            if idx % print_interval == 0:
                self._print_step(("intent loss", "intent acc"), (loss, acc))
        self.model.unfreeze_one_layer()
        total_loss, total_acc, num_examples = self._sum([total_loss, total_acc, num_examples])
        results = {
            "intent_loss": _weighted_mean(float(total_loss), num_examples),
            "intent_acc": _weighted_mean(float(total_acc), num_examples),
            "set": "train",
            "examples_per_sec": num_examples / max(time.time() - t0, 1e-9),
        }
        results.update(timer.summary())
        self.log(results)
        self.epoch += 1
        return results["intent_acc"], results["intent_loss"]

    @torch.no_grad()
    def test(self, dataset, log_set: str = "valid"):
        """Loss and accuracy without dropout: (phone_acc, phone_loss,
        word_acc, word_loss) for ASR, (intent_acc, intent_loss) for SLU. A
        seq2seq model's accuracy is the exact match of
        ``decode_intents(x, lengths=len)`` against the targets' strings, from
        epoch ``decode_acc_from_epoch`` (default 2) on, and 0 before it
        (JAX ``trainer.py:584-624``); each rank decodes its own shard."""
        self.model.eval()
        if self.is_pretraining:
            return self._test_asr(dataset, log_set)
        return self._test_slu(dataset, log_set)

    def _test_slu(self, dataset, log_set):
        total_loss = total_acc = 0.0
        num_examples = 0.0
        decode = self.model.seq2seq and self.epoch >= getattr(self.config, "decode_acc_from_epoch", 2)
        for idx, (bs, g, counts, batch) in enumerate(self._batches(dataset)):
            num_examples += bs
            loss, acc = self._losses(batch, counts, train=False)
            total_loss = total_loss + loss * g
            total_acc = total_acc + acc * g
            n_real = int(bs)
            if decode and n_real:
                guesses = np.array(self.model.decode_intents(batch["x"], lengths=batch.get("len"))[:n_real])
                y_host = batch["y_intent"][:n_real].cpu().numpy()
                truths = np.array([self.model.one_hot_to_string(y, self.model.Sy_intent) for y in y_host])
                match = float((guesses == truths).mean())
                total_acc = total_acc + match * bs
                if self.rank == 0:
                    print(f"decoding batch {idx}")
                    print(f"acc: {match}")
                    print(f"guess: {guesses[0]}")
                    print(f"truth: {truths[0]}")
        total_loss, total_acc, num_examples = self._sum([total_loss, total_acc, num_examples])
        results = {
            "intent_loss": _weighted_mean(float(total_loss), num_examples),
            "intent_acc": _weighted_mean(float(total_acc), num_examples),
            "set": log_set,
        }
        self.log(results)
        return results["intent_acc"], results["intent_loss"]

    def _test_asr(self, dataset, log_set):
        totals = dict.fromkeys(ASR_METRICS, 0.0)
        num_examples = 0.0
        for bs, g, counts, batch in self._batches(dataset):
            num_examples += bs
            pl, wl, pa, wa = self._losses(batch, counts, train=False)
            for k, v in zip(ASR_METRICS, (pl, pa, wl, wa)):
                totals[k] = totals[k] + v * g
        *sums, num_examples = self._sum(list(totals.values()) + [num_examples])
        results = {k: _weighted_mean(float(v), num_examples) for k, v in zip(totals, sums)}
        results["set"] = log_set
        self.log(results)
        return results["phone_acc"], results["phone_loss"], results["word_acc"], results["word_loss"]
