"""Training engine of the SLU models (fixed-slot and seq2seq), on one device.

Port of the SLU branch of ``tpu_slu/training/trainer.py``: masked Adam over
the ULMFiT schedule, per-epoch train and test passes over a dataset's
batches, a ``log.csv`` row per pass with the JAX Trainer's columns, and
``unfreeze_one_layer()`` at the end of each training epoch. For a seq2seq
model the test pass adds, from epoch ``decode_acc_from_epoch`` on (default
2), the exact-match accuracy of beam-search decodes against the targets.

A dataset is anything whose ``.loader`` yields batches in the JAX package's
``BatchLoader`` format: dicts of numpy arrays ``x`` (B, T) float32, ``w``
(B,) float32 (1 for a real example, 0 for batch padding), ``len`` (B,)
sample counts, and ``y_intent``: (B, n_slots) int for the fixed-slot model;
(B, U, L) float32 one-hot targets for the seq2seq model, with ``y_len``
(B,) their true lengths. The port has no data pipeline of its own yet.
"""

from __future__ import annotations

import contextlib
import csv
import os
import time

import numpy as np
import torch

from tpu_slu_torch.models.slu import Model
from tpu_slu_torch.training.optim import MaskedAdam, clip_grad_norm


def _weighted_mean(total, count):
    return total / max(count, 1e-9)


class StepTimer:
    """Wall-clock step timer with a percentile summary. On a CUDA device each
    step ends in a synchronise, so a step's time is the device's."""

    def __init__(self, device: torch.device | None = None):
        self._times: list[float] = []
        self._sync = device is not None and device.type == "cuda"

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                torch.cuda.synchronize()
            self._times.append(time.perf_counter() - t0)

    def summary(self) -> dict:
        if not self._times:
            return {}
        t = np.asarray(self._times) * 1000.0
        return {
            "steps": len(t),
            "step_ms_p50": float(np.percentile(t, 50)),
            "step_ms_p99": float(np.percentile(t, 99)),
            "step_ms_mean": float(t.mean()),
        }


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
    """``Trainer(model, config).train(dataset)`` / ``.test(dataset)`` for the
    SLU :class:`~tpu_slu_torch.models.slu.Model` (either head), on the
    device the model lies on. Dropout masks and seeds come from
    ``generator`` (a CPU generator seeded with the config's seed by
    default)."""

    def __init__(self, model: Model, config, generator: torch.Generator | None = None):
        if not isinstance(model, Model):
            raise NotImplementedError("the port's Trainer trains the SLU Model only")
        self.model = model
        self.config = config
        self.lr = config.training_lr
        self.checkpoint_path = os.path.join(config.folder, "training")
        os.makedirs(self.checkpoint_path, exist_ok=True)
        self.epoch = 0
        self._rows: list[dict] = []
        self.generator = generator if generator is not None else torch.Generator().manual_seed(config.seed)
        self.clip = getattr(config, "gradient_clip_norm", 0.0)
        self.device = model.device
        self.optimizer = MaskedAdam(model.named_parameters(), self.lr)

    def _to_device(self, batch: dict) -> dict:
        dtypes = {"x": torch.float32, "y_intent": torch.float32 if self.model.seq2seq else torch.int64,
                  "w": torch.float32, "len": torch.int64, "y_len": torch.int64}
        return {k: torch.as_tensor(np.asarray(batch[k]), dtype=dt).to(self.device, non_blocking=True)
                for k, dt in dtypes.items() if k in batch}

    def _batches(self, dataset):
        for batch in dataset.loader:
            yield float(np.asarray(batch["w"]).sum()), self._to_device(batch)

    def train_step(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """One masked-Adam step on a device batch; returns (loss, acc) on the
        device, detached."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, acc = self.model.loss(batch["x"], batch["y_intent"], train=True, weights=batch["w"],
                                    lengths=batch.get("len"), y_len=batch.get("y_len"),
                                    generator=self.generator)
        loss.backward()
        clip_grad_norm(self.model.parameters(), self.clip)
        self.optimizer.step()
        return loss.detach(), acc.detach()

    def log(self, results: dict) -> None:
        self._rows.append(results)
        write_log_csv(os.path.join(self.checkpoint_path, "log.csv"), self._rows)

    def train(self, dataset, print_interval: int = 100):
        """One epoch; returns (intent_acc, intent_loss)."""
        total_loss = total_acc = 0.0
        num_examples = 0.0
        t0 = time.time()
        timer = StepTimer(self.device)
        self.model.print_frozen()
        self.optimizer.set_mask(self.model.trainable_mask())
        for idx, (bs, batch) in enumerate(self._batches(dataset)):
            num_examples += bs
            with timer.step():
                loss, acc = self.train_step(batch)
            total_loss = total_loss + loss * bs
            total_acc = total_acc + acc * bs
            if idx % print_interval == 0:
                print(f"intent loss: {float(loss)}")
                print(f"intent acc: {float(acc)}")
        self.model.unfreeze_one_layer()
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
        """Loss and accuracy without dropout; returns (intent_acc, intent_loss).
        A seq2seq model's accuracy is the exact match of
        ``decode_intents(x, lengths=len)`` against the targets' strings, from
        epoch ``decode_acc_from_epoch`` (default 2) on, and 0 before it
        (JAX ``trainer.py:584-624``)."""
        self.model.eval()
        total_loss = total_acc = 0.0
        num_examples = 0.0
        decode = self.model.seq2seq and self.epoch >= getattr(self.config, "decode_acc_from_epoch", 2)
        for idx, (bs, batch) in enumerate(self._batches(dataset)):
            num_examples += bs
            loss, acc = self.model.loss(batch["x"], batch["y_intent"], train=False,
                                        weights=batch["w"], lengths=batch.get("len"),
                                        y_len=batch.get("y_len"))
            total_loss = total_loss + loss * bs
            total_acc = total_acc + acc * bs
            if decode:
                n_real = int(bs)
                guesses = np.array(self.model.decode_intents(batch["x"], lengths=batch.get("len"))[:n_real])
                y_host = batch["y_intent"][:n_real].cpu().numpy()
                truths = np.array([self.model.one_hot_to_string(y, self.model.Sy_intent) for y in y_host])
                match = float((guesses == truths).mean())
                total_acc = total_acc + match * bs
                print(f"decoding batch {idx}")
                print(f"acc: {match}")
                print(f"guess: {guesses[0]}")
                print(f"truth: {truths[0]}")
        results = {
            "intent_loss": _weighted_mean(float(total_loss), num_examples),
            "intent_acc": _weighted_mean(float(total_acc), num_examples),
            "set": log_set,
        }
        self.log(results)
        return results["intent_acc"], results["intent_loss"]
