"""Training engine of the fixed-slot SLU model, on one device.

Port of the fixed-slot SLU branch of ``tpu_slu/training/trainer.py``: masked
Adam over the ULMFiT schedule, per-epoch train and test passes over a
dataset's batches, a ``log.csv`` row per pass with the JAX Trainer's columns,
and ``unfreeze_one_layer()`` at the end of each training epoch.

A dataset is anything whose ``.loader`` yields batches in the JAX package's
``BatchLoader`` format: dicts of numpy arrays ``x`` (B, T) float32,
``y_intent`` (B, n_slots) int, ``w`` (B,) float32 (1 for a real example, 0
for batch padding) and ``len`` (B,) sample counts. The port has no data
pipeline of its own yet.
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
    fixed-slot :class:`~tpu_slu_torch.models.slu.Model`, on the device the
    model lies on. Dropout masks and seeds come from ``generator`` (a CPU
    generator seeded with the config's seed by default)."""

    def __init__(self, model: Model, config, generator: torch.Generator | None = None):
        if not isinstance(model, Model):
            raise NotImplementedError("the port's Trainer trains the fixed-slot SLU Model only")
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
        dtypes = {"x": torch.float32, "y_intent": torch.int64, "w": torch.float32, "len": torch.int64}
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
                                    lengths=batch.get("len"), generator=self.generator)
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
        """Loss and accuracy without dropout; returns (intent_acc, intent_loss)."""
        self.model.eval()
        total_loss = total_acc = 0.0
        num_examples = 0.0
        for bs, batch in self._batches(dataset):
            num_examples += bs
            loss, acc = self.model.loss(batch["x"], batch["y_intent"], train=False,
                                        weights=batch["w"], lengths=batch.get("len"))
            total_loss = total_loss + loss * bs
            total_acc = total_acc + acc * bs
        results = {
            "intent_loss": _weighted_mean(float(total_loss), num_examples),
            "intent_acc": _weighted_mean(float(total_acc), num_examples),
            "set": log_set,
        }
        self.log(results)
        return results["intent_acc"], results["intent_loss"]
