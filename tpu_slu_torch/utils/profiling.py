"""Profiling and per-step timing: the counterpart of ``tpu_slu/utils/profiling.py``.

* :func:`profile_trace`: a context manager around ``torch.profiler`` that
  writes a Chrome trace of the enclosed region, one file a rank. The Trainer
  wraps its first epoch's train pass in it, as the JAX Trainer does, when
  the config sets ``profile_dir``
  (``[training] profile_dir=...``). Open a trace in Perfetto
  (https://ui.perfetto.dev, "Open trace file") or ``chrome://tracing``, or
  point TensorBoard's profiler plugin at the directory.
* :class:`StepTimer`: a step timer with a percentile summary, for the
  ``step_ms_*`` columns of ``log.csv``.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from tpu_slu_torch.parallel.dist import rank


@contextlib.contextmanager
def profile_trace(logdir: str | None, name: str = "trace", device: torch.device | None = None):
    """Trace the enclosed region into ``<logdir>/rank<r>.<name>.pt.trace.json``;
    a no-op for a falsy ``logdir``. The CPU activity always, and the CUDA
    activity (every kernel launched on the card, the port's own included)
    when ``device`` is a CUDA device."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"rank{rank()}.{name}.pt.trace.json"))


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
