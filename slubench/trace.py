"""The traced run: capture with ``torch.profiler``, and what the readers read.

:class:`Tracer` profiles the host and the device over a window marked by a
``slubench.window`` annotation, exports the Chrome trace into the run's
work directory and reads it back into a :class:`Trace`: the device's
operations (kernels, copies, sets) and the host's (operators, runtime and
driver calls), as (name, start, end) in seconds. Per-layer readers take
device time by kernel name from it (:meth:`Trace.device_time`); the harness
takes the busy time, the window and the breakdown.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict

WINDOW = "slubench.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver"}


class Trace:
    """Device and host events of one traced window, times in seconds."""

    def __init__(self, device: list[tuple[str, float, float]], host: list[tuple[str, float, float]],
                 window: tuple[float, float]):
        self.window = window
        w0, w1 = window
        self.device = sorted(((n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1),
                             key=lambda ev: ev[1])
        self.host = sorted(host, key=lambda ev: ev[1])

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device's operations, in time order."""
        out: list[list[float]] = []
        for _, s, e in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_time(self, patterns) -> float:
        """Seconds of device operations whose name matches any regex of ``patterns``."""
        rx = re.compile("|".join(f"(?:{p})" for p in patterns))
        return sum(e - s for n, s, e in self.device if rx.search(n))

    def device_ops(self, top: int = 10) -> list[list]:
        by = defaultdict(float)
        for n, s, e in self.device:
            by[n] += e - s
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The window's idle time summed by what the host was doing when each
        gap began: the innermost host operation open at that moment
        (``no_host_op`` where none was)."""
        gaps, t = [], self.window[0]
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        by = defaultdict(float)
        active: list[tuple[str, float, float]] = []
        i = 0
        for g0, g1 in gaps:  # a sweep: host events by start, the latest-started open one wins
            while i < len(self.host) and self.host[i][1] <= g0:
                active.append(self.host[i])
                i += 1
            while active and active[-1][2] <= g0:
                active.pop()
            by[active[-1][0] if active else "no_host_op"] += g1 - g0
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def read_chrome_trace(path: str) -> Trace:
    """A :class:`Trace` of a Chrome trace that ``torch.profiler`` exported:
    the window is the ``slubench.window`` annotation's span."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, window = [], [], None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATS:
            device.append((name, s, e))
        elif cat == "user_annotation" and name == WINDOW:
            window = (s, e)
        elif cat in HOST_CATS:
            host.append((name, s, e))
    if window is None:
        raise RuntimeError(f"no {WINDOW} annotation in {path}")
    return Trace(device, host, window)


class Tracer:
    """``with Tracer(workdir) as tr: ...`` profiles the block (after a
    synchronise; the block ends in one) and leaves ``tr.trace``."""

    def __init__(self, workdir: str):
        self.path = os.path.join(workdir, "trace.json")
        self.trace: Trace | None = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark = record_function(WINDOW)
        self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self._mark.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._prof.export_chrome_trace(self.path)
            try:
                self.trace = read_chrome_trace(self.path)
            finally:
                os.remove(self.path)
        return False
