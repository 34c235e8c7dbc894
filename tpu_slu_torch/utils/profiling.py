"""Profiling, program spans and per-step timing: the counterpart of ``tpu_slu/utils/profiling.py``.

* :func:`profile_trace`: a context manager around ``torch.profiler`` that
  writes a Chrome trace of the enclosed region, one file a rank. The Trainer
  wraps its first epoch's train pass in it, as the JAX Trainer does, when
  the config sets ``profile_dir``
  (``[training] profile_dir=...``). Open a trace in Perfetto
  (https://ui.perfetto.dev, "Open trace file") or ``chrome://tracing``, or
  point TensorBoard's profiler plugin at the directory.
* :func:`span` and :func:`record_span`: the program's spans (name, start,
  end, parent span, attributes; a request's spans share its ``rid``), kept
  in a bounded store in memory (:func:`spans`, :func:`dropped_spans`).
  Recording is on exactly while a ``torch.profiler`` session is: a traced
  run, :func:`profile_trace`, any user's profiler. Off, :func:`span` returns
  a shared no-op after one flag check, and reads no clock. Spans are stamped
  with ``time.time_ns()``, the clock of the profiler's Chrome trace
  (:func:`trace_seconds`), and a span opened on the profiling thread also
  opens a ``record_function`` of its name, so the trace shows it above the
  kernels it launched.
* :class:`StepTimer`: a step timer with a percentile summary, for the
  ``step_ms_*`` columns of ``log.csv``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import numpy as np
import torch
import torch.autograd.profiler as autograd_profiler

from tpu_slu_torch.parallel.dist import rank

# Kineto stamps a Chrome trace's events in microseconds of CLOCK_REALTIME past
# its ``baseTimeNanoseconds``: the wall clock rounded down to a multiple of
# this many seconds (torch's ``profiler/_cupti_monitor_trace.py``).
TRIMONTH_S = 7_889_238
SPAN_CAPACITY = 1 << 18


@contextlib.contextmanager
def profile_trace(logdir: str | None, name: str = "trace", device: torch.device | None = None):
    """Trace the enclosed region into ``<logdir>/rank<r>.<name>.pt.trace.json``;
    a no-op for a falsy ``logdir``. The CPU activity always, and the CUDA
    activity (every kernel launched on the card, the port's own included)
    when ``device`` is a CUDA device. Program spans record while it runs."""
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


# -- program spans ---------------------------------------------------------------


def recording() -> bool:
    """Whether spans record: a ``torch.profiler`` session is active."""
    return autograd_profiler._is_profiler_enabled


class Span:
    """One span: ``name``, ``id``, the ``parent`` span's id (None at the top
    of its thread or for :func:`record_span`), the ``thread`` it was opened
    on (None for :func:`record_span`), ``t0_ns``/``t1_ns`` of
    ``time.time_ns()``, and ``attrs``. Opened as a context manager by
    :func:`span`; :meth:`set` adds attributes meanwhile."""

    __slots__ = ("name", "id", "parent", "thread", "t0_ns", "t1_ns", "attrs", "_recorder", "_rf")

    def __init__(self, recorder: SpanRecorder, name: str, attrs: dict):
        self.name, self.attrs, self._recorder, self._rf = name, attrs, recorder, None
        self.id = next(recorder._ids)
        self.thread = threading.get_ident()
        self.parent = self.t0_ns = self.t1_ns = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> Span:
        stack = self._recorder._stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.t0_ns = time.time_ns()
        if torch._C._autograd._profiler_enabled():  # this thread is profiled: a copy in its trace
            self._rf = autograd_profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.t1_ns = time.time_ns()
        self._recorder._stack().pop()
        self._recorder._keep(self)
        return False


class _NoSpan:
    """What :func:`span` returns while nothing records: false, and inert."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> _NoSpan:
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


class SpanRecorder:
    """A bounded store of closed spans, each thread's stack of open ones,
    and the count of spans ``dropped`` once ``capacity`` were kept."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.capacity = capacity
        self.dropped = 0
        self._store: list[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    def span(self, name: str, **attrs):
        """A context manager recording the enclosed region as span ``name``
        while a profiler runs, else the shared no-op :data:`NO_SPAN`."""
        if not autograd_profiler._is_profiler_enabled:
            return NO_SPAN
        return Span(self, name, attrs)

    def record_span(self, name: str, t0_ns: int, t1_ns: int, **attrs) -> None:
        """Record a span whose ends were stamped (``time.time_ns()``) on
        different threads, while a profiler runs."""
        if not autograd_profiler._is_profiler_enabled:
            return
        s = Span(self, name, attrs)
        s.thread, s.t0_ns, s.t1_ns = None, t0_ns, t1_ns
        self._keep(s)

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._store)

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self.dropped = 0

    def _stack(self) -> list[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _keep(self, s: Span) -> None:
        with self._lock:
            if len(self._store) < self.capacity:
                self._store.append(s)
            else:
                self.dropped += 1


RECORDER = SpanRecorder()
span = RECORDER.span
record_span = RECORDER.record_span


def spans() -> list[Span]:
    """A copy of the program's span store."""
    return RECORDER.spans()


def dropped_spans() -> int:
    """Spans lost since the store filled up."""
    return RECORDER.dropped


def clear_spans() -> None:
    RECORDER.clear()


def kineto_base_ns(t_ns: int) -> int:
    """The ``baseTimeNanoseconds`` of a Chrome trace exported near ``t_ns``."""
    step = TRIMONTH_S * 1_000_000_000
    return t_ns // step * step


def trace_seconds(t_ns: int, base_ns: int | None = None) -> float:
    """A ``time.time_ns()`` stamp on the clock of the profiler's Chrome trace,
    in seconds (an event's ``ts`` over 1e6): past ``base_ns``, by default the
    base of a trace exported near ``t_ns``."""
    return (t_ns - (kineto_base_ns(t_ns) if base_ns is None else base_ns)) / 1e9


def span_on_trace(s: Span, base_ns: int | None = None) -> tuple[float, float]:
    """Span ``s``'s start and end in seconds of the trace clock."""
    base = kineto_base_ns(s.t0_ns) if base_ns is None else base_ns
    return trace_seconds(s.t0_ns, base), trace_seconds(s.t1_ns, base)


# -- steps -------------------------------------------------------------------------


class StepTimer:
    """Step timer with a percentile summary; each step is a ``train.step``
    span. On a CUDA device each step records an event at its start on the
    current stream and one more marks the last step's end, so no step
    waits for the device: :meth:`summary` synchronises once and reads the
    events' spacing (a step's time is the device's, or the host's where the
    host lags). Elsewhere each step's host clock."""

    def __init__(self, device: torch.device | None = None):
        self._ms: list[float] = []
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._starts: list = []
        self._end = torch.cuda.Event(enable_timing=True) if self._cuda else None

    @contextlib.contextmanager
    def step(self):
        with span("train.step"):
            if self._cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                self._starts.append(start)
                try:
                    yield
                finally:
                    self._end.record()
            else:
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    self._ms.append((time.perf_counter() - t0) * 1000.0)

    def _step_ms(self) -> list[float]:
        if not self._starts:
            return self._ms
        self._end.synchronize()
        marks = self._starts + [self._end]
        return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]

    def summary(self) -> dict:
        t = np.asarray(self._step_ms())
        if not t.size:
            return {}
        return {
            "steps": len(t),
            "step_ms_p50": float(np.percentile(t, 50)),
            "step_ms_p99": float(np.percentile(t, 99)),
            "step_ms_mean": float(t.mean()),
        }
