"""What the span readers share: the program's spans on the traced window's clock.

The program records spans (``tpu_slu_torch/utils/profiling.py``) while a
``torch.profiler`` session runs, which the traced run's :class:`~slubench.trace.Tracer`
is, and keeps them in memory. :func:`window_spans` puts them on the clock of
the run's :class:`~slubench.trace.Trace` and clips them to its window;
:func:`idle_by_span` splits the window's idle device time by the innermost
span open at each moment. A program without spans gives nothing to read, and
each reader then returns ``None``.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

LAUNCH_PREFIXES = ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")


@dataclass(frozen=True)
class WSpan:
    """A span on the trace clock, clipped to the window: seconds ``t0``-``t1``."""

    name: str
    id: int
    parent: int | None
    thread: int | None
    t0: float
    t1: float
    attrs: dict

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


def program_spans(ctx: dict) -> list:
    """``ctx["spans"]`` where given, else a copy of the program's span store
    (empty where the program records none)."""
    if "spans" in ctx:
        return list(ctx["spans"] or [])
    try:
        from tpu_slu_torch.utils.profiling import spans
    except ImportError:
        return []
    return spans()


def window_spans(ctx: dict, name: str | None = None) -> list[WSpan]:
    """The spans (named ``name``, or all) that overlap the traced window, on
    its clock and clipped to it, in time order; [] without a trace."""
    tr = ctx.get("trace")
    raw = [s for s in program_spans(ctx) if s.t1_ns is not None]
    if tr is None or not raw:
        return []
    from tpu_slu_torch.utils.profiling import kineto_base_ns, span_on_trace

    base = kineto_base_ns(min(s.t0_ns for s in raw))
    w0, w1 = tr.window
    out = []
    for s in raw:
        if name is not None and s.name != name:
            continue
        t0, t1 = span_on_trace(s, base)
        if t1 > w0 and t0 < w1:
            out.append(WSpan(s.name, s.id, s.parent, s.thread, max(t0, w0), min(t1, w1), dict(s.attrs)))
    return sorted(out, key=lambda s: (s.t0, -s.t1))


def covered(t0: float, t1: float, intervals: list[tuple[float, float]]) -> float:
    """Seconds of ``t0``-``t1`` that sorted, disjoint ``intervals`` cover."""
    return sum(max(0.0, min(t1, e) - max(t0, s)) for s, e in intervals if e > t0 and s < t1)


def union(intervals) -> list[tuple[float, float]]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def mean_ms(values: list[float]) -> float | None:
    return 1e3 * sum(values) / len(values) if values else None


def idle_gaps(tr) -> list[tuple[float, float]]:
    """The window's stretches in which no device operation ran."""
    gaps, t = [], tr.window[0]
    for s, e in tr.busy_intervals():
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if tr.window[1] > t:
        gaps.append((t, tr.window[1]))
    return gaps


def idle_by_span(ctx: dict) -> dict[str, float]:
    """Seconds of the window's idle device time by the innermost span open at
    each moment (the latest opened of those a thread opened: ``serve.queue``
    and other spans with no thread of their own are left out); ``no_span``
    where none was. {} without a trace or spans."""
    tr = ctx.get("trace")
    spans = [s for s in window_spans(ctx) if s.thread is not None]
    if tr is None or not spans:
        return {}
    points = sorted({t for g in idle_gaps(tr) for t in g} | {t for s in spans for t in (s.t0, s.t1)})
    gaps = idle_gaps(tr)
    by: dict[str, float] = defaultdict(float)
    active: list[WSpan] = []
    i = g = 0
    for a, b in zip(points, points[1:]):
        while i < len(spans) and spans[i].t0 <= a:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s.t1 > a]
        while g < len(gaps) and gaps[g][1] <= a:
            g += 1
        if g < len(gaps) and gaps[g][0] <= a:
            inner = max(active, key=lambda s: (s.t0, -s.t1), default=None)
            by[inner.name if inner else "no_span"] += b - a
    return dict(by)
