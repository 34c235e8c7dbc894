"""The span readers (``slubench/spans.py``, ``metrics/*``) on a synthetic trace
with synthetic program spans, what they do with nothing to read, and a
traced run of ``slubench/drivers/serve.py`` on the CPU that reads the program's own
spans."""

import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from slubench import spans as sp
from slubench.cell import metric_reader
from slubench.drivers import serve
from slubench.port import Marks
from slubench.run import result_line
from slubench.trace import Trace
from tpu_slu_torch.utils.profiling import kineto_base_ns

BASE = kineto_base_ns(time.time_ns())
OFF = 100.0  # the synthetic window's start past the trace's base, in seconds
READERS = ["queue_wait_ms.closed", "server_self_ms.closed", "decode_idle_ms.closed", "h2d_ms.closed",
           "launches_per_call.closed"]
WORKER = 11


def s(name, sid, parent, t0, t1, thread=WORKER, **attrs):
    """A program span of ``t0``-``t1`` seconds on the trace clock."""
    return SimpleNamespace(name=name, id=sid, parent=parent, thread=thread, t0_ns=BASE + round((OFF + t0) * 1e9),
                           t1_ns=BASE + round((OFF + t1) * 1e9), attrs=attrs)


def window(device, host):
    """A trace of window 0-1 s (``OFF`` on the trace clock) with these events."""
    return Trace([(n, OFF + a, OFF + b) for n, a, b in device], [(n, OFF + a, OFF + b) for n, a, b in host],
                 (OFF, OFF + 1.0))


def synthetic():
    """Window 0-1 s. Device busy 0.10-0.20, 0.30-0.35, 0.60-0.70 (and 1.2-1.3,
    past the window). Call A 0.05-0.40 (its decode 0.08-0.38), call B
    0.55-0.95 (decode 0.60-0.90), call C 0.98-1.10 (decode 0.99-1.08, both
    cut at the window's end); three queue spans, one begun before the window."""
    device = [("k7", 0.10, 0.20), ("k4f", 0.30, 0.35), ("Memcpy HtoD", 0.60, 0.70), ("k7", 1.2, 1.3)]
    host = [("cudaLaunchKernel", 0.09, 0.091), ("cudaLaunchKernelExC", 0.2, 0.201),
            ("cudaMemcpyAsync", 0.61, 0.63), ("cudaMemsetAsync", 0.62, 0.621),
            ("cudaLaunchKernel", 0.45, 0.451), ("cudaStreamSynchronize", 0.37, 0.38), ("aten::mm", 0.1, 0.2),
            ("cudaLaunchKernel", 0.995, 0.996), ("cudaLaunchKernel", 1.05, 1.051)]
    spans = [
        s("serve.batch", 1, None, 0.05, 0.40, rids=[0, 1]), s("serve.drain", 2, 1, 0.05, 0.06),
        s("serve.pad", 3, 1, 0.06, 0.08), s("decode", 4, 1, 0.08, 0.38), s("decode.h2d", 5, 4, 0.08, 0.10),
        s("decode.search", 6, 4, 0.10, 0.36), s("decode.readback", 7, 4, 0.36, 0.38),
        s("serve.resolve", 8, 1, 0.38, 0.40),
        s("serve.batch", 10, None, 0.55, 0.95), s("decode", 11, 10, 0.60, 0.90), s("decode.h2d", 12, 11, 0.60, 0.64),
        s("serve.batch", 20, None, 0.98, 1.10), s("decode", 21, 20, 0.99, 1.08),
        s("serve.queue", 30, None, -0.05, 0.05, thread=None, rid=0),
        s("serve.queue", 31, None, 0.00, 0.05, thread=None, rid=1),
        s("serve.queue", 32, None, 0.02, 0.55, thread=None, rid=2),
    ]
    return {"trace": window(device, host), "spans": spans}


def test_spans_go_onto_the_trace_clock_clipped_to_the_window():
    got = sp.window_spans(synthetic())
    assert len(got) == 16
    first = sp.window_spans(synthetic(), "serve.queue")[0]
    assert (first.t0, first.t1, first.attrs) == (OFF, pytest.approx(OFF + 0.05), {"rid": 0})
    last = sp.window_spans(synthetic(), "decode")[-1]
    assert last.t0 == pytest.approx(OFF + 0.99) and last.t1 == OFF + 1.0 and last.parent == 20
    assert sp.window_spans({"trace": None, "spans": synthetic()["spans"]}) == []


def test_each_span_reader_on_the_synthetic_window():
    ctx = synthetic()
    # queue spans clipped: 0.05, 0.05 and 0.53 s
    assert metric_reader("queue_wait_ms.closed").read(ctx) == pytest.approx(1e3 * 0.63 / 3)
    # batch less its decode: 0.35 - 0.30, 0.40 - 0.30, and C cut at 1.0: 0.02 - 0.01
    assert metric_reader("server_self_ms.closed").read(ctx) == pytest.approx(1e3 * 0.16 / 3)
    # idle in each decode: 0.30 - 0.15, 0.30 - 0.10, and C's 0.01 (the busy 1.2-1.3 lies past the window)
    assert metric_reader("decode_idle_ms.closed").read(ctx) == pytest.approx(1e3 * 0.36 / 3)
    assert metric_reader("h2d_ms.closed").read(ctx) == pytest.approx(1e3 * 0.06 / 2)
    # 2 in A, 2 in B, 1 in C inside the window; not the launch between calls, the sync, the operator, nor 1.05
    assert metric_reader("launches_per_call.closed").read(ctx) == pytest.approx(5 / 3)


def test_idle_split_by_innermost_span():
    got = sp.idle_by_span(synthetic())
    want = {"no_span": 0.23, "serve.drain": 0.01, "serve.pad": 0.02, "decode.h2d": 0.02, "decode.search": 0.11,
            "decode.readback": 0.02, "serve.resolve": 0.02, "serve.batch": 0.11, "decode": 0.21}
    assert set(got) == set(want)
    for name, v in want.items():
        assert got[name] == pytest.approx(v, abs=1e-9), name
    assert sum(got.values()) == pytest.approx(1.0 - synthetic()["trace"].busy_s())


def test_interval_helpers():
    assert sp.union([(0.3, 0.4), (0.0, 0.1), (0.05, 0.2)]) == [(0.0, 0.2), (0.3, 0.4)]
    assert sp.covered(0.1, 0.35, [(0.0, 0.2), (0.3, 0.4)]) == pytest.approx(0.15)
    assert sp.mean_ms([]) is None and sp.mean_ms([0.001, 0.003]) == pytest.approx(2.0)


@pytest.mark.parametrize("name", READERS)
def test_a_span_reader_with_nothing_to_read_returns_nothing(name):
    empty = window([], [])
    full = synthetic()
    for ctx in ({}, {"spans": []}, {"trace": None, "spans": full["spans"]}, {"trace": empty, "spans": []},
                {"trace": full["trace"], "spans": []}):
        assert metric_reader(name).read(ctx) is None
    if name in ("decode_idle_ms.closed", "launches_per_call.closed"):  # they read the trace too
        assert metric_reader(name).read({"trace": empty, "spans": full["spans"]}) is None


class CpuTracer:
    """The harness's ``Tracer`` on the CPU: a profiler over the block, the
    window its span on the trace clock, no device operations."""

    def __init__(self, workdir):
        self.trace = None

    def __enter__(self):
        self._prof = profile(activities=[ProfilerActivity.CPU])
        self._prof.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self._prof.__exit__(*exc)
        base = kineto_base_ns(self._t0)
        self.trace = Trace([], [], ((self._t0 - base) / 1e9, (t1 - base) / 1e9))
        return False


def test_a_traced_run_on_the_cpu_reads_the_programs_spans(tiny, monkeypatch):
    from tpu_slu_torch.utils.profiling import clear_spans

    clear_spans()
    monkeypatch.setattr(serve, "Tracer", CpuTracer)
    cell = tiny("s2s_serve_closed")
    res = serve.run(cell, 2**31 + 91, 0.5, True, torch.device("cpu"), Marks(time.time()))
    line = result_line(cell, res, True, "cpu")
    clear_spans()
    # no device operation and no runtime call on the CPU: the span readers of the trace find nothing
    assert set(line["metrics"]) == {"batch_fill.closed", "decode_call_ms.closed", "mfu.closed",
                                    "queue_wait_ms.closed", "server_self_ms.closed", "h2d_ms.closed"}
    assert line["correct"] is True
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert 0.0 < m["h2d_ms.closed"] < m["decode_call_ms.closed"] and m["server_self_ms.closed"] > 0.0
    assert m["queue_wait_ms.closed"] > 0.0
