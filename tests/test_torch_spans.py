"""The port's program spans (``tpu_slu_torch/utils/profiling.py``): the recorder,
its clock against a real exported Chrome trace, and the spans of the serving
path (``IntentServer``, ``Model.decode_intents``) and of ``StepTimer``, on the
CPU under ``torch.profiler``.

Spans record exactly while a profiler session is active; with none, ``span``
returns the shared no-op and nothing is stamped or kept.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from __graft_entry__ import _make_config
from tpu_slu_torch import serving
from tpu_slu_torch.models.slu import Model
from tpu_slu_torch.serving import IntentServer
from tpu_slu_torch.utils import profiling
from tpu_slu_torch.utils.profiling import (NO_SPAN, SpanRecorder, StepTimer, clear_spans, dropped_spans,
                                           kineto_base_ns, profile_trace, record_span, span, span_on_trace,
                                           spans, trace_seconds)

DECODE_PARTS = ["decode.h2d", "decode.frontend", "decode.encode", "decode.search", "decode.readback",
                "decode.strings"]
SLACK_US = 50.0


@pytest.fixture(scope="module")
def s2s_model(tmp_path_factory):
    config = _make_config(str(tmp_path_factory.mktemp("spans")), small=True)
    config.seq2seq = True
    config.Sy_intent = ["<sos>"] + list("abcdeklmu ") + ["<eos>"]
    config.intent_encoder_dim = 8
    config.num_intent_encoder_layers = 1
    config.intent_decoder_dim = 12
    config.num_intent_decoder_layers = 2
    config.intent_decoder_key_dim = 6
    config.intent_decoder_value_dim = 10
    config.seq2seq_max_decode_len = 5
    return Model(config, seed=3, load_pretrained=False).eval()


@pytest.fixture(autouse=True)
def empty_store():
    clear_spans()
    yield
    clear_spans()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def batch(rng, B=3, T=4000):
    lengths = rng.integers(T // 2, T + 1, B)
    lengths[0] = T
    x = np.zeros((B, T), np.float32)
    for i, n in enumerate(lengths):
        x[i, :n] = 0.1 * rng.standard_normal(n)
    return x, lengths


def by_name(recorded, name=lambda s: s.name):
    out = {}
    for s in recorded:
        out.setdefault(name(s), []).append(s)
    return out


def test_nesting_parents_and_request_ids():
    with cpu_profile():
        with span("outer", rid=7) as outer:
            with span("inner") as inner:
                with span("leaf"):
                    pass
            inner.set(rids=[7, 8])
        t = time.time_ns()
        record_span("queued", t - 1000, t, rid=8)
        with span("second"):
            pass
    got = by_name(spans())
    assert sorted(got) == ["inner", "leaf", "outer", "queued", "second"]
    assert got["outer"][0] is outer and outer.parent is None and outer.attrs == {"rid": 7}
    assert inner.parent == outer.id and inner.attrs == {"rids": [7, 8]}
    assert got["leaf"][0].parent == inner.id
    assert got["second"][0].parent is None
    queued = got["queued"][0]
    assert queued.parent is None and queued.thread is None and queued.attrs == {"rid": 8}
    assert queued.t1_ns - queued.t0_ns == 1000
    for s in (outer, inner, got["leaf"][0]):
        assert s.thread == threading.get_ident() and s.t0_ns <= s.t1_ns
    assert outer.t0_ns <= inner.t0_ns <= got["leaf"][0].t0_ns <= got["leaf"][0].t1_ns <= inner.t1_ns <= outer.t1_ns
    assert len({s.id for s in spans()}) == 5


def test_without_a_profiler_nothing_records_and_span_is_the_shared_no_op():
    assert not profiling.recording()
    s = span("x", rid=1)
    assert s is NO_SPAN and span("y") is NO_SPAN and not s
    with s as entered:
        entered.set(rids=[1])
    record_span("q", 0, 1, rid=1)
    assert spans() == []
    with cpu_profile():
        assert profiling.recording() and span("z")
    assert not profiling.recording() and span("z") is NO_SPAN


def test_a_full_store_counts_what_it_drops():
    rec = SpanRecorder(capacity=3)
    with cpu_profile():
        for i in range(5):
            with rec.span(f"s{i}"):
                pass
        rec.record_span("q", 0, 1)
    assert [s.name for s in rec.spans()] == ["s0", "s1", "s2"] and rec.dropped == 3
    rec.spans().clear()
    assert len(rec.spans()) == 3  # a copy
    rec.clear()
    assert rec.spans() == [] and rec.dropped == 0 and dropped_spans() == 0


def test_threads_keep_their_own_stacks_under_contention():
    """More threads than cores open nested spans at once with a short switch
    interval; every span keeps its own thread's parent and none is lost."""
    n_threads, n_iter = 2 * (os.cpu_count() or 2) + 2, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cpu_profile():
            def work(k):
                for _ in range(n_iter):
                    with span("t.outer", rid=k):
                        with span("t.inner", rid=k):
                            pass

            threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = spans()
    ids = {s.id: s for s in got}
    assert len(got) == len(ids) == 2 * n_threads * n_iter
    for s in got:
        if s.name == "t.inner":
            parent = ids[s.parent]
            assert parent.name == "t.outer" and parent.thread == s.thread and parent.attrs == s.attrs
        else:
            assert s.parent is None


def test_the_serving_path_records_nothing_and_no_span_object_without_a_profiler(s2s_model, monkeypatch):
    """No profiler: ``submit`` stamps nothing, no ``Span`` is made, and no
    code of the spans reads the clock for them."""
    made = []

    class Counted(profiling.Span):
        __slots__ = ()

        def __init__(self, *args):
            made.append(args)
            super().__init__(*args)

    class NoNsClock:
        def __getattr__(self, name):
            if name == "time_ns":
                raise AssertionError("a span clock was read")
            return getattr(time, name)

    monkeypatch.setattr(profiling, "Span", Counted)
    monkeypatch.setattr(profiling, "time", NoNsClock())
    monkeypatch.setattr(serving, "time", NoNsClock())
    x, lengths = batch(np.random.default_rng(1))
    s2s_model.decode_intents(x, lengths=lengths)
    server = IntentServer(s2s_model, max_batch=4, batch_window_ms=1)
    try:
        futs = [server.submit(w[:n]) for w, n in zip(x, lengths)]
        assert all(item[2] is None for item in list(server._queue.queue))
        for f in futs:
            f.result(timeout=120)
    finally:
        server.close()
    assert made == [] and spans() == []


def test_the_server_records_a_queue_span_a_request_and_a_batch_span_a_call(s2s_model):
    rng = np.random.default_rng(2)
    x, lengths = batch(rng, B=6)
    server = IntentServer(s2s_model, max_batch=4, batch_window_ms=20)
    try:
        server.warmup(seconds=(0.25,))
        n_calls0 = sum(server.batch_sizes.values())
        with cpu_profile():
            futs = [server.submit(w[:n]) for w, n in zip(x, lengths)]
            answers = [f.result(timeout=120) for f in futs]
        n_calls = sum(server.batch_sizes.values()) - n_calls0
    finally:
        server.close()
    assert all(isinstance(a, str) for a in answers)
    got = by_name(spans())
    queue_spans, batches = got["serve.queue"], got["serve.batch"]
    assert sorted(s.attrs["rid"] for s in queue_spans) == sorted(r for b in batches for r in b.attrs["rids"])
    assert len(queue_spans) == len(x) and len({s.attrs["rid"] for s in queue_spans}) == len(x)
    assert len(batches) == n_calls >= 2 and all(len(b.attrs["rids"]) <= 4 for b in batches)
    ids = {s.id: s for s in spans()}
    for b in batches:
        kids = sorted((s for s in spans() if s.parent == b.id), key=lambda s: s.t0_ns)
        assert [k.name for k in kids] == ["serve.drain", "serve.pad", "decode", "serve.resolve"]
        decode = kids[2]
        parts = sorted((s for s in spans() if s.parent == decode.id), key=lambda s: s.t0_ns)
        assert [p.name for p in parts] == DECODE_PARTS
        for a, c in zip(parts, parts[1:]):
            assert a.t1_ns <= c.t0_ns  # one after another
        assert b.t0_ns <= kids[0].t0_ns and kids[-1].t1_ns <= b.t1_ns
    for q in queue_spans:
        owner = next(b for b in batches if q.attrs["rid"] in b.attrs["rids"])
        assert q.t0_ns <= q.t1_ns <= owner.t1_ns and q.thread is None and q.parent is None
    assert all(ids[d.parent].name == "serve.batch" for d in got["decode"])


def chrome_events(path):
    with open(path) as f:
        data = json.load(f)
    return data, [e for e in data["traceEvents"] if e.get("ph") == "X"]


def test_same_thread_spans_lie_on_the_trace_clock(s2s_model, tmp_path):
    """A decode on the profiling thread: each span, put on the clock of the
    exported trace by the helper, holds its ``record_function`` copy and the
    copy's operators, within 50 us; the helper's base is the trace's."""
    x, lengths = batch(np.random.default_rng(3))
    s2s_model.decode_intents(x, lengths=lengths)
    with cpu_profile() as prof:
        for _ in range(2):
            s2s_model.decode_intents(x, lengths=lengths)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    data, events = chrome_events(path)
    recorded = spans()
    assert kineto_base_ns(recorded[0].t0_ns) == int(data["baseTimeNanoseconds"])
    copies = by_name((e for e in events if e.get("cat") == "user_annotation"), lambda e: e["name"])
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    got = by_name(recorded)
    assert sorted(got) == sorted(["decode"] + DECODE_PARTS) and all(len(v) == 2 for v in got.values())
    slack = SLACK_US * 1e-6
    n_ops = 0
    for name, mine in got.items():
        theirs = sorted(copies[name], key=lambda e: e["ts"])
        assert len(theirs) == len(mine)
        for s, e in zip(sorted(mine, key=lambda s: s.t0_ns), theirs):
            t0, t1 = span_on_trace(s)
            c0, c1 = e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6
            assert t0 - slack <= c0 <= c1 <= t1 + slack, name
            assert c1 - c0 <= t1 - t0 + slack
            inside = [o for o in ops if o["tid"] == e["tid"] and c0 <= o["ts"] * 1e-6 < c1]
            for o in inside:
                assert t0 - slack <= o["ts"] * 1e-6 <= (o["ts"] + o["dur"]) * 1e-6 <= t1 + slack
            n_ops += len(inside)
    assert n_ops > 0
    assert trace_seconds(recorded[0].t0_ns, int(data["baseTimeNanoseconds"])) == span_on_trace(recorded[0])[0]


def test_profile_traces_file_holds_the_spans(s2s_model, tmp_path):
    x, lengths = batch(np.random.default_rng(4))
    with profile_trace(str(tmp_path / "p"), "serve"):
        s2s_model.decode_intents(x, lengths=lengths)
        timer = StepTimer(torch.device("cpu"))
        for _ in range(2):
            with timer.step():
                torch.ones(8) * 2
    _, events = chrome_events(tmp_path / "p" / "rank0.serve.pt.trace.json")
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    for name in ["decode"] + DECODE_PARTS:
        assert names.count(name) == 1, name
    assert names.count("train.step") == 2
    assert [s.name for s in spans()].count("train.step") == 2
    assert timer.summary()["steps"] == 2


def test_the_cpu_step_timer_times_each_step_on_the_host():
    timer = StepTimer(torch.device("cpu"))
    assert timer.summary() == {}
    for pause in (0.002, 0.004, 0.006):
        with timer.step():
            time.sleep(pause)
    got = timer.summary()
    assert got["steps"] == 3 and set(got) == {"steps", "step_ms_p50", "step_ms_p99", "step_ms_mean"}
    assert 4.0 <= got["step_ms_p50"] and 2.0 <= got["step_ms_mean"] <= got["step_ms_p99"]
    assert spans() == []
