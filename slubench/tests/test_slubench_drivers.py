"""A tiny run of the serving driver on the CPU through the program's plain
PyTorch path, the result line it makes, and the same runs with the timed
path broken underneath: each fault the cell can have turns ``correct`` false.

The harness's look for a chip is skipped: the driver is called with the
CPU device, at widths a test can hold, against the cell's own limits."""

import json
import time

import torch

from slubench.drivers import serve
from slubench.port import Marks
from slubench.run import result_line

CPU = torch.device("cpu")
SEED = 2**31 + 77


def run_cell(cell, trace=False):
    res = serve.run(cell, SEED, 0.5, trace, CPU, Marks(time.time()))
    return result_line(cell, res, trace, "cpu")


def check_shape(line: dict, metrics: set):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == metrics
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.dumps(line)


def test_serve_driver_line(tiny):
    cell = tiny("s2s_serve_closed")
    line = run_cell(cell)
    check_shape(line, {"serve_utt_per_s", "serve_p95_ms", "setup_s"})
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == set(cell.limits)
    assert line["checks"]["search_gap"]["value"] == 0.0


def test_traced_line_on_the_cpu_reads_nothing_of_the_device(tiny, monkeypatch):
    monkeypatch.setattr(serve, "Tracer", lambda workdir: _NoTrace())
    line = run_cell(tiny("s2s_serve_closed"), trace=True)
    # only the host's readers find something: the server's counter and the call times
    assert set(line["metrics"]) == {"batch_fill.closed", "decode_call_ms.closed"} and line["correct"] is True


class _NoTrace:
    trace = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def searched(monkeypatch, change):
    """The program's search with ``change`` applied to what it returns."""
    from tpu_slu_torch.models import slu

    real = slu.beam_decode
    monkeypatch.setattr(slu, "beam_decode", lambda *args, **kwargs: change(*real(*args, **kwargs)))


def test_fault_token_altered_where_the_search_makes_it(tiny, monkeypatch):
    def altered(scores, tokens):
        tokens = tokens.clone()
        tokens[0, :, 2] = (tokens[0, :, 2] + 1) % 12
        return scores, tokens

    searched(monkeypatch, altered)
    line = run_cell(tiny("s2s_serve_closed"))
    gap = line["checks"]["score_gap_mean"]
    assert line["correct"] is False and gap["value"] > gap["limit"]


def test_fault_search_puts_its_second_best_first(tiny, monkeypatch):
    # scored right and served as returned: only the search's own check sees it
    searched(monkeypatch, lambda scores, tokens: (scores[[1, 0, 2, 3]], tokens[[1, 0, 2, 3]]))
    line = run_cell(tiny("s2s_serve_closed"))
    checks = line["checks"]
    assert line["correct"] is False and checks["search_gap"]["value"] > checks["search_gap"]["limit"]
    assert checks["score_gap_mean"]["value"] <= checks["score_gap_mean"]["limit"]
    assert checks["answer_mismatches"]["value"] == 0


def test_fault_answer_altered_where_it_is_served(tiny, monkeypatch):
    from tpu_slu_torch.models.slu import Model

    real = Model.decode_intents
    monkeypatch.setattr(Model, "decode_intents", lambda self, x, bucket=False, lengths=None: [
        a + "x" for a in real(self, x, bucket=bucket, lengths=lengths)])
    line = run_cell(tiny("s2s_serve_closed"))
    assert line["correct"] is False and line["checks"]["answer_mismatches"]["value"] > 0


def test_the_check_finds_each_sampled_request_in_the_batch_that_served_it(tiny):
    cell = tiny("s2s_serve_closed")
    res = serve.run(cell, SEED, 0.5, False, CPU, Marks(time.time()))
    assert len(res.ctx["samples"]) == cell.mix["check_requests"]
    assert dict((n, v) for n, v, _ in res.checks)["answer_mismatches"] == 0
