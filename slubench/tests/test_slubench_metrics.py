"""Each per-layer reader on a synthetic trace, and what it does when there
is nothing to read."""

import collections
import json

import pytest

from slubench_cells import full_cell
from slubench.cell import load_benchmark, metric_reader
from slubench.reference.model import Arch
from slubench.trace import Trace, read_chrome_trace
from slubench.work import PEAK_F32, decode_flops, k7_call_bound_s

K2 = "void (anonymous namespace)::gru_cluster_kernel<2, 2, true, true, false, float>(args)"
K3 = "void (anonymous namespace)::gru_cluster_bwd_kernel<2, 2, false, true>(args)"
CORE = "void (anonymous namespace)::gemm_kernel<0, 0, 128, 128, 8>((anonymous namespace)::GemmArgs)"
K7 = "void (anonymous namespace)::beam_decode_kernel<4, false>(float const*)"
CONV = "void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1, false, false, true>(int)"


def trace():
    # window 0..1 s; device busy 0.1-0.3 (K2, overlapping a copy), 0.4-0.5 (K3), 0.5-0.6 (core), 0.7-0.8 (conv, K7)
    device = [(K2, 0.1, 0.3), ("Memcpy HtoD (Pageable -> Device)", 0.2, 0.25), (K3, 0.4, 0.5), (CORE, 0.5, 0.6),
              (CONV, 0.7, 0.75), (K7, 0.75, 0.8), (K2, 1.2, 1.3)]
    host = [("aten::mm", 0.0, 0.12), ("cudaLaunchKernel", 0.3, 0.32), ("aten::empty_strided", 0.58, 0.65),
            ("cudaLaunchKernel", 0.6, 0.62)]
    return Trace(device, host, (0.0, 1.0))


def test_trace_busy_idle_and_breakdown():
    tr = trace()
    assert tr.busy_s() == pytest.approx(0.2 + 0.2 + 0.1)
    assert tr.device_time([r"gru_cluster_kernel"]) == pytest.approx(0.2)  # the K2 past the window is left out
    ops = dict(tr.device_ops())
    assert ops[K2] == pytest.approx(0.2) and len(ops) == 6
    gaps = dict(tr.idle_gaps())
    # 0-0.1 under aten::mm, 0.3-0.4 under cudaLaunchKernel, 0.6-0.7 under the later launch, 0.8-1.0 under none
    assert gaps["aten::mm"] == pytest.approx(0.1)
    assert gaps["cudaLaunchKernel"] == pytest.approx(0.2)
    assert gaps["no_host_op"] == pytest.approx(0.2)


def test_chrome_trace_reader(tmp_path):
    events = [{"ph": "X", "cat": "user_annotation", "name": "slubench.window", "ts": 1000.0, "dur": 1e6},
              {"ph": "X", "cat": "kernel", "name": K3, "ts": 2000.0, "dur": 500.0},
              {"ph": "X", "cat": "gpu_user_annotation", "name": "Optimizer.step", "ts": 1000.0, "dur": 9e5},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1500.0, "dur": 100.0},
              {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1.0}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = read_chrome_trace(str(path))
    assert tr.window_s == pytest.approx(1.0)
    assert tr.busy_s() == pytest.approx(0.0005)  # annotations on the device are not operations
    assert tr.host == [("aten::mm", 0.0015, 0.0016)]


def ctx_serve():
    arch = Arch(full_cell("s2s_serve_closed").conf)
    calls = [{"t0": 0.0, "t1": 0.012, "lengths": [64000] * 16},
             {"t0": 0.5, "t1": 0.51, "lengths": [48000] * 8 + [0] * 8}]
    fill = collections.Counter({16: 1, 8: 1})
    return {"trace": trace(), "arch": arch, "calls": calls, "batch_fill": fill, "W": 4, "U": 200}, arch, calls


def test_serve_readers():
    ctx, arch, calls = ctx_serve()
    assert metric_reader("batch_fill.closed").read(ctx) == pytest.approx(12.0)
    assert metric_reader("decode_call_ms.closed").read(ctx) == pytest.approx(11.0)
    bound = sum(k7_call_bound_s(arch, c["lengths"], 4, 200) for c in calls)
    assert metric_reader("k7_roofline.closed").read(ctx) == pytest.approx(100 * bound / 0.05)
    flops = 16 * decode_flops(arch, 64000, 4, 200) + 8 * decode_flops(arch, 48000, 4, 200)
    assert metric_reader("mfu.closed").read(ctx) == pytest.approx(100 * flops / PEAK_F32)
    assert metric_reader("device_idle.closed").read(ctx) == pytest.approx(50.0)


@pytest.mark.parametrize("name", ["batch_fill.closed", "decode_call_ms.closed", "k7_roofline.closed", "mfu.closed",
                                  "device_idle.closed"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    empty = Trace([], [], (0.0, 1.0))
    arch = Arch(full_cell("s2s_serve_closed").conf)
    for ctx in ({}, {"trace": None, "arch": arch, "calls": [], "batch_fill": collections.Counter()},
                {"trace": empty, "arch": arch, "calls": [], "batch_fill": collections.Counter(), "W": 4, "U": 200}):
        assert metric_reader(name).read(ctx) is None


@pytest.mark.parametrize("entry", load_benchmark()["per_layer"], ids=lambda m: m["name"])
def test_benchmark_entry_agrees_with_its_reader(entry):
    mod = metric_reader(entry["name"])
    assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == (entry["unit"], entry["layer"], entry["moves"],
                                                            entry["source"])
    moved = {m["name"]: m for m in load_benchmark()["end_to_end"]}[entry["moves"]]
    assert set(entry["workloads"]) <= set(moved.get("workloads", entry["workloads"]))
