"""Run one cell of the benchmark once and print its result.

    python3 -m slubench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's GPUs. The cell,
its configuration, traffic mix, limits and per-layer readers are found by
name (:mod:`slubench.cell`); the mix's ``driver`` runs set-up, the window
and the check (``slubench/drivers/``). With ``--trace 0`` the result's
metrics are the cell's end-to-end ones, with ``--trace 1`` its per-layer
ones, read from the profiled window. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and with ``--trace 1`` ``breakdown``), then ``checks``: each
number that decided ``correct`` beside its limit, also printed as the last
lines of standard error.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """This process's start on the ``time.time()`` clock (Linux's
    /proc; elsewhere the moment this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_PROCESS = _process_start()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_slu"}  # compared by whole top-level name


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m slubench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from slubench.cell import load_benchmark, load_cell
    from slubench.port import Marks

    cell = load_cell(load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slubench: {cell.name} needs {cell.chips} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    marks = Marks(T_PROCESS)
    marks("torch")
    torch.zeros(1, device=device)
    marks("cuda context")
    driver = importlib.import_module(f"slubench.drivers.{cell.mix['driver']}")
    res = driver.run(cell, args.seed, args.seconds, bool(args.trace), device, marks)

    found = loaded_forbidden()
    if found:
        print(f"slubench: the process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    out = result_line(cell, res, bool(args.trace), torch.cuda.get_device_name(device))
    if args.trace:
        print(f"slubench: shares against the published H100 SXM peaks; card and power limit: {power_limit()}",
              file=sys.stderr)
    for n, v, lim in res.checks:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def result_line(cell, res, trace: bool, kind: str) -> dict:
    """The result's JSON object: with ``trace`` the cell's per-layer metrics
    that its readers found (``metrics/<name>.py``), the device's busy time
    and the breakdown, else its end-to-end metrics; ``checks`` last."""
    from slubench.cell import metric_reader

    dev = {"platform": "gpu", "kind": kind, "count": cell.chips, "memory_peak_bytes": res.memory_peak_bytes}
    out = {"correct": None, "attempted": res.attempted, "failed": res.failed, "metrics": {}, "device": dev}
    if trace:
        tr = res.ctx["trace"]
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(res.ctx)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s
            out["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        for m in cell.end_to_end:
            out["metrics"][m["name"]] = {"value": res.end_to_end[m["name"]], "unit": m["unit"]}
    out["correct"] = res.failed == 0 and all(v <= lim for _, v, lim in res.checks)
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in res.checks}
    return out


if __name__ == "__main__":
    sys.exit(main())
