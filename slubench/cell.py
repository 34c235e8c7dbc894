"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (a ``workloads`` entry) names a configuration and a traffic mix;
each lives in a file of its own:

* ``slubench/configs/<config>.json`` (the entry's ``file``): the sections
  of the configuration as it is run, in the source's .cfg format, and what
  the harness adds (``num_phonemes``, the seq2seq ``labels``, the
  ``serve`` settings);
* ``slubench/traffic/<traffic>.json``: the mix's parameters, its
  ``generator`` (:mod:`slubench.traffic`) and its ``driver``
  (``slubench/drivers/<driver>.py``);
* ``slubench/limits/<workload>.json``: the limit of each number that
  decides ``correct``;
* ``slubench/metrics/<metric>.py``: one reader a per-layer metric.

So a later change adds a configuration, a mix, a cell or a per-layer
metric by adding files and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    conf: dict  # the configuration file
    mix: dict  # the traffic file
    limits: dict  # the correctness limits of this cell
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    workdir: str  # build/slubench/<workload>: the run's scratch, inside the checkout


def _reports(metric: dict, cell: str, e2e_names: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(bench: dict, name: str) -> Cell:
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(sorted(work))})")
    w = work[name]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    return Cell(
        name=name,
        chips=int(w["chips"]),
        conf=_json(os.path.join(ROOT, config["file"])),
        mix=_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json")),
        limits=_json(os.path.join(HERE, "limits", f"{name}.json")),
        end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"] if _reports(m, name, names)],
        workdir=os.path.join(ROOT, "build", "slubench", name),
    )


def metric_reader(name: str):
    """The reader module of per-layer metric ``name``
    (``slubench/metrics/<name>.py``): ``UNIT``, ``LAYER``, ``MOVES``,
    ``SOURCE`` and ``read(ctx) -> float | None``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"slubench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
