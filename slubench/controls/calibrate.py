"""The readings that the limits of ``correct`` are set from, on the card.

    python3 -m slubench.controls.calibrate --workload s2s_serve_closed --seeds 1 2 ... --controls 3 --seconds 3

One process, one JSON line a reading, at the cell's own size:

* ``sound``: the program as the benchmark runs it, one reading a seed: a
  short window at the cell's load, then the check of its sample;
* on the first ``--controls`` seeds, judged by the same numbers on the same
  sample's waveforms, with in the program's place:
  * ``control_tf32``: the reference's search computed with TF32 on (the
    lower-precision control);
  * ``same_f32``: the reference's own f32 search (what a sound search
    reads);
  * ``fault_skip_best_<u>``: the reference's f32 search that drops the best
    extension at step ``u`` (a planted selection fault, at each step of
    ``--skip-steps``);
  * ``fault_order``: the program's own hypotheses with its first two
    swapped (a search that does not put its best first).

Run from the root of a checkout on a machine with one GPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from slubench import checks
from slubench.cell import load_benchmark, load_cell
from slubench.drivers import serve
from slubench.port import Marks
from slubench.reference.model import ids_to_string
from slubench.traffic import sub_seed
from slubench.weights import make_weights


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def spread(g: dict) -> dict:
    """What the look needs of :func:`checks.serve_gaps`: each number's
    largest, mean and median over the samples, and how near the
    reference's own best two came."""
    sg, raw = g["score_gap"], g["search_gap"]
    return {"score_gap_max": float(sg.max()), "score_gap_median": float(np.median(sg)),
            "score_gaps_nonzero": int((sg > 0).sum()), "search_gap_raw": float(max(0.0, raw.max())),
            "top2_min": float(g["top2"].min()), "near_ties": int((g["top2"] <= 2.0 * sg).sum())}


def swapped(samples: list[dict], labels) -> list[dict]:
    """The samples with their first two hypotheses in each other's place."""
    out = []
    for s in samples:
        order = [1, 0] + list(range(2, len(s["scores"])))
        tokens = s["tokens"][order]
        out.append({**s, "tokens": tokens, "scores": s["scores"][order], "served": ids_to_string(tokens[0], labels)})
    return out


def readings(cell, seed: int, device, control: bool, seconds: float, skip_steps: list[int]) -> None:
    t0 = time.perf_counter()
    res = serve.run(cell, seed, seconds, False, device, Marks(time.time()))
    nums = {n: v for n, v, _ in res.checks}
    samples, arch, W, U = res.ctx["samples"], res.ctx["arch"], res.ctx["W"], res.ctx["U"]
    p = make_weights(arch, sub_seed(seed, 3), device)
    emit(kind="sound", seed=seed, **nums, **spread(checks.serve_gaps(p, arch, samples, W, U)),
         score_median=float(np.median([abs(s["scores"][0]) for s in samples])),
         rate=res.end_to_end["serve_utt_per_s"], s=time.perf_counter() - t0)
    if not control:
        return
    wavs = [s["wav"] for s in samples]
    runs = [("control_tf32", {"tf32": True}), ("same_f32", {})]
    runs += [(f"fault_skip_best_{u}", {"skip_best_at": u}) for u in skip_steps]
    for kind, kw in runs:
        t1 = time.perf_counter()
        other = checks.reference_serve(p, arch, wavs, W, U, **kw)
        emit(kind=kind, seed=seed, **checks.serve_numbers(p, arch, other, W, U),
             **spread(checks.serve_gaps(p, arch, other, W, U)), s=time.perf_counter() - t1)
    other = swapped(samples, arch.labels)
    emit(kind="fault_order", seed=seed, **checks.serve_numbers(p, arch, other, W, U),
         **spread(checks.serve_gaps(p, arch, other, W, U)))


def main() -> None:
    ap = argparse.ArgumentParser(prog="python3 -m slubench.controls.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3, help="seeds (the first ones) that also read the controls")
    ap.add_argument("--seconds", type=float, default=3.0, help="the window of each reading")
    ap.add_argument("--skip-steps", type=int, nargs="*", default=[0, 100],
                    help="steps at which the planted selection fault drops the best extension")
    args = ap.parse_args()
    cell = load_cell(load_benchmark(), args.workload)
    device = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        readings(cell, seed, device, i < args.controls, args.seconds, args.skip_steps)


if __name__ == "__main__":
    main()
