"""The control and a planted selection fault on the card, at the cell's own
size: the reference put in the program's place, computed with TF32 on or
made to drop its best extension at one step, comes out not correct. Skips
where there is no CUDA device (decided inside each test)."""

import time

import numpy as np
import pytest
import torch

from slubench import checks
from slubench_cells import full_cell
from slubench.drivers import serve
from slubench.port import Marks
from slubench.traffic import sub_seed
from slubench.weights import make_weights

SEED = 2**31 + 4242


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists on the card only")
    return torch.device("cuda", 0)


def failed_numbers(nums: dict, limits: dict) -> set:
    return {n for n, lim in limits.items() if n in nums and nums[n] > lim}


@pytest.mark.cuda
def test_serve_control_and_selection_fault_are_not_correct():
    dev = card()
    cell = full_cell("s2s_serve_closed")
    res = serve.run(cell, SEED, 2.0, False, dev, Marks(time.time()))
    assert all(v <= lim for _, v, lim in res.checks)
    arch, samples, W, U = res.ctx["arch"], res.ctx["samples"], res.ctx["W"], res.ctx["U"]
    p = make_weights(arch, sub_seed(SEED, 3), dev)
    wavs = [s["wav"] for s in samples]
    control = checks.serve_numbers(p, arch, checks.reference_serve(p, arch, wavs, W, U, tf32=True), W, U)
    assert failed_numbers(control, cell.limits), control
    assert np.isfinite(control["score_gap_mean"])
    fault = checks.serve_numbers(p, arch, checks.reference_serve(p, arch, wavs, W, U, skip_best_at=0), W, U)
    assert failed_numbers(fault, cell.limits) == {"search_gap"}, fault
