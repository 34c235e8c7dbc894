"""The developer copies of ``chip_smoke.py`` (``VARIANTS``) edit kernel text
that exists; its phase splits name kernels that exist; its beam-search tie
check allows the f32 drift of the summed steps.

Each variant is a copy of ``tpu_slu_torch/csrc`` with some exact texts
replaced, compiled on the card beside the port's library for an A/B or a
trace. A text that no longer occurs (the template's lines changed) or occurs
in several files would stop the smoke on the card; here it fails on the CPU,
with no compiler.
"""

import os
import re

import numpy as np
import pytest

import chip_smoke
from tpu_slu_torch.ops import _build


def _sources() -> dict:
    texts = {}
    for fn in os.listdir(_build.CSRC):
        with open(os.path.join(_build.CSRC, fn)) as f:
            texts[fn] = f.read()
    return texts


@pytest.mark.parametrize("name", sorted(chip_smoke.VARIANTS))
def test_variant_edits_apply_to_one_source(name):
    source, edits, flags = chip_smoke.VARIANTS[name]
    texts = _sources()
    assert source in texts and source.endswith(".cu")
    for old, new in edits:
        assert old != new
        assert len([fn for fn, t in texts.items() if old in t]) == 1, old


def test_other_size_variants_invert_only_the_two_direction_rule():
    """K1's, K2's and K4f's A/B copies change the two-direction cluster rule
    and nothing of K5f's one-direction rule."""
    sizes = {}
    for name in ("k1_other_c", "k2_other_c", "k4f_other_c"):
        (rule, inverted), _ = chip_smoke.VARIANTS[name][1]
        sizes[name] = inverted
        assert rule.startswith("*C = (ndir == 1 ? 4 * B <= sms : ")
        assert inverted.startswith("*C = (ndir == 1 ? 4 * B <= sms : ") and inverted != rule
    assert len(set(sizes.values())) == 1


def _kernels_of(source: str) -> set:
    """The ``__global__`` functions that ``source`` defines, through its
    local ``#include "..."`` files too, read from the text."""
    seen, todo, text = set(), [source], ""
    while todo:
        fn = todo.pop()
        if fn in seen:
            continue
        seen.add(fn)
        with open(os.path.join(_build.CSRC, fn)) as f:
            body = f.read()
        text += body
        todo += re.findall(r'^#include "([^"]+)"', body, re.M)
    return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\(.*?\)\s+)?(\w+)\s*\(", text))


@pytest.mark.parametrize("phases,source", [("K3_PHASES", "bigru_shared_bwd.cu"),
                                           ("K4B_PHASES", "bigru_masked_bwd.cu"),
                                           ("K5B_PHASES", "bigru_masked_bwd.cu")])
def test_phase_splits_name_kernels_of_their_source(phases, source):
    """Every kernel name of a phase split (``device_split`` matches them in
    the profiler's names) is a kernel its backward's source compiles."""
    defined = _kernels_of(source)
    names = getattr(chip_smoke, phases).values()
    for name in names:
        assert name.split("<")[0] in defined, (name, sorted(defined))
    assert len(set(names)) == len(names)


def test_the_backward_chain_is_the_cluster_kernel():
    """K4b's and K5b's chain is the backward cluster recurrence; the one-CTA
    chain they ran before is gone from their source, and K3 keeps its own."""
    assert chip_smoke.K4B_PHASES["chain"] == "gru_cluster_bwd_kernel"
    assert "masked_bwd_chain_kernel" not in _kernels_of("bigru_masked_bwd.cu")
    assert "bwd_chain_kernel" in _kernels_of("bigru_shared_bwd.cu")


def test_k6_runs_the_cluster_recurrence():
    """K6's recurrence is K1's cluster kernel with the row-stacked flag; the
    one-CTA recurrence it ran before is gone from every source."""
    assert "gru_cluster_kernel" in _kernels_of("bigru_shared_fwd.cu")
    for fn in os.listdir(_build.CSRC):
        assert "bigru_rec_kernel" not in _kernels_of(fn), fn
    with open(os.path.join(_build.CSRC, "bigru_shared_fwd.cu")) as f:
        assert f.read().count("gru_cluster_rec<true, false, true>") == 1


@pytest.mark.parametrize("steps,score", [(1, -3.0), (24, -60.5), (56, -252.0), (200, -903.25)])
def test_tie_tolerance_is_the_drift_of_the_summed_steps(steps, score):
    """(steps + 4) spacings of the largest score, 2^-23 |s| a spacing, and
    at least 1e-5."""
    want = max((steps + 4) * 2**-23 * abs(score), 1e-5)
    assert chip_smoke.tie_tolerance(steps, [score / 2, score]) == want
    assert chip_smoke.tie_tolerance(steps, [10 * score]) < chip_smoke.tie_tolerance(steps + 1, [10 * score])
    assert chip_smoke.tie_tolerance(steps, [0.0, -1e-3]) == 1e-5


@pytest.mark.parametrize("steps", [1, 24, 56, 200])
def test_two_f32_running_sums_stay_within_the_tie_tolerance(steps):
    """Two f32 searches of the same hypothesis: each sums its own
    log-probabilities step by step in f32, and their log-probabilities
    differ by up to 2 units of f32 rounding each (another order of
    evaluation). Over seeded draws of widely spread log-probabilities the
    two scores stay within the bound; one search also stays within half of
    it of the exact sum of its own log-probabilities."""
    rng = np.random.default_rng(steps)
    worst = 0.0
    for _ in range(200):
        lp = -rng.exponential(rng.choice([0.01, 1.0, 10.0]), steps)
        one, two = (np.float32(lp * (1 + rng.uniform(-2, 2, steps) * 2.0**-24)) for _ in range(2))
        s1, s2 = np.add.accumulate(one)[-1], np.add.accumulate(two)[-1]
        assert s1.dtype == np.float32
        tol = chip_smoke.tie_tolerance(steps, [float(s1), float(s2)])
        assert abs(float(s1) - float(s2)) <= tol
        assert abs(float(s1) - one.astype(np.float64).sum()) <= steps * 2**-24 * abs(float(s1)) + 1e-30
        worst = max(worst, abs(float(s1) - float(s2)) / tol)
    assert worst > 0.0


def _search(scores, tokens):
    """A search of n steps as ``compare_searches`` calls it: the first n
    columns of fixed tokens (W, B, U), with ``scores[n]`` (W, B)."""
    import torch

    return lambda n: (torch.tensor(scores[n]), torch.tensor(tokens)[:, :, :n])


@pytest.mark.parametrize("apart,passes", [(0.5, True), (2.0, False)])
def test_compare_searches_takes_a_tie_within_the_drift(apart, passes):
    """Two beams swapped at step 3 of 5: a tie where their sorted scores
    differ by half the drift of 4 summed steps, a fault at twice it."""
    U, s = 5, -100.0
    tol = chip_smoke.tie_tolerance(4, [s])
    ref_tokens = np.array([[[1, 1, 1, 1, 1]], [[1, 1, 1, 2, 2]]])
    got_tokens = ref_tokens[[1, 0]].copy()
    got_tokens[:, :, :3] = ref_tokens[:, :, :3]
    ref_scores = {n: [[s], [s - 1e-3]] for n in range(U + 1)}
    got_scores = {n: [[s], [s - 1e-3 - apart * tol]] for n in range(U + 1)}
    run, ref_run = _search(got_scores, got_tokens), _search(ref_scores, ref_tokens)
    if passes:
        _, _, rows, notes = chip_smoke.compare_searches("case", run, ref_run, U)
        assert rows == [] and len(notes) == 1 and "step 3 of 5" in notes[0]
    else:
        with pytest.raises(AssertionError, match="f32 drift of 4 summed steps"):
            chip_smoke.compare_searches("case", run, ref_run, U)
