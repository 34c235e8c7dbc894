"""K8's launch plan (``tpu_slu_torch/ops/frontend_fused.py`` ``frontend_plan``).

The plan is plain Python, so the plan the card runs is checked here: the
kernel's walk over it (CTA c keeps filter tile c % nft and walks the
(example, row tile) items c // nft, c // nft + grid // nft, ...; the walk
of ``csrc/sinc_frontend.cu`` ``sinc_frontend_kernel``) covers every
(example, conv row, filter) exactly once, no pooling window straddles two
items, the shared memory fits an H100's 227 KB a block and the grid is at
most one wave of its 132 SMs. The kernel itself is held against its plain
version on the card in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

from tests.test_torch_cuda import K8_CASES
from tpu_slu_torch.ops.frontend_fused import (MAX_THREADS, SMEM_LIMIT, THREAD_FILTERS, THREAD_ROWS,
                                              frontend_plan, smem_bytes)

SMS = 132  # an H100 SXM's SMs
FLAGSHIP = dict(F=80, K=401, S=80, pad=200, pool=2)  # the sinc layer of experiments/no_unfreezing.cfg
SHAPES = ([(B, T, *FLAGSHIP.values()) for B in (1, 2, 16, 128, 300) for T in (1555, 16000, 52800, 64000)]
          + list(K8_CASES))


def walk(plan: dict, B: int):
    """The kernel's work items: (CTA, example, first conv row, first filter)."""
    per_tile = plan["grid"] // plan["nft"]
    for c in range(plan["grid"]):
        it = c // plan["nft"]
        while it < B * plan["nrt"]:
            yield c, it // plan["nrt"], it % plan["nrt"] * plan["rows"], c % plan["nft"] * plan["ftile"]
            it += per_tile


@pytest.mark.parametrize("B,T,F,K,S,pad,pool", SHAPES)
def test_plan_covers_every_output_once_and_fits_the_card(B, T, F, K, S, pad, pool):
    plan = frontend_plan(B, T, F, K, S, pad, pool, SMS)
    t_out = (T + 2 * pad - K) // S + 1
    rows, ft = plan["rows"], plan["ftile"]
    assert plan["t_out"] == t_out and plan["nrt"] == -(-t_out // rows) and plan["nft"] == -(-F // ft)
    assert rows % THREAD_ROWS == 0 and rows % pool == 0 and ft % THREAD_FILTERS == 0
    work = plan["ksplit"] * rows // THREAD_ROWS * ft // THREAD_FILTERS
    assert plan["threads"] % 32 == 0 and work <= plan["threads"] < work + 32 and plan["threads"] <= MAX_THREADS
    assert 1 <= plan["ksplit"] <= -(-K // 4)
    assert plan["smem"] == smem_bytes(rows, ft, plan["ksplit"], K, S, pool) <= SMEM_LIMIT == 232_448
    assert plan["grid"] <= SMS and plan["grid"] % plan["nft"] == 0
    seen = np.zeros((B, t_out, F), np.int8)
    ctas = set()
    for c, b, r0, f0 in walk(plan, B):
        ctas.add(c)
        assert r0 % pool == 0  # an item starts a pooling window, so none straddles two items
        seen[b, r0:r0 + rows, f0:f0 + ft] += 1
    assert (seen == 1).all()
    assert ctas == set(range(plan["grid"]))  # no CTA idles


@pytest.mark.parametrize("boundary,epilogue", [
    *[(b, "tile") for b in ("filters split at B=1", "several items a CTA", "F past its last filter tile",
                            "one conv row", "ragged last window", "scalar stride")],
    *[(b, "registers") for b in ("several items a CTA", "F past its last filter tile", "ragged last window")]])
def test_k8_card_cases_reach_the_plans_boundaries(boundary, epilogue):
    """The card test's K8_CASES take each edge of the plan the kernel walks,
    where it can, through each epilogue: the windows pooled in registers
    (one tap group, a pool dividing 8) or through the tile of each tap
    group's sums."""
    def reaches(B, T, F, K, S, pad, pool):
        p = frontend_plan(B, T, F, K, S, pad, pool, SMS)
        registers = p["ksplit"] == 1 and 8 % pool == 0
        return (registers == (epilogue == "registers")) and {
            "filters split at B=1": B == 1 and p["nft"] > 1,
            "several items a CTA": B * p["nrt"] > p["grid"] // p["nft"],
            "F past its last filter tile": F % p["ftile"] != 0,
            "one conv row": p["t_out"] == 1,
            "ragged last window": p["t_out"] % pool != 0,
            "scalar stride": S % 4 != 0}[boundary]
    assert any(reaches(*case) for case in K8_CASES)


# the fastest plan on 4 s at each B (rows, filter tile, tap split, CTAs)
FASTEST = {1: (32, 16, 16, 125), 16: (104, 80, 1, 128), 128: (96, 80, 1, 132)}


@pytest.mark.parametrize("B", [1, 16, 128])
def test_plan_is_the_cheapest_admitted_and_fills_the_card(B):
    """At the flagship on 4 s frontend_plan takes the plan that was the
    fastest on an H100 of all the plans it admits (rows, filter tile, tap
    split, CTAs; tools/torch_cluster_ab.py --k8-plans, PERF.md section 6),
    and it keeps at least 120 of the 132 SMs busy."""
    shape = (B, 64000, *FLAGSHIP.values())
    plan = frontend_plan(*shape, SMS)
    assert (plan["rows"], plan["ftile"], plan["ksplit"], plan["grid"]) == FASTEST[B]
    assert plan["grid"] >= 120
    assert frontend_plan(*shape, SMS) is plan  # cached: the decode pays for the search once a shape


def test_plan_refuses_a_shape_without_a_conv_row():
    with pytest.raises(ValueError, match="no conv row"):
        frontend_plan(1, 100, 80, 401, 80, 0, 2, SMS)
