"""The traffic generator: the same seed gives the same inputs; every seed
the same set of sizes, in its own order."""

import numpy as np
import torch

from slubench_cells import full_cell
from slubench.traffic import client_request, closed_requests, request_lengths

CPU = torch.device("cpu")


def small_closed():
    mix = dict(full_cell("s2s_serve_closed").mix)
    mix.update({"pool": 12, "clients": 4})
    return mix


def test_closed_requests_repeat_by_seed_and_keep_sizes():
    mix = small_closed()
    a, b = closed_requests(mix, 2**31 + 9, CPU), closed_requests(mix, 2**31 + 9, CPU)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = closed_requests(mix, 2**31 + 10, CPU)
    assert sorted(map(len, a)) == sorted(map(len, c)) == sorted(request_lengths(mix).tolist())
    lo, hi = round(mix["length_min_s"] * mix["fs"]), round(mix["length_max_s"] * mix["fs"])
    assert all(lo <= len(x) <= hi for x in a)


def test_clients_walk_the_pool():
    mix = small_closed()
    seen = [client_request(mix, c, k) for k in range(3) for c in range(mix["clients"])]
    assert seen == list(range(12))
