"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without one.
The file imports neither jax nor the repo's conftest fixtures, so that it also
runs where jax is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tpu_slu_torch.ops.bigru_shared import bigru_shared, bigru_shared_reference
from tpu_slu_torch.ops.conv import conv1d

POOLS = [(1, "avg"), (2, "avg"), (2, "max")]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def k1_inputs(seed, dims, T, B, H, dev):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(H)

    def u(*shape):
        return torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32)).to(dev)

    params = {d: {"weight_ih": u(3 * H, sum(dims)), "weight_hh": u(3 * H, H),
                  "bias_ih": u(3 * H), "bias_hh": u(3 * H)} for d in ("fwd", "bwd")}
    parts = [torch.from_numpy(rng.standard_normal((T, B, d)).astype(np.float32)).to(dev) for d in dims]
    return params, parts


@pytest.mark.cuda
# B = 100 and 300 take the kernel's batch tiles of 2 and 8 rows on a 132-SM card
@pytest.mark.parametrize("B,T", [(1, 1), (1, 21), (1, 400), (3, 21), (16, 21), (16, 400), (100, 21), (300, 21)])
@pytest.mark.parametrize("pool,method", POOLS)
@pytest.mark.parametrize("dims", [(60,), (128, 128)], ids=["parts1", "parts2"])
def test_k1_matches_plain(dev, dims, pool, method, B, T):
    params, parts = k1_inputs(0, dims, T, B, 128, dev)
    before = bigru_shared.launches
    got = bigru_shared(params, parts, pool=pool, pool_method=method)[:2]
    torch.cuda.synchronize()
    assert bigru_shared.launches == before + 1
    ref = bigru_shared_reference(params, parts, pool=pool, pool_method=method)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)  # f32 sums in another order


@pytest.mark.cuda
@pytest.mark.parametrize("H,dims", [(12, (16,)), (12, (12, 12)), (16, (24,))])
def test_k1_matches_plain_at_golden_widths(dev, H, dims):
    params, parts = k1_inputs(1, dims, 37, 2, H, dev)
    got = bigru_shared(params, parts, pool=2)[:2]
    ref = bigru_shared_reference(params, parts, pool=2)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
# the flagship's sinc conv (80 x 401, stride 80) and its 5-tap convs, with bias
@pytest.mark.parametrize("shape", [(4, 1, 64000, 80, 401, 80, 200), (4, 80, 400, 60, 5, 1, 2)])
def test_conv1d_is_f32_at_torchs_default_tf32(dev, shape):
    B, cin, T, cout, K, stride, pad = shape
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((B, cin, T)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-0.1, 0.1, (cout, cin, K)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-0.1, 0.1, cout).astype(np.float32))
    ref = torch.nn.functional.conv1d(x.double(), w.double(), b.double(), stride=stride, padding=pad)
    got = conv1d(x.to(dev), w.to(dev), b.to(dev), stride=stride, padding=pad).double().cpu()
    assert got.shape == ref.shape
    # f32 sums are ~1e-7 of the largest output off f64; TF32 operands are ~1e-3 off
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["float64", "noncontiguous", "h_not_multiple_of_4", "cpu_weight", "shape"])
def test_k1_rejects_what_it_does_not_take(dev, fault):
    H = 10 if fault == "h_not_multiple_of_4" else 8
    params, parts = k1_inputs(2, (6,), 9, 2, H, dev)
    if fault == "float64":
        parts = [p.double() for p in parts]
    elif fault == "noncontiguous":
        parts = [p.transpose(0, 1).contiguous().transpose(0, 1) for p in parts]
    elif fault == "cpu_weight":
        params["bwd"]["weight_hh"] = params["bwd"]["weight_hh"].cpu()
    elif fault == "shape":
        params["fwd"]["bias_ih"] = params["fwd"]["bias_ih"][:-1].contiguous()
    before = bigru_shared.launches
    with pytest.raises((TypeError, ValueError)):
        bigru_shared(params, parts)
    assert bigru_shared.launches == before
