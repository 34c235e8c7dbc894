"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without one.
The file imports neither jax nor the repo's conftest fixtures, so that it also
runs where jax is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tpu_slu_torch.models.slu import Seq2SeqArch, Seq2SeqDecoder
from tpu_slu_torch.ops.attention import attention_kv
from tpu_slu_torch.ops.beam import beam_search_reference
from tpu_slu_torch.ops.beam_fused import SMEM_LIMIT, beam_cluster_size, beam_decode
from tpu_slu_torch.ops.bigru_masked import (
    bigru_masked,
    bigru_masked_bwd,
    bigru_masked_bwd_reference,
    bigru_masked_reference,
)
from tpu_slu_torch.ops.bigru_shared import (
    bigru_cluster_size,
    bigru_shared,
    bigru_shared_bwd,
    bigru_shared_bwd_reference,
    bigru_shared_fwd,
    bigru_shared_reference,
    bigru_shared_rowstack_reference,
    bigru_trainpool,
    bigru_trainpool_reference,
)
from tpu_slu_torch.ops.conv import conv1d
from tpu_slu_torch.ops.dropout import DIR_SALT_B, DIR_SALT_F, keep_mask, keep_threshold
from tpu_slu_torch.ops.frontend_fused import sinc_frontend_fused, sinc_frontend_reference
from tpu_slu_torch.ops.bigru_gemm import (gemm_dw, gemm_dx, gemm_dx_bf16, gemm_dx_bf16_reference, gemm_proj,
                                          gemm_proj_bf16, gemm_proj_rs_bf16, tc_launches)
from tpu_slu_torch.ops.gru1 import (gru1, gru1_bwd, gru1_bwd_reference, gru1_cluster_size, gru1_fwd,
                                     gru1_reference)

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
# B = 100 and 300 take the kernel's batch tiles of 4 and 8 rows on a 132-SM card
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


# On an H100's 132 SMs, K1 takes clusters of 4 CTAs at B <= 12 (2 x 4 x B CTAs, at most three
# quarters of the SMs) and of 2 past it, with batch tiles of 1 (B <= 33), 2 (B <= 66), 4 (B <= 132)
# and 8 rows (B = 300, two waves)
_K1_BATCHES = [1, 2, 12, 16, 17, 33, 64, 100, 300]


@pytest.mark.cuda
def test_k1_cluster_size_follows_the_batch(dev):
    """4 CTAs a cluster while both directions' clusters of 4 fill at most
    three quarters of the SMs, else 2 (the rule K2 and K4f take too); the
    batches below reach both sizes."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B in (1, 2, 12, 13, 16, 17, 33, 34, 64, 100, 300):
        assert bigru_cluster_size(B) == (4 if 32 * B <= 3 * sms else 2), B
    assert {bigru_cluster_size(B) for B in _K1_BATCHES} == {2, 4}


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 21, 400])
@pytest.mark.parametrize("B", _K1_BATCHES)
@pytest.mark.parametrize("pool,method", POOLS)
@pytest.mark.parametrize("dims", [(60,), (128, 128)], ids=["parts1", "parts2"])
def test_k1_cluster_recurrence_matches_plain(dev, dims, pool, method, B, T):
    """K1 on the clusters and batch tiles it takes at batch B against
    ``bigru_shared_reference``, within 1e-4; one launch a call."""
    params, parts = k1_inputs(3, dims, T, B, 128, dev)
    before = bigru_shared.launches
    with torch.inference_mode():
        got = bigru_shared_fwd(params, parts, pool=pool, pool_method=method)
    torch.cuda.synchronize()
    assert bigru_shared.launches == before + 1
    ref = bigru_shared_reference(params, parts, pool=pool, pool_method=method)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (-(-T // pool), B, 128)
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)  # f32 sums in another order


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 17, 64, 300])
def test_k1_repeats_bit_for_bit(dev, B):
    """Two calls on the same inputs give the same bits: no atomics, a fixed
    order of every sum."""
    params, parts = k1_inputs(4, (128, 128), 50, B, 128, dev)
    with torch.inference_mode():
        first = bigru_shared_fwd(params, parts, pool=2)
        again = bigru_shared_fwd(params, parts, pool=2)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k1", "k6", "k2", "k3", "k4f", "k4b", "k5f", "k5b"])
def test_recurrent_kernels_refuse_h_past_128(dev, kernel):
    """H = 132 (a multiple of 4 past the limit): each recurrent kernel's
    wrapper raises a ValueError naming the limit before any launch."""
    H, T, B = 132, 9, 2
    params, parts = k1_inputs(5, (8,), T, B, H, dev)
    x = parts[0].transpose(0, 1).contiguous()
    n = torch.tensor([T, 4], device=dev)
    one = {"fwd": params["fwd"]}

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    calls = {
        "k1": lambda: bigru_shared_fwd(params, parts),
        "k6": lambda: bigru_shared_fwd(params, parts, layout="rowstack"),
        "k2": lambda: bigru_trainpool(params, parts, pool=2, drop_p=0.5, seed=1),
        "k3": lambda: bigru_shared_bwd(params, parts, *[zeros(T, B, H) for _ in range(4)]),
        "k4f": lambda: bigru_masked(params, x, n),
        "k4b": lambda: bigru_masked_bwd(params, x, zeros(B, T, 2 * H), n, zeros(B, T, 2 * H)),
        "k5f": lambda: gru1_fwd(one, x, n),
        "k5b": lambda: gru1_bwd(one, x, zeros(B, T, H), n, zeros(B, T, H)),
    }
    counters = (bigru_shared, bigru_trainpool, bigru_shared_bwd, bigru_masked, bigru_masked_bwd, gru1,
                gru1_bwd)
    before = [c.launches for c in counters] + [bigru_shared.launches_rowstack]
    with torch.inference_mode(), pytest.raises(ValueError, match="H <= 128"):
        calls[kernel]()
    assert [c.launches for c in counters] + [bigru_shared.launches_rowstack] == before


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
@pytest.mark.parametrize("shape", [(4, 1, 64000, 80, 401, 80, 200), (4, 80, 400, 60, 5, 1, 2)])
def test_conv1d_backward_is_f32_at_torchs_default_tf32(dev, shape):
    """Input and weight gradients within 1e-5 of an f64 CPU reference,
    relative to the largest element (TF32 would be ~1e-3 off)."""
    B, cin, T, cout, K, stride, pad = shape
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((B, cin, T)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-0.1, 0.1, (cout, cin, K)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-0.1, 0.1, cout).astype(np.float32))
    T_out = (T + 2 * pad - K) // stride + 1
    cot = torch.from_numpy(rng.standard_normal((B, cout, T_out)).astype(np.float32))
    leaves64 = [t.double().requires_grad_() for t in (x, w, b)]
    torch.nn.functional.conv1d(*leaves64, stride=stride, padding=pad).backward(cot.double())
    leaves = [t.to(dev).requires_grad_() for t in (x, w, b)]
    conv1d(*leaves, stride=stride, padding=pad).backward(cot.to(dev))
    for name, got, ref in zip(("x", "weight", "bias"), leaves, leaves64):
        err = (got.grad.double().cpu() - ref.grad).abs().max().item()
        assert err <= 1e-5 * ref.grad.abs().max().item(), (name, err)


def assert_same_zeros(g, r):
    """The dropout zero pattern of ``g`` is ``r``'s: a window the mask drops
    whole is exactly 0 in both. Among millions of outputs a sum of kept
    values may also cancel to exactly 0 in one version and not in the other,
    so such a position may differ if both values are within 1e-6 of 0."""
    differ = (g == 0) != (r == 0)
    assert not differ.any() or torch.maximum(g.abs(), r.abs())[differ].max().item() <= 1e-6


# On an H100's 132 SMs the two-direction cluster recurrence (K1, K2, K4f) takes clusters of 4 CTAs
# to B = 12 and of 2 from B = 13, with batch tiles of 1 row to B = 33, 2 to 66, 4 to 132 and 8 past;
# B = 34, 67 and 133 are the first batches whose tiles hold rows of different lengths in K4f
_CLUSTER_EDGES = [12, 13, 33, 34, 66, 67, 133]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 25, 400])
@pytest.mark.parametrize("H", [16, 128])
@pytest.mark.parametrize("B", sorted([1, 3, 8, 64, 300] + _CLUSTER_EDGES))
def test_k2_matches_plain(dev, B, H, T):
    """Pooled outputs and hp within 1e-4 (f32 sums in another order); the
    dropout zero pattern equal to the plain version's, element for element."""
    dims = (60,) if T == 400 else (H, H)
    params, parts = k1_inputs(5, dims, T, B, H, dev)
    for pool, p in ((2, 0.5), (1, 0.5), (2, 0.0)):
        before = bigru_trainpool.launches
        got = bigru_trainpool(params, parts, pool=pool, drop_p=p, seed=12345 + B)
        torch.cuda.synchronize()
        assert bigru_trainpool.launches == before + 1
        ref = bigru_trainpool_reference(params, parts, pool=pool, drop_p=p, seed=12345 + B)
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
        for g, r in zip(got[2:], ref[2:]):
            assert_same_zeros(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_k2_mask_is_the_hash_bit_for_bit(dev, seed):
    """pool 1: K2's output is its undropped output, zeroed exactly where
    keep_mask drops and scaled by 1/(1-p) elsewhere, bit for bit."""
    T, B, H, p = 33, 70, 128, 0.3
    params, parts = k1_inputs(6, (128, 128), T, B, H, dev)
    _, _, o_f, o_b = bigru_trainpool(params, parts, pool=1, drop_p=p, seed=seed)
    _, _, h_f, h_b = bigru_trainpool(params, parts, pool=1, drop_p=0.0, seed=seed)
    for out, h, salt in ((o_f, h_f, DIR_SALT_F), (o_b, h_b, DIR_SALT_B)):
        keep = keep_mask(seed, salt, 0, (T, B, H), keep_threshold(p), dev)
        assert torch.equal(out, torch.where(keep, h * (1.0 / (1.0 - p)), 0.0))


def _bwd_case(seed, dims, T, B, H, dev, fused):
    params, parts = k1_inputs(seed, dims, T, B, H, dev)
    rng = np.random.default_rng(seed + 1)
    if fused:
        hp_f, hp_b, o_f, _ = bigru_trainpool_reference(params, parts, pool=2, drop_p=0.5, seed=seed)
        kw = {"pool": 2, "drop_p": 0.5, "seed": seed}
    else:
        o_f, o_b = bigru_shared_reference(params, parts)
        hp_f = torch.cat([torch.zeros_like(o_f[:1]), o_f[:-1]])
        hp_b = torch.cat([o_b[1:], torch.zeros_like(o_b[:1])])
        kw = {}
    dy = [torch.from_numpy(rng.standard_normal(tuple(o_f.shape)).astype(np.float32)).to(dev)
          for _ in range(2)]
    return params, parts, hp_f, hp_b, dy, kw


def _assert_grads_close(got, ref, tol=1e-4):
    """Each tensor within ``tol`` of its largest element: f32 sums over up to
    T*B rows, in another order."""
    (dxs, grads), (rdxs, rgrads) = got, ref
    pairs = list(zip(dxs, rdxs)) + [(grads[d][n], rgrads[d][n]) for d in grads for n in grads[d]]
    for g, r in pairs:
        assert g.shape == r.shape
        assert (g - r).abs().max().item() <= tol * max(r.abs().max().item(), 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 25, 400])
@pytest.mark.parametrize("H", [16, 128])
@pytest.mark.parametrize("B", [1, 3, 64, 300])
def test_k3_matches_plain(dev, B, H, T):
    dims = (60,) if T == 400 else (H, H)
    for fused in (True, False):
        params, parts, hp_f, hp_b, dy, kw = _bwd_case(8, dims, T, B, H, dev, fused)
        before = bigru_shared_bwd.launches
        got = bigru_shared_bwd(params, parts, hp_f, hp_b, *dy, **kw)
        torch.cuda.synchronize()
        assert bigru_shared_bwd.launches == before + 1
        _assert_grads_close(got, bigru_shared_bwd_reference(params, parts, hp_f, hp_b, *dy, **kw))


@pytest.mark.cuda
def test_k3_weight_gradients_are_deterministic(dev):
    params, parts, hp_f, hp_b, dy, kw = _bwd_case(9, (128, 128), 200, 64, 128, dev, True)
    a = bigru_shared_bwd(params, parts, hp_f, hp_b, *dy, **kw)
    b = bigru_shared_bwd(params, parts, hp_f, hp_b, *dy, **kw)
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    for d in a[1]:
        for n in a[1][d]:
            assert torch.equal(a[1][d][n], b[1][d][n]), (d, n)


def _leaves(params, parts):
    return ({d: {n: t.clone().requires_grad_() for n, t in params[d].items()} for d in params},
            [p.clone().requires_grad_() for p in parts])


@pytest.mark.cuda
@pytest.mark.parametrize("kwargs", [{"pool": 2}, {"pool": 2, "pool_method": "max"}, {},
                                    {"train": True},
                                    {"train": True, "pool": 2, "drop_p": 0.5, "seed": 3}])
def test_layer_gradients_match_autograd_of_the_plain_version(dev, kwargs):
    """Through the autograd Functions (eval pooled: the repaired path; train
    unpooled; train pooled with dropout) against torch autograd of the plain
    forward on the same card."""
    T, B, H, dims = 37, 5, 128, (128, 128)
    params, parts = k1_inputs(10, dims, T, B, H, dev)
    tp, tx = _leaves(params, parts)
    out = bigru_shared(tp, tx, **kwargs)
    assert out[0].grad_fn is not None
    rp, rx = _leaves(params, parts)
    if "seed" in kwargs:
        ref = bigru_trainpool_reference(rp, rx, pool=2, drop_p=0.5, seed=3)[2:]
    else:
        ref = bigru_shared_reference(rp, rx, pool=kwargs.get("pool", 1),
                                     pool_method=kwargs.get("pool_method", "avg"))
    rng = np.random.default_rng(11)
    cot = [torch.from_numpy(rng.standard_normal(tuple(r.shape)).astype(np.float32)).to(dev)
           for r in ref]
    torch.autograd.backward(out[:2], cot)
    torch.autograd.backward(ref, cot)
    pairs = list(zip(tx, rx)) + [(tp[d][n], rp[d][n]) for d in tp for n in tp[d]]
    for g, r in pairs:
        assert (g.grad - r.grad).abs().max().item() <= 1e-4 * r.grad.abs().max().item()


@pytest.mark.cuda
def test_decode_under_inference_mode_launches_k1_only(dev):
    params, parts = k1_inputs(12, (60,), 25, 2, 128, dev)
    counts = (bigru_shared.launches, bigru_trainpool.launches, bigru_shared_bwd.launches)
    with torch.inference_mode():
        out = bigru_shared(params, parts, pool=2)
    assert out[0].grad_fn is None
    assert (bigru_shared.launches, bigru_trainpool.launches, bigru_shared_bwd.launches) == (
        counts[0] + 1, counts[1], counts[2])


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


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["float64", "noncontiguous", "cpu_tensor", "shape"])
@pytest.mark.parametrize("kernel", ["k2", "k3"])
def test_k2_k3_reject_what_they_do_not_take(dev, kernel, fault):
    params, parts, hp_f, hp_b, dy, kw = _bwd_case(13, (8,), 9, 2, 8, dev, True)
    if fault == "float64":
        parts = [p.double() for p in parts]
    elif fault == "noncontiguous":
        parts = [p.transpose(0, 1).contiguous().transpose(0, 1) for p in parts]
    elif fault == "cpu_tensor" and kernel == "k2":
        params["fwd"]["bias_hh"] = params["fwd"]["bias_hh"].cpu()
    elif fault == "cpu_tensor":
        hp_f = hp_f.cpu()
    elif kernel == "k2":  # a part of another T than the first
        parts = [parts[0], parts[0][:-1].contiguous()]
    else:
        dy[0] = dy[0][:-1].contiguous()
    counts = (bigru_trainpool.launches, bigru_shared_bwd.launches)
    with pytest.raises((TypeError, ValueError)):
        if kernel == "k2":
            bigru_trainpool(params, parts, **kw)
        else:
            bigru_shared_bwd(params, parts, hp_f, hp_b, *dy, **kw)
    assert (bigru_trainpool.launches, bigru_shared_bwd.launches) == counts


# ---------------------------------------------------------------------------
# K1, K2 and K3 on bf16 streams (compute_dtype=bfloat16)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


def assert_bf16_close(got, ref, ref32):
    """The bf16 bounds: ``got`` (the kernel at bf16) within a quarter of the
    plain version's bf16-vs-f32 gap of the plain bf16 result, by relative
    Frobenius distance, and within 4 bf16 ulps of the largest element
    (2^-6 max|ref|)."""
    g, r, r32 = got.double(), ref.double(), ref32.double()
    assert g.shape == r.shape and got.dtype == ref.dtype
    gap = ((r - r32).norm() / r32.norm().clamp_min(1e-30)).item()
    dist = ((g - r).norm() / r.norm().clamp_min(1e-30)).item()
    assert dist <= 0.25 * gap, (dist, gap)
    assert (g - r).abs().max().item() <= 2.0**-6 * r.abs().max().item()


def bf16_case(seed, dims, T, B, H, dev):
    """K1's inputs with bf16 parts, and the same parts in f32 (exact)."""
    params, parts = k1_inputs(seed, dims, T, B, H, dev)
    parts16 = [p.to(BF16) for p in parts]
    return params, parts16, [p.float() for p in parts16]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(1, 25), (16, 400), (16, 25), (64, 100), (300, 21)])
@pytest.mark.parametrize("pool,method", POOLS)
@pytest.mark.parametrize("dims", [(60,), (128, 128)], ids=["parts1", "parts2"])
def test_bf16_k1_matches_plain(dev, dims, pool, method, B, T):
    """K1's bf16 entry against the plain bf16 version; bf16 outputs."""
    params, parts, parts32 = bf16_case(20, dims, T, B, 128, dev)
    before = bigru_shared.launches
    got = bigru_shared(params, parts, pool=pool, pool_method=method)[:2]
    torch.cuda.synchronize()
    assert bigru_shared.launches == before + 1
    ref = bigru_shared_reference(params, parts, pool=pool, pool_method=method)
    ref32 = bigru_shared_reference(params, parts32, pool=pool, pool_method=method)
    for g, r, r32 in zip(got, ref, ref32):
        assert g.dtype == BF16
        assert_bf16_close(g, r, r32)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(1, 25), (16, 400), (64, 200), (64, 25), (300, 21)])
@pytest.mark.parametrize("dims", [(60,), (128, 128)], ids=["parts1", "parts2"])
def test_bf16_k2_matches_plain(dev, dims, B, T):
    """K2's bf16 entry: h_prev and the pooled outputs, bf16, and the dropout
    zero pattern equal to the plain version's."""
    params, parts, parts32 = bf16_case(21, dims, T, B, 128, dev)
    for pool, p in ((2, 0.5), (2, 0.0), (1, 0.5)):
        before = bigru_trainpool.launches
        got = bigru_trainpool(params, parts, pool=pool, drop_p=p, seed=99 + B)
        torch.cuda.synchronize()
        assert bigru_trainpool.launches == before + 1
        ref = bigru_trainpool_reference(params, parts, pool=pool, drop_p=p, seed=99 + B)
        ref32 = bigru_trainpool_reference(params, parts32, pool=pool, drop_p=p, seed=99 + B)
        for g, r, r32 in zip(got, ref, ref32):
            assert g.dtype == BF16
            assert_bf16_close(g, r, r32)
        for g, r in zip(got[2:], ref[2:]):
            assert_same_zeros(g.float(), r.float())


def _bf16_bwd_case(seed, dims, T, B, H, dev, fused):
    """K3's inputs at bf16 (the residuals of the plain bf16 forward, bf16
    cotangents), and the same in f32."""
    params, parts, parts32 = bf16_case(seed, dims, T, B, H, dev)
    rng = np.random.default_rng(seed + 1)
    kw = {"pool": 2, "drop_p": 0.5, "seed": seed} if fused else {}
    if fused:
        hp_f, hp_b = bigru_trainpool_reference(params, parts, **kw)[:2]
        To = -(-T // 2)
    else:
        o_f, o_b = bigru_shared_reference(params, parts)
        hp_f = torch.cat([torch.zeros_like(o_f[:1]), o_f[:-1]])
        hp_b = torch.cat([o_b[1:], torch.zeros_like(o_b[:1])])
        To = T
    dy = [torch.from_numpy(rng.standard_normal((To, B, H)).astype(np.float32)).to(dev).to(BF16)
          for _ in range(2)]
    return params, parts, parts32, hp_f, hp_b, dy, kw


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(1, 25), (16, 400), (64, 200), (64, 25), (300, 21)])
@pytest.mark.parametrize("dims", [(60,), (128, 128)], ids=["parts1", "parts2"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_bf16_k3_matches_plain(dev, dims, B, T, fused):
    """K3's bf16 entry: bf16 dX, f32 weight and bias gradients, against the
    plain bf16 version, the yardstick the plain version on f32 copies of
    the same inputs."""
    params, parts, parts32, hp_f, hp_b, dy, kw = _bf16_bwd_case(22, dims, T, B, 128, dev, fused)
    before = bigru_shared_bwd.launches
    dxs, grads = bigru_shared_bwd(params, parts, hp_f, hp_b, *dy, **kw)
    torch.cuda.synchronize()
    assert bigru_shared_bwd.launches == before + 1
    rdxs, rgrads = bigru_shared_bwd_reference(params, parts, hp_f, hp_b, *dy, **kw)
    f32 = [t.float() for t in (hp_f, hp_b, *dy)]
    r32dxs, r32grads = bigru_shared_bwd_reference(params, parts32, *f32, **kw)
    for g, r, r32 in zip(dxs, rdxs, r32dxs):
        assert g.dtype == BF16
        assert_bf16_close(g, r, r32)
    for d in grads:
        for n in grads[d]:
            assert grads[d][n].dtype == torch.float32
            assert_bf16_close(grads[d][n], rgrads[d][n], r32grads[d][n])


@pytest.mark.cuda
def test_bf16_k3_repeats_bit_for_bit(dev):
    """K3 at bf16 sums its weight gradients in a fixed order too."""
    params, parts, _, hp_f, hp_b, dy, kw = _bf16_bwd_case(23, (128, 128), 200, 64, 128, dev, True)
    a = bigru_shared_bwd(params, parts, hp_f, hp_b, *dy, **kw)
    b = bigru_shared_bwd(params, parts, hp_f, hp_b, *dy, **kw)
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    for d in a[1]:
        for n in a[1][d]:
            assert torch.equal(a[1][d][n], b[1][d][n]), (d, n)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["mixed_parts", "bf16_weight", "f32_hp", "f32_dy", "rowstack", "masked_f32_dy",
                                   "uni_bf16_weight"])
def test_bf16_kernels_refuse_mixed_dtypes(dev, fault):
    """bf16 streams take f32 weights, and every stream of a call one dtype:
    K1, K2 and K3; K6 (``rowstack``: a bf16 weight); K4b (an f32 dy beside
    a bf16 x) and K5f (a bf16 weight). Nothing launches."""
    params, parts, _, hp_f, hp_b, dy, kw = _bf16_bwd_case(24, (8, 8), 9, 2, 8, dev, True)
    x = torch.cat(parts, dim=-1).transpose(0, 1).contiguous()
    n = torch.tensor([9, 4], device=dev)
    counters = (bigru_shared, bigru_trainpool, bigru_shared_bwd, bigru_masked, bigru_masked_bwd, gru1, gru1_bwd)

    def counts():
        return [c.launches for c in counters] + [bigru_shared.launches_rowstack] + [c.launches_bf16 for c in counters]

    if fault == "masked_f32_dy":
        with torch.inference_mode():
            out = bigru_masked(params, x, n)
    before = counts()
    with pytest.raises(TypeError):
        if fault == "mixed_parts":
            bigru_shared(params, [parts[0], parts[1].float()])
        elif fault in ("bf16_weight", "rowstack", "uni_bf16_weight"):
            params["fwd"]["weight_hh"] = params["fwd"]["weight_hh"].to(BF16)
            if fault == "bf16_weight":
                bigru_trainpool(params, parts, **kw)
            elif fault == "rowstack":
                bigru_shared_fwd(params, parts, layout="rowstack")
            else:
                gru1({"fwd": params["fwd"]}, x, n)
        elif fault == "masked_f32_dy":
            bigru_masked_bwd(params, x, out, n, torch.zeros(out.shape, device=dev))
        else:
            hp_f, dy[0] = (hp_f.float(), dy[0]) if fault == "f32_hp" else (hp_f, dy[0].float())
            bigru_shared_bwd(params, parts, hp_f, hp_b, *dy, **kw)
    torch.cuda.synchronize()
    assert counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("kwargs", [{"train": True}, {"train": True, "pool": 2, "drop_p": 0.5, "seed": 3},
                                    {"pool": 2}])
def test_bf16_layer_gradients_through_the_functions(dev, kwargs):
    """bf16 parts through the autograd Functions: bf16 outputs, a bf16
    gradient into the parts and f32 ones into the weights, equal to the
    wrappers' plain versions on the same card within the bf16 bounds."""
    T, B, H, dims = 37, 5, 128, (128, 128)
    params, parts, parts32 = bf16_case(25, dims, T, B, H, dev)
    outs = {}
    for name, ps in (("card", parts), ("plain", parts), ("f32", parts32)):
        tp, tx = _leaves(params, ps)
        if name == "card":
            out = bigru_shared(tp, tx, **kwargs)[:2]
        else:
            cpu = [x.detach().cpu().requires_grad_() for x in tx]
            cp = {d: {n: t.detach().cpu().requires_grad_() for n, t in tp[d].items()} for d in tp}
            tp, tx = cp, cpu
            out = bigru_shared(tp, tx, **kwargs)[:2]
        rng = np.random.default_rng(26)
        cot = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(np.float32)).to(BF16)
               .to(o.device, o.dtype) for o in out]  # the same values at either dtype
        torch.autograd.backward(out, cot)
        outs[name] = ([o.detach().cpu() for o in out], [x.grad.cpu() for x in tx],
                      [tp[d][n].grad.cpu() for d in tp for n in tp[d]])
    for o in outs["card"][0]:
        assert o.dtype == BF16
    for g in outs["card"][1]:
        assert g.dtype == BF16
    for g in outs["card"][2]:
        assert g.dtype == torch.float32
    for k in range(3):
        for g, r, r32 in zip(outs["card"][k], outs["plain"][k], outs["f32"][k]):
            assert_bf16_close(g, r, r32)


# ---------------------------------------------------------------------------
# K4f: the length-masked bi-GRU forward
# ---------------------------------------------------------------------------


def k4_inputs(seed, B, T, D, H, dev):
    """Random K4f inputs: params and x (B, T, D) on ``dev``, and length
    vectors that hold T and (where B > 1) 0 in each; B = 1 gets both, one at a time."""
    params, parts = k1_inputs(seed, (D,), T, B, H, dev)
    x = parts[0].transpose(0, 1).contiguous()
    rng = np.random.default_rng(seed + 100)
    if B == 1:
        lengths = [[T], [0], [int(rng.integers(0, T + 1))]]
    else:
        n = rng.integers(0, T + 1, B)
        n[0], n[-1] = T, 0
        lengths = [list(n)]
    return params, x, [torch.tensor(n, device=dev) for n in lengths]


def _rel_close(g, r, tol=1e-4):
    """Within ``tol`` of the reference's largest element: f32 sums in another order."""
    return (g - r).abs().max().item() <= tol * max(r.abs().max().item(), 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 25, 400])
@pytest.mark.parametrize("H", [16, 128])
@pytest.mark.parametrize("B", sorted([1, 3, 8, 64] + _CLUSTER_EDGES))
def test_k4f_matches_plain(dev, B, H, T):
    D = 60 if T == 400 else 2 * H
    params, x, lengths = k4_inputs(20, B, T, D, H, dev)
    for n in lengths:
        before = bigru_masked.launches
        with torch.inference_mode():
            got = bigru_masked(params, x, n)
        torch.cuda.synchronize()
        assert bigru_masked.launches == before + 1
        ref = bigru_masked_reference(params, x, n)
        assert got.shape == ref.shape == (B, T, 2 * H)
        assert _rel_close(got, ref), (got - ref).abs().max().item()
        for b, nb in enumerate(n.tolist()):  # exact zeros past each row's length
            assert (got[b, nb:] == 0).all()


@pytest.mark.cuda
def test_k4f_rows_equal_their_example_alone(dev):
    """Each row of a padded batch equals K4f on that example alone at
    T = n_b, and K1 on it (the exact-shape layer), within 1e-4."""
    params, x, (n,) = k4_inputs(21, 8, 50, 128, 128, dev)
    with torch.inference_mode():
        got = bigru_masked(params, x, n)
        for b, nb in enumerate(n.tolist()):
            if nb == 0:
                continue
            xb = x[b:b + 1, :nb].contiguous()
            alone = bigru_masked(params, xb, torch.tensor([nb], device=dev))[0]
            h_f, h_b = bigru_shared_fwd(params, (xb.transpose(0, 1).contiguous(),))
            k1 = torch.cat([h_f, h_b], dim=-1)[:, 0]
            assert _rel_close(got[b, :nb], alone) and _rel_close(got[b, :nb], k1)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["float64", "noncontiguous", "cpu_weight", "shape", "h_not_multiple_of_4",
                                   "n_too_long", "n_negative", "n_on_cpu", "n_float", "n_shape"])
def test_k4f_rejects_what_it_does_not_take(dev, fault):
    H = 10 if fault == "h_not_multiple_of_4" else 8
    params, x, (n,) = k4_inputs(22, 3, 9, 6, H, dev)
    if fault == "float64":
        x = x.double()
    elif fault == "noncontiguous":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "cpu_weight":
        params["bwd"]["weight_ih"] = params["bwd"]["weight_ih"].cpu()
    elif fault == "shape":
        params["fwd"]["weight_ih"] = params["fwd"]["weight_ih"][:, :-1].contiguous()
    elif fault == "n_too_long":
        n = n.clone()
        n[1] = 10
    elif fault == "n_negative":
        n = n.clone()
        n[1] = -1
    elif fault == "n_on_cpu":
        n = n.cpu()
    elif fault == "n_float":
        n = n.float()
    elif fault == "n_shape":
        n = n[:2]
    before = bigru_masked.launches
    with pytest.raises((TypeError, ValueError)):
        bigru_masked(params, x, n)
    assert bigru_masked.launches == before


# ---------------------------------------------------------------------------
# K4b: the length-masked bi-GRU backward
# ---------------------------------------------------------------------------


def k4b_inputs(seed, B, T, D, H, dev):
    """K4f's inputs (lengths holding T and 0, and 1 where B > 2), the
    forward output of each length vector and a seeded cotangent that is
    nonzero past each length."""
    params, x, lengths = k4_inputs(seed, B, T, D, H, dev)
    if B > 2:
        lengths[0][1] = 1
    with torch.inference_mode():
        outs = [bigru_masked(params, x, n) for n in lengths]
    rng = np.random.default_rng(seed + 200)
    dy = torch.from_numpy(rng.standard_normal((B, T, 2 * H)).astype(np.float32)).to(dev)
    return params, x, lengths, outs, dy


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 25, 400])
@pytest.mark.parametrize("H", [16, 128])
@pytest.mark.parametrize("B", [1, 3, 8, 64])
def test_k4b_matches_plain(dev, B, H, T):
    """dX and the eight weight and bias gradients within 1e-4 of each
    tensor's largest element (f32 sums over B*T rows in another order); dX
    exactly 0 past each row's length."""
    D = 60 if T == 400 else 2 * H
    params, x, lengths, outs, dy = k4b_inputs(30, B, T, D, H, dev)
    for n, out in zip(lengths, outs):
        before = bigru_masked_bwd.launches
        got = bigru_masked_bwd(params, x, out, n, dy)
        torch.cuda.synchronize()
        assert bigru_masked_bwd.launches == before + 1
        ref = bigru_masked_bwd_reference(params, x, out, n, dy)
        _assert_grads_close(((got[0],), got[1]), ((ref[0],), ref[1]))
        for b, nb in enumerate(n.tolist()):
            assert (got[0][b, nb:] == 0).all()


@pytest.mark.cuda
def test_k4b_weight_gradients_are_deterministic(dev):
    params, x, (n,), (out,), dy = k4b_inputs(31, 64, 25, 256, 128, dev)
    a = bigru_masked_bwd(params, x, out, n, dy)
    b = bigru_masked_bwd(params, x, out, n, dy)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[1][d][k], b[1][d][k]) for d in a[1] for k in a[1][d])


@pytest.mark.cuda
@pytest.mark.parametrize("leaf", ["x", "weight"])
def test_bigru_masked_gradients_match_autograd_of_the_plain_version(dev, leaf):
    """With grad on, ``bigru_masked`` on the card goes through K4f and K4b
    (one launch each) and never returns a detached output; its gradients
    are autograd's of the plain version within 1e-4 of each largest element."""
    params, x, (n,) = k4_inputs(32, 8, 37, 128, 128, dev)
    tp, (tx,) = _leaves(params, [x])
    if leaf == "weight":
        tx.requires_grad_(False)
    counts = (bigru_masked.launches, bigru_masked_bwd.launches)
    out = bigru_masked(tp, tx, n)
    assert out.grad_fn is not None
    rp, (rx,) = _leaves(params, [x])
    ref = bigru_masked_reference(rp, rx, n)
    cot = torch.from_numpy(np.random.default_rng(33).standard_normal(tuple(ref.shape)).astype(np.float32)).to(dev)
    out.backward(cot)
    ref.backward(cot)
    torch.cuda.synchronize()
    assert (bigru_masked.launches, bigru_masked_bwd.launches) == (counts[0] + 1, counts[1] + 1)
    pairs = [(tp[d][k], rp[d][k]) for d in tp for k in tp[d]] + ([(tx, rx)] if leaf == "x" else [])
    for g, r in pairs:
        assert _rel_close(g.grad, r.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["float64_dy", "noncontiguous_dy", "cpu_out", "dy_shape", "n_too_long"])
def test_k4b_rejects_what_it_does_not_take(dev, fault):
    params, x, (n,), (out,), dy = k4b_inputs(34, 3, 9, 8, 8, dev)
    if fault == "float64_dy":
        dy = dy.double()
    elif fault == "noncontiguous_dy":
        dy = dy.transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "cpu_out":
        out = out.cpu()
    elif fault == "dy_shape":
        dy = dy[:, :-1].contiguous()
    else:
        n = n.clone()
        n[1] = 10
    before = bigru_masked_bwd.launches
    with pytest.raises((TypeError, ValueError)):
        bigru_masked_bwd(params, x, out, n, dy)
    assert bigru_masked_bwd.launches == before


# ---------------------------------------------------------------------------
# K5f and K5b: the unidirectional GRU layer, forward and backward
# ---------------------------------------------------------------------------


def k5_inputs(seed, B, T, D, H, dev):
    """One direction's params and x (B, T, D) on ``dev``, and the length
    vectors to try: None (every row T) and K4f's (T and 0 in each, and 1
    where B > 2)."""
    params, x, lengths = k4_inputs(seed, B, T, D, H, dev)
    if B > 2:
        lengths[0][1] = 1
    return {"fwd": params["fwd"]}, x, [None] + lengths


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 25, 400])
@pytest.mark.parametrize("H", [16, 128])
@pytest.mark.parametrize("B", [1, 3, 8, 64])
def test_k5f_matches_plain(dev, B, H, T):
    """Within 1e-4 of the plain version's largest element, exact zeros past
    each row's length, one launch a call."""
    D = 60 if T == 400 else H
    params, x, lengths = k5_inputs(40, B, T, D, H, dev)
    for n in lengths:
        before = gru1.launches
        with torch.inference_mode():
            got = gru1(params, x, n)
        torch.cuda.synchronize()
        assert gru1.launches == before + 1
        ref = gru1_reference(params, x, n)
        assert got.shape == ref.shape == (B, T, H)
        assert _rel_close(got, ref), (got - ref).abs().max().item()
        for b, nb in enumerate([T] * B if n is None else n.tolist()):
            assert (got[b, nb:] == 0).all()


@pytest.mark.cuda
def test_k5f_rows_equal_their_example_alone(dev):
    params, x, (_, n) = k5_inputs(41, 8, 50, 128, 128, dev)
    with torch.inference_mode():
        got = gru1_fwd(params, x, n)
        for b, nb in enumerate(n.tolist()):
            if nb:
                alone = gru1_fwd(params, x[b:b + 1, :nb].contiguous())[0]
                assert _rel_close(got[b, :nb], alone)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 25, 400])
@pytest.mark.parametrize("H", [16, 128])
@pytest.mark.parametrize("B", [1, 3, 8, 64])
def test_k5b_matches_plain(dev, B, H, T):
    """dX and the four weight and bias gradients within 1e-4 of each
    tensor's largest element; dX exactly 0 past each row's length."""
    D = 60 if T == 400 else H
    params, x, lengths = k5_inputs(42, B, T, D, H, dev)
    dy = torch.from_numpy(np.random.default_rng(43).standard_normal((B, T, H)).astype(np.float32)).to(dev)
    for n in lengths:
        with torch.inference_mode():
            out = gru1_fwd(params, x, n)
        before = gru1_bwd.launches
        got = gru1_bwd(params, x, out, n, dy)
        torch.cuda.synchronize()
        assert gru1_bwd.launches == before + 1
        ref = gru1_bwd_reference(params, x, out, n, dy)
        _assert_grads_close(((got[0],), got[1]), ((ref[0],), ref[1]))
        for b, nb in enumerate([T] * B if n is None else n.tolist()):
            assert (got[0][b, nb:] == 0).all()


@pytest.mark.cuda
def test_k5b_weight_gradients_are_deterministic(dev):
    params, x, (n, *_) = k5_inputs(44, 64, 100, 128, 128, dev)
    with torch.inference_mode():
        out = gru1_fwd(params, x, n)
    dy = torch.randn_like(out)
    a = gru1_bwd(params, x, out, n, dy)
    b = gru1_bwd(params, x, out, n, dy)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[1]["fwd"][k], b[1]["fwd"][k]) for k in a[1]["fwd"])


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_gru1_gradients_match_autograd_of_the_plain_version(dev, masked):
    """With grad on, ``gru1`` on the card goes through K5f and K5b (one
    launch each) and never returns a detached output; its gradients are
    autograd's of the plain version within 1e-4 of each largest element."""
    params, x, (_, n) = k5_inputs(45, 8, 37, 128, 128, dev)
    n = n if masked else None
    tp, (tx,) = _leaves(params, [x])
    counts = (gru1.launches, gru1_bwd.launches)
    out = gru1(tp, tx, n)
    assert out.grad_fn is not None
    rp, (rx,) = _leaves(params, [x])
    ref = gru1_reference(rp, rx, n)
    cot = torch.from_numpy(np.random.default_rng(46).standard_normal(tuple(ref.shape)).astype(np.float32)).to(dev)
    out.backward(cot)
    ref.backward(cot)
    torch.cuda.synchronize()
    assert (gru1.launches, gru1_bwd.launches) == (counts[0] + 1, counts[1] + 1)
    for g, r in [(tp["fwd"][k], rp["fwd"][k]) for k in tp["fwd"]] + [(tx, rx)]:
        assert _rel_close(g.grad, r.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["float64", "noncontiguous", "cpu_weight", "shape", "h_not_multiple_of_4",
                                   "n_too_long", "n_on_cpu", "two_directions", "dy_shape"])
def test_k5_rejects_what_it_does_not_take(dev, fault):
    H = 10 if fault == "h_not_multiple_of_4" else 8
    params, x, (_, n) = k5_inputs(47, 3, 9, 6, H, dev)
    with torch.inference_mode():
        out = gru1_fwd(params, x, n) if H % 4 == 0 else None
    dy = None if out is None else torch.randn_like(out)
    if fault == "float64":
        x = x.double()
    elif fault == "noncontiguous":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "cpu_weight":
        params["fwd"]["weight_hh"] = params["fwd"]["weight_hh"].cpu()
    elif fault == "shape":
        params["fwd"]["weight_ih"] = params["fwd"]["weight_ih"][:, :-1].contiguous()
    elif fault == "n_too_long":
        n = n.clone()
        n[1] = 10
    elif fault == "n_on_cpu":
        n = n.cpu()
    elif fault == "two_directions":
        params = k4_inputs(47, 3, 9, 6, H, dev)[0]
    elif fault == "dy_shape":
        dy = dy[:, :-1].contiguous()
    counts = (gru1.launches, gru1_bwd.launches)
    if fault != "dy_shape":
        with pytest.raises((TypeError, ValueError)):
            gru1_fwd(params, x, n)
    if out is not None:
        with pytest.raises((TypeError, ValueError)):
            gru1_bwd(params, x, out, n, dy)
    assert (gru1.launches, gru1_bwd.launches) == counts


# ---------------------------------------------------------------------------
# K4f, K4b, K5f, K5b and K6 on bf16 streams (compute_dtype=bfloat16)
# ---------------------------------------------------------------------------


def _bf16_masked_case(seed, ndir, B, T, D, H, dev):
    """K4's inputs (``ndir`` 2) or K5's (1) with a bf16 x, that x in f32
    (exact), the length vectors to try (every row T, then K4f's: T and 0 in
    each, and 1 where B > 2), and a seeded bf16 cotangent."""
    params, x, lengths = k4_inputs(seed, B, T, D, H, dev)
    if B > 2:
        lengths[0][1] = 1
    if ndir == 1:
        params = {"fwd": params["fwd"]}
    x16 = x.to(BF16)
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rng.standard_normal((B, T, ndir * H)).astype(np.float32)).to(dev).to(BF16)
    return params, x16, x16.float(), [torch.full((B,), T, device=dev)] + lengths, dy


_BF16_MASKED_SHAPES = [(1, 25), (8, 400), (8, 25), (64, 25), (133, 21)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", _BF16_MASKED_SHAPES)
def test_bf16_k4f_matches_plain(dev, B, T):
    """K4f's bf16 entry against the plain bf16 version (the yardstick the
    plain version on the f32 copy of x): a bf16 output within the bf16
    bounds, exact zeros past each row's length, one launch counted on
    ``launches`` and ``launches_bf16``."""
    D = 60 if T == 400 else 256
    params, x, x32, lengths, _ = _bf16_masked_case(50, 2, B, T, D, 128, dev)
    for n in lengths:
        before = (bigru_masked.launches, bigru_masked.launches_bf16)
        with torch.inference_mode():
            got = bigru_masked(params, x, n)
        torch.cuda.synchronize()
        assert (bigru_masked.launches, bigru_masked.launches_bf16) == (before[0] + 1, before[1] + 1)
        assert got.dtype == BF16
        assert_bf16_close(got, bigru_masked_reference(params, x, n), bigru_masked_reference(params, x32, n))
        for b, nb in enumerate(n.tolist()):
            assert (got[b, nb:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", _BF16_MASKED_SHAPES)
def test_bf16_k5f_matches_plain(dev, B, T):
    """K5f's bf16 entry, as K4f's, with and without lengths."""
    D = 60 if T == 400 else 128
    params, x, x32, lengths, _ = _bf16_masked_case(51, 1, B, T, D, 128, dev)
    for n in [None] + lengths[1:]:
        before = (gru1.launches, gru1.launches_bf16)
        with torch.inference_mode():
            got = gru1(params, x, n)
        torch.cuda.synchronize()
        assert (gru1.launches, gru1.launches_bf16) == (before[0] + 1, before[1] + 1)
        assert got.dtype == BF16
        assert_bf16_close(got, gru1_reference(params, x, n), gru1_reference(params, x32, n))
        for b, nb in enumerate([T] * B if n is None else n.tolist()):
            assert (got[b, nb:] == 0).all()


def _bf16_bwd_holds(got, ref, ref32, lengths):
    """dX (bf16) and the weight and bias gradients (f32) of a bf16 backward
    within the bf16 bounds; dX exactly 0 past each row's length."""
    (dx, grads), (rdx, rgrads), (r32dx, r32grads) = got, ref, ref32
    assert dx.dtype == BF16
    assert_bf16_close(dx, rdx, r32dx)
    for d in grads:
        for k in grads[d]:
            assert grads[d][k].dtype == torch.float32
            assert_bf16_close(grads[d][k], rgrads[d][k], r32grads[d][k])
    for b, nb in enumerate(lengths):
        assert (dx[b, nb:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", _BF16_MASKED_SHAPES)
def test_bf16_k4b_matches_plain(dev, B, T):
    """K4b's bf16 entry on the bf16 K4f's output against the plain bf16
    version: bf16 dX (each direction's rounded, then their sum), f32
    weight and bias gradients, within the bf16 bounds."""
    D = 60 if T == 400 else 256
    params, x, x32, lengths, dy = _bf16_masked_case(52, 2, B, T, D, 128, dev)
    for n in lengths:
        with torch.inference_mode():
            out = bigru_masked(params, x, n)
        before = (bigru_masked_bwd.launches, bigru_masked_bwd.launches_bf16)
        got = bigru_masked_bwd(params, x, out, n, dy)
        torch.cuda.synchronize()
        assert (bigru_masked_bwd.launches, bigru_masked_bwd.launches_bf16) == (before[0] + 1, before[1] + 1)
        _bf16_bwd_holds(got, bigru_masked_bwd_reference(params, x, out, n, dy),
                        bigru_masked_bwd_reference(params, x32, out.float(), n, dy.float()), n.tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", _BF16_MASKED_SHAPES)
def test_bf16_k5b_matches_plain(dev, B, T):
    """K5b's bf16 entry, as K4b's (its one dX rounded once), with and
    without lengths."""
    D = 60 if T == 400 else 128
    params, x, x32, lengths, dy = _bf16_masked_case(53, 1, B, T, D, 128, dev)
    for n in [None] + lengths[1:]:
        with torch.inference_mode():
            out = gru1(params, x, n)
        before = (gru1_bwd.launches, gru1_bwd.launches_bf16)
        got = gru1_bwd(params, x, out, n, dy)
        torch.cuda.synchronize()
        assert (gru1_bwd.launches, gru1_bwd.launches_bf16) == (before[0] + 1, before[1] + 1)
        _bf16_bwd_holds(got, gru1_bwd_reference(params, x, out, n, dy),
                        gru1_bwd_reference(params, x32, out.float(), n, dy.float()),
                        [T] * B if n is None else n.tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("ndir", [2, 1], ids=["k4b", "k5b"])
def test_bf16_k4b_k5b_repeat_bit_for_bit(dev, ndir):
    """K4b and K5b at bf16 sum their weight gradients in a fixed order too:
    two calls on the same inputs agree bit for bit (the seq2seq encoder
    layer's shape, and K5b's at B = 64)."""
    D, T = (256, 25) if ndir == 2 else (128, 100)
    params, x, _, (n, *_), dy = _bf16_masked_case(54, ndir, 64, T, D, 128, dev)
    fwd, bwd = (bigru_masked, bigru_masked_bwd) if ndir == 2 else (gru1, gru1_bwd)
    with torch.inference_mode():
        out = fwd(params, x, n)
    a, b = bwd(params, x, out, n, dy), bwd(params, x, out, n, dy)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[1][d][k], b[1][d][k]) for d in a[1] for k in a[1][d])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(1, 25), (16, 400), (16, 25), (64, 100)])
@pytest.mark.parametrize("pool,method", POOLS)
@pytest.mark.parametrize("dims", [(60,), (128, 128)], ids=["parts1", "parts2"])
def test_bf16_k6_matches_plain(dev, dims, pool, method, B, T):
    """K6's bf16 entry (``layout="rowstack"``) against its plain bf16
    version: bf16 outputs within the bf16 bounds, one launch counted on
    ``launches_rowstack`` and ``launches_bf16`` (K1's ``launches`` not)."""
    params, parts, parts32 = bf16_case(55, dims, T, B, 128, dev)
    before = (bigru_shared.launches_rowstack, bigru_shared.launches_bf16, bigru_shared.launches)
    got = bigru_shared(params, parts, pool=pool, pool_method=method, layout="rowstack")[:2]
    torch.cuda.synchronize()
    assert (bigru_shared.launches_rowstack, bigru_shared.launches_bf16, bigru_shared.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    ref = bigru_shared_rowstack_reference(params, parts, pool=pool, pool_method=method)
    ref32 = bigru_shared_rowstack_reference(params, parts32, pool=pool, pool_method=method)
    for g, r, r32 in zip(got, ref, ref32):
        assert g.dtype == BF16
        assert_bf16_close(g, r, r32)


@pytest.mark.cuda
def test_unidirectional_model_decodes_and_trains_through_k5(dev):
    """The flagship's unidirectional model (``UNIDIRECTIONAL`` overrides) on
    the card: a decode at the input's shape and a length-exact one launch
    K5f 5 times and K1, K4f 0 times, logits within 1e-3 of the CPU's; a
    train step launches K5f 5 times, K5b 5 times and K1, K2, K3 none."""
    import copy

    from tpu_slu_torch.models.flagship import TRAIN_CFG, UNIDIRECTIONAL, flagship_model

    cpu = flagship_model("cpu", **UNIDIRECTIONAL)
    card = copy.deepcopy(cpu).to(dev)
    x = (0.1 * np.random.default_rng(48).standard_normal((3, 16000))).astype(np.float32)
    for kw in ({}, {"lengths": [16000, 9000, 0]}):
        counts = (gru1.launches, bigru_shared.launches, bigru_masked.launches)
        logits, _ = card.predict_intents(x, **kw)
        torch.cuda.synchronize()
        assert (gru1.launches - counts[0], bigru_shared.launches - counts[1],
                bigru_masked.launches - counts[2]) == (5, 0, 0)
        ref, _ = cpu.predict_intents(x, **kw)
        assert torch.isfinite(logits).all() and (logits.cpu() - ref).abs().max().item() <= 1e-3
    model = flagship_model(dev, cfg=TRAIN_CFG, **UNIDIRECTIONAL).train()
    counts = (gru1.launches, gru1_bwd.launches, bigru_shared.launches, bigru_trainpool.launches,
              bigru_shared_bwd.launches)
    loss, _ = model(x, np.zeros((3, 3), np.int64), training=True)
    loss.backward()
    torch.cuda.synchronize()
    assert np.isfinite(loss.item())
    assert (gru1.launches - counts[0], gru1_bwd.launches - counts[1], bigru_shared.launches - counts[2],
            bigru_trainpool.launches - counts[3], bigru_shared_bwd.launches - counts[4]) == (5, 5, 0, 0, 0)


@pytest.mark.cuda
def test_k1_and_k2_unchanged_beside_k4f(dev):
    """K1 and K2 give the same bits and launch once each, before and after K4f runs."""
    params, parts = k1_inputs(24, (128, 128), 50, 8, 128, dev)
    x = torch.cat(parts, dim=-1).transpose(0, 1).contiguous()
    n = torch.tensor([50, 3, 0, 17, 50, 1, 49, 25], device=dev)

    def k1_k2():
        counts = (bigru_shared.launches, bigru_trainpool.launches)
        with torch.inference_mode():
            out = (*bigru_shared(params, parts, pool=2)[:2],
                   *bigru_trainpool(params, parts, pool=2, drop_p=0.5, seed=9))
        assert (bigru_shared.launches, bigru_trainpool.launches) == (counts[0] + 1, counts[1] + 1)
        return out

    first = k1_k2()
    counts = (bigru_shared.launches, bigru_trainpool.launches, bigru_shared_bwd.launches)
    with torch.inference_mode():
        bigru_masked(params, x, n)
    assert (bigru_shared.launches, bigru_trainpool.launches, bigru_shared_bwd.launches) == counts
    for a, b in zip(first, k1_k2()):
        assert torch.equal(a, b)
    ref = bigru_shared_reference(params, parts, pool=2)
    assert all(_rel_close(a, r) for a, r in zip(first[:2], ref))


@pytest.mark.cuda
def test_length_exact_decode_runs_k4f_only(dev, tmp_path):
    """The golden model's length-exact decode on the card: 5 K4f and no K1
    launches a call, logits within 1e-4 of the CPU's, the golden wavs exact."""
    import json
    import os
    import shutil

    from tpu_slu_torch import read_config
    from tpu_slu_torch.data.audio import read_wav
    from tpu_slu_torch.serving import load_trained_model

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "golden")
    folder = tmp_path / "exp"
    with open(os.path.join(golden, "experiment.cfg.template")) as f:
        (tmp_path / "exp.cfg").write_text(f.read().replace("__GOLDEN_FOLDER__", str(folder)))
    config = read_config(str(tmp_path / "exp.cfg"))
    for name in ("model_state.npz", "vocab.json"):
        shutil.copyfile(os.path.join(golden, name), folder / "training" / name)
    card, cpu = load_trained_model(config, device=dev), load_trained_model(config, device="cpu")
    with open(os.path.join(golden, "expected.json")) as f:
        cases = json.load(f)["expected"]
    waves = [read_wav(os.path.join(golden, c["wav"]))[0] for c in cases]
    T = max(len(w) for w in waves)
    x = np.zeros((len(waves) + 2, T), np.float32)
    for i, w in enumerate(waves):
        x[i, :len(w)] = w
    n = [len(w) for w in waves] + [0, 0]
    counts = (bigru_masked.launches, bigru_shared.launches)
    logits, _ = card.predict_intents(x, lengths=n)
    torch.cuda.synchronize()
    assert (bigru_masked.launches - counts[0], bigru_shared.launches - counts[1]) == (5, 0)
    ref, _ = cpu.predict_intents(x, lengths=n)
    assert torch.isfinite(logits).all() and (logits.cpu() - ref).abs().max().item() <= 1e-4
    decoded = card.decode_intents(x, lengths=n)
    assert decoded[:len(cases)] == [[c["action"], c["object"], c["location"]] for c in cases]


# ---------------------------------------------------------------------------
# K7: the fused beam search
# ---------------------------------------------------------------------------


def k7_inputs(seed, B, T, nl, H, K, V, L, dev, enc_dim=128):
    """A seeded seq2seq decoder on dev, and keys/values of random encoder states."""
    arch = Seq2SeqArch(num_labels=L, num_encoder_layers=1, encoder_dim=enc_dim, num_decoder_layers=nl,
                       decoder_dim=H, key_dim=K, value_dim=V, sos=0)
    dec = Seq2SeqDecoder(arch, torch.Generator().manual_seed(seed)).eval().to(dev)
    enc = np.random.default_rng(seed).standard_normal((B, T, 2 * enc_dim)).astype(np.float32)
    with torch.inference_mode():
        keys, values = attention_kv(dec.attention, torch.from_numpy(enc).to(dev))
    return dec, keys, values


K7_CASES = [  # B, T, nl, H, K, V, L, W, U
    (1, 25, 2, 256, 100, 200, 102, 4, 200),  # all_real_seq2seq.cfg's decoder, 4 s of audio
    (3, 25, 2, 256, 100, 200, 102, 4, 200),
    (2, 100, 2, 256, 100, 200, 102, 4, 40),  # 16 s, the server's longest request
    (4, 13, 1, 64, 64, 64, 102, 4, 16),  # the golden seq2seq decoder
    (5, 6, 2, 8, 4, 8, 11, 3, 10),  # the shapes of tests/test_pallas_beam.py
    (3, 9, 2, 8, 4, 8, 11, 1, 12),  # greedy
    (2, 7, 1, 12, 5, 6, 9, 8, 10),  # the widest beam, widths that are not multiples of 4
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,nl,H,K,V,L,W,U", K7_CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_k7_matches_plain(dev, B, T, nl, H, K, V, L, W, U, masked):
    dec, keys, values = k7_inputs(B * T + W, B, T, nl, H, K, V, L, dev)
    n = None
    if masked:
        n = torch.from_numpy(np.random.default_rng(T).integers(1, T + 1, B)).to(dev)
        n[0] = 1
    with torch.inference_mode():
        before = beam_decode.launches
        scores, tokens = beam_decode(dec, keys, values, n, W, U)
        torch.cuda.synchronize()
        assert beam_decode.launches == before + 1
        ref_scores, ref_tokens = beam_search_reference(dec, keys, values, n, W, U)
    assert tokens.shape == (W, B, U) and tokens.dtype == torch.int64
    assert torch.equal(tokens, ref_tokens)
    torch.testing.assert_close(scores, ref_scores, rtol=1e-5, atol=1e-4)  # f32, another order


@pytest.mark.cuda
@pytest.mark.parametrize("W", [2, 4, 8])
def test_k7_tie_order_is_lax_top_k(dev, W):
    """Label logits that do not depend on the state, with repeated values:
    every step's extensions tie across beams and tokens, and the kernel
    takes them in the plain version's (lax.top_k's) order."""
    dec, keys, values = k7_inputs(3, 2, 5, 2, 16, 8, 8, 10, dev)
    with torch.no_grad():
        dec.linear.weight.zero_()
        dec.linear.bias.copy_(torch.tensor([1.0, 1.0, 0.5, 2.0, 2.0, 0.5, 2.0, 1.0, 0.0, 0.0]))
    with torch.inference_mode():
        scores, tokens = beam_decode(dec, keys, values, None, W, 6)
        ref_scores, ref_tokens = beam_search_reference(dec, keys, values, None, W, 6)
    assert torch.equal(tokens, ref_tokens)
    torch.testing.assert_close(scores, ref_scores, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["float64", "noncontiguous", "cpu_weight", "n_zero", "n_past_T",
                                   "beam_zero", "shape"])
def test_k7_rejects_what_it_does_not_take(dev, fault):
    dec, keys, values = k7_inputs(5, 2, 6, 2, 8, 4, 8, 11, dev)
    n, W, U = torch.tensor([6, 3], device=dev), 3, 8
    if fault == "float64":
        keys = keys.double()
    elif fault == "noncontiguous":
        values = values.transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "cpu_weight":
        dec.linear.to("cpu")
    elif fault == "n_zero":
        n[1] = 0
    elif fault == "n_past_T":
        n[0] = 7
    elif fault == "beam_zero":
        W = 0
    elif fault == "shape":
        values = values[:, :, :7].contiguous()
    before = beam_decode.launches
    with torch.inference_mode(), pytest.raises((ValueError, TypeError)):
        beam_decode(dec, keys, values, n, W, U)
    assert beam_decode.launches == before


@pytest.mark.cuda
def test_k7_refuses_a_call_that_needs_a_gradient(dev):
    dec, keys, values = k7_inputs(7, 2, 6, 1, 8, 4, 8, 11, dev)
    before = beam_decode.launches
    with pytest.raises(NotImplementedError, match="no gradient"):
        beam_decode(dec, keys, values, None, 2, 5)
    with torch.no_grad():
        beam_decode(dec, keys, values, None, 2, 5)
    assert beam_decode.launches == before + 1


@pytest.mark.cuda
def test_golden_seq2seq_decodes_with_one_k7_launch(dev, tmp_path):
    """The golden seq2seq checkpoint on the card: each decode one K7 launch
    and no plain search, the six wavs exact, alone and in one padded batch."""
    import json
    import os
    import shutil

    from tpu_slu_torch import read_config
    from tpu_slu_torch.data.audio import read_wav
    from tpu_slu_torch.ops import beam as plain
    from tpu_slu_torch.serving import load_trained_model

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "golden_seq2seq")
    folder = tmp_path / "exp"
    with open(os.path.join(golden, "experiment.cfg.template")) as f:
        (tmp_path / "exp.cfg").write_text(f.read().replace("__GOLDEN_FOLDER__", str(folder)))
    config = read_config(str(tmp_path / "exp.cfg"))
    with open(os.path.join(golden, "expected.json")) as f:
        meta = json.load(f)
    config.seq2seq_max_decode_len = meta["max_decode_len"]
    for name in ("model_state.npz", "vocab.json"):
        shutil.copyfile(os.path.join(golden, name), folder / "training" / name)
    model = load_trained_model(config, device=dev)
    waves = [read_wav(os.path.join(golden, c["wav"]))[0] for c in meta["expected"]]
    want = [c["semantics"] for c in meta["expected"]]
    calls = []
    real = plain.beam_search
    plain.beam_search = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        for w, s in zip(waves, want):
            before = beam_decode.launches
            assert model.decode_intents(w[None, :])[0] == s
            assert beam_decode.launches == before + 1
        x = np.zeros((len(waves) + 1, max(len(w) for w in waves)), np.float32)
        for i, w in enumerate(waves):
            x[i, :len(w)] = w
        before = beam_decode.launches
        assert model.decode_intents(x, lengths=[len(w) for w in waves] + [0])[:len(waves)] == want
        assert beam_decode.launches == before + 1
    finally:
        plain.beam_search = real
    assert not calls


# ---------------------------------------------------------------------------
# K7 at long inputs and wide beams
# ---------------------------------------------------------------------------

FLAGSHIP_DECODER = (2, 256, 100, 200, 102)  # all_real_seq2seq.cfg: layers, H, K, V, L

# On an H100 the batches below take clusters of 8 CTAs (B = 1), fewer as B grows (16, 17, 33,
# 64), and 1 at B = 133, in two waves of its 132 SMs
_K7_BATCHES = [1, 16, 17, 33, 64, 133]


@pytest.mark.cuda
def test_k7_cluster_size_follows_the_batch(dev):
    """1 to 8 CTAs a cluster, the largest whose clusters of the batch are
    all resident on the card at once: it never grows with B, one utterance
    takes 8, B past the SMs takes 1, and the batches below reach four
    sizes or more."""
    def size(B):
        return beam_cluster_size(B, 25, 4, *FLAGSHIP_DECODER, 200)

    sizes = [size(B) for B in (1, 2, 8, 16, 17, 33, 34, 64, 66, 67, 133, 300)]
    assert set(sizes) <= set(range(1, 9)) and sizes == sorted(sizes, reverse=True), sizes
    assert size(1) == 8 and size(133) == 1
    assert len({size(B) for B in _K7_BATCHES}) >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("B", _K7_BATCHES)
@pytest.mark.parametrize("masked", [False, True])
def test_k7_cluster_design_matches_plain(dev, B, masked):
    """The flagship decoder at each batch, so that every cluster size and a
    second wave are reached, masked (ragged valid frames, 1 among them) and
    not: one launch; tokens equal the plain search's, or a row parts from
    it only at a tie (``compare_searches``), scores within rtol 1e-5 atol
    1e-4 on the rows that pass whole."""
    from chip_smoke import compare_searches

    W, U = 4, 24
    dec, keys, values = k7_inputs(B + 40, B, 25, *FLAGSHIP_DECODER, dev)
    n = None
    if masked:
        n = torch.from_numpy(np.random.default_rng(B).integers(1, 26, B)).to(dev)
        n[0] = 1
    before = beam_decode.launches
    with torch.inference_mode():
        beam_decode(dec, keys, values, n, W, U)
    torch.cuda.synchronize()
    assert beam_decode.launches == before + 1

    def search(fn):
        def steps(n_steps):
            with torch.inference_mode():
                return tuple(t.cpu() for t in fn(dec, keys, values, n, W, n_steps))
        return steps

    (scores, _), (ref_scores, _), rows, _ = compare_searches(
        f"K7 B={B}", search(beam_decode), search(beam_search_reference), U)
    torch.testing.assert_close(scores[:, rows], ref_scores[:, rows], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_k7_takes_the_smem_plan_where_it_fits(dev):
    """At the flagship decoder 25 beams' plan fits a block beside a one-CTA
    cluster's bias slices and 26 do not (the plan has no T term): W = 25
    runs the smem plan, W = 26 the global one."""
    from tpu_slu_torch.ops import _build

    plan = _build.library().tsl_beam_decode_smem_bytes
    assert plan(25, *FLAGSHIP_DECODER, 200) <= SMEM_LIMIT < plan(26, *FLAGSHIP_DECODER, 200)
    dec, keys, values = k7_inputs(19, 1, 25, *FLAGSHIP_DECODER, dev)
    for W, global_plan in ((25, 0), (26, 1)):
        before = beam_decode.launches, beam_decode.launches_global
        with torch.inference_mode():
            beam_decode(dec, keys, values, None, W, 200)
        torch.cuda.synchronize()
        assert (beam_decode.launches - before[0], beam_decode.launches_global - before[1]) == (1, global_plan)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [26, 32, 64])
def test_k7_global_plan_matches_plain(dev, W):
    """Beams too wide for a block's shared memory at the flagship decoder
    and its 200 steps: the global plan, one launch; tokens equal the plain
    search's, or a row parts from it only at a tie (``compare_searches``:
    where the two first differ, the row's sorted beam scores agree within
    the f32 drift of the summed steps; a random decoder scores permuted
    hypotheses alike)."""
    from chip_smoke import compare_searches

    dec, keys, values = k7_inputs(W + 2, 2, 25, *FLAGSHIP_DECODER, dev)
    n = torch.tensor([25, 9], device=dev)
    before = beam_decode.launches, beam_decode.launches_global
    with torch.inference_mode():
        beam_decode(dec, keys, values, n, W, 200)
    torch.cuda.synchronize()
    assert (beam_decode.launches - before[0], beam_decode.launches_global - before[1]) == (1, 1)

    def search(fn):
        def steps(n_steps):
            with torch.inference_mode():
                return tuple(t.cpu() for t in fn(dec, keys, values, n, W, n_steps))
        return steps

    (scores, _), (ref_scores, _), rows, _ = compare_searches(
        f"K7 W={W}", search(beam_decode), search(beam_search_reference), 200)
    torch.testing.assert_close(scores[:, rows], ref_scores[:, rows], rtol=1e-5, atol=1e-4)


# B, W, U: either side of the smem plan's edge at U = 24, and the widest smem beam at the flagship's
# U = 200 (a seeded case whose rows part from the plain search at ties, each within the f32 drift of
# its summed steps by an f64 replay, tools/k7_tie_replay.py)
_K7_PLAN_EDGES = [pytest.param(33, 27, 24, id="27-33"), pytest.param(33, 28, 24, id="28-33"),
                  pytest.param(133, 27, 24, id="27-133"), pytest.param(133, 28, 24, id="28-133"),
                  pytest.param(133, 25, 200, id="25-133-U200")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,W,U", _K7_PLAN_EDGES)
def test_k7_plan_boundary_on_small_clusters(dev, B, W, U):
    """Either side of the smem plan's edge at the flagship decoder: at U =
    24 steps W = 27, the widest smem beam, and W = 28, whose plan fits a
    block alone but not beside a one-CTA cluster's bias slices, so takes
    the global plan; at U = 200, W = 25, the widest smem beam there; at
    batches whose smem plan takes clusters of 3 CTAs or fewer, where each
    CTA's bias slices are the largest (B = 133: one CTA an utterance, two
    waves). One launch; tokens equal the plain search's, or a row parts
    from it only at a tie within the f32 drift of its summed steps
    (``compare_searches``), scores within rtol 1e-5 atol 1e-4."""
    from chip_smoke import compare_searches
    from tpu_slu_torch.ops import _build

    edge = {24: 27, 200: 25}[U]  # the widest smem beam at U steps
    plan = _build.library().tsl_beam_decode_smem_bytes
    assert plan(edge, *FLAGSHIP_DECODER, U) <= SMEM_LIMIT < plan(edge + 1, *FLAGSHIP_DECODER, U)
    assert beam_cluster_size(B, 25, edge, *FLAGSHIP_DECODER, U) <= 3
    dec, keys, values = k7_inputs(B + W, B, 25, *FLAGSHIP_DECODER, dev)
    n = torch.from_numpy(np.random.default_rng(B).integers(1, 26, B)).to(dev)
    before = beam_decode.launches, beam_decode.launches_global
    with torch.inference_mode():
        beam_decode(dec, keys, values, n, W, U)
    torch.cuda.synchronize()
    assert (beam_decode.launches - before[0], beam_decode.launches_global - before[1]) == (1, int(W > edge))

    def search(fn):
        def steps(n_steps):
            with torch.inference_mode():
                return tuple(t.cpu() for t in fn(dec, keys, values, n, W, n_steps))
        return steps

    (scores, _), (ref_scores, _), rows, _ = compare_searches(
        f"K7 W={W} B={B} U={U}", search(beam_decode), search(beam_search_reference), U)
    torch.testing.assert_close(scores[:, rows], ref_scores[:, rows], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_k7_global_plan_takes_a_long_search(dev):
    """20,000 steps at W = 4: the backpointers alone pass a block's shared
    memory, so the plan lies in device memory; tokens equal the plain search's."""
    dec, keys, values = k7_inputs(5, 2, 6, 2, 8, 4, 8, 11, dev)
    n = torch.tensor([6, 3], device=dev)
    with torch.inference_mode():
        before = beam_decode.launches_global
        scores, tokens = beam_decode(dec, keys, values, n, 4, 20000)
        torch.cuda.synchronize()
        assert beam_decode.launches_global == before + 1
        ref_scores, ref_tokens = beam_search_reference(dec, keys, values, n, 4, 20000)
    assert torch.equal(tokens, ref_tokens)
    torch.testing.assert_close(scores, ref_scores, rtol=1e-5, atol=1e-3)  # sums of 20,000 steps


K7_BLOCKED_CASES = [  # B, T, nl, H, K, V, L, W, U
    (1, 25, 2, 256, 100, 200, 102, 4, 60),  # the flagship decoder at 4 s
    (2, 188, 2, 256, 100, 200, 102, 4, 40),  # 30 s
    (3, 131, 2, 256, 100, 200, 102, 8, 30),  # an odd T, several frame blocks
    (4, 13, 1, 64, 64, 64, 102, 4, 16),  # the golden seq2seq decoder
    (5, 70, 2, 8, 4, 8, 11, 3, 10),  # odd small widths, two frame blocks
    (2, 65, 2, 12, 5, 6, 9, 16, 10),  # a wide beam, one frame past a block
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,nl,H,K,V,L,W,U", K7_BLOCKED_CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_k7_blocked_mode_matches_plain(dev, B, T, nl, H, K, V, L, W, U, masked):
    """K7's blocked attention (frame blocks, online softmax) against the
    plain search, from 13 to 188 frames and over several frame blocks:
    tokens equal, scores within rtol 1e-5 atol 1e-4 (the online softmax sums
    in another order)."""
    dec, keys, values = k7_inputs(B * T + W + 1, B, T, nl, H, K, V, L, dev)
    n = None
    if masked:
        n = torch.from_numpy(np.random.default_rng(T + 1).integers(1, T + 1, B)).to(dev)
        n[0] = 1
    with torch.inference_mode():
        before = beam_decode.launches
        scores, tokens = beam_decode(dec, keys, values, n, W, U)
        torch.cuda.synchronize()
        assert beam_decode.launches == before + 1
        ref_scores, ref_tokens = beam_search_reference(dec, keys, values, n, W, U)
    assert torch.equal(tokens, ref_tokens)
    torch.testing.assert_close(scores, ref_scores, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [9, 12, 16, 19])
def test_k7_wide_beams_match_plain(dev, W):
    dec, keys, values = k7_inputs(W, 3, 21, 2, 16, 8, 8, 10, dev)
    n = torch.tensor([21, 1, 13], device=dev)
    with torch.inference_mode():
        scores, tokens = beam_decode(dec, keys, values, n, W, 12)
        ref_scores, ref_tokens = beam_search_reference(dec, keys, values, n, W, 12)
    assert torch.equal(tokens, ref_tokens)
    torch.testing.assert_close(scores, ref_scores, rtol=1e-5, atol=1e-4)


def _flagship_seq2seq_pair(dev):
    import copy

    from tpu_slu_torch.models.flagship import flagship_seq2seq_model

    cpu = flagship_seq2seq_model("cpu")
    return cpu, copy.deepcopy(cpu).to(dev)


def _hold_against_the_cpu(card, cpu, x, W, **kw):
    """The card's decode against the CPU's plain path: beam-0 tokens equal
    (a row that parts at a tie within the f32 drift of its summed steps
    passes, as ``chip_smoke.compare_searches`` has it), scores within 1e-3
    relative."""
    import dataclasses

    from chip_smoke import compare_searches

    def predict(m, n_steps):
        arch = m.seq2seq_arch
        m.seq2seq_arch = dataclasses.replace(arch, max_decode_len=n_steps)
        try:
            return tuple(t.cpu() for t in m.predict_intents(x, beam_width=W, **kw))
        finally:
            m.seq2seq_arch = arch

    (scores, _), (ref, _), rows, _ = compare_searches(
        "card vs CPU", lambda n: predict(card, n), lambda n: predict(cpu, n), card.seq2seq_arch.max_decode_len)
    assert torch.isfinite(scores).all()
    assert torch.allclose(scores[:, rows], ref[:, rows], rtol=1e-3, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["30s", "padded_to_40s", "4s_w9", "4s_w16"])
def test_flagship_seq2seq_decodes_every_length_and_width(dev, case):
    """The flagship seq2seq ``predict_intents`` on the card, one K7 launch a
    decode, against the CPU's plain search: 30 s at W = 4, a batch padded
    to 40 s with ``lengths=``, and 4 s at W = 9 and 16."""
    cpu, card = _flagship_seq2seq_pair(dev)
    rng = np.random.default_rng(49)
    kw, W = {}, 4
    if case == "30s":
        x = (0.1 * rng.standard_normal((1, 30 * 16000))).astype(np.float32)
    elif case == "padded_to_40s":
        lengths = [40 * 16000, 30 * 16000, 12 * 16000]
        x = np.zeros((3, 40 * 16000), np.float32)
        for i, t in enumerate(lengths):
            x[i, :t] = 0.1 * rng.standard_normal(t)
        kw = {"lengths": lengths}
    else:
        x = (0.1 * rng.standard_normal((2, 4 * 16000))).astype(np.float32)
        W = 9 if case == "4s_w9" else 16
    before = beam_decode.launches
    with torch.inference_mode():
        card.predict_intents(x, beam_width=W, **kw)
    torch.cuda.synchronize()
    assert beam_decode.launches == before + 1
    _hold_against_the_cpu(card, cpu, x, W, **kw)


@pytest.mark.cuda
def test_trainer_test_decodes_a_long_seq2seq_batch(dev, tmp_path):
    """``Trainer.test`` with the decode's exact match on a seq2seq batch
    padded past 24 s: one K7 launch, no plain search, no raise."""
    from tpu_slu_torch.models.flagship import flagship_seq2seq_model
    from tpu_slu_torch.ops import beam as plain
    from tpu_slu_torch.training import Trainer

    model = flagship_seq2seq_model(dev, seq2seq_max_decode_len=16)
    model.config.folder = str(tmp_path)
    model.config.decode_acc_from_epoch = 0
    labels = model.Sy_intent
    rng = np.random.default_rng(50)
    T = 26 * 16000
    ids = rng.integers(1, len(labels) - 1, (2, 16))
    batch = {"x": (0.1 * rng.standard_normal((2, T))).astype(np.float32),
             "y_intent": np.eye(len(labels), dtype=np.float32)[ids], "w": np.ones(2, np.float32),
             "len": np.array([T, 20 * 16000]), "y_len": np.array([16, 9])}

    class Data:
        loader = [batch]

    calls = []
    real = plain.beam_search
    plain.beam_search = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        before = beam_decode.launches
        acc, loss = Trainer(model, model.config).test(Data())
        torch.cuda.synchronize()
    finally:
        plain.beam_search = real
    assert beam_decode.launches == before + 1
    assert not calls and np.isfinite(loss) and 0.0 <= acc <= 1.0


# ---------------------------------------------------------------------------
# K8, the fused sinc front end
# ---------------------------------------------------------------------------

K8_CASES = [  # B, T, F, K, S, pad, pool; the launch plan each reaches: test_torch_frontend_plan.py
    (1, 64000, 80, 401, 80, 200, 2),  # the flagship's front end on 4 s: at B=1 the filters split over CTAs
    (16, 64000, 80, 401, 80, 200, 2),
    (16, 52800, 80, 401, 80, 200, 2),  # 3.3 s: a part-filled last row tile
    (40, 52880, 80, 401, 80, 200, 2),  # 661 conv rows: a last window of one row, pooled in registers
    (64, 64000, 80, 401, 80, 200, 2),  # pooled in registers, F past its last filter tile, items a CTA
    (300, 16000, 80, 401, 80, 200, 2),  # 1 s at B=300: each CTA walks several row tiles
    (2, 401, 80, 401, 80, 0, 2),  # one conv row
    (3, 1600, 16, 31, 10, 15, 2),  # tests/test_pallas_shared.py's shapes, the scalar-stride path (S=10)
    (3, 1555, 16, 31, 10, 15, 2),
    (2, 4000, 100, 61, 7, 30, 3),  # F=100, not a multiple of the filter tile; S=7; a pool that does not divide 8
]


def k8_inputs(seed, B, T, F, dev):
    from tpu_slu_torch.ops.sinc import mel_init

    b1, band = (torch.from_numpy(a).to(dev) for a in mel_init(F, 16000))
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((B, T)).astype(np.float32)).to(dev)
    return b1, band, x


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,F,K,S,pad,pool", K8_CASES)
@pytest.mark.parametrize("act", ["leaky_relu", "relu"])
def test_k8_matches_plain(dev, B, T, F, K, S, pad, pool, act):
    """Within 1e-5 of the largest output (f32 sums of K products in another
    order; TF32 would be ~1e-3 off)."""
    b1, band, x = k8_inputs(B + T, B, T, F, dev)
    kw = dict(filt_dim=K, fs=16000, stride=S, padding=pad, pool=pool, act=act)
    before = sinc_frontend_fused.launches
    with torch.inference_mode():
        got = sinc_frontend_fused(b1, band, x, **kw)
    torch.cuda.synchronize()
    assert sinc_frontend_fused.launches == before + 1
    ref = sinc_frontend_reference(b1, band, x, **kw)
    assert got.shape == ref.shape == (B, -(-((T + 2 * pad - K) // S + 1) // pool), F)
    assert got.transpose(1, 2).is_contiguous()  # channels-first underneath, for the convs after it
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


@pytest.mark.cuda
def test_k8_gradients_recompute_through_the_plain_composition(dev):
    b1, band, x = k8_inputs(1, 2, 16000, 80, dev)
    kw = dict(filt_dim=401, fs=16000, stride=80, padding=200, pool=2)
    leaves = [t.clone().requires_grad_() for t in (b1, band, x)]
    out = sinc_frontend_fused(*leaves, **kw)
    assert out.grad_fn is not None
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(dev)
    out.backward(cot)
    ref_leaves = [t.clone().requires_grad_() for t in (b1, band, x)]
    sinc_frontend_reference(*ref_leaves, **kw).backward(cot)
    for g, r in zip(leaves, ref_leaves):
        torch.testing.assert_close(g.grad, r.grad, rtol=1e-5, atol=1e-5 * r.grad.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["float64", "noncontiguous", "cpu_filter"])
def test_k8_rejects_what_it_does_not_take(dev, fault):
    b1, band, x = k8_inputs(3, 2, 1600, 16, dev)
    if fault == "float64":
        x = x.double()
    elif fault == "noncontiguous":
        x = torch.cat([x, x], dim=1)[:, ::2]
    else:
        band = band.cpu()
    before = sinc_frontend_fused.launches
    with torch.inference_mode(), pytest.raises((TypeError, ValueError)):
        sinc_frontend_fused(b1, band, x, filt_dim=31, fs=16000, stride=10, padding=15, pool=2)
    assert sinc_frontend_fused.launches == before


# ---------------------------------------------------------------------------
# K6, the row-stacked layout of K1
# ---------------------------------------------------------------------------


@pytest.mark.cuda
# B <= 12 takes clusters of 4 CTAs on an H100 (B = 1, 3), B > 12 clusters of 2 (16: one-row tiles; 100:
# 4-row tiles; 300: 8-row tiles over more than one wave); bigru_shared.bigru_cluster_size
@pytest.mark.parametrize("B,T", [(1, 1), (1, 21), (1, 400), (3, 21), (16, 400), (100, 21), (300, 21)])
@pytest.mark.parametrize("pool,method", POOLS)
@pytest.mark.parametrize("dims", [(60,), (128, 128)], ids=["parts1", "parts2"])
def test_k6_matches_plain_and_k1(dev, dims, pool, method, B, T):
    params, parts = k1_inputs(0, dims, T, B, 128, dev)
    before = bigru_shared.launches, bigru_shared.launches_rowstack
    got = bigru_shared(params, parts, pool=pool, pool_method=method, layout="rowstack")[:2]
    torch.cuda.synchronize()
    assert (bigru_shared.launches, bigru_shared.launches_rowstack) == (before[0], before[1] + 1)
    ref = bigru_shared_rowstack_reference(params, parts, pool=pool, pool_method=method)
    k1 = bigru_shared(params, parts, pool=pool, pool_method=method)[:2]
    for g, r, k in zip(got, ref, k1):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)  # K1's limits: f32 sums in another order
        torch.testing.assert_close(g, k, rtol=1e-5, atol=1e-5)  # one recurrence, the biases added apart


@pytest.mark.cuda
@pytest.mark.parametrize("kwargs", [{"pool": 2}, {"pool": 2, "pool_method": "max"}, {"train": True}])
def test_k6_forward_under_autograd_with_k3(dev, kwargs):
    """The pooled eval core and the train core with K6 forward and K3
    backward, against torch autograd of K1's plain version."""
    params, parts = k1_inputs(13, (128, 128), 37, 5, 128, dev)
    tp, tx = _leaves(params, parts)
    before = bigru_shared.launches, bigru_shared.launches_rowstack, bigru_shared_bwd.launches
    out = bigru_shared(tp, tx, layout="rowstack", **kwargs)
    rp, rx = _leaves(params, parts)
    ref = bigru_shared_reference(rp, rx, pool=kwargs.get("pool", 1),
                                 pool_method=kwargs.get("pool_method", "avg"))
    rng = np.random.default_rng(14)
    cot = [torch.from_numpy(rng.standard_normal(tuple(r.shape)).astype(np.float32)).to(dev) for r in ref]
    torch.autograd.backward(out[:2], cot)
    torch.autograd.backward(ref, cot)
    torch.cuda.synchronize()
    recompute = int(kwargs.get("pool", 1) > 1)  # the pooled core recomputes the full-rate forward
    assert (bigru_shared.launches - before[0], bigru_shared.launches_rowstack - before[1],
            bigru_shared_bwd.launches - before[2]) == (0, 1 + recompute, 1)
    pairs = list(zip(tx, rx)) + [(tp[d][n], rp[d][n]) for d in tp for n in tp[d]]
    for g, r in pairs:
        assert (g.grad - r.grad).abs().max().item() <= 1e-4 * r.grad.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["float64", "noncontiguous", "h_not_multiple_of_4", "cpu_weight", "shape"])
def test_k6_rejects_what_it_does_not_take(dev, fault):
    H = 10 if fault == "h_not_multiple_of_4" else 8
    params, parts = k1_inputs(2, (6,), 9, 2, H, dev)
    if fault == "float64":
        parts = [p.double() for p in parts]
    elif fault == "noncontiguous":
        parts = [p.transpose(0, 1).contiguous().transpose(0, 1) for p in parts]
    elif fault == "cpu_weight":
        params["bwd"]["weight_hh"] = params["bwd"]["weight_hh"].cpu()
    elif fault == "shape":
        params["fwd"]["bias_hh"] = params["fwd"]["bias_hh"][:-1].contiguous()
    before = bigru_shared.launches_rowstack
    with pytest.raises((TypeError, ValueError)):
        bigru_shared(params, parts, layout="rowstack")
    assert bigru_shared.launches_rowstack == before


@pytest.mark.cuda
@pytest.mark.parametrize("frontend,gru_layout", [("fused", "rowstack"), ("fused", "split"),
                                                 ("composed", "rowstack")])
def test_flagship_decode_through_k8_and_k6(dev, frontend, gru_layout):
    """The flagship decode with each route set: one K8 launch a call on the
    fused front end, five K6 (and no K1) launches on the row-stacked layout;
    logits within the smoke's 1e-3 of the same model on the CPU."""
    from tpu_slu_torch.models.flagship import flagship_model

    cpu = flagship_model("cpu")
    card = flagship_model(dev)
    for m in (cpu, card):
        m.pretrained_model.frontend, m.pretrained_model.gru_layout = frontend, gru_layout
    x = (0.1 * np.random.default_rng(15).standard_normal((2, 64000))).astype(np.float32)
    before = sinc_frontend_fused.launches, bigru_shared.launches, bigru_shared.launches_rowstack
    logits, _ = card.predict_intents(x)
    torch.cuda.synchronize()
    rowstack = gru_layout == "rowstack"
    assert (sinc_frontend_fused.launches - before[0], bigru_shared.launches - before[1],
            bigru_shared.launches_rowstack - before[2]) == (int(frontend == "fused"), 5 * (not rowstack),
                                                           5 * rowstack)
    ref, _ = cpu.predict_intents(x)
    assert (logits.cpu() - ref).abs().max().item() <= 1e-3


# ---------------------------------------------------------------------------
# The GEMM core (csrc/bigru_gemm.cuh) in each of its three layouts, and the
# kernels that take it; K5f's cluster recurrence at the batches that take each
# cluster size
# ---------------------------------------------------------------------------


def _f32(rng, *shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)


def _close_to_f64(got, ref64, scale64, tol=1e-5):
    """Within ``tol`` of the largest element of |A| |B| (the f64 product of
    the operands' magnitudes): f32 sums of up to 25,600 terms against f64."""
    assert got.shape == ref64.shape
    err = (got.double() - ref64).abs().max().item()
    assert err <= tol * max(scale64.max().item(), 1e-30), err


# M = T*B rows: 75 (T = 25, B = 3) and 1,601 not a multiple of the 128-row tile;
# K or N in {36 (3H at the golden H = 12), 60, 128, 256, 384}; two parts with d1 != d2
@pytest.mark.cuda
@pytest.mark.parametrize("M,d1,d2,N", [(75, 60, 0, 384), (75, 128, 128, 384), (75, 12, 20, 36),
                                       (1601, 256, 0, 384), (25600, 60, 0, 384), (200, 128, 0, 60)])
@pytest.mark.parametrize("bias", [True, False])
def test_gemm_core_proj_layout_matches_f64(dev, M, d1, d2, N, bias):
    rng = np.random.default_rng(M + d1 + d2 + N)
    x1, w = _f32(rng, M, d1, dev=dev), _f32(rng, N, d1 + d2, dev=dev)
    x2 = _f32(rng, M, d2, dev=dev) if d2 else None
    b = _f32(rng, N, dev=dev) if bias else None
    got = gemm_proj(x1, x2, w, b)
    torch.cuda.synchronize()
    x = (x1 if x2 is None else torch.cat([x1, x2], 1)).double()
    ref = x @ w.double().t() + (b.double() if bias else 0.0)
    _close_to_f64(got, ref, x.abs() @ w.double().abs().t() + (b.double().abs() if bias else 0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("ndir,M,K,d1,d2", [(2, 75, 384, 60, 0), (2, 75, 384, 128, 128), (1, 75, 36, 12, 20),
                                            (2, 1601, 384, 256, 0), (1, 25600, 384, 60, 0),
                                            (2, 200, 36, 12, 12)])
def test_gemm_core_dx_layout_matches_f64(dev, ndir, M, K, d1, d2):
    rng = np.random.default_rng(M + K + d1 + d2)
    a = _f32(rng, ndir, M, K, dev=dev)
    ws = [_f32(rng, K, d1 + d2, dev=dev) for _ in range(ndir)]
    dx1, dx2 = gemm_dx(a, ws, d1)
    torch.cuda.synchronize()
    ref = sum(a[i].double() @ w.double() for i, w in enumerate(ws))
    scale = sum(a[i].double().abs() @ w.double().abs() for i, w in enumerate(ws))
    _close_to_f64(torch.cat([dx1, dx2], 1), ref, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,d1,d2", [(75, 384, 60, 0), (75, 384, 128, 128), (75, 36, 12, 20),
                                       (25600, 384, 60, 0), (1601, 384, 128, 128), (25600, 384, 128, 0),
                                       (7, 36, 12, 0)])
def test_gemm_core_dw_layout_matches_f64_and_repeats_bit_for_bit(dev, M, K, d1, d2):
    """dW and db (the column sums, no ones column) against f64; two calls
    agree bit for bit (the row chunks are summed in chunk order)."""
    rng = np.random.default_rng(M + K + d1 + d2)
    a, x1 = _f32(rng, M, K, dev=dev), _f32(rng, M, d1, dev=dev)
    x2 = _f32(rng, M, d2, dev=dev) if d2 else None
    dw, db = gemm_dw(a, x1, x2)
    again = gemm_dw(a, x1, x2)
    torch.cuda.synchronize()
    x = (x1 if x2 is None else torch.cat([x1, x2], 1)).double()
    _close_to_f64(dw, a.double().t() @ x, a.double().abs().t() @ x.abs())
    _close_to_f64(db, a.double().sum(0), a.double().abs().sum(0))
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])


# The bf16 core on the tensor cores (gemm_kernel_tc: bf16 mma.sync, f32 accumulation), held against
# an f64 product of the bf16-rounded operands. An f32 output within (K + 2) 2^-23 of sum_k |a_k b_k|
# (plus |bias| and |fold|): the first-order bound of a K-term f32 sum (u = 2^-24), doubled because
# the tensor cores may truncate where an f32 add rounds. A bf16 dX element also within one bf16
# spacing (2^-7 of the value) of each rounded value it went through: each direction's product and,
# with two, their sum. Each call repeats bit for bit; operands that the kernel must read value by
# value (parts at an odd 2-byte offset, f32 operands 4 bytes past a 16-byte boundary) give the bits
# of aligned copies.


def _shifted(t, shift: int):
    """A contiguous copy of ``t`` that starts ``shift`` elements into its buffer."""
    buf = torch.empty(t.numel() + shift, device=t.device, dtype=t.dtype)
    view = buf[shift:].view(t.shape)
    view.copy_(t)
    return view


def _bf64(t):
    return t.to(torch.bfloat16).double()


def _within_tc_bound(got, ref64, K: int, scale64, extra64=0.0):
    err = (got.double() - ref64).abs()
    bound = (K + 2) * 2.0**-23 * scale64 + extra64
    assert (err <= bound).all(), (err / bound.clamp_min(1e-30)).max().item()


# M = T*B rows of the flagship's layers (1,600 to 25,600) and rows no multiple of a tile; K in
# {60, 120 = 60 | 60, 128, 256 = 128 | 128} and the golden model's 12 | 20; N = 3H
@pytest.mark.cuda
@pytest.mark.parametrize("M,d1,d2,N", [(1600, 60, 0, 384), (75, 60, 60, 384), (1601, 128, 0, 384),
                                       (25600, 60, 0, 384), (201, 256, 0, 384), (77, 128, 128, 384),
                                       (75, 12, 20, 36)])
@pytest.mark.parametrize("shift", ["none", "x", "w"])
def test_gemm_core_bf16_proj_matches_f64_and_repeats(dev, M, d1, d2, N, shift):
    """gi and gh at bf16 (launch_proj<bf16>): bf16 parts, f32 weights
    rounded to bf16 as read, f32 out; one and two k segments."""
    rng = np.random.default_rng(M + d1 + d2 + N)
    x1 = _f32(rng, M, d1, dev=dev).to(torch.bfloat16)
    x2 = _f32(rng, M, d2, dev=dev).to(torch.bfloat16) if d2 else None
    w, b = 0.1 * _f32(rng, N, d1 + d2, dev=dev), 0.1 * _f32(rng, N, dev=dev)
    before = tc_launches()
    got = gemm_proj_bf16(x1, x2, w, b)
    torch.cuda.synchronize()
    assert tc_launches() == before + 1
    x = x1 if x2 is None else torch.cat([x1, x2], 1)
    _within_tc_bound(got, x.double() @ _bf64(w).t() + b.double(), d1 + d2,
                     x.double().abs() @ _bf64(w).abs().t() + b.double().abs())
    assert torch.equal(gemm_proj_bf16(x1, x2, w, b), got)
    if shift == "x":  # the parts at an odd 2-byte offset
        moved = [_shifted(x1, 1), None if x2 is None else _shifted(x2, 1), w]
        assert moved[0].data_ptr() % 4 == 2
    elif shift == "w":  # the weights 4 bytes past a 16-byte boundary
        moved = [x1, x2, _shifted(w, 1)]
        assert moved[2].data_ptr() % 16 == 4
    else:
        return
    assert torch.equal(gemm_proj_bf16(*moved, b), got)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,d1,d2", [(25, 3, 60, 0), (50, 16, 128, 128), (25, 64, 256, 0), (7, 5, 12, 20)])
def test_gemm_core_bf16_rowstack_matches_f64_and_repeats(dev, T, B, d1, d2):
    """K6's row-stacked gi at bf16 (launch_gi_proj_rs<bf16>): both
    directions in one launch, row (t, dir B + b) from input row (s, b), s = t
    forward and T - 1 - t backward, b_hh folded into the first 2N/3 columns."""
    rng = np.random.default_rng(T * B + d1)
    N = 384 if d1 > 12 else 36
    x1 = _f32(rng, T * B, d1, dev=dev).to(torch.bfloat16)
    x2 = _f32(rng, T * B, d2, dev=dev).to(torch.bfloat16) if d2 else None
    ws = [0.1 * _f32(rng, N, d1 + d2, dev=dev) for _ in range(2)]
    bs = [0.1 * _f32(rng, N, dev=dev) for _ in range(2)]
    folds = [0.1 * _f32(rng, N, dev=dev) for _ in range(2)]
    got = gemm_proj_rs_bf16(x1, x2, ws, bs, folds, T, B)
    torch.cuda.synchronize()
    x = (x1 if x2 is None else torch.cat([x1, x2], 1)).double()
    keep = (torch.arange(N, device=dev) < 2 * N // 3).double()
    for d in range(2):
        extra = bs[d].double() + keep * folds[d].double()
        ref = (x @ _bf64(ws[d]).t() + extra).view(T, B, N)
        scale = (x.abs() @ _bf64(ws[d]).abs().t() + extra.abs()).view(T, B, N)
        rows = got[:, d * B:(d + 1) * B]
        if d:
            ref, scale = ref.flip(0), scale.flip(0)
        _within_tc_bound(rows, ref, d1 + d2 + 2, scale)
    assert torch.equal(gemm_proj_rs_bf16(x1, x2, ws, bs, folds, T, B), got)


@pytest.mark.cuda
@pytest.mark.parametrize("ndir,M,K,d1,d2", [(2, 1600, 384, 256, 0), (2, 25600, 384, 60, 0), (1, 1601, 384, 60, 0),
                                            (1, 3200, 384, 128, 0), (2, 201, 384, 128, 128), (2, 75, 36, 12, 20)])
@pytest.mark.parametrize("shift", [0, 1])
def test_gemm_core_bf16_dx_matches_f64_and_repeats(dev, ndir, M, K, d1, d2, shift):
    """dX at bf16 (launch_dx_bf16): each direction's dgi and W_ih rounded to
    bf16 as read, its product rounded to bf16 (OBF), the two directions'
    sum rounded again; shift 1 puts dgi and W_ih 4 bytes past a 16-byte
    boundary. At least 99% of the elements equal the plain version's."""
    rng = np.random.default_rng(M + K + d1 + d2 + ndir)
    a = _f32(rng, ndir, M, K, dev=dev)
    ws = [0.1 * _f32(rng, K, d1 + d2, dev=dev) for _ in range(ndir)]
    got = torch.cat(gemm_dx_bf16(a, ws, d1), 1)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    exact = [_bf64(a[i]) @ _bf64(w) for i, w in enumerate(ws)]
    scale = sum(_bf64(a[i]).abs() @ _bf64(w).abs() for i, w in enumerate(ws))
    spacing = 2.0**-7 * (sum(p.abs() for p in exact) + (sum(exact).abs() if ndir == 2 else 0.0))
    _within_tc_bound(got, sum(exact), K, scale, spacing)
    plain = torch.cat(gemm_dx_bf16_reference(a, ws, d1), 1)
    assert (got == plain).double().mean().item() >= 0.99
    assert torch.equal(torch.cat(gemm_dx_bf16(a, ws, d1), 1), got)
    if shift:
        moved = torch.cat(gemm_dx_bf16(_shifted(a, 1), [_shifted(w, 1) for w in ws], d1), 1)
        assert torch.equal(moved, got)


def _assert_grads_equal(a, b):
    (adx, ag), (bdx, bg) = a, b
    assert all(torch.equal(x, y) for x, y in zip(adx, bdx))
    assert all(torch.equal(ag[d][n], bg[d][n]) for d in ag for n in ag[d]), "dW/db differ between runs"


# the flagship's K3 layers at B = 64 (D = 60 at T = 400; two parts of 128; the intent
# layer) and small widths with T*B not a multiple of 128 and two parts of unequal width
@pytest.mark.cuda
@pytest.mark.parametrize("dims,T,B,H,fused", [((60,), 400, 64, 128, True), ((128, 128), 200, 64, 128, True),
                                              ((256,), 25, 64, 128, False), ((12, 20), 25, 3, 12, True),
                                              ((60,), 25, 3, 16, False)])
def test_k3_matches_plain_and_repeats_bit_for_bit(dev, dims, T, B, H, fused):
    params, parts, hp_f, hp_b, dy, kw = _bwd_case(11, dims, T, B, H, dev, fused)
    got = bigru_shared_bwd(params, parts, hp_f, hp_b, *dy, **kw)
    again = bigru_shared_bwd(params, parts, hp_f, hp_b, *dy, **kw)
    torch.cuda.synchronize()
    _assert_grads_close(got, bigru_shared_bwd_reference(params, parts, hp_f, hp_b, *dy, **kw))
    _assert_grads_equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,H", [(64, 25, 256, 128), (3, 25, 60, 12), (8, 37, 60, 128)])
def test_k4b_matches_plain_and_repeats_bit_for_bit(dev, B, T, D, H):
    params, x, lengths, outs, dy = k4b_inputs(32, B, T, D, H, dev)
    for n, out in zip(lengths, outs):
        got = bigru_masked_bwd(params, x, out, n, dy)
        again = bigru_masked_bwd(params, x, out, n, dy)
        torch.cuda.synchronize()
        ref = bigru_masked_bwd_reference(params, x, out, n, dy)
        _assert_grads_close(((got[0],), got[1]), ((ref[0],), ref[1]))
        _assert_grads_equal(((got[0],), got[1]), ((again[0],), again[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,H", [(64, 400, 60, 128), (64, 25, 128, 128), (3, 25, 60, 12)])
def test_k5b_matches_plain_and_repeats_bit_for_bit(dev, B, T, D, H):
    params, x, lengths = k5_inputs(48, B, T, D, H, dev)
    dy = torch.from_numpy(np.random.default_rng(49).standard_normal((B, T, H)).astype(np.float32)).to(dev)
    for n in lengths:
        with torch.inference_mode():
            out = gru1_fwd(params, x, n)
        got = gru1_bwd(params, x, out, n, dy)
        again = gru1_bwd(params, x, out, n, dy)
        torch.cuda.synchronize()
        ref = gru1_bwd_reference(params, x, out, n, dy)
        _assert_grads_close(((got[0],), got[1]), ((ref[0],), ref[1]))
        _assert_grads_equal(((got[0],), got[1]), ((again[0],), again[1]))


# On an H100's 132 SMs, B <= 33 takes clusters of 4 CTAs and B = 64 clusters of 2
_K5F_BATCHES = [(1, False), (3, False), (8, True), (16, False), (64, False)]


@pytest.mark.cuda
def test_k5f_cluster_size_follows_the_batch(dev):
    """4 CTAs a cluster while every row gets a cluster in one wave of the
    SMs, else 2; the batches of the test below reach both sizes."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B in (1, 3, 8, 16, 33, 34, 64, 200):
        assert gru1_cluster_size(B) == (4 if 4 * B <= sms else 2), B
    assert {gru1_cluster_size(B) for B, _ in _K5F_BATCHES} == {2, 4}


@pytest.mark.cuda
@pytest.mark.parametrize("H", [12, 128])
@pytest.mark.parametrize("B,masked", _K5F_BATCHES)
def test_k5f_cluster_recurrence_matches_plain(dev, B, masked, H):
    """K5f on the clusters it takes at batch B against ``gru1_reference``,
    within 1e-4 of its largest element; B = 8 with lengths holding 0 and T
    among mixed ones, zeros past each; one launch a call on the counter."""
    T, D = 50, 60
    params, x, _ = k5_inputs(50, B, T, D, H, dev)
    n = None
    if masked:
        lengths = np.random.default_rng(51).integers(1, T, B)
        lengths[0], lengths[-1] = T, 0
        n = torch.tensor(lengths, device=dev)
    before = gru1.launches
    with torch.inference_mode():
        got = gru1_fwd(params, x, n)
    torch.cuda.synchronize()
    assert gru1.launches == before + 1
    ref = gru1_reference(params, x, n)
    assert got.shape == ref.shape == (B, T, H)
    assert _rel_close(got, ref), (got - ref).abs().max().item()
    for b, nb in enumerate([T] * B if n is None else n.tolist()):
        assert (got[b, nb:] == 0).all()


@pytest.mark.cuda
def test_k5f_rejects_a_width_past_its_registers(dev):
    wide, x_wide, _ = k5_inputs(52, 2, 5, 8, 132, dev)
    before = gru1.launches
    with pytest.raises(ValueError):
        gru1_fwd(wide, x_wide)
    assert gru1.launches == before


# ---------------------------------------------------------------------------
# K4b's and K5b's dh chain on the backward cluster recurrence
# ---------------------------------------------------------------------------

# On an H100's 132 SMs the backward chain takes the forward's cluster sizes: K5b (one direction)
# clusters of 4 to B = 33, then of 2 with batch tiles of 1 row to B = 66, 2 to 132, 4 to 264 and 8
# past; K4b (two directions) _CLUSTER_EDGES' sizes and tiles
_K5B_EDGES = [33, 34, 66, 67, 133, 265]


def _tile_lengths(seed, B, T):
    """Seeded lengths in [0, T] where every run of three rows holds T, 0
    and 1, so that each batch tile of two rows or more mixes walks of T,
    none and one step."""
    n = np.random.default_rng(seed).integers(0, T + 1, B)
    n[0::3], n[1::3], n[2::3] = T, 0, 1
    n[3::5] = np.random.default_rng(seed + 1).integers(2, T, len(n[3::5]))
    return n


@pytest.mark.cuda
def test_bwd_chain_batches_reach_both_cluster_sizes(dev):
    """The chain takes the forward's cluster size (gru_cluster_bwd.cuh); the
    batches of the tests below reach clusters of 2 and of 4 CTAs for each
    number of directions."""
    assert {gru1_cluster_size(B) for B in [1, 3, 8] + _K5B_EDGES} == {2, 4}
    assert {bigru_cluster_size(B) for B in [1, 3, 8] + _CLUSTER_EDGES} == {2, 4}


@pytest.mark.cuda
@pytest.mark.parametrize("B", sorted([1, 3, 8] + _CLUSTER_EDGES))
def test_k4b_cluster_chain_matches_plain(dev, B):
    """K4b at the batches where the chain's cluster size or batch tile
    changes, each tile mixing rows of length 0, 1 and T: dX and the eight
    weight and bias gradients within 1e-4 of each largest element, dX
    exactly 0 past each length, one launch, and a second call equal to the
    first bit for bit."""
    T, D, H = 25, 60, 128
    params, x, _ = k4_inputs(60, B, T, D, H, dev)
    n = torch.from_numpy(_tile_lengths(61, B, T)).to(dev)
    with torch.inference_mode():
        out = bigru_masked(params, x, n)
    dy = torch.from_numpy(np.random.default_rng(62).standard_normal((B, T, 2 * H)).astype(np.float32)).to(dev)
    before = bigru_masked_bwd.launches
    got = bigru_masked_bwd(params, x, out, n, dy)
    again = bigru_masked_bwd(params, x, out, n, dy)
    torch.cuda.synchronize()
    assert bigru_masked_bwd.launches == before + 2
    ref = bigru_masked_bwd_reference(params, x, out, n, dy)
    _assert_grads_close(((got[0],), got[1]), ((ref[0],), ref[1]))
    _assert_grads_equal(((got[0],), got[1]), ((again[0],), again[1]))
    for b, nb in enumerate(n.tolist()):
        assert (got[0][b, nb:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B", sorted([1, 3, 8, 16] + _K5B_EDGES))
def test_k5b_cluster_chain_matches_plain(dev, B, masked):
    """K5b at the batches where the chain's cluster size or batch tile
    changes, every row T or each tile mixing rows of length 0, 1 and T:
    dX and the four gradients within 1e-4 of each largest element, dX
    exactly 0 past each length, one launch, and a second call equal to the
    first bit for bit."""
    T, D, H = 25, 60, 128
    params, x, _ = k5_inputs(63, B, T, D, H, dev)
    n = torch.from_numpy(_tile_lengths(64, B, T)).to(dev) if masked else None
    with torch.inference_mode():
        out = gru1_fwd(params, x, n)
    dy = torch.from_numpy(np.random.default_rng(65).standard_normal((B, T, H)).astype(np.float32)).to(dev)
    before = gru1_bwd.launches
    got = gru1_bwd(params, x, out, n, dy)
    again = gru1_bwd(params, x, out, n, dy)
    torch.cuda.synchronize()
    assert gru1_bwd.launches == before + 2
    ref = gru1_bwd_reference(params, x, out, n, dy)
    _assert_grads_close(((got[0],), got[1]), ((ref[0],), ref[1]))
    _assert_grads_equal(((got[0],), got[1]), ((again[0],), again[1]))
    for b, nb in enumerate([T] * B if n is None else n.tolist()):
        assert (got[0][b, nb:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [13, 34, 133])
def test_k3_repeats_bit_for_bit_at_the_cluster_edges(dev, B):
    """K3, whose chain is the backward cluster recurrence that K4b and K5b
    run (gru_cluster_bwd.cuh with its SPLIT flag), at batches whose tiles
    hold 1, 2 and 8 rows: within 1e-4 of its plain version, a second call
    equal to the first bit for bit."""
    params, parts, hp_f, hp_b, dy, kw = _bwd_case(66, (128, 128), 25, B, 128, dev, True)
    got = bigru_shared_bwd(params, parts, hp_f, hp_b, *dy, **kw)
    again = bigru_shared_bwd(params, parts, hp_f, hp_b, *dy, **kw)
    torch.cuda.synchronize()
    _assert_grads_close(got, bigru_shared_bwd_reference(params, parts, hp_f, hp_b, *dy, **kw))
    _assert_grads_equal(got, again)


@pytest.fixture(scope="module")
def k3_other_lib():
    """The ``k3_other_c`` copy of the kernel library (chip_smoke.VARIANTS):
    K3 with its chain on the cluster size the rule does not pick, built with
    nvcc beside the port's library."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    import chip_smoke

    return chip_smoke.load_variant("k3_other_c", *chip_smoke.start_variant("k3_other_c",
                                                                         *chip_smoke.VARIANTS["k3_other_c"]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_k3_at_b64_on_both_cluster_sizes(dev, k3_other_lib, dtype, fused):
    """K3 at B = 64 on the cluster size its rule takes there (2, with
    2-row tiles) and on the other (4, with 4-row tiles, the ``k3_other_c``
    copy that the ``--k3-batches`` A/B times): within its bound of the plain
    version on each, a second call equal to the first bit for bit, and the
    two sizes equal bit for bit, since each unit's sums do not depend on C."""
    from tpu_slu_torch.ops import _build

    assert bigru_cluster_size(64) == 2
    T, B, H = 50, 64, 128
    if dtype == "bf16":
        params, parts, parts32, hp_f, hp_b, dy, kw = _bf16_bwd_case(67, (128, 128), T, B, H, dev, fused)
    else:
        params, parts, hp_f, hp_b, dy, kw = _bwd_case(67, (128, 128), T, B, H, dev, fused)
    runs = {}
    for C, lib in ((2, _build.library()), (4, k3_other_lib)):
        real, _build._lib = _build._lib, lib
        try:
            runs[C] = [bigru_shared_bwd(params, parts, hp_f, hp_b, *dy, **kw) for _ in range(2)]
        finally:
            _build._lib = real
    torch.cuda.synchronize()
    ref = bigru_shared_bwd_reference(params, parts, hp_f, hp_b, *dy, **kw)
    for C, (got, again) in runs.items():
        if dtype == "bf16":
            r32 = bigru_shared_bwd_reference(params, parts32, *[t.float() for t in (hp_f, hp_b, *dy)], **kw)
            for g, r, r2 in zip(got[0], ref[0], r32[0]):
                assert_bf16_close(g, r, r2)
            for d in got[1]:
                for n in got[1][d]:
                    assert_bf16_close(got[1][d][n], ref[1][d][n], r32[1][d][n])
        else:
            _assert_grads_close(got, ref)
        _assert_grads_equal(got, again)
    _assert_grads_equal(runs[2][0], runs[4][0])


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_bf16_k3_takes_h_prev_at_an_odd_offset(dev, fused):
    """K3's bf16 chain reads each h_prev value through the 4-byte word that
    holds it: contiguous bf16 h_prev views that start 2 bytes into a word
    give the outputs of aligned copies, bit for bit."""
    params, parts, _, hp_f, hp_b, dy, kw = _bf16_bwd_case(68, (60,), 25, 3, 16, dev, fused)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=dev, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 4 == 2
        return view

    got = bigru_shared_bwd(params, parts, shifted(hp_f), shifted(hp_b), *dy, **kw)
    want = bigru_shared_bwd(params, parts, hp_f.contiguous(), hp_b.contiguous(), *dy, **kw)
    torch.cuda.synchronize()
    assert hp_f.data_ptr() % 4 == 0 and hp_b.data_ptr() % 4 == 0
    _assert_grads_equal(got, want)


@pytest.mark.cuda
def test_the_step_timer_waits_for_the_device_only_in_its_summary(dev):
    """``StepTimer`` on the card: each step records an event and returns
    while the device still runs it; ``summary`` synchronises once and reads
    each step's device time from the events."""
    from tpu_slu_torch.utils.profiling import StepTimer

    cycles = 40_000_000  # 20 ms at 2 GHz, more at lower clocks
    timer = StepTimer(dev)
    torch.cuda.synchronize()
    for _ in range(3):
        with timer.step():
            torch.cuda._sleep(cycles)
    assert not timer._end.query()  # the host did not wait for the steps
    got = timer.summary()
    assert got["steps"] == 3 and timer._end.query()
    assert 10.0 <= got["step_ms_p50"] <= got["step_ms_p99"] and got["step_ms_mean"] >= 10.0
