"""The port's train-mode bi-GRU layer (K2, K3 and their autograd) vs the JAX package.

On the CPU the wrappers run their plain versions, inside the same autograd
Functions the card runs with the kernels. JAX ``bigru_apply_shared(train=True)``
runs the Pallas kernels in interpret mode. Both sides get the same seeded
inputs, weights and cotangents, and the same uint32 dropout seed, so the
dropout masks are the same bits. Tolerances: f32 sums over T steps taken in
another order (the port's gate sigmoid is the logistic, JAX's kernels take
0.5 + 0.5 tanh(x/2), equal to a few ulp); rtol 1e-4, atol 1e-5 on
gradients, whose sums run over T*B rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bigru_shared import make_params, make_parts
from tpu_slu.ops.pallas_gru import _DIR_SALT_B, _DIR_SALT_F, _keep_mask, bigru_apply_shared
from tpu_slu_torch.ops import bigru_shared as ops
from tpu_slu_torch.ops.bigru_shared import (
    _PooledEvalCore,
    _TrainCore,
    _TrainPoolCore,
    bigru_shared,
    bigru_shared_bwd_reference,
    bigru_shared_reference,
    bigru_trainpool_reference,
)
from tpu_slu_torch.ops.dropout import keep_mask, keep_threshold

RTOL, ATOL = 1e-4, 1e-5
_JAX_NAMES = {"weight_ih": "w_ih", "weight_hh": "w_hh", "bias_ih": "b_ih", "bias_hh": "b_hh"}


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("salt", [_DIR_SALT_F, _DIR_SALT_B], ids=["fwd", "bwd"])
@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF, 2**32 - 1])
def test_keep_mask_is_jax_bit_for_bit(seed, salt, p):
    for t0 in (0, 5, 1 << 20):
        th = keep_threshold(p)
        want = np.asarray(_keep_mask(jnp.uint32(seed), salt, t0, (11, 3, 24), th))
        got = keep_mask(seed, salt, t0, (11, 3, 24), th).numpy()
        np.testing.assert_array_equal(got, want)
    assert 0.5 * (1 - p) < want.mean() < 1.5 * (1 - p)


def _torch_leaves(port_p):
    """The port's weights as leaf tensors that require grad."""
    return {d: {n: t.clone().requires_grad_() for n, t in port_p[d].items()} for d in port_p}


def _jax_vjp(jax_p, parts, cot, **kw):
    """JAX outputs and the VJP of (h_f, h_b) wrt (parts, params) at ``cot``."""
    def f(ps, p):
        h_f, h_b, _ = bigru_apply_shared(p, tuple(ps), **kw)
        return h_f, h_b

    out, vjp = jax.vjp(f, [jnp.asarray(x) for x in parts], jax_p)
    d_parts, d_p = vjp(tuple(jnp.asarray(c) for c in cot))
    return out, d_parts, d_p


def _compare_grads(tparams, tparts, d_parts, d_p):
    for x, g in zip(tparts, d_parts):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=RTOL, atol=ATOL)
    for d in ("fwd", "bwd"):
        for n, j in _JAX_NAMES.items():
            want = np.asarray(d_p[d][j])
            got = tparams[d][n].grad.numpy()
            np.testing.assert_allclose(got, want.T if n.startswith("weight") else want,
                                       rtol=RTOL, atol=ATOL, err_msg=f"{d}.{n}")


@pytest.mark.parametrize("T", [9, 24])
@pytest.mark.parametrize("dims", [(10,), (6, 10)], ids=["parts1", "parts2"])
def test_trainpool_path_matches_jax(rng, dims, T):
    """Pooled + dropout train path: forward and every gradient."""
    B, H, seed = 3, 8, 0x1234ABCD
    jax_p, port_p = make_params(rng, sum(dims), H)
    parts = make_parts(rng, dims, T, B)
    To = -(-T // 2)
    cot = [rng.standard_normal((To, B, H)).astype(np.float32) for _ in range(2)]
    out, d_parts, d_p = _jax_vjp(jax_p, parts, cot, train=True, pool=2, pool_method="avg",
                                 drop_p=0.5, drop_seed=jnp.asarray([seed], jnp.uint32))

    tparams = _torch_leaves(port_p)
    tparts = [torch.from_numpy(x).requires_grad_() for x in parts]
    h_f, h_b, pooled = bigru_shared(tparams, tparts, train=True, pool=2, drop_p=0.5, seed=seed)
    assert pooled and h_f.shape == (To, B, H)
    assert h_f.grad_fn is not None and "TrainPoolCore" in type(h_f.grad_fn).__name__
    for g, w in zip((h_f, h_b), out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    torch.autograd.backward((h_f, h_b), [torch.from_numpy(c) for c in cot])
    _compare_grads(tparams, tparts, d_parts, d_p)


@pytest.mark.parametrize("T", [7, 16])
@pytest.mark.parametrize("dims", [(10,), (6, 10)], ids=["parts1", "parts2"])
def test_unpooled_train_core_matches_jax(rng, dims, T):
    B, H = 2, 8
    jax_p, port_p = make_params(rng, sum(dims), H)
    parts = make_parts(rng, dims, T, B)
    cot = [rng.standard_normal((T, B, H)).astype(np.float32) for _ in range(2)]
    out, d_parts, d_p = _jax_vjp(jax_p, parts, cot, train=True)

    tparams = _torch_leaves(port_p)
    tparts = [torch.from_numpy(x).requires_grad_() for x in parts]
    h_f, h_b, pooled = bigru_shared(tparams, tparts, train=True)
    assert not pooled and h_f.shape == (T, B, H)
    assert "TrainCore" in type(h_f.grad_fn).__name__
    for g, w in zip((h_f, h_b), out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    torch.autograd.backward((h_f, h_b), [torch.from_numpy(c) for c in cot])
    _compare_grads(tparams, tparts, d_parts, d_p)


@pytest.mark.parametrize("pool,method", [(2, "avg"), (2, "max"), (4, "avg")])
def test_pooled_eval_path_is_differentiable(rng, pool, method):
    """Eval with a fused pool, under grad: exact gradients (JAX's pooled core
    recomputes the forward), through the Function, never a detached result."""
    B, H, T, dims = 2, 8, 11, (6, 10)
    jax_p, port_p = make_params(rng, sum(dims), H)
    parts = make_parts(rng, dims, T, B)
    To = -(-T // pool)
    cot = [rng.standard_normal((To, B, H)).astype(np.float32) for _ in range(2)]
    out, d_parts, d_p = _jax_vjp(jax_p, parts, cot, pool=pool, pool_method=method)

    tparams = _torch_leaves(port_p)
    tparts = [torch.from_numpy(x).requires_grad_() for x in parts]
    h_f, h_b, pooled = bigru_shared(tparams, tparts, pool=pool, pool_method=method)
    assert pooled and "PooledEvalCore" in type(h_f.grad_fn).__name__
    for g, w in zip((h_f, h_b), out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    torch.autograd.backward((h_f, h_b), [torch.from_numpy(c) for c in cot])
    _compare_grads(tparams, tparts, d_parts, d_p)


@pytest.mark.parametrize("route,kwargs,fn", [
    ("eval_pooled", {"pool": 2}, _PooledEvalCore),
    ("eval_full", {}, _TrainCore),
    ("train_full", {"train": True}, _TrainCore),
    ("train_pooled", {"train": True, "pool": 2, "drop_p": 0.5, "seed": 7}, _TrainPoolCore),
])
def test_dispatch_goes_through_the_function_when_grad_is_needed(rng, monkeypatch, route, kwargs, fn):
    """Grad needed -> the autograd Function; no grad (inference_mode, no_grad,
    nothing requires grad) -> the forward wrapper alone."""
    _, port_p = make_params(rng, 10, 4)
    parts = [torch.from_numpy(x) for x in make_parts(rng, (10,), 6, 2)]
    calls = []
    real = fn.apply
    monkeypatch.setattr(fn, "apply", lambda *a: calls.append(1) or real(*a))
    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx():
            h_f = bigru_shared(_torch_leaves(port_p), parts, **kwargs)[0]
        assert h_f.grad_fn is None
    bigru_shared(port_p, parts, **kwargs)
    assert calls == []
    h_f = bigru_shared(_torch_leaves(port_p), parts, **kwargs)[0]
    assert calls == [1] and h_f.grad_fn is not None


@pytest.mark.parametrize("mode", ["plain", "fused"])
@pytest.mark.parametrize("dims", [(10,), (6, 10)], ids=["parts1", "parts2"])
def test_bwd_reference_matches_autograd_of_the_plain_forwards(rng, dims, mode):
    """K3's written-out formulas against torch autograd of the plain forward."""
    B, H, T, seed = 3, 8, 13, 99
    _, port_p = make_params(rng, sum(dims), H)
    tparams = _torch_leaves(port_p)
    tparts = [torch.from_numpy(x).requires_grad_() for x in make_parts(rng, dims, T, B)]
    if mode == "fused":
        hp_f, hp_b, o_f, o_b = bigru_trainpool_reference(tparams, tparts, pool=2, drop_p=0.3,
                                                         seed=seed)
        kw = {"pool": 2, "drop_p": 0.3, "seed": seed}
    else:
        o_f, o_b = bigru_shared_reference(tparams, tparts)
        hp_f, hp_b = ops._shift_hp(o_f, o_b)
        kw = {}
    cot = [torch.from_numpy(rng.standard_normal(o_f.shape).astype(np.float32)) for _ in range(2)]
    torch.autograd.backward((o_f, o_b), cot)
    with torch.no_grad():
        dxs, grads = bigru_shared_bwd_reference(port_p, [x.detach() for x in tparts],
                                                hp_f.detach(), hp_b.detach(), *cot, **kw)
    for x, g in zip(tparts, dxs):
        torch.testing.assert_close(g, x.grad, rtol=RTOL, atol=ATOL)
    for d in ("fwd", "bwd"):
        for n in grads[d]:
            torch.testing.assert_close(grads[d][n], tparams[d][n].grad, rtol=RTOL, atol=ATOL,
                                       msg=f"{d}.{n}")


# the shapes the GEMM core's tiles cut raggedly: T*B = 75 rows (not a multiple of 128),
# an input of 60 columns (the flagship's first layer), two parts of unequal width; and the
# flagship's first layer at its width, H = 128, the width the cluster chain runs at
@pytest.mark.parametrize("mode", ["plain", "fused"])
@pytest.mark.parametrize("dims,H", [((60,), 12), ((12, 20), 12), ((60,), 8), ((60,), 128)],
                         ids=["d60", "parts12_20", "d60_h8", "d60_h128"])
def test_bwd_reference_matches_jax_vjp_at_ragged_shapes(rng, dims, H, mode):
    """K3's plain version, which the card holds the kernel against, against
    ``jax.vjp`` of ``bigru_apply_shared(train=True)`` (the Pallas kernels in
    interpret mode) on the same forward residuals and cotangents."""
    T, B, seed = 25, 3, 0x5EED
    jax_p, port_p = make_params(rng, sum(dims), H)
    parts = make_parts(rng, dims, T, B)
    tparts = [torch.from_numpy(x) for x in parts]
    if mode == "fused":
        kw = {"pool": 2, "drop_p": 0.5, "seed": seed}
        jkw = {"pool": 2, "pool_method": "avg", "drop_p": 0.5, "drop_seed": jnp.asarray([seed], jnp.uint32)}
        hp_f, hp_b, o_f, _ = bigru_trainpool_reference(port_p, tparts, **kw)
    else:
        kw, jkw = {}, {}
        o_f, o_b = bigru_shared_reference(port_p, tparts)
        hp_f, hp_b = ops._shift_hp(o_f, o_b)
    cot = [rng.standard_normal(tuple(o_f.shape)).astype(np.float32) for _ in range(2)]
    _, d_parts, d_p = _jax_vjp(jax_p, parts, cot, train=True, **jkw)
    dxs, grads = bigru_shared_bwd_reference(port_p, tparts, hp_f, hp_b, *[torch.from_numpy(c) for c in cot],
                                            **kw)
    for g, want in zip(dxs, d_parts):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    for d in ("fwd", "bwd"):
        for n, j in _JAX_NAMES.items():
            want = np.asarray(d_p[d][j])
            np.testing.assert_allclose(grads[d][n].numpy(), want.T if n.startswith("weight") else want,
                                       rtol=RTOL, atol=ATOL, err_msg=f"{d}.{n}")


def test_trainpool_reference_hp_and_mask(rng):
    """hp is the previous-step h of each walk; the dropout zero pattern is the mask's."""
    _, port_p = make_params(rng, 6, 4)
    parts = [torch.from_numpy(x) for x in make_parts(rng, (6,), 5, 2)]
    h_f, h_b = bigru_shared_reference(port_p, parts)
    hp_f, hp_b, p_f, _ = bigru_trainpool_reference(port_p, parts, pool=1, drop_p=0.5, seed=3)
    torch.testing.assert_close(hp_f[1:], h_f[:-1], rtol=0, atol=0)
    torch.testing.assert_close(hp_b[:-1], h_b[1:], rtol=0, atol=0)
    assert not hp_f[0].any() and not hp_b[-1].any()
    keep = keep_mask(3, _DIR_SALT_F, 0, h_f.shape, keep_threshold(0.5))
    assert torch.equal(p_f != 0, keep)
    torch.testing.assert_close(p_f[keep], 2.0 * h_f[keep])


@pytest.mark.parametrize("kwargs", [{"drop_p": 1.0, "seed": 1}, {"drop_p": 0.5, "seed": -1},
                                    {"drop_p": 0.5, "seed": 2**32}])
def test_train_path_rejects_bad_dropout(rng, kwargs):
    _, port_p = make_params(rng, 6, 4)
    parts = [torch.from_numpy(x) for x in make_parts(rng, (6,), 5, 2)]
    with pytest.raises(ValueError):
        bigru_shared(port_p, parts, train=True, pool=2, **kwargs)
