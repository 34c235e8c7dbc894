"""K6, the row-stacked layout of the shared-stream bi-GRU, vs the JAX package.

On the CPU the port's wrapper runs K6's plain version, which lays the gates
out as K6 does (both directions in one (T, 2B, 3H) array, the backward rows
pre-reversed, b_hh's r and z columns folded into b_ih); it is held against
JAX ``bigru_apply_shared`` with ``TPU_SLU_GRU_ROWSTACK=1`` (the Pallas kernel
``_mk_shared_fwd_kernel_rs`` in interpret mode; a spy proves it ran), and a
whole small fixed-slot decode through every pair of routes (K8 or the
composed front end, K6 or K1) against JAX's decode with the matching
flags. The CUDA kernel is held against the plain version on the card in
``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_config
from tests.test_torch_bigru_shared import make_params, make_parts
from tpu_slu.models import slu as jslu
from tpu_slu.ops import pallas_frontend, pallas_gru
from tpu_slu.ops.pallas_gru import bigru_apply_shared
from tpu_slu_torch.models import encoder as tenc
from tpu_slu_torch.models.convert import params_from_jax
from tpu_slu_torch.models.slu import Model
from tpu_slu_torch.ops import bigru_shared as tbs
from tpu_slu_torch.ops.bigru_shared import bigru_shared, bigru_shared_reference, bigru_shared_rowstack_reference

RTOL, ATOL = 1e-5, 1e-6
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-5  # five GRU layers of f32 sums in another order
POOLS = [(1, "avg"), (2, "avg"), (2, "max")]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("TPU_SLU_PALLAS_INTERPRET", "1")


def spy_on(monkeypatch, module, name) -> list:
    """Count the calls of ``module.name`` (looked up at call time)."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("T", [32, 35])  # 35: JAX pads to its time block and holds the backward carry
@pytest.mark.parametrize("pool,method", POOLS)
@pytest.mark.parametrize("dims", [(10,), (4, 6)], ids=["parts1", "parts2"])
def test_plain_k6_matches_jax(interpret, monkeypatch, rng, dims, pool, method, T):
    B, H = 4, 8
    jax_p, port_p = make_params(rng, sum(dims), H)
    parts = make_parts(rng, dims, T, B)
    monkeypatch.setenv("TPU_SLU_GRU_ROWSTACK", "1")
    k6_builds = spy_on(monkeypatch, pallas_gru, "_mk_shared_fwd_kernel_rs")
    k_f, k_b, k_pooled = bigru_apply_shared(jax_p, tuple(jnp.asarray(p) for p in parts),
                                            pool=pool, pool_method=method)  # eager, not under a jit
    assert k6_builds, "the JAX side did not run its row-stacked kernel"
    before = bigru_shared.launches, bigru_shared.launches_rowstack
    h_f, h_b, pooled = bigru_shared(port_p, [torch.from_numpy(p) for p in parts], pool=pool,
                                    pool_method=method, layout="rowstack")
    assert (bigru_shared.launches, bigru_shared.launches_rowstack) == before  # CPU: no launch
    assert pooled == k_pooled == (pool > 1)
    assert h_f.shape == h_b.shape == (-(-T // pool), B, H)
    np.testing.assert_allclose(h_f.numpy(), np.asarray(k_f), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(h_b.numpy(), np.asarray(k_b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("T", [1, 17])
@pytest.mark.parametrize("pool,method", POOLS)
def test_plain_k6_matches_plain_k1(rng, pool, method, T):
    """The two layouts compute one function: K6's plain version against K1's."""
    _, port_p = make_params(rng, 12, 8)
    parts = [torch.from_numpy(p) for p in make_parts(rng, (12,), T, 3)]
    got = bigru_shared_rowstack_reference(port_p, parts, pool=pool, pool_method=method)
    ref = bigru_shared_reference(port_p, parts, pool=pool, pool_method=method)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pool", [1, 2])
def test_k6_layout_under_autograd(rng, pool):
    """The train core's unpooled forward and the pooled eval path take the
    layout; their backward (K3's function) gives K1's gradients."""
    _, port_p = make_params(rng, 10, 8)
    x = torch.from_numpy(make_parts(rng, (10,), 9, 2)[0])
    grads = {}
    for layout in tbs.LAYOUTS:
        params = {d: {k: v.clone().requires_grad_() for k, v in p.items()} for d, p in port_p.items()}
        xg = x.clone().requires_grad_()
        h_f, h_b, _ = bigru_shared(params, [xg], train=pool == 1, pool=pool, layout=layout)
        (h_f.square().sum() + (2.0 * h_b).sum()).backward()
        grads[layout] = [xg.grad] + [params[d][k].grad for d in params for k in params[d]]
    for g, r in zip(grads["rowstack"], grads["split"]):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


def test_k6_rejects_an_unknown_layout(rng):
    _, port_p = make_params(rng, 10, 8)
    with pytest.raises(ValueError):
        bigru_shared(port_p, [torch.zeros(3, 2, 10)], layout="stacked")


@pytest.mark.parametrize("gru_layout", tbs.LAYOUTS)
@pytest.mark.parametrize("frontend", tenc.FRONTENDS)
def test_small_decode_through_each_route_matches_jax(tmp_path, interpret, monkeypatch, rng, frontend,
                                                     gru_layout):
    """A whole fixed-slot decode (front end, five bi-GRU layers, the head)
    with the port's routes set against JAX's decode with the matching
    flags; the JAX model is built after the flags are set, so its jitted
    decode traces the kernels they select."""
    fused, rowstack = frontend == "fused", gru_layout == "rowstack"
    if fused:
        monkeypatch.setenv("TPU_SLU_FUSED_FRONTEND", "1")
    if rowstack:
        monkeypatch.setenv("TPU_SLU_GRU_ROWSTACK", "1")
    k8_builds = spy_on(monkeypatch, pallas_frontend, "_mk_kernel")
    k6_builds = spy_on(monkeypatch, pallas_gru, "_mk_shared_fwd_kernel_rs")
    config = _make_config(str(tmp_path), small=True)
    config.gru_impl = "pallas"
    jmodel = jslu.Model(config, seed=3)
    tmodel = Model(config, frontend=frontend, gru_layout=gru_layout)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)), strict=True)
    tmodel.eval()
    x = rng.standard_normal((3, 4000)).astype(np.float32)
    ref_logits, ref_preds = jmodel.predict_intents(x)
    assert (len(k8_builds) > 0, len(k6_builds) > 0) == (fused, rowstack)
    port_k8 = spy_on(monkeypatch, tenc, "sinc_frontend_fused")
    port_k6 = spy_on(monkeypatch, tbs, "bigru_shared_rowstack_reference")
    with torch.inference_mode():
        logits, preds = tmodel.predict_intents(x)
    assert (len(port_k8), len(port_k6)) == (int(fused), 5 * rowstack)  # 5 bi-GRU layers a decode
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=SLICE_RTOL, atol=SLICE_ATOL)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(ref_preds))
