"""K1, the shared-stream bi-GRU layer of the PyTorch port, vs the JAX package.

On the CPU the port's wrapper runs its plain version; it is held against JAX
``bigru_apply_shared`` (the Pallas kernel in interpret mode on the CPU) and
against the scan GRU plus ``ops.downsample``, at rtol 1e-5 / atol 1e-6. The
CUDA kernel itself is held against the plain version on the card in
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slu import ops as jops
from tpu_slu.ops.pallas_gru import bigru_apply_shared
from tpu_slu_torch.ops.bigru_shared import bigru_shared

RTOL, ATOL = 1e-5, 1e-6
POOLS = [(1, "avg"), (2, "avg"), (2, "max")]


def make_params(rng, D, H):
    """The same seeded weights in the JAX layout (D, 3H) and the port's (3H, D)."""
    bound = 1.0 / np.sqrt(H)
    jax_p, port_p = {}, {}
    for d in ("fwd", "bwd"):
        w = {k: rng.uniform(-bound, bound, s).astype(np.float32)
             for k, s in (("w_ih", (D, 3 * H)), ("w_hh", (H, 3 * H)), ("b_ih", (3 * H,)), ("b_hh", (3 * H,)))}
        jax_p[d] = {k: jnp.asarray(v) for k, v in w.items()}
        port_p[d] = {"weight_ih": torch.from_numpy(w["w_ih"].T.copy()),
                     "weight_hh": torch.from_numpy(w["w_hh"].T.copy()),
                     "bias_ih": torch.from_numpy(w["b_ih"]), "bias_hh": torch.from_numpy(w["b_hh"])}
    return jax_p, port_p


def make_parts(rng, dims, T, B):
    return [rng.standard_normal((T, B, d)).astype(np.float32) for d in dims]


@pytest.mark.parametrize("T", [5, 21, 32, 65])
@pytest.mark.parametrize("pool,method", POOLS)
@pytest.mark.parametrize("dims", [(10,), (6, 10)], ids=["parts1", "parts2"])
def test_plain_k1_matches_jax(rng, dims, pool, method, T):
    B, H = 3, 8
    jax_p, port_p = make_params(rng, sum(dims), H)
    parts = make_parts(rng, dims, T, B)
    before = bigru_shared.launches
    h_f, h_b, pooled = bigru_shared(port_p, [torch.from_numpy(p) for p in parts],
                                    pool=pool, pool_method=method)
    assert bigru_shared.launches == before  # CPU tensors never launch the kernel
    assert pooled == (pool > 1)
    To = -(-T // pool)
    assert h_f.shape == h_b.shape == (To, B, H)
    got = torch.cat([h_f, h_b], dim=-1).transpose(0, 1).numpy()  # (B, To, 2H)

    # the Pallas kernel, in interpret mode on the CPU
    k_f, k_b, k_pooled = bigru_apply_shared(jax_p, tuple(jnp.asarray(p) for p in parts),
                                            pool=pool, pool_method=method)
    assert k_pooled == (pool > 1)
    pallas = np.swapaxes(np.concatenate([np.asarray(k_f), np.asarray(k_b)], -1), 0, 1)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)

    # the scan GRU over the concatenated stream, then the downsample
    x_btc = jnp.swapaxes(jnp.concatenate([jnp.asarray(p) for p in parts], -1), 0, 1)
    scan = jops.gru_apply(jax_p, x_btc, impl="scan")
    if pool > 1:
        scan = jops.downsample(scan, method, pool, time_axis=1)
    np.testing.assert_allclose(got, np.asarray(scan), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kwargs,err", [
    ({"n_parts": 3}, ValueError),
    ({"pool": 0}, ValueError),
    ({"pool_method": "none"}, ValueError),
])
def test_wrapper_rejects_bad_arguments(rng, kwargs, err):
    _, port_p = make_params(rng, 12, 4)
    n_parts = kwargs.pop("n_parts", 2)
    parts = [torch.from_numpy(p) for p in make_parts(rng, [12 // n_parts] * n_parts, 7, 2)]
    with pytest.raises(err):
        bigru_shared(port_p, parts, **kwargs)
