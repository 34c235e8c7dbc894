"""The bf16 GEMM core's plain versions against JAX's bf16 matrix product.

At ``compute_dtype=bfloat16`` the TPU kernels compute gi, gh and dX as
``jnp.dot(a.astype(bf16), b.astype(bf16), preferred_element_type=f32)``
(``tpu_slu/ops/pallas_gru.py`` ``_mxu``), dX rounded to bf16 in each
direction and the two directions summed by XLA in bf16
(``pallas_gru.py:1433-1436``, ``:1536``). The port runs them on the tensor
cores (``csrc/bigru_gemm.cuh`` ``gemm_kernel_tc``); its plain versions in
``tpu_slu_torch/ops/bigru_gemm.py``, which the wrappers run on CPU tensors,
are held here against that product on the same numpy inputs, at the
flagship's widths (K = 60, 120 = 60 | 60, 128, 256 = 128 | 128; N = 384) and
at rows that are no multiple of a tile.

Bounds, from K: a plain f32 output lies within (K + 2) u sum_k |a_k b_k| of
JAX's, u = 2^-24, the first-order bound of JAX's K-term f32 sum and the
final rounding (the plain version sums in f64). A bf16 dX element lies
within one bf16 spacing of each rounded value it went through (2^-7 of
each direction's product and of their sum) of JAX's, and at least 99% of
the elements are equal: a plain version that rounded once, after the sum,
differs from JAX's in about a third of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slu_torch.ops.bigru_gemm import (gemm_dx_bf16, gemm_dx_bf16_reference, gemm_proj_bf16,
                                          gemm_proj_bf16_reference, gemm_proj_rs_bf16,
                                          gemm_proj_rs_bf16_reference)

U = 2.0**-24
JBF = jnp.bfloat16


def _jdot(a, b):
    """JAX's bf16 product with f32 accumulation, as the TPU kernel's ``_mxu``."""
    return np.asarray(jnp.dot(jnp.asarray(a).astype(JBF), jnp.asarray(b).astype(JBF),
                              preferred_element_type=jnp.float32), np.float64)


def _bf(a):
    """a rounded to bf16, back in f64 (exact)."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(JBF), np.float64)


def _inputs(rng, M, dims, N):
    parts = [rng.standard_normal((M, d)).astype(np.float32) for d in dims]
    w = rng.uniform(-0.1, 0.1, (N, sum(dims))).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, N).astype(np.float32)
    return parts, w, b


def _torch_parts(parts):
    # the parts reach the port as bf16 streams
    return [torch.from_numpy(p).to(torch.bfloat16) for p in parts]


@pytest.mark.parametrize("M,dims", [(1600, (60,)), (75, (60, 60)), (1601, (128,)), (200, (128, 128)),
                                    (77, (12, 20))])
@pytest.mark.parametrize("bias", [True, False])
def test_gemm_proj_bf16_plain_matches_jax(M, dims, bias):
    """gi = [x1 | x2] W_ih^T + b (and gh = h_prev W_hh^T + b) at bf16: the
    plain version, also through the wrapper on CPU tensors, against JAX."""
    rng = np.random.default_rng(M + sum(dims))
    parts, w, b = _inputs(rng, M, dims, 384 if M > 100 else 36)
    K = sum(dims)
    x = np.concatenate(parts, 1)
    want = _jdot(x, w.T) + (b if bias else 0.0)
    scale = np.abs(_bf(x)) @ np.abs(_bf(w)).T + (np.abs(b) if bias else 0.0)
    tp = _torch_parts(parts)
    args = (tp[0], tp[1] if len(tp) > 1 else None, torch.from_numpy(w), torch.from_numpy(b) if bias else None)
    got = gemm_proj_bf16_reference(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = np.abs(got.double().numpy() - want)
    assert (err <= (K + 2) * U * scale).all(), (err / np.maximum(scale, 1e-30)).max()
    assert torch.equal(gemm_proj_bf16(*args), got)


@pytest.mark.parametrize("T,B,dims", [(25, 3, (60,)), (7, 16, (128, 128))])
def test_gemm_proj_rs_bf16_plain_matches_jax(T, B, dims):
    """K6's row-stacked gi at bf16: row (t, dir B + b) the direction's
    product of input row (s, b), s = t forward and T - 1 - t backward, plus
    b_ih and b_hh's r and z columns."""
    rng = np.random.default_rng(T * B)
    N = 384
    parts, _, _ = _inputs(rng, T * B, dims, N)
    x = np.concatenate(parts, 1)
    K = x.shape[1]
    ws = [rng.uniform(-0.1, 0.1, (N, K)).astype(np.float32) for _ in range(2)]
    bs = [rng.uniform(-0.1, 0.1, N).astype(np.float32) for _ in range(2)]
    folds = [rng.uniform(-0.1, 0.1, N).astype(np.float32) for _ in range(2)]
    want = np.empty((T, 2 * B, N))
    scale = np.empty((T, 2 * B, N))
    for d in range(2):
        fold = np.where(np.arange(N) < 2 * N // 3, folds[d], 0.0)
        g = (_jdot(x, ws[d].T) + bs[d] + fold).reshape(T, B, N)
        s = (np.abs(_bf(x)) @ np.abs(_bf(ws[d])).T + np.abs(bs[d]) + np.abs(fold)).reshape(T, B, N)
        want[:, d * B:(d + 1) * B] = g[::-1] if d else g
        scale[:, d * B:(d + 1) * B] = s[::-1] if d else s
    tp = _torch_parts(parts)
    args = (tp[0], tp[1] if len(tp) > 1 else None, [torch.from_numpy(w) for w in ws],
            [torch.from_numpy(b) for b in bs], [torch.from_numpy(f) for f in folds], T, B)
    got = gemm_proj_rs_bf16_reference(*args)
    err = np.abs(got.double().numpy() - want)
    assert (err <= (K + 4) * U * scale).all(), (err / np.maximum(scale, 1e-30)).max()
    assert torch.equal(gemm_proj_rs_bf16(*args), got)


@pytest.mark.parametrize("ndir,M,K,dims", [(2, 1600, 384, (256,)), (2, 301, 384, (60,)), (1, 1601, 384, (60,)),
                                           (2, 75, 36, (12, 20)), (1, 200, 384, (128,))])
def test_gemm_dx_bf16_plain_matches_jax(ndir, M, K, dims):
    """dX at bf16: each direction's dgi W_ih rounded to bf16, the two
    directions' sum rounded again, as the TPU kernel and XLA round them."""
    rng = np.random.default_rng(M + K + ndir)
    D = sum(dims)
    a = rng.standard_normal((ndir, M, K)).astype(np.float32)
    ws = [rng.uniform(-0.1, 0.1, (K, D)).astype(np.float32) for _ in range(ndir)]
    per_dir = [jnp.asarray(_jdot(a[i], ws[i]), jnp.float32).astype(JBF) for i in range(ndir)]
    want = per_dir[0] if ndir == 1 else per_dir[0] + per_dir[1]  # XLA's bf16 sum
    want = np.asarray(want, np.float64)
    exact = [_bf(a[i]) @ _bf(ws[i]) for i in range(ndir)]
    scale = sum(np.abs(_bf(a[i])) @ np.abs(_bf(ws[i])) for i in range(ndir))
    bound = 2.0**-7 * (sum(np.abs(p) for p in exact) + (np.abs(sum(exact)) if ndir == 2 else 0.0)) \
        + (K + 2) * U * scale
    got = gemm_dx_bf16_reference(torch.from_numpy(a), [torch.from_numpy(w) for w in ws], dims[0])
    assert all(g.dtype == torch.bfloat16 for g in got)
    cat = torch.cat(got, 1).double().numpy()
    assert cat.shape == want.shape
    assert (np.abs(cat - want) <= bound).all()
    assert (cat == want).mean() >= 0.99, (cat == want).mean()
    again = gemm_dx_bf16(torch.from_numpy(a), [torch.from_numpy(w) for w in ws], dims[0])
    assert all(torch.equal(x, y) for x, y in zip(again, got))
