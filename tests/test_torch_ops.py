"""PyTorch port ops (``tpu_slu_torch.ops``, ``tpu_slu_torch.data``) vs their JAX twins.

The same seeded numpy inputs go through both; float32 on the CPU, compared
at rtol 1e-5 / atol 1e-6 (the two frameworks sum in different orders).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slu import ops as jops
from tpu_slu.data.audio import read_wav as jax_read_wav
from tpu_slu.ops import sinc as jsinc
from tpu_slu_torch.data.audio import read_wav
from tpu_slu_torch.ops import conv, gru, sinc

RTOL, ATOL = 1e-5, 1e-6
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "golden")


def close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n_filt,filt_dim", [(16, 31), (80, 401)])
def test_sinc_filters(rng, n_filt, filt_dim):
    b1, band = sinc.mel_init(n_filt, 16000)
    jb1, jband = jsinc.mel_init(n_filt, 16000)
    np.testing.assert_array_equal(b1, jb1)
    np.testing.assert_array_equal(band, jband)
    # perturbed away from the init, as after training
    b1 = (b1 * (1 + 0.1 * rng.standard_normal(n_filt))).astype(np.float32)
    band = (band * (1 + 0.1 * rng.standard_normal(n_filt))).astype(np.float32)
    got = sinc.sinc_filters(torch.from_numpy(b1), torch.from_numpy(band), filt_dim, 16000)
    ref = jsinc.sinc_filters(jnp.asarray(b1), jnp.asarray(band), filt_dim, 16000)
    close(got, ref)


def test_sinc_conv(rng):
    b1, band = sinc.mel_init(16, 16000)
    x = rng.standard_normal((2, 1, 1003)).astype(np.float32)
    got = sinc.sinc_conv(torch.from_numpy(b1), torch.from_numpy(band), torch.from_numpy(x),
                         31, 16000, 10, 15)
    ref = jsinc.sinc_conv(jnp.asarray(b1), jnp.asarray(band), jnp.asarray(x), 31, 16000, 10, 15)
    assert got.shape == ref.shape
    close(got, ref, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv1d(rng, stride):
    x = rng.standard_normal((2, 6, 37)).astype(np.float32)
    w = rng.standard_normal((5, 6, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    got = conv.conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                      stride=stride, padding=2)
    ref = jops.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride, padding=2)
    assert got.shape == ref.shape
    close(got, ref, atol=1e-5)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("pool", ["max", "avg"])
def test_ceil_pools_odd_t(rng, pool, k):
    x = rng.standard_normal((2, 3, 21)).astype(np.float32)
    fn, jfn = ((conv.max_pool1d_ceil, jops.max_pool1d_ceil) if pool == "max"
               else (conv.avg_pool1d_ceil, jops.avg_pool1d_ceil))
    got = fn(torch.from_numpy(x), k)
    ref = jfn(jnp.asarray(x), k)
    assert got.shape == ref.shape == (2, 3, -(-21 // k))
    close(got, ref)


@pytest.mark.parametrize("method", ["none", "avg", "max"])
@pytest.mark.parametrize("time_axis", [0, 1])
def test_downsample(rng, method, time_axis):
    x = rng.standard_normal((3, 21, 4) if time_axis == 1 else (21, 3, 4)).astype(np.float32)
    got = conv.downsample(torch.from_numpy(x), method, 2, time_axis=time_axis)
    ref = jops.downsample(jnp.asarray(x), method, 2, time_axis=time_axis)
    assert got.shape == ref.shape
    close(got, ref)


def test_leaky_relu(rng):
    x = rng.standard_normal((4, 9)).astype(np.float32)
    close(conv.leaky_relu(torch.from_numpy(x), 0.2), jops.leaky_relu(jnp.asarray(x), 0.2))


def test_gru_apply_matches_scan(rng):
    B, T, D, H = 3, 11, 5, 4
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    jp = jops.gru_init(jax.random.PRNGKey(0), D, H, bidirectional=True)
    tp = {d: {"weight_ih": torch.tensor(np.asarray(jp[d]["w_ih"]).T),
              "weight_hh": torch.tensor(np.asarray(jp[d]["w_hh"]).T),
              "bias_ih": torch.tensor(np.asarray(jp[d]["b_ih"])),
              "bias_hh": torch.tensor(np.asarray(jp[d]["b_hh"]))} for d in ("fwd", "bwd")}
    got = gru.gru_apply(tp, torch.from_numpy(x))
    ref = jops.gru_apply(jp, jnp.asarray(x), impl="scan")
    assert got.shape == ref.shape == (B, T, 2 * H)
    close(got, ref)


def _golden_wavs():
    with open(os.path.join(GOLDEN, "expected.json")) as f:
        return [c["wav"] for c in json.load(f)["expected"]]


@pytest.mark.parametrize("wav", _golden_wavs())
def test_read_wav_matches_jax(wav):
    path = os.path.join(GOLDEN, wav)
    got, fs = read_wav(path)
    ref, ref_fs = jax_read_wav(path)
    assert fs == ref_fs == 16000
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
