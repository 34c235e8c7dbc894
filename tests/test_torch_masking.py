"""The port's length-exact path against the JAX package's, and against itself.

Masked pools and ``reverse_padded`` equal JAX's exactly; the plain masked
bi-GRU (K4f's plain version) matches JAX ``gru_apply_masked`` running the
Pallas K4f in interpret mode; ``encoder_features(lengths=)`` and
``predict_intents(lengths=/bucket=True)`` match JAX's ``predict_exact`` on
the small config; and inside the port every padded example equals its
exact-shape decode. Inputs are made from numpy seeds.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_config
from tpu_slu import ops as jops
from tpu_slu.models import encoder as jenc
from tpu_slu.models import slu as jslu
from tpu_slu_torch.models.convert import params_from_jax
from tpu_slu_torch.models.encoder import encoder_features, frames_through, zero_time_tail
from tpu_slu_torch.models.slu import Model, intent_logits
from tpu_slu_torch.ops.bigru_masked import bigru_masked, bigru_masked_reference
from tpu_slu_torch.ops.conv import masked_avg_pool1d_ceil, masked_max_pool1d_ceil
from tpu_slu_torch.ops.gru import gru_apply, gru_apply_masked, reverse_padded

RTOL, ATOL = 1e-4, 1e-5  # five GRU layers of f32 sums in another order
GRU_RTOL, GRU_ATOL = 1e-5, 1e-6  # one layer (tests/test_pallas_gru.py)
EXACT_ATOL = 1e-5  # padded vs exact shape inside the port (tests/test_masking.py)
MIXED_LENGTHS = (7200, 8000, 5111, 6400)  # tests/test_masking.py


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(config, JAX Model, port Model) sharing the JAX model's weights."""
    config = _make_config(str(tmp_path_factory.mktemp("small")), small=True)
    config.gru_impl = "pallas"
    jmodel = jslu.Model(config, seed=3)
    tmodel = Model(config)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)), strict=True)
    return config, jmodel, tmodel.eval()


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("TPU_SLU_PALLAS_INTERPRET", "1")


def padded_batch(rng, lengths, t_pad):
    waves = [(0.1 * rng.standard_normal(t)).astype(np.float32) for t in lengths]
    x = np.zeros((len(waves), t_pad), np.float32)
    for i, w in enumerate(waves):
        x[i, :len(w)] = w
    return waves, x


# ---------------------------------------------------------------------------
# Ops, exact against JAX
# ---------------------------------------------------------------------------

LENGTHS = [0, 1, 6, 7, 13]  # T = 13: empty, one frame, even, odd, full


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("pool", ["max", "avg"])
def test_masked_pools_match_jax(rng, pool, k):
    x = rng.standard_normal((len(LENGTHS), 4, 13)).astype(np.float32)
    n = np.array(LENGTHS)
    jfn = jops.masked_max_pool1d_ceil if pool == "max" else jops.masked_avg_pool1d_ceil
    tfn = masked_max_pool1d_ceil if pool == "max" else masked_avg_pool1d_ceil
    ref = np.asarray(jfn(jnp.asarray(x), k, jnp.asarray(n, jnp.int32)))
    got = tfn(torch.from_numpy(x), k, torch.from_numpy(n)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)
    if k > 1:  # n = 0: no window, output 0 (not -inf, not NaN); k = 1 is the identity
        assert (got[0] == 0).all()


def test_reverse_padded_and_zero_tail_match_jax(rng):
    from tpu_slu.ops.gru import reverse_padded as jreverse

    x = rng.standard_normal((len(LENGTHS), 13, 5)).astype(np.float32)
    n = np.array(LENGTHS)
    got = reverse_padded(torch.from_numpy(x), torch.from_numpy(n)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jreverse(jnp.asarray(x), jnp.asarray(n))))
    np.testing.assert_array_equal(got[3, :7], x[3, :7][::-1])
    for axis in (1, 2):
        xt = x if axis == 1 else x.transpose(0, 2, 1).copy()
        ref = np.asarray(jenc._zero_time_tail(jnp.asarray(xt), jnp.asarray(n), axis))
        np.testing.assert_array_equal(
            zero_time_tail(torch.from_numpy(xt), torch.from_numpy(n), axis).numpy(), ref)


def test_frame_counts_floor_as_jax(pair):
    """Length arithmetic on int64 tensors floors as JAX's on int32: a row of
    0 samples has 0 frames at the sinc layer ((0 + 400 - 401) // 80 + 1)."""
    _, jmodel, tmodel = pair
    t = np.array([0, 1, 9, 10, 31, 399, 401, 5111, 8000])
    for upto in ("phoneme", "word"):
        got = tmodel.encoder_arch.num_frames(torch.from_numpy(t), upto=upto).numpy()
        ref = np.asarray(jmodel.encoder_arch.num_frames(jnp.asarray(t, jnp.int32), upto=upto))
        np.testing.assert_array_equal(got, ref)
    sinc = tmodel.encoder_arch.phoneme_layers[0]
    flagship = sinc.__class__("sinc", 0, "sinc0", (80, 401, 16000, 80, 200))
    assert frames_through((flagship,), torch.tensor([0, 1, 80, 81])).tolist() == [0, 1, 1, 2]


# ---------------------------------------------------------------------------
# K4f's function: the plain masked bi-GRU against JAX's Pallas K4f (interpret)
# ---------------------------------------------------------------------------


def gru_params(rng, D, H):
    """(port params, JAX params) of one bi-GRU layer, equal values."""
    b = 1.0 / np.sqrt(H)
    tp, jp = {}, {}
    for d in ("fwd", "bwd"):
        w = {k: rng.uniform(-b, b, s).astype(np.float32) for k, s in
             (("weight_ih", (3 * H, D)), ("weight_hh", (3 * H, H)), ("bias_ih", (3 * H,)),
              ("bias_hh", (3 * H,)))}
        tp[d] = {k: torch.from_numpy(v) for k, v in w.items()}
        jp[d] = {"w_ih": jnp.asarray(w["weight_ih"].T), "w_hh": jnp.asarray(w["weight_hh"].T),
                 "b_ih": jnp.asarray(w["bias_ih"]), "b_hh": jnp.asarray(w["bias_hh"])}
    return tp, jp


@pytest.mark.parametrize("B,T,D,H,lengths", [
    (5, 13, 6, 8, [0, 1, 13, 7, 12]),
    (3, 1, 4, 12, [0, 1, 1]),
    (4, 30, 16, 16, [30, 29, 2, 0]),
])
def test_gru_apply_masked_matches_jax_pallas(interpret, rng, B, T, D, H, lengths):
    from tpu_slu.ops.gru import gru_apply_masked as jgru_apply_masked

    tp, jp = gru_params(rng, D, H)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    n = np.array(lengths)
    ref = np.asarray(jgru_apply_masked(jp, jnp.asarray(x), jnp.asarray(n, jnp.int32), impl="pallas"))
    got = gru_apply_masked(tp, torch.from_numpy(x), torch.from_numpy(n))
    assert got.shape == ref.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got.numpy(), ref, rtol=GRU_RTOL, atol=GRU_ATOL)
    for b, nb in enumerate(lengths):
        assert (got[b, nb:] == 0).all()
        if nb:  # each row is the layer on its example alone
            alone = gru_apply(tp, torch.from_numpy(x[b:b + 1, :nb]))[0]
            torch.testing.assert_close(got[b, :nb], alone, rtol=0, atol=1e-6)


def test_bigru_masked_on_cpu_is_the_plain_version(rng):
    tp, _ = gru_params(rng, 6, 8)
    x = torch.from_numpy(rng.standard_normal((3, 9, 6)).astype(np.float32))
    n = torch.tensor([9, 0, 4])
    before = bigru_masked.launches
    got = bigru_masked(tp, x, n)
    assert bigru_masked.launches == before  # counts kernel launches only
    assert torch.equal(got, bigru_masked_reference(tp, x, n))
    # autograd through and through on the CPU
    leaves = {d: {k: v.clone().requires_grad_() for k, v in tp[d].items()} for d in tp}
    bigru_masked(leaves, x, n).sum().backward()
    assert all(leaves[d][k].grad is not None for d in leaves for k in leaves[d])


# ---------------------------------------------------------------------------
# The slice against JAX's predict_exact
# ---------------------------------------------------------------------------


def test_encoder_features_lengths_match_jax(pair, interpret, rng):
    _, jmodel, tmodel = pair
    waves, x = padded_batch(rng, MIXED_LENGTHS, 8000)
    n = np.array(MIXED_LENGTHS)
    ref = np.asarray(jenc.encoder_features(
        jmodel.params["pretrained_model"], jmodel.encoder_arch, jnp.asarray(x), gru_impl="pallas",
        lengths=jnp.asarray(n, jnp.int32)))
    with torch.inference_mode():
        got = encoder_features(tmodel.pretrained_model, torch.from_numpy(x),
                               lengths=torch.from_numpy(n)).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        for i, w in enumerate(waves):  # inside the port: each row is its exact-shape run
            alone = encoder_features(tmodel.pretrained_model, torch.from_numpy(w[None])).numpy()[0]
            n_i = int(tmodel.encoder_arch.num_frames(len(w)))
            assert alone.shape[0] == n_i
            np.testing.assert_allclose(got[i, :n_i], alone, rtol=0, atol=EXACT_ATOL)
            np.testing.assert_array_equal(got[i, n_i:], 0.0)


def test_intent_logits_n_frames_match_jax(pair, interpret, rng):
    _, jmodel, tmodel = pair
    feats = rng.standard_normal((3, 9, tmodel.encoder_arch.word_feat_dim)).astype(np.float32)
    n = np.array([9, 4, 0])
    ref = jslu.intent_logits(jmodel.params["intent_layers"], jmodel.intent_arch, jnp.asarray(feats),
                             gru_impl="pallas", n_frames=jnp.asarray(n, jnp.int32))
    with torch.inference_mode():
        got = intent_logits(tmodel.intent_layers, tmodel.intent_arch, torch.from_numpy(feats),
                            n_frames=torch.from_numpy(n))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_predict_intents_lengths_match_jax_and_exact_shape(pair, interpret, rng):
    _, jmodel, tmodel = pair
    waves, x = padded_batch(rng, MIXED_LENGTHS, 8000)
    n = np.array(MIXED_LENGTHS)
    ref_logits, ref_preds = jmodel.predict_intents(x, lengths=n)
    logits, preds = tmodel.predict_intents(x, lengths=n)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(ref_preds))
    assert tmodel.decode_intents(x, lengths=n) == jmodel.decode_intents(x, lengths=n)
    for i, w in enumerate(waves):
        alone, alone_preds = tmodel.predict_intents(w)
        np.testing.assert_allclose(logits[i].numpy(), alone[0].numpy(), rtol=0, atol=EXACT_ATOL)
        assert torch.equal(preds[i], alone_preds[0])


def test_batch_fill_rows_stay_finite_and_leave_the_rest_alone(pair, rng):
    """Rows of length 0 (the server's batch fill) decode finite and change
    no other row."""
    tmodel = pair[2]
    waves, x = padded_batch(rng, (7200, 0, 5111, 0), 8000)
    logits, _ = tmodel.predict_intents(x, lengths=[7200, 0, 5111, 0])
    assert torch.isfinite(logits).all()
    two, _ = tmodel.predict_intents(x[[0, 2]], lengths=[7200, 5111])
    torch.testing.assert_close(logits[[0, 2]], two, rtol=0, atol=EXACT_ATOL)


@pytest.mark.parametrize("T", [7200, 8000, 3333])
def test_bucket_mode_matches_jax_and_exact_shape(pair, interpret, rng, T):
    _, jmodel, tmodel = pair
    w = (0.1 * rng.standard_normal(T)).astype(np.float32)
    ref, _ = jmodel.predict_intents(w, bucket=True)
    got, _ = tmodel.predict_intents(w, bucket=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    exact, _ = tmodel.predict_intents(w)
    torch.testing.assert_close(got, exact, rtol=0, atol=EXACT_ATOL)


def test_mask_padding_false_turns_the_exact_path_off(pair, interpret, rng, tmp_path):
    """Strict reference emulation: the padding leaks, as in JAX."""
    config, jmodel, tmodel = pair
    cfg = copy.copy(config)
    cfg.mask_padding = False
    jleak = jslu.Model(cfg, seed=3)
    tleak = Model(cfg).eval()
    tleak.load_state_dict(tmodel.state_dict())
    _, x = padded_batch(rng, (5111, 8000), 8000)
    n = np.array([5111, 8000])
    ref, _ = jleak.predict_intents(x, lengths=n)
    got, _ = tleak.predict_intents(x, lengths=n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    unmasked, _ = tleak.predict_intents(x)
    torch.testing.assert_close(got, unmasked, rtol=0, atol=0)
    exact, _ = tmodel.predict_intents(x, lengths=n)
    assert not torch.allclose(got[0], exact[0], rtol=0, atol=EXACT_ATOL)
