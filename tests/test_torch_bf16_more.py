"""``compute_dtype=bfloat16`` for the seq2seq encoder, the unidirectional
layers and the row-stacked layout, against the JAX package's Pallas kernels.

The port runs K4f/K4b (the seq2seq encoder layer), K5f/K5b (every
unidirectional layer) and K6 (``gru_layout="rowstack"``) on bf16 streams:
here their plain versions, in the same autograd Functions the card runs with
the kernels. JAX's contract is that of its Pallas kernels at bf16
(``_fused_fwd_kernel``/``_fused_bwd_kernel``, ``_fused1_*``,
``_mk_shared_fwd_kernel_rs`` under ``TPU_SLU_GRU_ROWSTACK=1``), run in
interpret mode on the CPU. Each output and gradient is held to
``assert_bf16``'s two bounds (``tests/test_torch_bf16.py``): within a
quarter of JAX's own bf16-vs-f32 distance of JAX's bf16 result, and within
4 bf16 ulps of its largest element.

Measured here: every layer's output and dX equal JAX's bit for bit, and
its weight gradients lie 0 to 1.8e-7 from JAX's (f32 sums in another
order, against gaps of 0.85e-3 to 4.3e-3; ratios at most 1.2e-4). The model-level ratios are in the
tests' docstrings. As in ``test_torch_bf16.py``, the model tests run the
port's first GRU layer forward on JAX's front-end values (f32 values 4e-7
apart round to another bf16 at the first cast and spread through the bf16
recurrences); the inputs are made with numpy from seeds.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16 import _JAX_NAMES, _jax_layer, _np, _small_config, assert_bf16
from tests.test_torch_bigru_shared import make_params, make_parts
from tests.test_torch_seq2seq import small_seq2seq_config
from tpu_slu import ops as jops
from tpu_slu.models import encoder as jenc
from tpu_slu.models import slu as jslu
from tpu_slu.ops import conv as jconv
from tpu_slu_torch.models import encoder as tenc
from tpu_slu_torch.models.convert import params_from_jax
from tpu_slu_torch.models.encoder import PretrainedModel, dropout, encoder_loss
from tpu_slu_torch.models.slu import Model
from tpu_slu_torch.ops import conv as tconv
from tpu_slu_torch.ops.bigru_masked import _MaskedCore, bigru_masked, bigru_masked_bwd
from tpu_slu_torch.ops.bigru_shared import _PooledEvalCore, _TrainCore, bigru_shared
from tpu_slu_torch.ops.gru1 import _Gru1Core, gru1, gru1_bwd
from tpu_slu_torch.training import Trainer

BF16 = torch.bfloat16
UNI = {"phone_rnn_bidirectional": False, "word_rnn_bidirectional": False, "intent_rnn_bidirectional": False}
# unidirectional phone and intent layers around bidirectional word layers: bf16 handed uni -> bi -> uni
MIXED = {"phone_rnn_bidirectional": False, "intent_rnn_bidirectional": False}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("TPU_SLU_PALLAS_INTERPRET", "1")


def _grads_of(tp: dict, dirs) -> dict:
    """The port's weight gradients in JAX's layout, keyed as JAX's params."""
    return {d: {j: (tp[d][n].grad.numpy().T if n.startswith("weight") else tp[d][n].grad.numpy())
                for n, j in _JAX_NAMES.items()} for d in dirs}


# ---------------------------------------------------------------------------
# One layer: K4 and K5 (masked and not), K6, through the autograd Functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lengths", [None, (9, 4, 0)], ids=["exact", "lengths"])
@pytest.mark.parametrize("kernels", ["k4", "k5"])
def test_masked_layer_matches_jax_pallas_at_bf16(interpret, rng, kernels, lengths):
    """K4 (``{fwd, bwd}`` params) as JAX ``gru_apply`` (every row T: the
    seq2seq encoder's train route) and ``gru_apply_masked`` (lengths, a zero
    length among them), K5 (``{fwd}``) the same, at T = 9, B = 3, H = 8:
    the output, dX and every weight and bias gradient against JAX's Pallas
    kernels at bf16 (``_fused_fwd_kernel``/``_fused_bwd_kernel``, or
    ``_fused1_*``). bf16 output and dX, f32 weight gradients, one pass
    through the layer's autograd Function."""
    B, T, D, H = 3, 9, 10, 8
    jp, pp = make_params(rng, D, H)
    dirs = ("fwd", "bwd") if kernels == "k4" else ("fwd",)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    cot = rng.standard_normal((B, T, len(dirs) * H)).astype(np.float32)
    jpd = {d: jp[d] for d in dirs}
    n = None if lengths is None else np.array(lengths)

    def jf(p, xx):
        if n is None:
            return jops.gru_apply(p, xx, impl="pallas")
        return jops.gru_apply_masked(p, xx, jnp.asarray(n), impl="pallas")

    want = {}
    for dt in (jnp.bfloat16, jnp.float32):
        out, vjp = jax.vjp(jf, jpd, jnp.asarray(x, dt))
        want[dt] = (out, *vjp(jnp.asarray(cot, dt))[::-1])

    tp = {d: {k: v.clone().requires_grad_() for k, v in pp[d].items()} for d in dirs}
    tx = torch.from_numpy(x).to(BF16).requires_grad_()
    tn = torch.full((B,), T) if n is None else torch.from_numpy(n)
    if kernels == "k4":
        out, function = bigru_masked(tp, tx, tn), _MaskedCore
    else:
        out, function = gru1(tp, tx, None if n is None else tn), _Gru1Core
    assert type(out.grad_fn).__name__.startswith(function.__name__)
    assert out.dtype == BF16 and out.shape == (B, T, len(dirs) * H)
    out.backward(torch.from_numpy(cot).to(BF16))
    assert tx.grad.dtype == BF16
    (o16, dx16, dp16), (o32, dx32, dp32) = want[jnp.bfloat16], want[jnp.float32]
    assert_bf16(_np(out), _np(o16), _np(o32), "output")
    assert_bf16(_np(tx.grad), _np(dx16), _np(dx32), "dx")
    if n is not None:
        for b, nb in enumerate(lengths):
            assert not out[b, nb:].any() and not tx.grad[b, nb:].any()
    got = _grads_of(tp, dirs)
    for d in dirs:
        for j in _JAX_NAMES.values():
            assert tp[d]["weight_ih"].grad.dtype == torch.float32
            assert_bf16(got[d][j], _np(dp16[d][j]), _np(dp32[d][j]), f"{d}.{j}")


def test_masked_wrappers_take_bf16_streams_and_return_f32_weight_gradients(rng):
    """The K4b and K5b wrappers' dtype contract on the CPU (their plain
    versions): bf16 x, out and dy in; bf16 dX and f32 gradients out; no
    launch counted."""
    B, T, D, H = 2, 7, 6, 8
    _, pp = make_params(rng, D, H)
    x = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32)).to(BF16)
    n = torch.tensor([7, 3])
    counts = (bigru_masked_bwd.launches, gru1_bwd.launches, bigru_masked_bwd.launches_bf16,
              gru1_bwd.launches_bf16)
    for params, fwd, bwd in ((pp, bigru_masked, bigru_masked_bwd), ({"fwd": pp["fwd"]}, gru1, gru1_bwd)):
        with torch.no_grad():
            out = fwd(params, x, n)
        assert out.dtype == BF16
        dx, grads = bwd(params, x, out, n, torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(BF16))
        assert dx.dtype == BF16 and dx.shape == x.shape
        assert all(g.dtype == torch.float32 for gd in grads.values() for g in gd.values())
    assert (bigru_masked_bwd.launches, gru1_bwd.launches, bigru_masked_bwd.launches_bf16,
            gru1_bwd.launches_bf16) == counts


K6_ROUTES = {  # name: (the port's bigru_shared kwargs, its Function)
    "k6_pool_avg": ({"pool": 2, "pool_method": "avg"}, _PooledEvalCore),
    "k6_pool_max": ({"pool": 2, "pool_method": "max"}, _PooledEvalCore),
    "k6_unpooled": ({"train": True}, _TrainCore),
}


@pytest.mark.parametrize("route", sorted(K6_ROUTES))
@pytest.mark.parametrize("dims", [(10,), (6, 10)], ids=["parts1", "parts2"])
def test_k6_matches_jax_pallas_at_bf16(interpret, monkeypatch, rng, dims, route):
    """K6 (``layout="rowstack"``) at T = 9, B = 3, H = 8 against JAX's
    ``_mk_shared_fwd_kernel_rs`` (``TPU_SLU_GRU_ROWSTACK=1``) at bf16: the
    pooled eval routes' outputs; the unpooled train route's outputs, dX and
    eight weight and bias gradients (K6 forward, K3 backward). bf16 streams,
    f32 weight gradients."""
    monkeypatch.setenv("TPU_SLU_GRU_ROWSTACK", "1")
    kw, function = K6_ROUTES[route]
    T, B, H = 9, 3, 8
    jax_p, port_p = make_params(rng, sum(dims), H)
    parts = make_parts(rng, dims, T, B)
    To = T if "pool" not in kw else -(-T // 2)
    cot = [rng.standard_normal((To, B, H)).astype(np.float32) for _ in range(2)]
    out16, dparts16, dp16 = _jax_layer(jax_p, parts, cot, jnp.bfloat16, kw)
    out32, dparts32, dp32 = _jax_layer(jax_p, parts, cot, jnp.float32, kw)

    tparams = {d: {n: t.clone().requires_grad_() for n, t in port_p[d].items()} for d in port_p}
    tparts = [torch.from_numpy(x).to(BF16).requires_grad_() for x in parts]
    launches = (bigru_shared.launches_rowstack, bigru_shared.launches_bf16)
    h_f, h_b, _ = bigru_shared(tparams, tparts, layout="rowstack", **kw)
    assert (bigru_shared.launches_rowstack, bigru_shared.launches_bf16) == launches  # plain versions
    assert type(h_f.grad_fn).__name__.startswith(function.__name__)
    assert h_f.dtype == h_b.dtype == BF16 and h_f.shape == (To, B, H)
    torch.autograd.backward((h_f, h_b), [torch.from_numpy(c).to(BF16) for c in cot])
    for i, h in enumerate((h_f, h_b)):
        assert_bf16(_np(h), _np(out16[i]), _np(out32[i]), f"output {i}")
    for i, x in enumerate(tparts):
        assert x.grad.dtype == BF16 and torch.isfinite(x.grad.float()).all()
        if dparts16 is not None:
            assert_bf16(_np(x.grad), _np(dparts16[i]), _np(dparts32[i]), f"dx {i}")
    if dp16 is not None:
        got = _grads_of(tparams, ("fwd", "bwd"))
        for d in got:
            for j, g in got[d].items():
                assert_bf16(g, _np(dp16[d][j]), _np(dp32[d][j]), f"{d}.{j}")


@pytest.mark.parametrize("k", [2, 3, 4])
def test_bf16_pools_and_dropout_round_as_jax(rng, k):
    """The ops after a unidirectional layer act on its bf16 output as XLA's
    do: the ceil avg pool (plain and masked) sums a window's bf16 values
    with a rounding after each add, as ``reduce_window`` does (torch's
    ``avg_pool1d`` rounds once: another result for k > 2), then divides;
    dropout divides by the keep rate rounded to bf16, as JAX's weakly
    typed ``x / keep_p`` does."""
    x = rng.standard_normal((3, 16, 37)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(BF16)
    n = np.array([37, 20, 0])
    got = tconv.avg_pool1d_ceil(xt, k)
    assert got.dtype == BF16
    assert np.array_equal(_np(got), _np(jconv.avg_pool1d_ceil(xj, k)))
    assert np.array_equal(_np(tconv.masked_avg_pool1d_ceil(xt, k, torch.from_numpy(n))),
                          _np(jconv.masked_avg_pool1d_ceil(xj, k, jnp.asarray(n))))
    np.testing.assert_allclose(tconv.avg_pool1d_ceil(torch.from_numpy(x), k).numpy(),
                               np.asarray(jconv.avg_pool1d_ceil(jnp.asarray(x), k)), rtol=1e-6, atol=1e-7)
    p = 0.1 * k
    gen = torch.Generator().manual_seed(k)
    dropped = dropout(xt, p, gen)
    keep = dropped != 0
    want = jnp.where(jnp.asarray(keep.numpy()), xj / (1.0 - p), 0.0)
    assert dropped.dtype == BF16 and np.array_equal(_np(dropped), _np(want))


# ---------------------------------------------------------------------------
# The losses and their gradients
# ---------------------------------------------------------------------------


def _jax_front(group_params, specs, x) -> torch.Tensor:
    """JAX's front end (the specs before the first ``ncl2nlc``) on waveforms
    x (B, T): its (B, C, t) output."""
    k = next(i for i, s in enumerate(specs) if s.kind == "ncl2nlc")
    front, _, _ = jenc._apply_stack(group_params, specs[:k], jnp.asarray(x)[:, None, :], train=True,
                                    rng=jax.random.PRNGKey(0), gru_impl="pallas")
    return torch.from_numpy(np.asarray(front).copy())


def on_jax_front_end(monkeypatch, front: torch.Tensor) -> list:
    """Make the port's first GRU layer of each call read ``front`` (JAX's
    front-end values) forward, with the port's own backward (a
    straight-through replacement of its input), whether that layer is
    bidirectional (``_gru_block``, before its cast) or not (``gru1``, its
    bf16 input replaced by ``front`` rounded to bf16). Returns the list of
    calls, which the caller clears between calls."""
    calls = []
    real_block, real_gru1 = tenc._gru_block, tenc.gru1

    def block(layer, tail, out, **kw):
        if not calls:
            f = front.permute(2, 0, 1)
            out = tenc.PartsTM((out[0] + (f - out[0]).detach(),))
        calls.append(1)
        return real_block(layer, tail, out, **kw)

    def uni(params, x, *args):
        if not calls:
            x32 = x.float()
            x = (x32 + (front.transpose(1, 2) - x32).detach()).to(x.dtype)
        calls.append(1)
        return real_gru1(params, x, *args)

    monkeypatch.setattr(tenc, "_gru_block", block)
    monkeypatch.setattr(tenc, "gru1", uni)
    return calls


KEY_BIAS, KEY_WEIGHT = "decoder.attention.key_linear.bias", "decoder.attention.key_linear.weight"


def _grads_match(tmodel, jg16, jg32) -> dict:
    """Every gradient of the port against JAX's bf16 and f32 ones, the
    ratio of each; a parameter the loss does not reach has none. The
    attention's key bias shifts every score of a softmax alike, so its
    gradient is 0 in exact arithmetic and rounding noise in both packages
    (``tests/test_torch_seq2seq_train.py`` holds it so at f32): it is held
    within 4 bf16 ulps of the key weight's largest gradient instead."""
    want16 = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jg16))
    want32 = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jg32))
    ratios = {}
    for name, p in tmodel.named_parameters():
        if float(want32[name].abs().max()) == 0.0:
            assert p.grad is None or not p.grad.any(), name
            continue
        assert p.grad.dtype == torch.float32, name
        if name == KEY_BIAS:
            scale = want16[KEY_WEIGHT].abs().max().item()
            assert (p.grad - want16[name]).abs().max().item() <= 2.0**-6 * scale, name
            continue
        ratios[name] = assert_bf16(p.grad.numpy(), want16[name].numpy(), want32[name].numpy(), name)
    return ratios


def _fixed_slot_matches_jax(tmp_path, monkeypatch, layout="split", **overrides) -> dict:
    """The small fixed-slot model at dropout 0 (B = 3, 0.25 s, one weight-0
    row): the JAX Trainer's loss on its Pallas kernels at bf16 against
    ``Model.loss(compute_dtype=bf16)`` on the port's ``layout``, the loss
    f32, it and every gradient within the bf16 bounds. Returns the ratios."""
    monkeypatch.setenv("TPU_SLU_PALLAS_INTERPRET", "1")
    config = _small_config(tmp_path, **overrides)
    jmodel = jslu.Model(config, seed=3)
    tmodel = Model(config, load_pretrained=False)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)), strict=True)
    tmodel.pretrained_model.gru_layout = layout
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4000)).astype(np.float32)
    y = np.stack([rng.integers(0, n, 3) for n in tmodel.values_per_slot], 1).astype(np.int32)
    w = np.array([1.0, 1.0, 0.0], np.float32)
    earch, iarch = jmodel.encoder_arch, jmodel.intent_arch

    def jloss(p, impl, dtype):  # the JAX Trainer's loss_fn, train=True, without a frame mask
        feats = jenc.encoder_features(p["pretrained_model"], earch, jnp.asarray(x), train=True,
                                      rng=jax.random.PRNGKey(0), gru_impl=impl, compute_dtype=dtype)
        logits = jslu.intent_logits(p["intent_layers"], iarch, feats, train=True,
                                    rng=jax.random.PRNGKey(1), gru_impl=impl)
        return jslu.intent_loss_acc(logits, jnp.asarray(y), iarch.values_per_slot, jnp.asarray(w))[0]

    l16, g16 = jax.value_and_grad(jloss)(jmodel.params, "pallas", jnp.bfloat16)
    l32, g32 = jax.value_and_grad(jloss)(jmodel.params, "scan", None)
    on_jax_front_end(monkeypatch, _jax_front(jmodel.params["pretrained_model"]["phoneme_layers"],
                                             earch.phoneme_layers, x))
    loss, _ = tmodel.loss(torch.from_numpy(x), torch.from_numpy(y).long(), train=True,
                          weights=torch.from_numpy(w), compute_dtype=BF16)
    assert loss.dtype == torch.float32
    ratios = {"loss": assert_bf16(loss.item(), float(l16), float(l32), "loss")}
    loss.backward()
    return {**ratios, **_grads_match(tmodel, g16, g32)}


@pytest.mark.parametrize("variant", ["uni", "mixed"])
def test_unidirectional_loss_and_gradients_match_jax_at_bf16(tmp_path, monkeypatch, variant):
    """The small fixed-slot model with every GRU layer unidirectional
    (K5f/K5b at bf16), and with unidirectional phone and intent layers
    around bidirectional word layers (bf16 handed uni -> bi -> uni; K5, K2
    and K3 at bf16; the avg pools after the unidirectional layers on their
    bf16 outputs), against JAX's Trainer loss at bf16: the loss and every
    gradient. Measured: the loss equal to JAX's bf16 one in both, every
    gradient's ratio at most 8.5e-3 (all unidirectional) and 4.0e-4
    (mixed)."""
    ratios = _fixed_slot_matches_jax(tmp_path, monkeypatch, **(UNI if variant == "uni" else MIXED))
    assert len(ratios) > 1


def test_rowstack_loss_and_gradients_match_jax_at_bf16(tmp_path, monkeypatch):
    """The repaired fault: the small fixed-slot model on
    ``gru_layout="rowstack"`` at bf16 (its intent layer's train forward K6,
    the encoder's K2 and K3) against JAX's Trainer loss at bf16 under
    ``TPU_SLU_GRU_ROWSTACK=1`` (``_mk_shared_fwd_kernel_rs``): the loss and
    every gradient within the bf16 bounds. Measured: the loss 1.7e-3 of its
    gap from JAX's bf16 one, every gradient's ratio at most 3.7e-4."""
    monkeypatch.setenv("TPU_SLU_GRU_ROWSTACK", "1")
    _fixed_slot_matches_jax(tmp_path, monkeypatch, layout="rowstack")


def test_seq2seq_loss_and_gradients_match_jax_at_bf16(tmp_path, monkeypatch):
    """The small seq2seq model at dropout 0 (B = 3, 0.25 s, U = 7, one
    weight-0 row, the step mask at 6): the JAX Trainer's seq2seq loss at
    ``compute_dtype=bfloat16`` on its Pallas kernels (the encoder's K2/K3,
    the seq2seq encoder layer's ``_fused_fwd_kernel``/``_fused_bwd_kernel``
    on the bf16 features; attention promotes its bf16 states to f32)
    against ``Model.loss(compute_dtype=bf16)``: the loss f32, it and every
    gradient within the bf16 bounds (the key bias as ``_grads_match``
    says). Measured: the loss 0.022 of its 2.8e-6 gap from JAX's bf16 one,
    every gradient's ratio at most 0.053. Attention widens the bf16 states
    in each projection: one shared widening, which sums the two
    projections' gradients in f32 before rounding, put the encoder's
    gradients 0.5-1.3 gaps from JAX's."""
    monkeypatch.setenv("TPU_SLU_PALLAS_INTERPRET", "1")
    config = small_seq2seq_config(str(tmp_path))
    config.cnn_drop = [0.0] * len(config.cnn_drop)
    for k in ("phone_rnn_drop", "word_rnn_drop", "intent_rnn_drop"):
        setattr(config, k, [0.0] * len(getattr(config, k)))
    config.seq2seq_dropout = 0.0
    jmodel = jslu.Model(config, seed=3)
    tmodel = Model(config, load_pretrained=False)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)), strict=True)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 4000)).astype(np.float32)
    L = len(config.Sy_intent)
    y = np.eye(L, dtype=np.float32)[rng.integers(1, L, (3, 7))]
    w = np.array([1.0, 1.0, 0.0], np.float32)
    earch, sarch = jmodel.encoder_arch, jmodel.seq2seq_arch

    def jloss(p, impl, dtype):  # the JAX Trainer's seq2seq loss_fn, train=True, no frame mask
        feats = jenc.encoder_features(p["pretrained_model"], earch, jnp.asarray(x), train=True,
                                      rng=jax.random.PRNGKey(0), gru_impl=impl, compute_dtype=dtype)
        log_p = jslu.seq2seq_log_prob(p, sarch, feats, jnp.asarray(y), train=True, rng=jax.random.PRNGKey(1),
                                      gru_impl=impl, num_steps=6)
        return -(log_p * w).sum() / jnp.maximum(w.sum(), 1.0)

    l16, g16 = jax.value_and_grad(jloss)(jmodel.params, "pallas", jnp.bfloat16)
    l32, g32 = jax.value_and_grad(jloss)(jmodel.params, "scan", None)
    on_jax_front_end(monkeypatch, _jax_front(jmodel.params["pretrained_model"]["phoneme_layers"],
                                             earch.phoneme_layers, x))
    counts = (bigru_masked.launches, bigru_masked.launches_bf16)
    loss, acc = tmodel.loss(torch.from_numpy(x), torch.from_numpy(y), train=True, weights=torch.from_numpy(w),
                            y_len=torch.tensor([6, 4, 2]), compute_dtype=BF16)
    assert (bigru_masked.launches, bigru_masked.launches_bf16) == counts
    assert loss.dtype == torch.float32 and acc.item() == 0.0
    assert_bf16(loss.item(), float(l16), float(l32), "loss")
    loss.backward()
    _grads_match(tmodel, g16, g32)


def test_asr_unidirectional_loss_and_gradients_match_jax_at_bf16(tmp_path, monkeypatch):
    """ASR pre-training's ``encoder_loss`` (``pretraining_type`` 2) with
    every GRU layer unidirectional at bf16 (K5f/K5b, the avg pools on their
    bf16 outputs), dropout 0, B = 2 on 0.5 s, against JAX's on its Pallas
    kernels: the four values f32, both losses and every gradient within the
    bf16 bounds. Measured: the phoneme loss equal to JAX's bf16 one, the
    word loss 0.032 of its gap from it, every gradient's ratio at most
    1.1e-3."""
    monkeypatch.setenv("TPU_SLU_PALLAS_INTERPRET", "1")
    config = _small_config(tmp_path, pretraining_type=2, **UNI)
    jmodel = jenc.PretrainedModel(config, seed=4)
    tmodel = PretrainedModel(config)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)), strict=True)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8000)).astype(np.float32)
    t_p, t_w = int(tmodel.arch.num_frames(8000, upto="phoneme")), int(tmodel.arch.num_frames(8000))
    yp = rng.integers(-1, config.num_phonemes, (2, t_p)).astype(np.int32)
    yw = rng.integers(-1, config.vocabulary_size, (2, t_w)).astype(np.int32)
    arch = jmodel.arch

    def jloss(p, impl, dtype):
        out = jenc.encoder_loss(p, arch, jnp.asarray(x), jnp.asarray(yp), jnp.asarray(yw), train=True,
                                rng=jax.random.PRNGKey(0), gru_impl=impl, compute_dtype=dtype)
        return out[0] + out[1], out

    (_, o16), g16 = jax.value_and_grad(jloss, has_aux=True)(jmodel.params, "pallas", jnp.bfloat16)
    (_, o32), g32 = jax.value_and_grad(jloss, has_aux=True)(jmodel.params, "scan", None)
    on_jax_front_end(monkeypatch, _jax_front(jmodel.params["phoneme_layers"], arch.phoneme_layers, x))
    out = encoder_loss(tmodel, torch.from_numpy(x), torch.from_numpy(yp).long(), torch.from_numpy(yw).long(),
                       train=True, compute_dtype=BF16)
    assert all(v.dtype == torch.float32 for v in out)
    for got, want, want32, what in zip(out[:2], o16[:2], o32[:2], ("phoneme loss", "word loss")):
        assert_bf16(got.item(), float(want), float(want32), what)
    (out[0] + out[1]).backward()
    _grads_match(tmodel, g16, g32)


# ---------------------------------------------------------------------------
# The Trainer on the row-stacked layout (ROADMAP Queue 3's fault)
# ---------------------------------------------------------------------------


class _Data:
    def __init__(self, batches):
        self.loader = batches


def test_bf16_rowstack_trainer_trains_and_tests_as_the_split_layout(tmp_path):
    """A bf16 Trainer over a ``gru_layout="rowstack"`` model takes a train
    step and a test pass (they raised ``TypeError`` before K6 had a bf16
    form), and from equal weights its losses equal the split layout's to
    bf16's noise: K6 and K1 differ only in the f32 order of a bias add.
    Measured: both losses equal."""
    rng = np.random.default_rng(0)
    losses = {}
    for layout in ("split", "rowstack"):
        cfg = _small_config(tmp_path / layout, compute_dtype="bfloat16")
        model = Model(cfg, load_pretrained=False)
        model.pretrained_model.gru_layout = layout
        trainer = Trainer(model, cfg)
        if layout == "split":
            batches = [{"x": rng.standard_normal((4, 4000)).astype(np.float32),
                        "y_intent": np.stack([rng.integers(0, v, 4) for v in model.values_per_slot], 1),
                        "w": np.ones(4, np.float32), "len": np.full(4, 4000)}]
        launches = bigru_shared.launches_rowstack
        losses[layout] = (trainer.train(_Data(copy.deepcopy(batches)))[1],
                          trainer.test(_Data(copy.deepcopy(batches)))[1])
        assert bigru_shared.launches_rowstack == launches  # the plain version on the CPU
    for split, rowstack in zip(losses["split"], losses["rowstack"]):
        assert np.isfinite(rowstack) and abs(rowstack - split) <= 1e-3 * abs(split)
