"""Unidirectional GRU layers in the port against the JAX package.

K5f's plain version (``gru1_reference``) and K5b's (``gru1_bwd_reference``,
and autograd of ``gru1``) against JAX's ``gru_apply_pallas`` on ``{"fwd"}``
params, the Pallas ``_fused1_fwd_kernel`` / ``_fused1_bwd_kernel`` run in
interpret mode; the length-exact layer against JAX ``gru_apply_masked``; and
the small model with every GRU layer unidirectional, and with phone and
intent layers unidirectional around bidirectional word layers, against the
JAX Model on shared weights: features, decodes (exact shape and
``lengths=``), a served answer, the train loss with every gradient, and two
Trainer steps. Inputs are made with numpy from seeds.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_config
from tests import fixtures
from tpu_slu import read_config
from tpu_slu.data.datasets import get_SLU_datasets
from tpu_slu.models import encoder as jenc
from tpu_slu.models import slu as jslu
from tpu_slu.ops.gru import gru_apply_masked as jgru_apply_masked
from tpu_slu.ops.pallas_gru import gru_apply_pallas
from tpu_slu.training.trainer import Trainer as JaxTrainer
from tpu_slu_torch.models.convert import params_from_jax
from tpu_slu_torch.models.encoder import GRULayer, encoder_features
from tpu_slu_torch.models.slu import Model
from tpu_slu_torch.ops.gru1 import gru1, gru1_bwd, gru1_bwd_reference, gru1_fwd, gru1_reference
from tpu_slu_torch.serving import IntentServer
from tpu_slu_torch.training import Trainer

GRU_RTOL, GRU_ATOL = 1e-5, 1e-6  # one layer, f32 sums in another order (tests/test_pallas_gru.py)
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5  # its VJP: sums over B*T rows
LOGIT_RTOL = 1e-5  # logits and loss, of the largest |value|: five layers of f32 sums
GRAD_TOL = 1e-4  # each model gradient, of its tensor's largest element
PARAM_TOL = 1e-4  # parameters after two Adam steps, of each tensor's largest element
EXACT_ATOL = 1e-5  # a padded row against its exact-shape decode inside the port
MIXED_LENGTHS = (7200, 8000, 5111, 6400)  # tests/test_masking.py
UNI = {"phone_rnn_bidirectional": False, "word_rnn_bidirectional": False, "intent_rnn_bidirectional": False}
VARIANTS = {"uni": UNI, "mixed": {"phone_rnn_bidirectional": False, "intent_rnn_bidirectional": False}}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("TPU_SLU_PALLAS_INTERPRET", "1")


def uni_params(rng, D, H):
    """(port params, JAX params) of one unidirectional layer, equal values."""
    b = 1.0 / np.sqrt(H)
    w = {k: rng.uniform(-b, b, s).astype(np.float32) for k, s in
         (("weight_ih", (3 * H, D)), ("weight_hh", (3 * H, H)), ("bias_ih", (3 * H,)), ("bias_hh", (3 * H,)))}
    tp = {"fwd": {k: torch.from_numpy(v) for k, v in w.items()}}
    jp = {"fwd": {"w_ih": jnp.asarray(w["weight_ih"].T), "w_hh": jnp.asarray(w["weight_hh"].T),
                  "b_ih": jnp.asarray(w["bias_ih"]), "b_hh": jnp.asarray(w["bias_hh"])}}
    return tp, jp


def _rel(got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# The layer: K5f's and K5b's functions against JAX's Pallas kernels (interpret)
# ---------------------------------------------------------------------------


# (3, 25, 60, 12): T*B = 75 rows, not a multiple of the GEMM core's 128-row tile, D = 60
@pytest.mark.parametrize("B,T,D,H", [(2, 13, 6, 8), (3, 64, 5, 12), (4, 70, 16, 16), (1, 1, 4, 8), (3, 25, 60, 12)])
def test_gru1_reference_matches_jax_pallas(interpret, rng, B, T, D, H):
    """T a multiple of the kernel's 64-frame time block, and not."""
    tp, jp = uni_params(rng, D, H)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    ref = np.asarray(gru_apply_pallas(jp, jnp.asarray(x)))
    got = gru1_reference(tp, torch.from_numpy(x))
    assert got.shape == ref.shape == (B, T, H)
    np.testing.assert_allclose(got.numpy(), ref, rtol=GRU_RTOL, atol=GRU_ATOL)
    assert torch.equal(gru1(tp, torch.from_numpy(x)), got)  # on the CPU, gru1 is the plain version


@pytest.mark.parametrize("B,T,D,H", [(2, 13, 6, 8), (3, 70, 5, 12), (1, 1, 4, 8), (3, 25, 60, 12)])
def test_gru1_backward_matches_jax_pallas_vjp(interpret, rng, B, T, D, H):
    """dX and the four weight and bias gradients of ``gru1_bwd_reference`` and
    of autograd through ``gru1`` against ``jax.vjp`` through the Pallas
    K5f/K5b pair."""
    tp, jp = uni_params(rng, D, H)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    dy = rng.standard_normal((B, T, H)).astype(np.float32)
    out, vjp = jax.vjp(gru_apply_pallas, jp, jnp.asarray(x))
    jg, jdx = vjp(jnp.asarray(dy))
    want = {"weight_ih": np.asarray(jg["fwd"]["w_ih"]).T, "weight_hh": np.asarray(jg["fwd"]["w_hh"]).T,
            "bias_ih": np.asarray(jg["fwd"]["b_ih"]), "bias_hh": np.asarray(jg["fwd"]["b_hh"])}
    tx = torch.from_numpy(x)
    dx, grads = gru1_bwd_reference(tp, tx, torch.from_numpy(np.array(out)), None, torch.from_numpy(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for k, v in want.items():
        np.testing.assert_allclose(grads["fwd"][k].numpy(), v, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
    leaves = {"fwd": {k: v.clone().requires_grad_() for k, v in tp["fwd"].items()}}
    xl = tx.clone().requires_grad_()
    gru1(leaves, xl).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xl.grad.numpy(), np.asarray(jdx), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for k, v in want.items():
        np.testing.assert_allclose(leaves["fwd"][k].grad.numpy(), v, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("B,T,D,H,lengths", [
    (5, 13, 6, 8, [0, 1, 13, 7, 12]),
    (3, 25, 60, 12, [25, 0, 11]),
    (3, 1, 4, 12, [0, 1, 1]),
    (4, 70, 16, 16, [70, 69, 2, 0]),
])
def test_gru1_lengths_match_jax_gru_apply_masked(interpret, rng, B, T, D, H, lengths):
    """The length-exact layer against JAX ``gru_apply_masked`` (Pallas, on
    ``{"fwd"}``); each row is the layer on its example alone, zeros past
    its length; its backward (``dy`` past each length ignored) against
    ``jax.vjp`` of the same."""
    tp, jp = uni_params(rng, D, H)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    n = np.array(lengths)
    ref, vjp = jax.vjp(lambda p, xx: jgru_apply_masked(p, xx, jnp.asarray(n, jnp.int32), impl="pallas"),
                       jp, jnp.asarray(x))
    got = gru1(tp, torch.from_numpy(x), torch.from_numpy(n))
    assert got.shape == ref.shape == (B, T, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=GRU_RTOL, atol=GRU_ATOL)
    for b, nb in enumerate(lengths):
        assert (got[b, nb:] == 0).all()
        if nb:
            alone = gru1_fwd(tp, torch.from_numpy(x[b:b + 1, :nb]))[0]
            torch.testing.assert_close(got[b, :nb], alone, rtol=0, atol=1e-6)
    dy = rng.standard_normal((B, T, H)).astype(np.float32)
    jg, jdx = vjp(jnp.asarray(dy))
    dx, grads = gru1_bwd(tp, torch.from_numpy(x), got, torch.from_numpy(n), torch.from_numpy(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    want = {"weight_ih": np.asarray(jg["fwd"]["w_ih"]).T, "weight_hh": np.asarray(jg["fwd"]["w_hh"]).T,
            "bias_ih": np.asarray(jg["fwd"]["b_ih"]), "bias_hh": np.asarray(jg["fwd"]["b_hh"])}
    for k, v in want.items():
        np.testing.assert_allclose(grads["fwd"][k].numpy(), v, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
    for b, nb in enumerate(lengths):
        assert (dx[b, nb:] == 0).all()


def test_gru1_on_cpu_counts_no_launch(rng):
    tp, _ = uni_params(rng, 6, 8)
    x = torch.from_numpy(rng.standard_normal((3, 9, 6)).astype(np.float32))
    n = torch.tensor([9, 0, 4])
    before = (gru1.launches, gru1_bwd.launches)
    leaves = {"fwd": {k: v.clone().requires_grad_() for k, v in tp["fwd"].items()}}
    out = gru1(leaves, x, n)
    out.sum().backward()
    assert (gru1.launches, gru1_bwd.launches) == before  # counts kernel launches only
    assert torch.equal(out.detach(), gru1_reference(tp, x, n))
    assert all(v.grad is not None for v in leaves["fwd"].values())


def test_gru_layer_follows_the_jax_init_order():
    """``make_layer`` builds a unidirectional spec as ``GRULayer``, with
    torch.nn.GRU's names and shapes, drawn in JAX ``gru_init``'s order
    (w_ih, w_hh, b_ih, b_hh) from U(-1/sqrt(H), 1/sqrt(H))."""
    from tpu_slu_torch.models.encoder import LayerSpec, make_layer

    layer = make_layer(LayerSpec("gru", 0, "phone_rnn0", (6, 8, False)), torch.Generator().manual_seed(0))
    assert isinstance(layer, GRULayer)
    assert [(k, tuple(v.shape)) for k, v in layer.state_dict().items()] == [
        ("weight_ih_l0", (24, 6)), ("weight_hh_l0", (24, 8)), ("bias_ih_l0", (24,)), ("bias_hh_l0", (24,))]
    gen = torch.Generator().manual_seed(0)
    for p in layer.parameters():
        want = torch.empty_like(p).uniform_(-8 ** -0.5, 8 ** -0.5, generator=gen)
        assert torch.equal(p, want)
    assert list(layer.params()) == ["fwd"]


# ---------------------------------------------------------------------------
# The slice: the all-unidirectional and the mixed small model against JAX
# ---------------------------------------------------------------------------


def _config(tmp, variant, gru_impl="pallas"):
    config = _make_config(tmp, small=True)
    for k, v in VARIANTS[variant].items():
        setattr(config, k, v)
    config.gru_impl = gru_impl
    return config


def _no_dropout(config):
    config.cnn_drop = [0.0] * len(config.cnn_drop)
    for k in ("phone_rnn_drop", "word_rnn_drop", "intent_rnn_drop"):
        setattr(config, k, [0.0] * len(getattr(config, k)))
    return config


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request, tmp_path_factory):
    """(variant, config, JAX Model, port Model) sharing the JAX model's weights."""
    config = _config(str(tmp_path_factory.mktemp(request.param)), request.param)
    jmodel = jslu.Model(config, seed=3)
    tmodel = Model(config)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)), strict=True)
    return request.param, config, jmodel, tmodel.eval()


def padded_batch(rng, lengths, t_pad):
    waves = [(0.1 * rng.standard_normal(t)).astype(np.float32) for t in lengths]
    x = np.zeros((len(waves), t_pad), np.float32)
    for i, w in enumerate(waves):
        x[i, :len(w)] = w
    return waves, x


def test_layers_are_built_as_the_config_says(pair):
    variant, _, _, tmodel = pair
    enc = tmodel.pretrained_model
    grus = [(s.name, type(layers[s.index]).__name__) for layers, specs in
            ((enc.phoneme_layers, enc.arch.phoneme_layers), (enc.word_layers, enc.arch.word_layers),
             (tmodel.intent_layers, tmodel.intent_arch.layers)) for s in specs if s.kind == "gru"]
    word = "GRULayer" if variant == "uni" else "BiGRULayer"
    assert grus == [("phone_rnn0", "GRULayer"), ("phone_rnn1", "GRULayer"), ("word_rnn0", word),
                    ("word_rnn1", word), ("intent_rnn0", "GRULayer")]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_unfreeze_walk_and_masks_match_jax(variant, tmp_path, capsys):
    """Frozen base, unfreezing type 2: at each epoch the trainable names and
    ``print_frozen`` equal the JAX Model's, unidirectional layers included."""
    config = _config(str(tmp_path), variant)
    config.pretraining_type, config.unfreezing_type = 2, 2
    jmodel = jslu.Model(config, seed=0, load_pretrained=False)
    tmodel = Model(config, load_pretrained=False)
    for _ in range(jslu._num_walkable(jmodel.encoder_arch, 2) + 1):
        jmask = params_from_jax(jax.tree.map(np.asarray, jmodel.trainable_mask()))
        assert {k: float(v) for k, v in jmask.items()} == tmodel.trainable_mask()
        jmodel.print_frozen()
        want = capsys.readouterr().out
        tmodel.print_frozen()
        assert capsys.readouterr().out == want
        jmodel.unfreeze_one_layer()
        tmodel.unfreeze_one_layer()


def test_encoder_features_match_jax(pair, interpret, rng):
    """Exact shape and length-exact; each padded row equals its example alone."""
    _, _, jmodel, tmodel = pair
    waves, x = padded_batch(rng, MIXED_LENGTHS, 8000)
    n = np.array(MIXED_LENGTHS)
    params, arch = jmodel.params["pretrained_model"], jmodel.encoder_arch
    with torch.inference_mode():
        ref = np.asarray(jenc.encoder_features(params, arch, jnp.asarray(x), gru_impl="pallas"))
        got = encoder_features(tmodel.pretrained_model, torch.from_numpy(x)).numpy()
        assert got.shape == ref.shape
        assert _rel(got, ref) <= LOGIT_RTOL
        ref = np.asarray(jenc.encoder_features(params, arch, jnp.asarray(x), gru_impl="pallas",
                                               lengths=jnp.asarray(n, jnp.int32)))
        got = encoder_features(tmodel.pretrained_model, torch.from_numpy(x), lengths=torch.from_numpy(n)).numpy()
        assert got.shape == ref.shape
        assert _rel(got, ref) <= LOGIT_RTOL
        for i, w in enumerate(waves):
            alone = encoder_features(tmodel.pretrained_model, torch.from_numpy(w[None])).numpy()[0]
            n_i = alone.shape[0]
            np.testing.assert_allclose(got[i, :n_i], alone, rtol=0, atol=EXACT_ATOL)
            np.testing.assert_array_equal(got[i, n_i:], 0.0)


def test_predict_intents_match_jax(pair, interpret, rng):
    """Exact shape and ``lengths=``: logits within 1e-5 of the largest,
    predictions and decoded strings equal; each padded row equals its
    exact-shape decode."""
    _, _, jmodel, tmodel = pair
    waves, x = padded_batch(rng, MIXED_LENGTHS, 8000)
    n = np.array(MIXED_LENGTHS)
    for kw in ({}, {"lengths": n}):
        ref_logits, ref_preds = jmodel.predict_intents(x, **kw)
        logits, preds = tmodel.predict_intents(x, **kw)
        assert _rel(logits.numpy(), ref_logits) <= LOGIT_RTOL
        np.testing.assert_array_equal(preds.numpy(), np.asarray(ref_preds))
        assert tmodel.decode_intents(x, **kw) == jmodel.decode_intents(x, **kw)
    for i, w in enumerate(waves):
        alone, _ = tmodel.predict_intents(w)
        np.testing.assert_allclose(logits[i].numpy(), alone[0].numpy(), rtol=0, atol=EXACT_ATOL)


def test_served_answers_match_jax(pair, interpret, rng):
    """An ``IntentServer`` batch of requests of other lengths: each answer is
    the JAX model's exact-shape decode."""
    _, _, jmodel, tmodel = pair
    waves = [(0.1 * rng.standard_normal(t)).astype(np.float32) for t in (4000, 8000, 6100)]
    server = IntentServer(tmodel, max_batch=4)
    try:
        answers = [f.result(timeout=120) for f in [server.submit(w) for w in waves]]
    finally:
        server.close()
    assert answers == [jmodel.decode_intents(w[None])[0] for w in waves]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_every_gradient_match_jax(variant, interpret, tmp_path, rng):
    """``Model.forward(training=True)`` at dropout 0 against
    ``jax.value_and_grad`` of the JAX Trainer's loss through the Pallas
    kernels (K5f/K5b for the unidirectional layers), frame mask and example
    weights on. Loss within 1e-5 relative; each gradient
    within 1e-4 of its tensor's largest element."""
    x = (0.1 * rng.standard_normal((3, 4000))).astype(np.float32)
    w = np.array([1.0, 1.0, 0.0], np.float32)
    lengths = np.array([4000, 3100, 2500], np.int32)
    config = _no_dropout(_config(str(tmp_path), variant))
    jmodel = jslu.Model(config, seed=5)
    tmodel = Model(config, load_pretrained=False)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)), strict=True)
    earch, iarch = jmodel.encoder_arch, jmodel.intent_arch
    y = np.stack([rng.integers(0, v, 3) for v in iarch.values_per_slot], 1).astype(np.int32)

    def jloss(p):  # the JAX Trainer's loss_fn, train=True, rates 0
        feats = jenc.encoder_features(p["pretrained_model"], earch, jnp.asarray(x), train=True,
                                      rng=jax.random.PRNGKey(0), gru_impl="pallas")
        t_out = jenc.frames_through(iarch.layers, feats.shape[1])
        fm = jslu.frame_mask_from_lengths(earch, jnp.asarray(lengths), t_out, iarch)
        logits = jslu.intent_logits(p["intent_layers"], iarch, feats, train=True, rng=jax.random.PRNGKey(1),
                                    gru_impl="pallas", frame_mask=fm)
        return jslu.intent_loss_acc(logits, jnp.asarray(y), iarch.values_per_slot, jnp.asarray(w))

    (jl, ja), jg = jax.value_and_grad(jloss, has_aux=True)(jmodel.params)
    loss, acc = tmodel(x, y, training=True, weights=w, lengths=lengths)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOGIT_RTOL)
    assert acc.item() == float(ja)
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    for name, p in tmodel.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)  # unused: JAX gives zeros
        scale = max(want[name].abs().max().item(), 1e-12)
        err = (got - want[name]).abs().max().item()
        assert err <= GRAD_TOL * scale, (name, err, scale)


class _Batches:
    """A dataset whose ``.loader`` replays recorded batches."""

    def __init__(self, batches):
        self.loader = batches


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_two_trainer_steps_match_jax(variant, interpret, tmp_path):
    """Both Trainers from shared weights, one epoch of two recorded batches
    of the synthetic FSC fixture, dropout 0: the epoch's loss within 1e-5
    relative, accuracy equal, parameters after the two masked-Adam steps
    within 1e-4 of each tensor's largest element."""
    root = fixtures.make_slu_dataset(str(tmp_path / "fsc"), n_train=16, n_valid=8, n_test=8,
                                     seq2seq_too=False)
    flags = {f"{k}=True": f"{k}={'False' if k in VARIANTS[variant] else 'True'}"
             for k in ("phone_rnn_bidirectional", "word_rnn_bidirectional", "intent_rnn_bidirectional")}
    cfg = fixtures.write_cfg(str(tmp_path / "exp.cfg"), folder=str(tmp_path / "jax"), slu_path=root,
                             replace=flags)
    config = _no_dropout(read_config(cfg))
    config.gru_impl = "pallas"
    fixtures.write_phonemes_txt(config.folder)
    config.n_devices = 1
    train, _, _ = get_SLU_datasets(config)
    batches = _Batches(list(train.loader))
    assert len(batches.loader) == 2
    jmodel = jslu.Model(config, load_pretrained=False)
    tconfig = copy.copy(config)
    tconfig.folder = str(tmp_path / "port")
    tmodel = Model(tconfig, load_pretrained=False)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)), strict=True)
    assert isinstance(tmodel.intent_layers[0], GRULayer)
    (ja, jl), (ta, tl) = JaxTrainer(jmodel, config).train(batches), Trainer(tmodel, tconfig).train(batches)
    assert ta == pytest.approx(ja, abs=1e-6)
    assert tl == pytest.approx(jl, rel=LOGIT_RTOL)
    want = params_from_jax(jax.tree.map(np.asarray, jmodel.params))
    for name, p in tmodel.named_parameters():
        err = (p.detach() - want[name]).abs().max().item()
        assert err <= PARAM_TOL * max(want[name].abs().max().item(), 1e-6), (name, err)
