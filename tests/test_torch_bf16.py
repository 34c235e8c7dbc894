"""``compute_dtype=bfloat16`` in the port against the JAX package's Pallas kernels.

The port runs K1, K2 and K3 on bf16 streams (their plain versions here, in
the same autograd Functions the card runs with the kernels). JAX's contract
is that of its Pallas kernels at bf16 (``tpu_slu/ops/pallas_gru.py``), run in
interpret mode on the CPU: JAX's CPU default, the ``lax.scan`` GRU, rounds
only its inputs, so it is not the semantics the TPU trains with.

Each output and gradient is held at two points (``assert_bf16``):

* its relative Frobenius distance from JAX's bf16 result is at most a
  quarter of JAX's own bf16-vs-f32 distance on the same inputs (which shows
  both that bf16 acts and that the rounding points are the same), and
* it is within 4 bf16 ulps of the reference's largest element
  (2^-6 max|ref|).

Measured here: every output of K1 and K2 equals JAX's bit for bit (distance
0), and so do K3's dX (each direction's dX rounded, then their sum, as the
TPU kernel and XLA round them); the weight and bias gradients are 0.5e-7 to
2.3e-7 from JAX's (ratio below 1e-4 of gaps of 1.3e-3 to 5.1e-3), f32 sums
in another order. The model-level ratios are in the tests' docstrings.

JAX's f32 yardstick of the model-level tests is its ``scan`` GRU, which
agrees with its f32 Pallas kernels to f32 rounding (``test_torch_train.py``,
``test_pallas_gru.py``) at a fraction of the interpret mode's time.
"""

import copy
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_config
from tests import fixtures
from tests.test_torch_bigru_shared import make_params, make_parts
from tpu_slu.models import encoder as jenc
from tpu_slu.models import slu as jslu
from tpu_slu.ops.pallas_gru import bigru_apply_shared
from tpu_slu_torch import read_config
from tpu_slu_torch.models import encoder as tenc
from tpu_slu_torch.models.convert import params_from_jax
from tpu_slu_torch.models.encoder import PretrainedModel, apply_stack, encoder_loss
from tpu_slu_torch.models.flagship import TRAIN_CFG, UNIDIRECTIONAL, flagship_model, flagship_seq2seq_model
from tpu_slu_torch.models.slu import Model
from tpu_slu_torch.ops.bigru_shared import (_PooledEvalCore, _TrainCore, _TrainPoolCore, bigru_shared,
                                            bigru_shared_bwd)
from tpu_slu_torch.serving import IntentServer, load_trained_model
from tpu_slu_torch.training import Trainer

BF16 = torch.bfloat16
_JAX_NAMES = {"weight_ih": "w_ih", "weight_hh": "w_hh", "bias_ih": "b_ih", "bias_hh": "b_hh"}


def fro(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def assert_bf16(got, want16, want32, what: str) -> float:
    """The two bounds of the module docstring; returns the ratio of the
    distances."""
    got, want16, want32 = (np.asarray(t, np.float64) for t in (got, want16, want32))
    assert got.shape == want16.shape == want32.shape, (what, got.shape, want16.shape)
    gap, dist = fro(want16, want32), fro(got, want16)
    assert gap > 0.0, f"{what}: JAX's bf16 result equals its f32 one: bf16 did not act"
    assert dist <= 0.25 * gap, f"{what}: port {dist:.3g} from JAX bf16, whose gap to f32 is {gap:.3g}"
    assert np.abs(got - want16).max() <= 2.0**-6 * np.abs(want16).max(), what
    return dist / gap


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


# ---------------------------------------------------------------------------
# One layer: K1, K2 and K3 through the autograd Functions
# ---------------------------------------------------------------------------

ROUTES = {  # name: (the port's bigru_shared kwargs, its Function)
    "k1_pool_avg": ({"pool": 2, "pool_method": "avg"}, _PooledEvalCore),
    "k1_pool_max": ({"pool": 2, "pool_method": "max"}, _PooledEvalCore),
    "k1_unpooled": ({"train": True}, _TrainCore),
    "k2_p0": ({"train": True, "pool": 2, "drop_p": 0.0, "seed": 0xC0FFEE}, _TrainPoolCore),
    "k2_p05": ({"train": True, "pool": 2, "drop_p": 0.5, "seed": 0xC0FFEE}, _TrainPoolCore),
}


def _jax_layer(jax_p, parts, cot, dtype, kw):
    """JAX's bigru_apply_shared on ``parts`` cast to ``dtype``: its outputs
    and the VJP at ``cot`` (cast alike) with respect to the parts and params;
    the eval routes (no ``train``) their outputs alone: JAX's pooled eval
    path cannot be differentiated at bf16 (its recomputing backward pools in
    f32 and refuses the bf16 cotangent), and no trainer differentiates it."""
    kw = dict(kw)
    if "seed" in kw:
        kw["drop_seed"] = jnp.asarray([kw.pop("seed")], jnp.uint32)

    def f(ps, p):
        h_f, h_b, _ = bigru_apply_shared(p, tuple(ps), **kw)
        return h_f, h_b

    if not kw.get("train"):
        return f([jnp.asarray(x, dtype) for x in parts], jax_p), None, None
    out, vjp = jax.vjp(f, [jnp.asarray(x, dtype) for x in parts], jax_p)
    d_parts, d_p = vjp(tuple(jnp.asarray(c, dtype) for c in cot))
    return out, d_parts, d_p


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("dims", [(10,), (6, 10)], ids=["parts1", "parts2"])
def test_layer_matches_jax_pallas_at_bf16(rng, dims, route):
    """One layer at T = 9, B = 3, H = 8: outputs, dX and the eight weight
    and bias gradients against JAX's Pallas kernels at bf16 (K3 in plain
    mode under K1's unpooled train route, in fused mode under K2's; the
    pooled eval routes' outputs, their gradients' dtypes). bf16 streams and
    dX, f32 weight gradients."""
    kw, function = ROUTES[route]
    T, B, H = 9, 3, 8
    jax_p, port_p = make_params(rng, sum(dims), H)
    parts = make_parts(rng, dims, T, B)
    To = T if "pool" not in kw else -(-T // 2)
    cot = [rng.standard_normal((To, B, H)).astype(np.float32) for _ in range(2)]
    out16, dparts16, dp16 = _jax_layer(jax_p, parts, cot, jnp.bfloat16, kw)
    out32, dparts32, dp32 = _jax_layer(jax_p, parts, cot, jnp.float32, kw)

    tparams = {d: {n: t.clone().requires_grad_() for n, t in port_p[d].items()} for d in port_p}
    tparts = [torch.from_numpy(x).to(BF16).requires_grad_() for x in parts]
    h_f, h_b, _ = bigru_shared(tparams, tparts, **kw)
    assert type(h_f.grad_fn).__name__.startswith(function.__name__)
    assert h_f.dtype == h_b.dtype == BF16 and h_f.shape == (To, B, H)
    torch.autograd.backward((h_f, h_b), [torch.from_numpy(c).to(BF16) for c in cot])
    for i, h in enumerate((h_f, h_b)):
        assert_bf16(_np(h), _np(out16[i]), _np(out32[i]), f"output {i}")
    for i, x in enumerate(tparts):
        assert x.grad.dtype == BF16 and torch.isfinite(x.grad.float()).all()
        if dparts16 is not None:
            assert_bf16(_np(x.grad), _np(dparts16[i]), _np(dparts32[i]), f"dx {i}")
    for d in ("fwd", "bwd"):
        for n, j in _JAX_NAMES.items():
            g = tparams[d][n].grad
            assert g.dtype == torch.float32
            g = g.numpy().T if n.startswith("weight") else g.numpy()
            if dp16 is not None:
                assert_bf16(g, _np(dp16[d][j]), _np(dp32[d][j]), f"{d}.{n}")


def test_k3_wrapper_takes_bf16_streams_and_returns_f32_weight_gradients(rng):
    """The backward wrapper's dtype contract: bf16 parts, h_prev and
    cotangents in; bf16 dX and f32 gradients out; the fused mode's pooled
    cotangent is widened before its window divide. Mixed parts raise; the
    row-stacked layout (K6) takes bf16 parts and returns bf16 streams."""
    T, B, H = 7, 2, 8
    _, port_p = make_params(rng, 10, H)
    parts = [torch.from_numpy(x).to(BF16) for x in make_parts(rng, (4, 6), T, B)]
    hp = [torch.from_numpy(rng.standard_normal((T, B, H)).astype(np.float32)).to(BF16) for _ in range(2)]
    for kw, To in (({}, T), ({"pool": 2, "drop_p": 0.5, "seed": 5}, 4)):
        dy = [torch.from_numpy(rng.standard_normal((To, B, H)).astype(np.float32)).to(BF16) for _ in range(2)]
        dxs, grads = bigru_shared_bwd(port_p, parts, *hp, *dy, **kw)
        assert [d.dtype for d in dxs] == [BF16, BF16] and [d.shape[-1] for d in dxs] == [4, 6]
        assert all(g.dtype == torch.float32 for gd in grads.values() for g in gd.values())
    with pytest.raises(TypeError):
        bigru_shared(port_p, [parts[0], parts[1].float()])
    for kw, To in (({}, T), ({"pool": 2}, 4)):
        h_f, h_b, _ = bigru_shared(port_p, parts, layout="rowstack", **kw)
        assert h_f.dtype == h_b.dtype == BF16 and h_f.shape == h_b.shape == (To, B, H)


def test_float64_steps_stay_float64(tmp_path):
    """Widening takes bf16 only: an f64 copy of a model (the card checks'
    f64 reference steps) trains in f64 end to end, its heads' input and its
    losses f64, both models."""
    config = _small_config(tmp_path)
    model = Model(config, load_pretrained=False).double()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 4000)))
    y = torch.from_numpy(np.stack([rng.integers(0, n, 2) for n in model.values_per_slot], 1))
    loss, _ = model.loss(x, y, train=True, weights=torch.ones(2, dtype=torch.float64))
    loss.backward()
    assert loss.dtype == torch.float64
    assert all(p.grad.dtype == torch.float64 for p in model.parameters() if p.grad is not None)
    enc = model.pretrained_model
    t_p, t_w = int(enc.arch.num_frames(4000, upto="phoneme")), int(enc.arch.num_frames(4000))
    out = encoder_loss(enc, x, torch.zeros(2, t_p, dtype=torch.int64), torch.zeros(2, t_w, dtype=torch.int64),
                       train=True)
    assert all(v.dtype == torch.float64 for v in out)


def test_the_stack_casts_where_jax_casts(tmp_path, monkeypatch):
    """``apply_stack(compute_dtype=bf16)``: the f32 front end's output stays
    f32, each bi-GRU layer's input streams are bf16, and the gradient that
    flows back into the f32 conv output is f32 (the cast's backward, as
    JAX's ``astype`` transposes)."""
    cfg = fixtures.write_cfg(str(tmp_path / "c.cfg"), folder=str(tmp_path / "exp"))
    config = read_config(cfg)
    enc = PretrainedModel(config)
    specs = enc.arch.phoneme_layers
    first = next(i for i, s in enumerate(specs) if s.kind == "gru")
    conv_out = torch.randn(2, specs[first].h[0], 20, generator=torch.Generator().manual_seed(0))
    conv_out.requires_grad_()
    seen = []
    real = tenc.bigru_shared

    def spy(params, parts, **kw):
        seen.append([p.dtype for p in parts])
        return real(params, parts, **kw)

    monkeypatch.setattr(tenc, "bigru_shared", spy)
    out = apply_stack(enc.phoneme_layers, specs[first:], conv_out.transpose(1, 2), train=True,
                      compute_dtype=BF16)
    assert seen == [[BF16], [BF16, BF16]]
    assert all(p.dtype == BF16 for p in out)
    sum(p.float().sum() for p in out).backward()
    assert conv_out.grad.dtype == torch.float32 and torch.isfinite(conv_out.grad).all()


# ---------------------------------------------------------------------------
# The fixed-slot and ASR losses at bf16
# ---------------------------------------------------------------------------


def _small_config(tmp_path, **extra):
    config = _make_config(str(tmp_path), small=True)
    config.cnn_drop = [0.0] * len(config.cnn_drop)
    for k in ("phone_rnn_drop", "word_rnn_drop", "intent_rnn_drop"):
        setattr(config, k, [0.0] * len(getattr(config, k)))
    for k, v in extra.items():
        setattr(config, k, v)
    return config


def _grads_match(tmodel, jg16, jg32) -> dict:
    """Every gradient of the port against JAX's bf16 and f32 ones; returns
    the ratio of each."""
    want16 = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jg16))
    want32 = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jg32))
    ratios = {}
    for name, p in tmodel.named_parameters():
        if float(want32[name].abs().max()) == 0.0:  # a head the loss does not reach
            assert p.grad is None or not p.grad.any(), name
            continue
        assert p.grad.dtype == torch.float32, name
        ratios[name] = assert_bf16(p.grad.numpy(), want16[name].numpy(), want32[name].numpy(), name)
    return ratios


def test_fixed_slot_loss_and_gradients_match_jax_at_bf16(tmp_path, monkeypatch):
    """The small fixed-slot model at dropout 0 (B = 3, 0.25 s): the JAX
    Trainer's loss at ``compute_dtype=bfloat16`` on its Pallas kernels
    (interpret mode) against ``Model.loss(compute_dtype=bf16)``: the loss
    f32, it and every gradient within the bf16 bounds.

    The two front ends' f32 outputs differ by 3.8e-7 (relative; torch's and
    XLA's sinc filters and convs), and 5 of their 9,600 values round to
    another bf16 at the first GRU layer's cast; the bf16 recurrences spread
    those 5 through every later layer, forward and backward (end to end the
    first GRU layer's gradients then sit 0.42 of the bf16-vs-f32 gap from
    JAX's, the intent layer's 0.1). So here the port's front end runs
    forward on JAX's output values (its own backward, by a straight-through
    replacement at the first layer's input): from equal values the port's
    stack equals JAX's bit for bit, which the test also holds. Measured:
    the loss 8.3e-8 relative from JAX's bf16 one (0.0017 of its 4.9e-5 gap
    to f32), every gradient's ratio 1.2e-5 to 3.7e-4 (gaps 1.6e-4 to
    1.6e-2)."""
    monkeypatch.setenv("TPU_SLU_PALLAS_INTERPRET", "1")
    config = _small_config(tmp_path)
    jmodel = jslu.Model(config, seed=3)
    tmodel = Model(config, load_pretrained=False)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)), strict=True)
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
        loss, _ = jslu.intent_loss_acc(logits, jnp.asarray(y), iarch.values_per_slot, jnp.asarray(w))
        return loss, feats

    (l16, f16), g16 = jax.value_and_grad(jloss, has_aux=True)(jmodel.params, "pallas", jnp.bfloat16)
    (l32, _), g32 = jax.value_and_grad(jloss, has_aux=True)(jmodel.params, "scan", None)

    # JAX's front-end output (B, C, T) as the first layer's time-major part
    specs = earch.phoneme_layers
    k = next(i for i, s in enumerate(specs) if s.kind == "ncl2nlc")
    front, _, _ = jenc._apply_stack(jmodel.params["pretrained_model"]["phoneme_layers"], specs[:k],
                                    jnp.asarray(x)[:, None, :], train=True, rng=jax.random.PRNGKey(0), gru_impl="pallas")
    front = torch.from_numpy(np.asarray(front).transpose(2, 0, 1).copy())
    real, calls = tenc._gru_block, []

    def on_jax_front_end(layer, tail, out, **kw):
        if not calls:  # the first layer: JAX's values forward, the port's backward
            out = tenc.PartsTM((out[0] + (front - out[0]).detach(),))
        calls.append(1)
        return real(layer, tail, out, **kw)

    monkeypatch.setattr(tenc, "_gru_block", on_jax_front_end)
    feats = tenc.encoder_features(tmodel.pretrained_model, torch.from_numpy(x), train=True, compute_dtype=BF16)
    assert feats.dtype == BF16 and torch.equal(feats.float(), torch.tensor(_np(f16)))
    calls.clear()
    loss, _ = tmodel.loss(torch.from_numpy(x), torch.from_numpy(y).long(), train=True,
                          weights=torch.from_numpy(w), compute_dtype=BF16)
    assert loss.dtype == torch.float32
    assert_bf16(loss.item(), float(l16), float(l32), "loss")
    loss.backward()
    _grads_match(tmodel, g16, g32)


def test_asr_loss_and_gradients_match_jax_at_bf16(tmp_path, monkeypatch):
    """ASR pre-training's ``encoder_loss`` (``pretraining_type`` 2, the sum
    of the two heads' losses) at bf16, dropout 0, B = 2 on 0.5 s, against
    JAX's on its Pallas kernels: the four values f32, the losses and every
    gradient within the bf16 bounds, end to end (here the first layer's
    inputs round alike in both packages). Measured: the
    phoneme loss equal to JAX's bf16 one, the word loss 1.1e-7 relative
    apart (0.0066 of its 1.7e-5 gap to f32), every gradient's ratio 2.4e-5
    to 0.024 (the sinc parameters', sums over every sample, the largest;
    gaps 6.7e-4 to 7.3e-3)."""
    monkeypatch.setenv("TPU_SLU_PALLAS_INTERPRET", "1")
    config = _small_config(tmp_path, pretraining_type=2)
    jenc_model = jenc.PretrainedModel(config, seed=4)
    tenc_model = PretrainedModel(config)
    tenc_model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jenc_model.params)), strict=True)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8000)).astype(np.float32)
    t_p, t_w = int(tenc_model.arch.num_frames(8000, upto="phoneme")), int(tenc_model.arch.num_frames(8000))
    yp = rng.integers(-1, config.num_phonemes, (2, t_p)).astype(np.int32)
    yw = rng.integers(-1, config.vocabulary_size, (2, t_w)).astype(np.int32)
    arch = jenc_model.arch

    def jloss(p, impl, dtype):
        out = jenc.encoder_loss(p, arch, jnp.asarray(x), jnp.asarray(yp), jnp.asarray(yw), train=True,
                                rng=jax.random.PRNGKey(0), gru_impl=impl, compute_dtype=dtype)
        return out[0] + out[1], out

    (_, o16), g16 = jax.value_and_grad(jloss, has_aux=True)(jenc_model.params, "pallas", jnp.bfloat16)
    (_, o32), g32 = jax.value_and_grad(jloss, has_aux=True)(jenc_model.params, "scan", None)
    out = encoder_loss(tenc_model, torch.from_numpy(x), torch.from_numpy(yp).long(), torch.from_numpy(yw).long(),
                       train=True, compute_dtype=BF16)
    assert all(v.dtype == torch.float32 for v in out)
    for got, want, want32, what in zip(out[:2], o16[:2], o32[:2], ("phoneme loss", "word loss")):
        assert_bf16(got.item(), float(want), float(want32), what)
    (out[0] + out[1]).backward()
    _grads_match(tenc_model, g16, g32)


# ---------------------------------------------------------------------------
# The Trainer, the scope of the setting and its refusals
# ---------------------------------------------------------------------------


def _batches(rng, model, n: int = 1, B: int = 4, T: int = 4000):
    return [{"x": rng.standard_normal((B, T)).astype(np.float32),
             "y_intent": np.stack([rng.integers(0, v, B) for v in model.values_per_slot], 1),
             "w": np.ones(B, np.float32), "len": np.full(B, T)} for _ in range(n)]


class _Data:
    def __init__(self, batches):
        self.loader = batches


def test_trainer_takes_a_bf16_step_and_a_test_pass(tmp_path):
    """A ``compute_dtype=bfloat16`` cfg: the Trainer passes bf16 to the train
    step's and the test pass's losses; from equal weights its loss lies
    within 1e-2 relative of the f32 Trainer's and differs from it; its
    parameters and Adam state stay f32 and the step moves them."""
    losses, states = {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = _small_config(tmp_path / dtype, compute_dtype=dtype)
        model = Model(cfg, load_pretrained=False)
        trainer = Trainer(model, cfg)
        assert trainer.compute_dtype == (BF16 if dtype == "bfloat16" else None)
        batches = _batches(np.random.default_rng(0), model)
        before = copy.deepcopy(model.state_dict())
        losses[dtype] = (trainer.train(_Data(batches))[1], trainer.test(_Data(batches))[1])
        states[dtype] = (before, model.state_dict(), trainer.optimizer)
    for train_or_test in range(2):
        a, b = losses["float32"][train_or_test], losses["bfloat16"][train_or_test]
        assert np.isfinite(b) and a != b and abs(a - b) <= 1e-2 * abs(a)
    before, after, opt = states["bfloat16"]
    assert all(t.dtype == torch.float32 for t in after.values())
    assert any(not torch.equal(before[k], after[k]) for k in after)
    flat = opt.export_flat()
    assert all(np.asarray(v).dtype == np.float32 for k, v in flat.items() if k != "step")


def test_a_bf16_cfg_decodes_and_serves_what_the_f32_cfg_does(tmp_path):
    """Decode and serving ignore ``compute_dtype``, as JAX's do: the golden
    checkpoint under a bf16 cfg decodes and serves bit for bit what it does
    under the f32 cfg."""
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "golden")
    with open(os.path.join(golden, "experiment.cfg.template")) as f:
        template = f.read()
    results = {}
    for dtype in ("float32", "bfloat16"):
        folder = str(tmp_path / dtype)
        path = str(tmp_path / f"{dtype}.cfg")
        with open(path, "w") as f:
            f.write(template.replace("__GOLDEN_FOLDER__", folder).replace("[training]", f"[training]\ncompute_dtype={dtype}"))
        config = read_config(path)
        assert config.compute_dtype == dtype
        for name in ("model_state.npz", "vocab.json"):
            shutil.copyfile(os.path.join(golden, name), os.path.join(folder, "training", name))
        model = load_trained_model(config, device="cpu")
        wav = np.random.default_rng(2).standard_normal((2, 12000)).astype(np.float32) * 0.1
        logits, _ = model.predict_intents(wav)
        server = IntentServer(model, max_batch=2)
        try:
            served = server.decode(wav[0])
        finally:
            server.close()
        results[dtype] = (logits, model.decode_intents(wav), served)
    assert results["float32"][0].dtype == results["bfloat16"][0].dtype == torch.float32
    assert torch.equal(results["float32"][0], results["bfloat16"][0])
    assert results["float32"][1:] == results["bfloat16"][1:]


def _flagship_of(kind: str, folder: str, dtype: str):
    """The flagship model of ``kind`` on the CPU at dropout 0 and its config
    at ``compute_dtype`` ``dtype``: the seq2seq model, or the fixed-slot
    model with every GRU layer unidirectional, or that model's encoder
    (``asr_unidirectional``, ``pretraining_type`` 2)."""
    no_dropout = {"phone_rnn_drop": [0.0, 0.0], "word_rnn_drop": [0.0, 0.0], "cnn_drop": [0.0, 0.0, 0.0]}
    if kind == "seq2seq":
        model = flagship_seq2seq_model("cpu", seq2seq_dropout=0.0, **no_dropout)
    else:
        model = flagship_model("cpu", cfg=TRAIN_CFG, intent_rnn_drop=[0.0], **no_dropout, **UNIDIRECTIONAL)
    config = model.config
    config.folder, config.compute_dtype = folder, dtype
    if kind == "asr_unidirectional":
        config.pretraining_type = 2
        model = model.pretrained_model
    return model, config


@pytest.mark.parametrize("kind", ["seq2seq", "unidirectional", "asr_unidirectional"])
def test_the_trainer_takes_bf16_for_every_model_kind(tmp_path, kind):
    """A seq2seq model (K4f and K4b at bf16) or one with unidirectional
    layers (K5f and K5b), fixed-slot or ASR, at the flagship's widths: a
    bf16 ``Trainer(...)`` takes a CPU train step and a test pass on 0.25 s,
    B = 2. From equal weights on the same batch its losses are finite,
    differ from the f32 Trainer's (bf16 acts) and lie within 1e-2 relative
    of them; its parameters stay f32 and move. The loss functions take
    ``compute_dtype=BF16`` and return f32 losses."""
    rng = np.random.default_rng(4)
    model, _ = _flagship_of(kind, str(tmp_path / "probe"), "float32")
    x = (0.1 * rng.standard_normal((2, 4000))).astype(np.float32)
    batch = {"x": x, "w": np.ones(2, np.float32), "len": np.full(2, 4000)}
    if kind == "seq2seq":
        L = len(model.Sy_intent)
        batch.update(y_intent=np.eye(L, dtype=np.float32)[rng.integers(1, L, (2, 5))], y_len=np.array([5, 3]))
    elif kind == "unidirectional":
        batch["y_intent"] = np.stack([rng.integers(0, v, 2) for v in model.values_per_slot], 1)
    else:
        t_p, t_w = int(model.arch.num_frames(4000, upto="phoneme")), int(model.arch.num_frames(4000))
        batch.update(y_phoneme=rng.integers(-1, 42, (2, t_p)),
                     y_word=rng.integers(-1, model.arch.vocabulary_size, (2, t_w)))
    losses = {}
    for dtype in ("float32", "bfloat16"):
        model, config = _flagship_of(kind, str(tmp_path / dtype), dtype)
        trainer = Trainer(model, config)
        assert trainer.compute_dtype == (BF16 if dtype == "bfloat16" else None)
        before = copy.deepcopy(model.state_dict())
        losses[dtype] = (trainer.train(_Data([copy.deepcopy(batch)]))[1],
                         trainer.test(_Data([copy.deepcopy(batch)]))[1])
        after = model.state_dict()
        assert all(t.dtype == torch.float32 for t in after.values())
        assert any(not torch.equal(before[k], after[k]) for k in after)
    for a, b in zip(losses["float32"], losses["bfloat16"]):
        assert np.isfinite(b) and a != b and abs(a - b) <= 1e-2 * abs(a), (a, b)
    xt = torch.from_numpy(x)
    if kind == "asr_unidirectional":
        out = encoder_loss(model, xt, torch.from_numpy(batch["y_phoneme"]), torch.from_numpy(batch["y_word"]),
                           compute_dtype=BF16)
    else:
        y = torch.from_numpy(batch["y_intent"])
        out = model.loss(xt, y if kind == "seq2seq" else y.long(), train=False, compute_dtype=BF16)[:1]
    assert all(v.dtype == torch.float32 and torch.isfinite(v) for v in out)
