"""The PyTorch port's decode slice vs the JAX package on shared weights.

A small fixed-slot model (``__graft_entry__._make_config(small=True)`` widths)
is built in JAX, its params are carried into the port with
``params_from_jax``, and the same seeded waveforms go through both: the JAX
side runs the Pallas chain in interpret mode on the CPU. The committed
golden checkpoint must decode exactly through the port.
"""

import copy
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_config
from tpu_slu.models import encoder as jenc
from tpu_slu.models import slu as jslu
from tpu_slu.models.torch_import import export_model_state_dict
from tpu_slu_torch import read_config
from tpu_slu_torch.data.audio import read_wav
from tpu_slu_torch.models.convert import params_from_jax, read_npz
from tpu_slu_torch.models.encoder import encoder_features
from tpu_slu_torch.models.flagship import flagship_model
from tpu_slu_torch.models.slu import Model, intent_logits
from tpu_slu_torch.serving import load_trained_model

RTOL, ATOL = 1e-4, 1e-5  # five GRU layers of f32 sums in another order
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "golden")


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


def wave(rng, B, T):
    return rng.standard_normal((B, T)).astype(np.float32)


@pytest.mark.parametrize("B,T", [(2, 4000), (1, 3333)])
def test_encoder_features_match_jax(pair, interpret, rng, B, T):
    _, jmodel, tmodel = pair
    x = wave(rng, B, T)
    ref = jenc.encoder_features(jmodel.params["pretrained_model"], jmodel.encoder_arch,
                                jnp.asarray(x), gru_impl="pallas")
    with torch.inference_mode():
        got = encoder_features(tmodel.pretrained_model, torch.from_numpy(x))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_intent_logits_match_jax(pair, interpret, rng):
    _, jmodel, tmodel = pair
    feats = rng.standard_normal((2, 9, tmodel.encoder_arch.word_feat_dim)).astype(np.float32)
    ref = jslu.intent_logits(jmodel.params["intent_layers"], jmodel.intent_arch,
                             jnp.asarray(feats), gru_impl="pallas")
    with torch.inference_mode():
        got = intent_logits(tmodel.intent_layers, tmodel.intent_arch, torch.from_numpy(feats))
    assert got.shape == ref.shape == (2, sum(tmodel.values_per_slot))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,T", [(3, 4000), (1, 2501)])
def test_predict_intents_matches_jax(pair, interpret, rng, B, T):
    _, jmodel, tmodel = pair
    x = wave(rng, B, T)
    ref_logits, ref_preds = jmodel.predict_intents(x)
    logits, preds = tmodel.predict_intents(x)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(ref_preds))
    assert tmodel.decode_intents(x) == jmodel.decode_intents(x)


def test_length_exact_path_is_not_ported(pair):
    tmodel = pair[2]
    with pytest.raises(NotImplementedError):
        tmodel.predict_intents(np.zeros((1, 4000), np.float32), lengths=[4000])
    with pytest.raises(NotImplementedError):
        tmodel.predict_intents(np.zeros((1, 4000), np.float32), bucket=True)


def test_params_from_jax_tree_and_export_agree(pair):
    """The nested pytree and the reference-layout export load to the same weights."""
    config, jmodel, tmodel = pair
    from_tree = params_from_jax(jax.tree.map(np.asarray, jmodel.params))
    exported = export_model_state_dict(jmodel.params, jmodel.encoder_arch, jmodel.intent_arch)
    assert set(from_tree) == set(exported) == set(tmodel.state_dict())
    for k, v in exported.items():
        torch.testing.assert_close(from_tree[k], v, rtol=0, atol=0, msg=k)
    other = Model(config, seed=11)
    other.load_state_dict(exported, strict=True)
    for k, v in other.state_dict().items():
        torch.testing.assert_close(v, tmodel.state_dict()[k], rtol=0, atol=0, msg=k)
    # layouts: GRU and Linear transposed, conv as is
    w = np.asarray(jmodel.params["pretrained_model"]["phoneme_layers"]["10"]["bwd"]["w_ih"])
    np.testing.assert_array_equal(from_tree["pretrained_model.phoneme_layers.10.weight_ih_l0_reverse"], w.T)
    lin = np.asarray(jmodel.params["intent_layers"]["4"]["w"])
    np.testing.assert_array_equal(from_tree["intent_layers.4.weight"], lin.T)
    conv = np.asarray(jmodel.params["pretrained_model"]["phoneme_layers"]["5"]["w"])
    np.testing.assert_array_equal(from_tree["pretrained_model.phoneme_layers.5.weight"], conv)


def test_flagship_model_has_the_reference_layout():
    """The random-weight flagship has the JAX model's keys and shapes at that cfg."""
    tmodel = flagship_model()
    jmodel = jslu.Model(copy.deepcopy(tmodel.config), seed=0, load_pretrained=False)
    exported = export_model_state_dict(jmodel.params, jmodel.encoder_arch, jmodel.intent_arch)
    state = tmodel.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {k: tuple(v.shape) for k, v in exported.items()}
    assert tuple(tmodel.values_per_slot) == (6, 14, 4)
    assert state["pretrained_model.phoneme_layers.0.filt_b1"].shape == (80,)
    assert state["intent_layers.0.weight_hh_l0"].shape == (3 * 128, 128)


def test_params_from_jax_flat_npz():
    flat = read_npz(os.path.join(GOLDEN, "model_state.npz"))
    assert all("/" in k for k in flat)
    state = params_from_jax(flat)
    assert len(state) == len(flat)
    np.testing.assert_array_equal(state["pretrained_model.word_layers.4.weight_hh_l0"],
                                  flat["pretrained_model/word_layers/4/fwd/w_hh"].T)
    np.testing.assert_array_equal(state["pretrained_model.phoneme_layers.0.filt_band"],
                                  flat["pretrained_model/phoneme_layers/0/filt_band"])


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_is_strict(pair, fault):
    config, jmodel, _ = pair
    state = params_from_jax(jax.tree.map(np.asarray, jmodel.params))
    if fault == "missing":
        state.pop("intent_layers.0.bias_hh_l0")
    elif fault == "extra":
        state["intent_layers.9.weight"] = torch.zeros(2, 2)
    else:
        state["intent_layers.4.bias"] = torch.zeros(3)
    with pytest.raises(RuntimeError):
        Model(config).load_state_dict(state, strict=True)


def test_unknown_jax_leaf_raises():
    with pytest.raises(KeyError):
        params_from_jax({"decoder": {"initial_state": np.zeros((1, 4), np.float32)}})


@pytest.mark.parametrize("present", [True, False])
def test_model_loads_pretrained_encoder(pair, tmp_path, present):
    """pretraining_type != 0: the encoder comes from <folder>/pretraining/model_state.npz."""
    from tpu_slu.training.checkpoint import save_pytree

    config, jmodel, tmodel = pair
    cfg = copy.copy(config)
    cfg.folder, cfg.pretraining_type = str(tmp_path), 2
    os.makedirs(tmp_path / "pretraining")
    if not present:
        with pytest.raises(FileNotFoundError):
            Model(cfg)
        return
    save_pytree(str(tmp_path / "pretraining" / "model_state.npz"), jmodel.params["pretrained_model"])
    want = tmodel.pretrained_model.state_dict()
    for k, v in Model(cfg, seed=5).pretrained_model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


def _golden_folder(tmp_path_factory, name="golden"):
    tmp = tmp_path_factory.mktemp(name)
    folder = str(tmp / "exp")
    with open(os.path.join(GOLDEN, "experiment.cfg.template")) as f:
        template = f.read()
    cfg_path = str(tmp / "exp.cfg")
    with open(cfg_path, "w") as f:
        f.write(template.replace("__GOLDEN_FOLDER__", folder))
    config = read_config(cfg_path)
    shutil.copyfile(os.path.join(GOLDEN, "vocab.json"), os.path.join(folder, "training", "vocab.json"))
    return config, folder


@pytest.fixture(scope="module")
def golden_model(tmp_path_factory):
    config, folder = _golden_folder(tmp_path_factory)
    shutil.copyfile(os.path.join(GOLDEN, "model_state.npz"),
                    os.path.join(folder, "training", "model_state.npz"))
    return load_trained_model(config)


def _golden_cases():
    with open(os.path.join(GOLDEN, "expected.json")) as f:
        return json.load(f)["expected"]


@pytest.mark.parametrize("case", _golden_cases(), ids=lambda c: c["wav"])
def test_golden_decode_slots(golden_model, case):
    wav, fs = read_wav(os.path.join(GOLDEN, case["wav"]))
    assert fs == 16000
    assert golden_model.decode_intents(wav[None, :])[0] == [case["action"], case["object"], case["location"]]


def test_golden_loads_from_reference_pth(golden_model, tmp_path_factory):
    """A reference-layout ``model_state.pth`` loads like the ``.npz``."""
    config, folder = _golden_folder(tmp_path_factory, "golden_pth")
    torch.save(golden_model.state_dict(), os.path.join(folder, "training", "model_state.pth"))
    model = load_trained_model(config)
    wav, _ = read_wav(os.path.join(GOLDEN, _golden_cases()[0]["wav"]))
    torch.testing.assert_close(model.predict_intents(wav)[0], golden_model.predict_intents(wav)[0],
                               rtol=0, atol=0)
