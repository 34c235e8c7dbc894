"""The PyTorch port's seq2seq decode vs the JAX package on shared weights.

The pieces (``params_from_jax``, attention, the decoder step) and the plain
beam search (K7's plain version) are held against the JAX functions, the
search also against the TPU kernel itself (``beam_decode_pallas`` in
interpret mode), at the small shapes of ``tests/test_pallas_beam.py``. A
small seq2seq model with JAX weights decodes through both packages, and the
committed golden seq2seq checkpoint decodes exactly through the port, also
through its server, HTTP front and CLI.
"""

import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_config
from tpu_slu.models import slu as jslu
from tpu_slu.models.slu import init_seq2seq_params
from tpu_slu.models.torch_import import export_model_state_dict
from tpu_slu.ops import attention as jatt
from tpu_slu.ops.beam import beam_search as jax_beam_search
from tpu_slu.ops.pallas_beam import beam_decode_pallas
from tpu_slu_torch import read_config
from tpu_slu_torch.data.audio import read_wav
from tpu_slu_torch.models.convert import params_from_jax
from tpu_slu_torch.models.flagship import SEQ2SEQ_LABELS, flagship_seq2seq_model
from tpu_slu_torch.models.slu import Model, Seq2SeqArch, Seq2SeqDecoder
from tpu_slu_torch.ops.attention import attend_kv, attention_kv
from tpu_slu_torch.ops.beam import beam_search, beam_search_reference, decoder_step
from tpu_slu_torch.ops.beam_fused import beam_decode
from tpu_slu_torch.serving import IntentServer, load_trained_model, make_http_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "assets", "golden_seq2seq")
with open(os.path.join(GOLDEN, "expected.json")) as _f:
    META = json.load(_f)
TOL = 1e-5  # f32, sums in another order


def port_decoder(jdec, jarch) -> Seq2SeqDecoder:
    """A port decoder holding the JAX decoder's weights."""
    dec = Seq2SeqDecoder(Seq2SeqArch(**dataclasses.asdict(jarch)), torch.Generator().manual_seed(0))
    state = params_from_jax({"decoder": jax.tree.map(np.asarray, jdec)})
    dec.load_state_dict({k.removeprefix("decoder."): v for k, v in state.items()}, strict=True)
    return dec.eval()


def setup(seed, Bs, T, U, nl=2, L=11, H=8, Kd=4, Vd=8, enc_dim=3):
    """The shapes of tests/test_pallas_beam.py: a JAX decoder, its port, and
    seeded keys/values (numpy) from the JAX attention projections."""
    arch = jslu.Seq2SeqArch(num_labels=L, num_encoder_layers=1, encoder_dim=enc_dim,
                            num_decoder_layers=nl, decoder_dim=H, key_dim=Kd, value_dim=Vd,
                            sos=0, max_decode_len=U)
    jdec = init_seq2seq_params(jax.random.PRNGKey(seed), arch, 2 * enc_dim)["decoder"]
    enc_out = np.random.default_rng(seed).standard_normal((Bs, T, 2 * enc_dim)).astype(np.float32)
    keys, values = jatt.attention_kv(jdec["attention"], jnp.asarray(enc_out))
    return arch, jdec, port_decoder(jdec, arch), np.array(keys), np.array(values)


def jax_scan_beam(jdec, arch, keys, values, W, U, enc_mask=None):
    Bs = keys.shape[0]
    state0 = jnp.broadcast_to(jdec["initial_state"][None], (Bs,) + jdec["initial_state"].shape)

    def step_fn(state, y_prev):
        return jslu._decoder_step(jdec, arch, (jnp.asarray(keys), jnp.asarray(values)), state,
                                  y_prev, train=False, enc_mask=enc_mask)

    return jax_beam_search(step_fn, state0, Bs, arch.num_labels, U, W)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_attention_matches_jax(masked):
    arch, jdec, dec, _, _ = setup(0, 3, 7, 4, Kd=5, Vd=6, enc_dim=4)
    rng = np.random.default_rng(1)
    enc_out = rng.standard_normal((3, 7, 8)).astype(np.float32)
    state = rng.standard_normal((3, 8)).astype(np.float32)
    mask = np.arange(7)[None, :] < np.array([7, 1, 4])[:, None] if masked else None
    jk, jv = jatt.attention_kv(jdec["attention"], jnp.asarray(enc_out))
    ref = jatt.attend_kv(jdec["attention"], jk, jv, jnp.asarray(state),
                         mask=None if mask is None else jnp.asarray(mask))
    with torch.inference_mode():
        k, v = attention_kv(dec.attention, torch.from_numpy(enc_out))
        got = attend_kv(dec.attention, k, v, torch.from_numpy(state),
                        mask=None if mask is None else torch.from_numpy(mask))
    for g, r in ((k, jk), (v, jv), (got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nl", [1, 2])
@pytest.mark.parametrize("prev", ["zeros", "one_hot"])
def test_decoder_step_matches_jax(nl, prev):
    Bs, T = 4, 6
    arch, jdec, dec, keys, values = setup(2, Bs, T, 4, nl=nl)
    rng = np.random.default_rng(3)
    state = rng.standard_normal((Bs, nl, arch.decoder_dim)).astype(np.float32)
    y = np.zeros((Bs, arch.num_labels), np.float32)
    if prev == "one_hot":
        y[np.arange(Bs), rng.integers(0, arch.num_labels, Bs)] = 1.0
    mask = np.arange(T)[None, :] < np.array([6, 2, 1, 5])[:, None]
    ref_state, ref_lp = jslu._decoder_step(jdec, arch, (jnp.asarray(keys), jnp.asarray(values)),
                                           jnp.asarray(state), jnp.asarray(y), enc_mask=jnp.asarray(mask))
    with torch.inference_mode():
        got_state, got_lp = decoder_step(dec, torch.from_numpy(keys), torch.from_numpy(values),
                                         torch.from_numpy(state), torch.from_numpy(y),
                                         mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got_state.numpy(), np.asarray(ref_state), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(ref_lp), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the plain beam search (K7's plain version)
# ---------------------------------------------------------------------------


BEAM_CASES = [  # seed, Bs, T, W, U, nl, masked
    (0, 5, 6, 3, 10, 2, False), (1, 8, 6, 4, 10, 2, False), (2, 3, 6, 2, 10, 2, False),
    (3, 4, 7, 3, 8, 2, True), (4, 5, 4, 4, 6, 1, False), (5, 4, 8, 1, 12, 1, True),
    (6, 2, 5, 4, 12, 2, True),
    (7, 17, 6, 4, 8, 2, True),  # ragged valid frames past 16 rows: K7's clusters of 4 on the card
    (8, 33, 6, 10, 6, 2, True),  # a wide beam over ragged frames past 32 rows: K7's smallest clusters
]


@pytest.mark.parametrize("seed,Bs,T,W,U,nl,masked", BEAM_CASES)
@pytest.mark.parametrize("against", ["scan", "pallas"])
def test_beam_search_reference_matches_jax(seed, Bs, T, W, U, nl, masked, against):
    """Against the JAX scan beam (ops/beam.py over _decoder_step) and the TPU
    kernel itself (beam_decode_pallas, interpret mode)."""
    arch, jdec, dec, keys, values = setup(seed, Bs, T, U, nl=nl)
    n_valid = np.random.default_rng(seed).integers(1, T + 1, Bs) if masked else None
    enc_mask = None if n_valid is None else jnp.asarray(np.arange(T)[None, :] < n_valid[:, None])
    if against == "scan":
        ref_scores, ref_tokens = jax_scan_beam(jdec, arch, keys, values, W, U, enc_mask)
    else:
        ref_scores, ref_tokens = beam_decode_pallas(jdec, arch, jnp.asarray(keys), jnp.asarray(values),
                                                    W, U, enc_mask=enc_mask, interpret=True)
    with torch.inference_mode():
        scores, tokens = beam_search_reference(
            dec, torch.from_numpy(keys), torch.from_numpy(values),
            None if n_valid is None else torch.from_numpy(n_valid), W, U)
    assert scores.shape == (W, Bs) and tokens.shape == (W, Bs, U) and tokens.dtype == torch.int64
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), rtol=TOL, atol=TOL)


def test_beam_decode_on_the_cpu_is_the_plain_version():
    _, _, dec, keys, values = setup(7, 3, 5, 6)
    k, v, n = torch.from_numpy(keys), torch.from_numpy(values), torch.tensor([5, 1, 3])
    with torch.inference_mode():
        before = beam_decode.launches
        got = beam_decode(dec, k, v, n, 3, 6)
        ref = beam_search_reference(dec, k, v, n, 3, 6)
    assert beam_decode.launches == before
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("W", [2, 3, 4])
def test_beam_tie_order_is_lax_top_k_first_occurrence(W):
    """Exact ties across beams and tokens: the extension with the smaller
    beam * V + token index ranks first, as lax.top_k's does."""
    V, B, U = 6, 2, 5
    # log-probabilities with repeated values, the same for every beam and state
    table = np.log(np.array([[2, 2, 1, 1, 3, 3], [2, 2, 2, 2, 2, 2]], np.float32) / 12.0)

    def jstep(state, y_prev):
        return state, jnp.asarray(table)[state[:, 0]]

    def tstep(state, y_prev):
        return state, torch.from_numpy(table)[state[:, 0]]

    init = np.array([[0], [1]], np.int32)
    ref_scores, ref_tokens = jax_beam_search(jstep, jnp.asarray(init), B, V, U, W)
    scores, tokens = beam_search(tstep, torch.from_numpy(init).long(), B, V, U, W)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(ref_scores))
    assert len(set(tokens[:, 1].flatten().tolist())) > 1  # the tied row took several tokens


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def small_seq2seq_config(tmp):
    config = _make_config(tmp, small=True)
    config.seq2seq = True
    config.Sy_intent = ["<sos>"] + list("abcdeklmu ") + ["<eos>"]
    config.intent_encoder_dim = 8
    config.num_intent_encoder_layers = 1
    config.intent_decoder_dim = 12
    config.num_intent_decoder_layers = 2
    config.intent_decoder_key_dim = 6
    config.intent_decoder_value_dim = 10
    config.seq2seq_max_decode_len = 9
    return config


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(config, JAX Model, port Model) sharing the JAX model's weights."""
    config = small_seq2seq_config(str(tmp_path_factory.mktemp("s2s")))
    jmodel = jslu.Model(config, seed=4)
    tmodel = Model(config)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)), strict=True)
    return config, jmodel, tmodel.eval()


def test_params_from_jax_seq2seq_equals_the_export(pair):
    config, jmodel, tmodel = pair
    from_tree = params_from_jax(jax.tree.map(np.asarray, jmodel.params))
    exported = export_model_state_dict(jmodel.params, jmodel.encoder_arch,
                                       seq2seq_arch=jmodel.seq2seq_arch)
    assert set(from_tree) == set(exported) == set(tmodel.state_dict())
    for k, v in exported.items():
        torch.testing.assert_close(from_tree[k], v, rtol=0, atol=0, msg=k)
    other = Model(config, seed=9)
    other.load_state_dict(exported, strict=True)
    for k, v in other.state_dict().items():
        torch.testing.assert_close(v, tmodel.state_dict()[k], rtol=0, atol=0, msg=k)
    emb = np.asarray(jmodel.params["decoder"]["embed"]["w"])  # (L, H) -> torch (H, L)
    np.testing.assert_array_equal(from_tree["decoder.embed.weight"], emb.T)
    cell = np.asarray(jmodel.params["decoder"]["rnn"]["2"]["w_ih"])
    np.testing.assert_array_equal(from_tree["decoder.rnn.layers.2.weight_ih"], cell.T)
    np.testing.assert_array_equal(from_tree["decoder.initial_state"],
                                  np.asarray(jmodel.params["decoder"]["initial_state"]))


@pytest.mark.parametrize("mode", ["exact", "lengths", "bucket"])
@pytest.mark.parametrize("beam_width", [1, 4])
def test_predict_intents_matches_jax(pair, mode, beam_width):
    _, jmodel, tmodel = pair
    rng = np.random.default_rng(5)
    if mode == "lengths":
        n = np.array([8000, 3100, 5555])
        x = np.zeros((3, 8000), np.float32)
        for i, t in enumerate(n):
            x[i, :t] = rng.standard_normal(t)
        kw = {"lengths": n}
    else:
        x = rng.standard_normal((2, 4321)).astype(np.float32)
        kw = {"bucket": True} if mode == "bucket" else {}
    ref_scores, ref_tokens = jmodel.predict_intents(x, beam_width=beam_width, **kw)
    scores, tokens = tmodel.predict_intents(x, beam_width=beam_width, **kw)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), rtol=TOL, atol=TOL)
    assert tmodel.decode_intents(x, **kw) == jmodel.decode_intents(x, **kw)


def test_length_exact_rows_equal_their_example_alone(pair):
    tmodel = pair[2]
    rng = np.random.default_rng(6)
    waves = [rng.standard_normal(t).astype(np.float32) for t in (6000, 2345, 1)]
    x = np.zeros((4, 6000), np.float32)
    for i, w in enumerate(waves):
        x[i, :len(w)] = w
    scores, tokens = tmodel.predict_intents(x, lengths=[6000, 2345, 1, 0])
    for i, w in enumerate(waves):
        alone_scores, alone_tokens = tmodel.predict_intents(w)
        torch.testing.assert_close(tokens[:, i], alone_tokens[:, 0], rtol=0, atol=0)
        torch.testing.assert_close(scores[:, i], alone_scores[:, 0], rtol=TOL, atol=TOL)
    assert torch.isfinite(scores[:, 3]).all()  # a batch-fill row of length 0


def test_ids_to_string_strips_by_character_set():
    S = SEQ2SEQ_LABELS
    ids = [S.index(c) for c in "ok seen"] + [S.index("<eos>")] * 3
    assert Model.ids_to_string(ids, S) == jslu.Model.ids_to_string(ids, S) == "k seen"
    assert Model.ids_to_string([0, S.index("s"), S.index("a")], S) == "a"


def test_flagship_seq2seq_model_has_the_reference_layout():
    tmodel = flagship_seq2seq_model("cpu")
    jmodel = jslu.Model(copy.deepcopy(tmodel.config), seed=0, load_pretrained=False)
    exported = export_model_state_dict(jmodel.params, jmodel.encoder_arch,
                                       seq2seq_arch=jmodel.seq2seq_arch)
    state = tmodel.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {k: tuple(v.shape) for k, v in exported.items()}
    arch = tmodel.seq2seq_arch
    assert (arch.encoder_dim, arch.decoder_dim, arch.num_decoder_layers, arch.key_dim, arch.value_dim,
            arch.num_labels, arch.max_decode_len) == (128, 256, 2, 100, 200, 102, 200)
    with open(os.path.join(GOLDEN, "vocab.json")) as f:
        assert json.load(f)["Sy_intent"] == SEQ2SEQ_LABELS


# ---------------------------------------------------------------------------
# the golden seq2seq checkpoint: model, server, HTTP, CLI
# ---------------------------------------------------------------------------


def golden_cfg(tmp) -> str:
    folder = os.path.join(tmp, "exp")
    with open(os.path.join(GOLDEN, "experiment.cfg.template")) as f:
        template = f.read()
    path = os.path.join(tmp, "exp.cfg")
    with open(path, "w") as f:
        f.write(template.replace("__GOLDEN_FOLDER__", folder))
    os.makedirs(os.path.join(folder, "training"), exist_ok=True)
    for name in ("model_state.npz", "vocab.json"):
        shutil.copyfile(os.path.join(GOLDEN, name), os.path.join(folder, "training", name))
    return path


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    return golden_cfg(str(tmp_path_factory.mktemp("golden_s2s")))


@pytest.fixture(scope="module")
def golden(cfg_path):
    config = read_config(cfg_path, make_dirs=False)
    config.seq2seq_max_decode_len = META["max_decode_len"]
    return load_trained_model(config, device="cpu")


def golden_wav(case):
    wav, fs = read_wav(os.path.join(GOLDEN, case["wav"]))
    assert fs == 16000
    return wav


@pytest.mark.parametrize("case", META["expected"], ids=lambda c: c["wav"])
def test_golden_decode_seq2seq(golden, case):
    assert golden.decode_intents(golden_wav(case)[None, :])[0] == case["semantics"]


def test_golden_server_answers_as_direct_decodes(golden):
    waves = [golden_wav(c) for c in META["expected"]]
    server = IntentServer(golden, max_batch=4, batch_window_ms=50)
    try:
        got = [f.result(timeout=120) for f in [server.submit(w) for w in waves]]
    finally:
        server.close()
    assert got == [golden.decode_intents(w)[0] for w in waves] == [c["semantics"] for c in META["expected"]]
    assert max(server.batch_sizes) > 1


def test_golden_http_answers_the_string(golden):
    server = IntentServer(golden, max_batch=2)
    httpd = make_http_server(server, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        case = META["expected"][3]
        with open(os.path.join(GOLDEN, case["wav"]), "rb") as f:
            req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/decode", data=f.read())
        with urllib.request.urlopen(req, timeout=120) as r:
            assert json.loads(r.read())["intents"] == case["semantics"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()


def test_cli_decode_prints_the_string(cfg_path):
    """The CLI decodes at the config's max_decode_len (200 steps): its line
    is the in-process decode at that length."""
    case = META["expected"][0]
    out = subprocess.run(
        [sys.executable, "-m", "tpu_slu_torch.cli", "--decode", "--wav", os.path.join(GOLDEN, case["wav"]),
         "--config_path", cfg_path, "--device", "cpu"],
        cwd=REPO, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        capture_output=True, text=True, timeout=300, check=True).stdout
    model = load_trained_model(read_config(cfg_path, make_dirs=False), device="cpu")
    assert out.strip().splitlines()[-1] == model.decode_intents(golden_wav(case)[None, :])[0]
