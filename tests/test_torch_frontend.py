"""K8, the fused sinc front end of the PyTorch port, vs the JAX package.

On the CPU the port's wrapper runs its plain version (the composition
``sinc_conv`` -> abs -> ceil max pool -> act, channels-last); it is held
against JAX ``sinc_frontend_fused`` (the Pallas kernel in interpret mode on
the CPU) at the JAX package's own test shapes, with gradients, and the
encoder's fused route against JAX's ``TPU_SLU_FUSED_FRONTEND=1`` route. The
CUDA kernel itself is held against the plain version on the card in
``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import fixtures
from tpu_slu import read_config as jax_read_config
from tpu_slu.models import encoder as jenc
from tpu_slu.ops import pallas_frontend
from tpu_slu.ops.sinc import mel_init
from tpu_slu_torch import read_config
from tpu_slu_torch.models import encoder as tenc
from tpu_slu_torch.models.convert import params_from_jax
from tpu_slu_torch.ops.frontend_fused import sinc_frontend_fused, sinc_frontend_reference

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # sums over every sample, another order
FEAT_RTOL, FEAT_ATOL = 1e-4, 1e-5  # the encoder's five f32 stages after it
# tests/test_pallas_shared.py's shapes: 16 filters of 31 taps at stride 10
KW = dict(filt_dim=31, fs=16000, stride=10, padding=15, pool=2)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("TPU_SLU_PALLAS_INTERPRET", "1")


@pytest.fixture
def jax_kernel_calls(monkeypatch):
    """Counts the JAX side's builds of the TPU kernel body (`_mk_kernel`)."""
    calls = []
    real = pallas_frontend._mk_kernel

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(pallas_frontend, "_mk_kernel", spy)
    return calls


def filters():
    b1, band = mel_init(16, 16000)
    return b1, band


@pytest.mark.parametrize("T", [1600, 1555])  # 1555: a ragged last pooling window
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("act", ["leaky_relu", "relu"])
def test_plain_k8_matches_jax(interpret, jax_kernel_calls, rng, B, T, act):
    b1, band = filters()
    x = rng.standard_normal((B, T)).astype(np.float32)
    ref = pallas_frontend.sinc_frontend_fused(jnp.asarray(b1), jnp.asarray(band), jnp.asarray(x),
                                              act=act, **KW)
    assert jax_kernel_calls, "the JAX side did not reach its TPU kernel"
    before = sinc_frontend_fused.launches
    got = sinc_frontend_fused(torch.from_numpy(b1), torch.from_numpy(band), torch.from_numpy(x),
                              act=act, **KW)
    assert sinc_frontend_fused.launches == before  # CPU tensors never launch the kernel
    t_out = (T + 2 * KW["padding"] - KW["filt_dim"]) // KW["stride"] + 1
    assert got.shape == ref.shape == (B, -(-t_out // KW["pool"]), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_plain_k8_is_the_composition(rng):
    """The plain version is JAX's `_xla_reference` composition, op for op."""
    b1, band = filters()
    x = rng.standard_normal((2, 1600)).astype(np.float32)
    ref = pallas_frontend._xla_reference(jnp.asarray(b1), jnp.asarray(band), jnp.asarray(x),
                                         KW["filt_dim"], KW["fs"], KW["stride"], KW["padding"],
                                         KW["pool"], "leaky_relu")
    got = sinc_frontend_reference(torch.from_numpy(b1), torch.from_numpy(band), torch.from_numpy(x), **KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("T", [1600, 1555])
def test_k8_gradients_match_jax(interpret, rng, T):
    """The backward recomputes through the plain composition, as JAX's custom VJP does."""
    b1, band = filters()
    x = rng.standard_normal((2, T)).astype(np.float32)
    out_shape = pallas_frontend.sinc_frontend_fused(jnp.asarray(b1), jnp.asarray(band),
                                                    jnp.asarray(x), **KW).shape
    wout = rng.standard_normal(out_shape).astype(np.float32)

    def loss(b1_, band_, x_):
        return jnp.sum(pallas_frontend.sinc_frontend_fused(b1_, band_, x_, **KW) * wout)

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(b1), jnp.asarray(band), jnp.asarray(x))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (b1, band, x)]
    (sinc_frontend_fused(*leaves, **KW) * torch.from_numpy(wout)).sum().backward()
    for name, leaf, r in zip(("filt_b1", "filt_band", "x"), leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_k8_gradient_of_one_input(rng):
    """Only the inputs that require grad get one."""
    b1, band = filters()
    x = torch.from_numpy(rng.standard_normal((1, 1600)).astype(np.float32)).requires_grad_()
    sinc_frontend_fused(torch.from_numpy(b1), torch.from_numpy(band), x, **KW).sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("kwargs", [
    {"act": "tanh"}, {"pool": 0}, {"stride": 0}, {"padding": -1}, {"filt_dim": 4001},
], ids=["act", "pool", "stride", "padding", "too_short"])
def test_k8_rejects_bad_arguments(kwargs):
    b1, band = (torch.from_numpy(a) for a in filters())
    with pytest.raises(ValueError):
        sinc_frontend_fused(b1, band, torch.zeros(1, 1600), **{**KW, **kwargs})
    with pytest.raises(ValueError):  # a (B, 1, T) input is the conv layout, not K8's
        sinc_frontend_fused(b1, band, torch.zeros(1, 1, 1600), **KW)


@pytest.fixture(scope="module")
def encoder_pair(tmp_path_factory):
    """(JAX params, JAX arch, port PretrainedModel) on the JAX package's
    fused-front-end fixture cfg (`test_pallas_shared.py:456-477`)."""
    tmp = tmp_path_factory.mktemp("frontend")
    path = fixtures.write_cfg(str(tmp / "c.cfg"), folder=str(tmp / "exp"))
    jconfig = jax_read_config(path)
    jconfig.num_phonemes = 5
    arch = jenc.EncoderArch.from_config(jconfig)
    params = jenc.init_encoder_params(jax.random.PRNGKey(5), arch)
    config = read_config(path, make_dirs=False)
    config.num_phonemes = 5
    port = tenc.PretrainedModel(config)
    state = params_from_jax({"pretrained_model": jax.tree.map(np.asarray, params)})
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()}, strict=True)
    return params, arch, port.eval()


@pytest.mark.parametrize("frontend", tenc.FRONTENDS)
@pytest.mark.parametrize("B,T", [(2, 4000), (3, 3555)])
def test_encoder_features_fused_route_matches_jax(encoder_pair, interpret, jax_kernel_calls, monkeypatch,
                                                  rng, frontend, B, T):
    """The port's encoder through either front-end route against JAX's
    `encoder_features` with its fused front end on; the port's fused route
    calls K8's wrapper once, the composed route never."""
    params, arch, port = encoder_pair
    monkeypatch.setenv("TPU_SLU_FUSED_FRONTEND", "1")
    x = rng.standard_normal((B, T)).astype(np.float32)
    ref = np.asarray(jenc.encoder_features(params, arch, jnp.asarray(x), gru_impl="pallas"))
    assert jax_kernel_calls, "the JAX side did not take its fused front end"
    calls = []
    monkeypatch.setattr(tenc, "sinc_frontend_fused",
                        lambda *a, **k: calls.append(k) or sinc_frontend_fused(*a, **k))
    monkeypatch.setattr(port, "frontend", frontend)
    with torch.inference_mode():
        got = tenc.encoder_features(port, torch.from_numpy(x)).numpy()
    assert len(calls) == (frontend == "fused")
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=FEAT_RTOL, atol=FEAT_ATOL)


def test_fused_route_is_eval_only(encoder_pair, monkeypatch, rng):
    """Training and the length-exact branch keep the composed front end, as in JAX."""
    _, _, port = encoder_pair
    calls = []
    monkeypatch.setattr(tenc, "sinc_frontend_fused", lambda *a, **k: calls.append(k))
    monkeypatch.setattr(port, "frontend", "fused")
    x = torch.from_numpy(rng.standard_normal((2, 4000)).astype(np.float32))
    with torch.no_grad():
        tenc.encoder_features(port, x, lengths=torch.tensor([4000, 2500]))
        tenc.encoder_features(port, x, train=True, generator=torch.Generator().manual_seed(0))
    assert calls == []


@pytest.mark.parametrize("kwargs", [{"frontend": "cudnn"}, {"gru_layout": "stacked"}])
def test_routes_are_checked(encoder_pair, kwargs):
    _, _, port = encoder_pair
    with pytest.raises(ValueError):
        tenc.apply_stack(port.phoneme_layers, port.arch.phoneme_layers, torch.zeros(1, 1, 4000), **kwargs)
