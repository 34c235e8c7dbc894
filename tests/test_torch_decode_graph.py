"""The length-exact decode as CUDA graphs (``tpu_slu_torch/models/decode_graph.py``).

CPU tests: the CPU path never captures, the host check of the lengths, the
graph key, the cache's LRU bound, the wrappers' eager range checks, and the
reader of ``graph_replay_share.closed`` on synthetic spans. Card tests
(``cuda`` marker, skipped without a GPU): a replay equals the eager
length-exact path bit for bit for both heads, at several buckets and B = 1
and 16, on second calls too; one capture a key; returned tensors outlive the
next call; new parameter storage captures anew; a capture that raises
answers from the eager path. The file imports no jax, so that it runs on the
card machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decode_graph.py -q
"""

import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from slubench.cell import metric_reader
from slubench.trace import Trace
from tpu_slu_torch.models import slu
from tpu_slu_torch.models.decode_graph import CAPACITY, DecodeGraphs
from tpu_slu_torch.models.flagship import flagship_model, flagship_seq2seq_model
from tpu_slu_torch.ops.beam_fused import _check_cuda
from tpu_slu_torch.ops.bigru_masked import check_layer
from tpu_slu_torch.utils.profiling import kineto_base_ns

SECOND = 16000
U = 24  # search steps of the card tests' seq2seq model (the served config's 200 is its K7 time alone)


def waves(rng, B, t_pad, lengths):
    """(B, t_pad) waveforms, zeros past each row's length."""
    x = np.zeros((B, t_pad), np.float32)
    for i, n in enumerate(lengths):
        x[i, :n] = 0.1 * rng.standard_normal(n)
    return x


def mixed_lengths(rng, B, t_pad):
    """A server's batch: one full row, random rows, and rows of length 0."""
    if B == 1:
        return np.array([t_pad], np.int64)
    n = rng.integers(1, t_pad + 1, B)
    n[0] = t_pad
    n[B - 3:] = 0
    return n.astype(np.int64)


# -- CPU ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cpu_models():
    return {"seq2seq": flagship_seq2seq_model("cpu", seq2seq_max_decode_len=3), "slots": flagship_model("cpu")}


@pytest.mark.parametrize("head", ["seq2seq", "slots"])
def test_the_cpu_path_never_captures(cpu_models, head):
    model = cpu_models[head]
    rng = np.random.default_rng(0)
    n = np.array([8000, 3000, 0])
    model.predict_intents(waves(rng, 3, 8000, n), lengths=n)
    model.decode_intents(waves(rng, 3, 7000, [7000] * 3)[:, :6500], bucket=True)
    g = model.decode_graphs
    assert (g.captures, g.replays, g.fallbacks, g.keys()) == (0, 0, 0, [])


@pytest.mark.parametrize("bad", [[-1, 100], [100, 8001], [8001, 0]])
def test_lengths_outside_the_padded_batch_raise_before_any_device_work(cpu_models, monkeypatch, bad):
    model = cpu_models["seq2seq"]

    def no_device_work(*args, **kwargs):
        raise AssertionError("device work before the lengths' check")

    monkeypatch.setattr(slu, "encoder_features", no_device_work)
    with pytest.raises(ValueError, match="lengths must lie in"):
        model.predict_intents(np.zeros((2, 8000), np.float32), lengths=np.array(bad))
    with pytest.raises(ValueError, match="lengths must lie in"):
        model.predict_intents(np.zeros((2, 8000), np.float32), lengths=torch.tensor(bad))


def test_bucket_pads_before_the_lengths_check(cpu_models, monkeypatch):
    model = cpu_models["seq2seq"]
    seen = []
    monkeypatch.setattr(model, "_decode_exact", lambda x, n, w: seen.append((tuple(x.shape), n.tolist())))
    model.predict_intents(np.zeros((2, 7000), np.float32), bucket=True, lengths=[8000, 10])
    assert seen == [((2, 8000), [8000, 10])]
    with pytest.raises(ValueError, match=r"\[0, T=8000\]"):
        model.predict_intents(np.zeros((2, 7000), np.float32), bucket=True, lengths=[8001, 10])


def test_the_key_separates_head_batch_padded_length_beam_width_and_dtype(cpu_models):
    s2s, slots = cpu_models["seq2seq"], cpu_models["slots"]
    base = s2s._graph_key(16, 32000, 4)
    assert base == (s2s.seq2seq_arch, 16, 32000, 4, torch.float32, "highest")
    others = [s2s._graph_key(1, 32000, 4), s2s._graph_key(16, 40000, 4), s2s._graph_key(16, 32000, 1),
              slots._graph_key(16, 32000, 4)]
    assert len({base, *others}) == 5
    assert slots._graph_key(16, 32000, 4) == slots._graph_key(16, 32000, 1)  # no beam in the fixed-slot head
    wide = flagship_seq2seq_model("cpu", seq2seq_max_decode_len=3).double()
    assert wide._graph_key(16, 32000, 4)[4] == torch.float64
    longer = flagship_seq2seq_model("cpu", seq2seq_max_decode_len=4)  # another search length
    assert longer._graph_key(16, 32000, 4) != base
    torch.set_float32_matmul_precision("high")
    try:
        assert s2s._graph_key(16, 32000, 4) != base
    finally:
        torch.set_float32_matmul_precision("highest")


def test_the_cache_drops_the_least_recently_used_key():
    g = DecodeGraphs()
    for k in range(CAPACITY):
        g.put(k, k)
    assert g.get(0) == 0  # 1 is now the least recently used
    g.put("new", -1)
    assert len(g.keys()) == CAPACITY and g.get(1) is None and g.keys()[-1] == "new"
    g.put("newer", -2)
    assert g.keys()[:2] == [3, 4] and g.get(0) == 0 and g.get(2) is None


def test_a_copy_of_the_model_starts_with_no_graphs(cpu_models):
    import copy

    model = cpu_models["slots"]
    model.decode_graphs.put("k", threading.Lock())  # a graph's entry cannot be copied
    try:
        twin = copy.deepcopy(model)
        assert twin.decode_graphs is not model.decode_graphs
        assert twin.decode_graphs.keys() == [] and twin.decode_graphs.captures == 0
    finally:
        model.decode_graphs._graphs.clear()


def test_the_wrappers_eager_range_checks_still_raise():
    rng = np.random.default_rng(1)
    B, T, D, H = 3, 5, 8, 4
    params = {d: {"weight_ih": torch.zeros(3 * H, D), "weight_hh": torch.zeros(3 * H, H),
                  "bias_ih": torch.zeros(3 * H), "bias_hh": torch.zeros(3 * H)} for d in ("fwd", "bwd")}
    x = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32))
    assert check_layer("bigru_masked", params, x, torch.tensor([5, 0, 2])) == (B, T, D, H)
    for bad in ([6, 1, 1], [-1, 1, 1]):
        with pytest.raises(ValueError, match=r"lengths must lie in \[0, T=5\]"):
            check_layer("bigru_masked", params, x, torch.tensor(bad))
    with pytest.raises(ValueError, match=r"lengths must lie in \[0, T=5\]"):
        check_layer("gru1", {"fwd": params["fwd"]}, x, torch.tensor([1, 7, 1]))
    dec = flagship_seq2seq_model("cpu", seq2seq_max_decode_len=3).decoder
    keys, values = torch.zeros((2, 4, 100)), torch.zeros((2, 4, 200))
    assert _check_cuda(dec, keys, values, torch.tensor([1, 4]), 4, 3)["T"] == 4
    for bad in ([0, 4], [1, 5]):
        with pytest.raises(ValueError, match=r"valid frame counts must lie in \[1, T=4\]"):
            _check_cuda(dec, keys, values, torch.tensor(bad), 4, 3)


BASE = kineto_base_ns(time.time_ns())
OFF = 100.0


def sp(name, sid, parent, t0, t1):
    return SimpleNamespace(name=name, id=sid, parent=parent, thread=1, attrs={},
                           t0_ns=BASE + round((OFF + t0) * 1e9), t1_ns=BASE + round((OFF + t1) * 1e9))


def replay_ctx(spans):
    return {"trace": Trace([("k7", OFF + 0.1, OFF + 0.2)], [], (OFF, OFF + 1.0)), "spans": spans}


def test_graph_replay_share_reads_the_decodes_with_a_replay_child():
    read = metric_reader("graph_replay_share.closed").read
    spans = [
        # a decode begun before the window whose replay lies before it: counted, replayed
        sp("decode", 1, None, -0.10, 0.05), sp("decode.h2d", 2, 1, -0.10, -0.09), sp("decode.replay", 3, 1, -0.09, 0.0),
        sp("decode", 4, None, 0.10, 0.20), sp("decode.replay", 5, 4, 0.12, 0.18),
        sp("decode", 6, None, 0.30, 0.40), sp("decode.capture", 7, 6, 0.31, 0.39),
        sp("decode.frontend", 8, 7, 0.32, 0.33),  # the capture's own: not a decode's route
        sp("decode", 9, None, 0.50, 0.60), sp("decode.frontend", 10, 9, 0.52, 0.55),  # eager
        sp("decode", 11, None, 0.70, 0.80), sp("decode.h2d", 12, 11, 0.70, 0.71),  # no route recorded: left out
        sp("decode", 13, None, 1.20, 1.30), sp("decode.replay", 14, 13, 1.21, 1.29),  # past the window
    ]
    assert read(replay_ctx(spans)) == pytest.approx(50.0)
    assert read(replay_ctx([s for s in spans if s.id in (4, 5)])) == pytest.approx(100.0)
    assert read(replay_ctx([s for s in spans if s.id in (11, 12)])) is None
    assert read({"trace": None, "spans": spans}) is None
    idle = replay_ctx(spans)
    idle["trace"] = Trace([], [], (OFF, OFF + 1.0))  # no device operation: the CPU's run
    assert read(idle) is None


def test_graph_replay_share_reads_nothing_from_a_program_without_graphs(monkeypatch):
    read = metric_reader("graph_replay_share.closed").read
    spans = [sp("decode", 1, None, 0.10, 0.20), sp("decode.frontend", 2, 1, 0.11, 0.19)]
    assert read(replay_ctx(spans)) == pytest.approx(0.0)
    monkeypatch.setitem(sys.modules, "tpu_slu_torch.models.decode_graph", None)
    assert read(replay_ctx(spans)) is None


# -- card -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def card_models(dev):
    return {"seq2seq": lambda: flagship_seq2seq_model(dev, seq2seq_max_decode_len=U),
            "slots": lambda: flagship_model(dev)}


@torch.inference_mode()
def eager(model, x, n, W=4):
    """The eager length-exact decode of the same padded batch."""
    dev = model.device
    return model._decode_exact(torch.from_numpy(x).to(dev), torch.from_numpy(n).to(dev), W)


def assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), f"max difference {(g.double() - w.double()).abs().max().item()}"


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["seq2seq", "slots"])
@pytest.mark.parametrize("B", [1, 16])
def test_a_replay_equals_the_eager_decode_bit_for_bit(card_models, head, B):
    model = card_models[head]()
    rng = np.random.default_rng(100 + B)
    buckets = [SECOND, 5 * SECOND // 2, 4 * SECOND]
    held = []
    for t_pad in buckets:
        for _ in range(2):  # the capturing call, then a replay with other waveforms and lengths
            n = mixed_lengths(rng, B, t_pad)
            x = waves(rng, B, t_pad, n)
            got = model.predict_intents(x, lengths=n)
            assert_equal(got, eager(model, x, n))
            held.append((got, tuple(t.clone() for t in got)))
    g = model.decode_graphs
    assert (g.captures, g.replays, g.fallbacks) == (3, 6, 0)
    assert len(g.keys()) == len(buckets)
    for got, copy in held:  # no later call wrote into a tensor a caller holds
        assert_equal(got, copy)


@pytest.mark.cuda
def test_bucket_and_decode_intents_take_the_graph(card_models):
    model = card_models["seq2seq"]()
    rng = np.random.default_rng(7)
    x = 0.1 * rng.standard_normal((16, 30000)).astype(np.float32)
    first = model.decode_intents(x, bucket=True)
    again = model.decode_intents(x, bucket=True)
    padded = np.pad(x, ((0, 0), (0, 32000 - 30000)))
    want = eager(model, padded, np.full(16, 30000, np.int64))
    assert_equal(model.predict_intents(x, bucket=True), want)
    assert first == again == [model.ids_to_string(ids, model.Sy_intent) for ids in want[1][0].cpu().numpy()]
    assert model.decode_graphs.captures == 1 and model.decode_graphs.replays == 3


@pytest.mark.cuda
def test_in_place_updates_are_read_and_new_storage_captures_anew(card_models):
    model = card_models["seq2seq"]()
    rng = np.random.default_rng(3)
    n = mixed_lengths(rng, 16, 2 * SECOND)
    x = waves(rng, 16, 2 * SECOND, n)
    model.predict_intents(x, lengths=n)
    with torch.no_grad():  # in place: the graph reads the new values
        model.decoder.linear.weight.mul_(1.5)
        model.pretrained_model.phoneme_layers[0].filt_band.mul_(1.1)
    assert_equal(model.predict_intents(x, lengths=n), eager(model, x, n))
    assert model.decode_graphs.captures == 1
    p = model.encoder.layers[0].weight_hh_l0
    p.data = p.data.clone() * 0.5  # new storage: the old graph would read freed memory
    assert_equal(model.predict_intents(x, lengths=n), eager(model, x, n))
    dev = model.device
    model.to(torch.device("cpu")).to(dev)  # every parameter in new storage
    assert_equal(model.predict_intents(x, lengths=n), eager(model, x, n))
    assert model.decode_graphs.captures == 3 and model.decode_graphs.fallbacks == 0


@pytest.mark.cuda
def test_a_capture_that_raises_answers_from_the_eager_path(card_models, monkeypatch):
    model = card_models["slots"]()
    features = slu.encoder_features

    def refuses_capture(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("not capturable")
        return features(*args, **kwargs)

    monkeypatch.setattr(slu, "encoder_features", refuses_capture)
    rng = np.random.default_rng(4)
    for k in range(2):
        n = mixed_lengths(rng, 16, 3 * SECOND)
        x = waves(rng, 16, 3 * SECOND, n)
        assert_equal(model.predict_intents(x, lengths=n), eager(model, x, n))
        g = model.decode_graphs
        assert (g.captures, g.replays, g.fallbacks, g.keys()) == (0, 0, k + 1, [])


@pytest.mark.cuda
def test_two_threads_decode_through_the_graphs(card_models):
    model = card_models["seq2seq"]()
    rng = np.random.default_rng(5)
    batches = []
    for t_pad in (SECOND, 3 * SECOND // 2) * 3:
        n = mixed_lengths(rng, 16, t_pad)
        batches.append((waves(rng, 16, t_pad, n), n))
    results = [None] * len(batches)

    def work(i):
        x, n = batches[i]
        results[i] = model.predict_intents(x, lengths=n)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(batches))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for (x, n), got in zip(batches, results):
        assert_equal(got, eager(model, x, n))
    assert model.decode_graphs.captures == 2


@pytest.mark.cuda
def test_another_search_length_captures_anew(card_models):
    import dataclasses

    model = card_models["seq2seq"]()
    rng = np.random.default_rng(6)
    n = mixed_lengths(rng, 16, SECOND)
    x = waves(rng, 16, SECOND, n)
    first = model.predict_intents(x, lengths=n)
    arch = model.seq2seq_arch
    model.seq2seq_arch = dataclasses.replace(arch, max_decode_len=U // 2)
    shorter = model.predict_intents(x, lengths=n)
    assert shorter[1].shape[-1] == U // 2 and model.decode_graphs.captures == 2
    assert_equal(shorter, eager(model, x, n))
    model.seq2seq_arch = arch
    assert_equal(model.predict_intents(x, lengths=n), first)
    assert model.decode_graphs.captures == 2
