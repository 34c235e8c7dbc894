"""The developer copies of ``chip_smoke.py`` (``VARIANTS``) edit kernel text
that exists; its phase splits name kernels that exist; its beam-search tie
check allows the f32 drift of the summed steps.

Each variant is a copy of ``tpu_slu_torch/csrc`` with some exact texts
replaced, compiled on the card beside the port's library for an A/B or a
trace. A text that no longer occurs (the template's lines changed) or occurs
in several files would stop the smoke on the card; here it fails on the CPU,
with no compiler.
"""

import os
import re

import numpy as np
import pytest

import chip_smoke
from tpu_slu_torch.ops import _build


def _sources() -> dict:
    texts = {}
    for fn in os.listdir(_build.CSRC):
        with open(os.path.join(_build.CSRC, fn)) as f:
            texts[fn] = f.read()
    return texts


@pytest.mark.parametrize("name", sorted(chip_smoke.VARIANTS))
def test_variant_edits_apply_to_one_source(name):
    source, edits, flags = chip_smoke.VARIANTS[name]
    texts = _sources()
    assert source in texts and source.endswith(".cu")
    for old, new in edits:
        assert old != new
        assert len([fn for fn, t in texts.items() if old in t]) == 1, old


def test_other_size_variants_invert_only_the_two_direction_rule():
    """K1's, K2's and K4f's A/B copies change the two-direction cluster rule
    and nothing of K5f's one-direction rule."""
    sizes = {}
    for name in ("k1_other_c", "k2_other_c", "k4f_other_c"):
        (rule, inverted), _ = chip_smoke.VARIANTS[name][1]
        sizes[name] = inverted
        assert rule.startswith("*C = (ndir == 1 ? 4 * B <= sms : ")
        assert inverted.startswith("*C = (ndir == 1 ? 4 * B <= sms : ") and inverted != rule
    assert len(set(sizes.values())) == 1


def _kernels_of(source: str) -> set:
    """The ``__global__`` functions that ``source`` defines, through its
    local ``#include "..."`` files too, read from the text."""
    seen, todo, text = set(), [source], ""
    while todo:
        fn = todo.pop()
        if fn in seen:
            continue
        seen.add(fn)
        with open(os.path.join(_build.CSRC, fn)) as f:
            body = f.read()
        text += body
        todo += re.findall(r'^#include "([^"]+)"', body, re.M)
    return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\(.*?\)\s+)?(\w+)\s*\(", text))


@pytest.mark.parametrize("phases,source", [("K3_PHASES", "bigru_shared_bwd.cu"),
                                           ("K3_BF16_PHASES", "bigru_shared_bwd.cu"),
                                           ("K4B_PHASES", "bigru_masked_bwd.cu"),
                                           ("K4B_BF16_PHASES", "bigru_masked_bwd.cu"),
                                           ("K5B_PHASES", "bigru_masked_bwd.cu")])
def test_phase_splits_name_kernels_of_their_source(phases, source):
    """Every kernel name of a phase split (``device_split`` matches them in
    the profiler's names) is a kernel its backward's source compiles."""
    defined = _kernels_of(source)
    names = getattr(chip_smoke, phases).values()
    for name in names:
        assert name.split("<")[0] in defined, (name, sorted(defined))
    assert len(set(names)) == len(names)


def test_the_backward_chain_is_the_cluster_kernel():
    """K3's, K4b's and K5b's chain is the backward cluster recurrence, at f32
    and bf16: the one-CTA chains they ran before (``masked_bwd_chain_kernel``,
    ``bwd_chain_kernel``, ``bwd_chain_kernel_bf16``) are gone from every
    source, and K3's source launches the cluster kernel with its SPLIT flag
    at both stream types."""
    for phases in ("K3_PHASES", "K3_BF16_PHASES", "K4B_PHASES", "K4B_BF16_PHASES", "K5B_PHASES"):
        assert getattr(chip_smoke, phases)["chain"] == "gru_cluster_bwd_kernel", phases
    for fn in os.listdir(_build.CSRC):
        kernels = _kernels_of(fn)
        assert not kernels & {"masked_bwd_chain_kernel", "bwd_chain_kernel", "bwd_chain_kernel_bf16"}, fn
    assert "gru_cluster_bwd_kernel" in _kernels_of("bigru_shared_bwd.cu")
    with open(os.path.join(_build.CSRC, "bigru_shared_bwd.cu")) as f:
        text = f.read()
    assert text.count("gru_cluster_bwd<kBF, true>(a, 2, st)") == 1
    assert "template <typename TS>\ncudaError_t shared_bwd(" in text


def test_k3_wide_hp_edits_apply_to_one_source():
    """``tools/torch_cluster_ab.py --k3-hp``'s copy of K3 (h_prev widened
    before the chain) edits texts that occur in exactly one source, and
    compiles K3's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_cluster_ab", os.path.join(os.path.dirname(_build.CSRC), "..", "tools", "torch_cluster_ab.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    texts = _sources()
    for old, new in tool.K3_WIDE_HP:
        assert old != new
        assert [fn for fn, t in texts.items() if old in t] in (["bigru_shared_bwd.cu"], ["gru_cluster_bwd.cuh"]), old


@pytest.mark.parametrize("name", ["no128", "bk64"])
def test_tc_variant_edits_apply_to_one_source(name):
    """``tools/torch_cluster_ab.py --tc-variants``'s copies of the bf16
    tensor-core GEMM kernel edit texts that occur in one source only,
    ``bigru_gemm.cuh``, the header every kernel source includes."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_cluster_ab", os.path.join(os.path.dirname(_build.CSRC), "..", "tools", "torch_cluster_ab.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    texts = _sources()
    for old, new in tool.TC_VARIANTS[name]:
        assert old != new
        assert [fn for fn, t in texts.items() if old in t] == ["bigru_gemm.cuh"], old


def test_k6_runs_the_cluster_recurrence():
    """K6's recurrence is K1's cluster kernel with the row-stacked flag, at
    the parts' stream type (f32, or bf16 since K6 has a bf16 form); the
    one-CTA recurrence it ran before is gone from every source."""
    assert "gru_cluster_kernel" in _kernels_of("bigru_shared_fwd.cu")
    for fn in os.listdir(_build.CSRC):
        assert "bigru_rec_kernel" not in _kernels_of(fn), fn
    with open(os.path.join(_build.CSRC, "bigru_shared_fwd.cu")) as f:
        assert f.read().count("gru_cluster_rec<true, false, true, TS>") == 1


@pytest.mark.parametrize("steps,score", [(1, -3.0), (24, -60.5), (56, -252.0), (200, -903.25)])
def test_tie_tolerance_is_the_drift_of_the_summed_steps(steps, score):
    """(steps + 4) spacings of the largest score, 2^-23 |s| a spacing, and
    at least 1e-5."""
    want = max((steps + 4) * 2**-23 * abs(score), 1e-5)
    assert chip_smoke.tie_tolerance(steps, [score / 2, score]) == want
    assert chip_smoke.tie_tolerance(steps, [10 * score]) < chip_smoke.tie_tolerance(steps + 1, [10 * score])
    assert chip_smoke.tie_tolerance(steps, [0.0, -1e-3]) == 1e-5


@pytest.mark.parametrize("steps", [1, 24, 56, 200])
def test_two_f32_running_sums_stay_within_the_tie_tolerance(steps):
    """Two f32 searches of the same hypothesis: each sums its own
    log-probabilities step by step in f32, and their log-probabilities
    differ by up to 2 units of f32 rounding each (another order of
    evaluation). Over seeded draws of widely spread log-probabilities the
    two scores stay within the bound; one search also stays within half of
    it of the exact sum of its own log-probabilities."""
    rng = np.random.default_rng(steps)
    worst = 0.0
    for _ in range(200):
        lp = -rng.exponential(rng.choice([0.01, 1.0, 10.0]), steps)
        one, two = (np.float32(lp * (1 + rng.uniform(-2, 2, steps) * 2.0**-24)) for _ in range(2))
        s1, s2 = np.add.accumulate(one)[-1], np.add.accumulate(two)[-1]
        assert s1.dtype == np.float32
        tol = chip_smoke.tie_tolerance(steps, [float(s1), float(s2)])
        assert abs(float(s1) - float(s2)) <= tol
        assert abs(float(s1) - one.astype(np.float64).sum()) <= steps * 2**-24 * abs(float(s1)) + 1e-30
        worst = max(worst, abs(float(s1) - float(s2)) / tol)
    assert worst > 0.0


def _search(scores, tokens):
    """A search of n steps as ``compare_searches`` calls it: the first n
    columns of fixed tokens (W, B, U), with ``scores[n]`` (W, B)."""
    import torch

    return lambda n: (torch.tensor(scores[n]), torch.tensor(tokens)[:, :, :n])


@pytest.mark.parametrize("apart,passes", [(0.5, True), (2.0, False)])
def test_compare_searches_takes_a_tie_within_the_drift(apart, passes):
    """Two beams swapped at step 3 of 5: a tie where their sorted scores
    differ by half the drift of 4 summed steps, a fault at twice it."""
    U, s = 5, -100.0
    tol = chip_smoke.tie_tolerance(4, [s])
    ref_tokens = np.array([[[1, 1, 1, 1, 1]], [[1, 1, 1, 2, 2]]])
    got_tokens = ref_tokens[[1, 0]].copy()
    got_tokens[:, :, :3] = ref_tokens[:, :, :3]
    ref_scores = {n: [[s], [s - 1e-3]] for n in range(U + 1)}
    got_scores = {n: [[s], [s - 1e-3 - apart * tol]] for n in range(U + 1)}
    run, ref_run = _search(got_scores, got_tokens), _search(ref_scores, ref_tokens)
    if passes:
        _, _, rows, notes = chip_smoke.compare_searches("case", run, ref_run, U)
        assert rows == [] and len(notes) == 1 and "step 3 of 5" in notes[0]
    else:
        with pytest.raises(AssertionError, match="f32 drift of 4 summed steps"):
            chip_smoke.compare_searches("case", run, ref_run, U)


def test_asr_batches_carry_ignored_labels_and_padding_rows(tmp_path):
    """``asr_batches``: labels of ``ceil(T / ds)`` frames in range or -1,
    about a fifth -1; the last two rows zero waves of length 0 and weight 0
    with every label -1; the port's ASR step trains on them at a small
    width (finite losses, the padding rows without any gradient)."""
    import torch

    from __graft_entry__ import _make_config
    from tpu_slu_torch.models.encoder import PretrainedModel, encoder_loss
    from tpu_slu_torch.training import Trainer

    rng = np.random.default_rng(0)
    batches = chip_smoke.asr_batches(rng, 2, 6, 4000, 8, 64, 80, 320)
    for b in batches:
        assert b["x"].shape == (6, 4000) and b["y_phoneme"].shape == (6, 50) and b["y_word"].shape == (6, 13)
        for y, top in ((b["y_phoneme"], 8), (b["y_word"], 64)):
            assert y.dtype == np.int32 and y.min() == -1 and y.max() < top
            assert 0.1 < (y[:4] == -1).mean() < 0.3 and (y[4:] == -1).all()
        assert list(b["w"]) == [1] * 4 + [0] * 2 and list(b["len"]) == [4000] * 4 + [0] * 2
        assert not b["x"][4:].any()
    config = _make_config(str(tmp_path), small=True)
    config.pretraining_type = 2
    trainer = Trainer(PretrainedModel(config), config)
    losses = trainer.train_step(trainer._to_device(batches[0]))
    assert all(np.isfinite(v.item()) for v in losses)
    padded = {k: v[4:] for k, v in batches[1].items()}  # only the padding rows: no gradient at all
    trainer.optimizer.zero_grad(set_to_none=True)
    pl, wl, _, _ = encoder_loss(trainer.model, torch.from_numpy(padded["x"]),
                                torch.from_numpy(padded["y_phoneme"]).long(),
                                torch.from_numpy(padded["y_word"]).long(), weights=torch.from_numpy(padded["w"]))
    (pl + wl).backward()
    assert pl.item() == wl.item() == 0.0
    assert all(not p.grad.any() for p in trainer.model.parameters() if p.grad is not None)


def test_cli_tree_reads_in_both_packages(tmp_path):
    """``write_cli_tree``'s tree gives equal datasets in the port and the JAX
    package (the CLI leg's data), and ``write_cli_cfg`` cuts the flagship cfg
    as ``CLI_CUTS`` says."""
    from tests.test_torch_data import _assert_batches_equal, _epochs
    from tpu_slu import read_config as jax_read_config
    from tpu_slu.data import datasets as jdata
    from tpu_slu_torch.config import read_config
    from tpu_slu_torch.data import datasets as tdata
    from tpu_slu_torch.models.flagship import FLAGSHIP_CFG

    slu, asr = chip_smoke.write_cli_tree(str(tmp_path / "tree"), np.random.default_rng(3))
    with pytest.raises(KeyError):
        chip_smoke.write_cli_cfg(str(tmp_path / "bad.cfg"), FLAGSHIP_CFG, no_such_key=1)
    out = {}
    for pkg, read, data in (("jax", jax_read_config, jdata), ("port", read_config, tdata)):
        cfg = str(tmp_path / f"{pkg}.cfg")
        chip_smoke.write_cli_cfg(cfg, FLAGSHIP_CFG, folder=str(tmp_path / pkg), asr_path=asr, slu_path=slu,
                                 **chip_smoke.CLI_CUTS)
        config = read(cfg)
        assert {k: getattr(config, k) for k in chip_smoke.CLI_CUTS} == chip_smoke.CLI_CUTS
        np.random.seed(config.seed)
        out[pkg] = (config, _epochs(data.get_SLU_datasets(config), 1) + _epochs(data.get_ASR_datasets(config), 1))
    (jc, jb), (tc, tb) = out["jax"], out["port"]
    assert tc.Sy_intent == jc.Sy_intent and tc.num_phonemes == jc.num_phonemes
    assert [len(b) for b in tb] == [2, 1, 1, 1, 1, 1]
    for got, want in zip(tb, jb):
        _assert_batches_equal(got, want)


def test_asr_shapes_are_the_encoders_gru_inputs():
    """``asr_shapes``: each encoder bi-GRU layer's input frames at 2.25 s (and
    at 4 s, ``ENC_SHAPES``' T) as the port's ``frames_through`` counts them on
    the flagship cfg, with ``ENC_SHAPES``' widths."""
    from tpu_slu_torch.config import read_config
    from tpu_slu_torch.models.encoder import EncoderArch, frames_through
    from tpu_slu_torch.models.flagship import FLAGSHIP_CFG

    config = read_config(FLAGSHIP_CFG, make_dirs=False)
    config.num_phonemes = 42
    arch = EncoderArch.from_config(config)
    specs = arch.phoneme_layers + arch.word_layers
    grus = [i for i, s in enumerate(specs) if s.kind == "gru"]
    assert len(grus) == len(chip_smoke.ENC_SHAPES) == 4
    for T in (chip_smoke.ASR_T, 64000):
        want = [int(frames_through(specs[:i], T)) for i in grus]
        assert [t for *_, t in chip_smoke.asr_shapes(T)] == want
    assert [s[:3] for s in chip_smoke.asr_shapes()] == [s[:3] for s in chip_smoke.ENC_SHAPES]
    assert [s[3] for s in chip_smoke.asr_shapes(64000)] == [s[3] for s in chip_smoke.ENC_SHAPES]
    assert [s[3] for s in chip_smoke.asr_shapes()] == [225, 113, 57, 29]


def test_front_end_params_are_the_parameters_before_the_first_gru():
    """The train step checks hold the front end's gradients against an f64
    step on the card's branches: ``front_end_params`` names every parameter
    of ``phoneme_layers`` before its first GRU layer (the sinc filters and
    the two convs), in the ASR encoder and in the SLU model that holds it,
    and nothing past it."""
    import torch

    from tpu_slu_torch.config import read_config
    from tpu_slu_torch.models.encoder import PretrainedModel
    from tpu_slu_torch.models.flagship import FLAGSHIP_CFG, TRAIN_CFG, flagship_model

    config = read_config(FLAGSHIP_CFG, make_dirs=False)
    config.num_phonemes = 42
    enc = PretrainedModel(config, generator=torch.Generator().manual_seed(0))
    want = {"phoneme_layers.0.filt_b1", "phoneme_layers.0.filt_band", "phoneme_layers.5.weight",
            "phoneme_layers.5.bias", "phoneme_layers.9.weight", "phoneme_layers.9.bias"}
    assert chip_smoke.front_end_params(enc) == want
    first_gru = min(s.index for s in enc.arch.phoneme_layers if s.kind == "gru")
    names = [n for n, _ in enc.named_parameters()]
    assert want == {n for n in names if n.startswith("phoneme_layers.") and int(n.split(".")[1]) < first_gru}
    assert chip_smoke.front_end_params(flagship_model("cpu", cfg=TRAIN_CFG)) == {
        f"pretrained_model.{n}" for n in want}


@pytest.mark.parametrize("perturb", [0.0, 1e-2])
def test_asr_eval_vs_cpu_holds_the_test_pass_against_a_copy(tmp_path, monkeypatch, perturb):
    """``asr_eval_vs_cpu`` on the CPU at a small width: a model held against
    its own copy passes with no argmax flips; a copy whose word head is moved
    by ``perturb`` fails on the logits."""
    import copy
    import types

    import torch

    from __graft_entry__ import _make_config
    from tpu_slu_torch.models.encoder import PretrainedModel

    config = _make_config(str(tmp_path), small=True)
    config.pretraining_type = 2
    model = PretrainedModel(config)
    batch = chip_smoke.asr_batches(np.random.default_rng(1), 1, 6, 4000, model.arch.num_phonemes,
                                   config.vocabulary_size, config.phone_downsample_factor,
                                   config.word_downsample_factor)[0]

    def moved(m):
        out = copy.deepcopy(m)
        with torch.no_grad():
            out.word_linear.bias += perturb
        return out

    monkeypatch.setattr(chip_smoke, "copy", types.SimpleNamespace(deepcopy=moved))
    if perturb:
        with pytest.raises(AssertionError, match="word logits"):
            chip_smoke.asr_eval_vs_cpu(model, batch)
    else:
        held = chip_smoke.asr_eval_vs_cpu(model, batch)
        assert held.count("max abs err 0 ") == 2 and held.count("(0 argmax flips)") == 2


def test_the_profile_dir_check_tells_the_step_kernels_apart():
    """Phase 13's ``[profile-dir]`` counts K1, K2 and K3 in a trace by the
    one kernel each wrapper call launches: the cluster recurrence without
    and with its TRAIN flag (the template's fourth parameter), and K3's
    chain (the backward cluster recurrence with its SPLIT flag, the fourth
    parameter); the names it matches are kernels the sources define."""
    assert chip_smoke.step_kernel("void gru_cluster_kernel<2, 8, true, true, false>(ClusterArgs<true>)") == "K2"
    assert chip_smoke.step_kernel("void gru_cluster_kernel<4, 1, false, false, false>(ClusterArgs<false>)") == "K1"
    assert chip_smoke.step_kernel("void gru_cluster_bwd_kernel<2, 2, false, true>(ClusterBwdSplitRec<float>)") == "K3"
    assert chip_smoke.step_kernel(
        "void gru_cluster_bwd_kernel<4, 1, true, true>(ClusterBwdSplitRec<__nv_bfloat16>)") == "K3"
    assert chip_smoke.step_kernel("void gru_cluster_bwd_kernel<2, 8, false, false>(ClusterBwdRec)") is None
    assert chip_smoke.step_kernel("void gemm_kernel<0, 0, 128, 128, 8>(GemmArgs)") is None
    for source, name in (("bigru_shared_fwd.cu", "gru_cluster_kernel"), ("bigru_trainpool_fwd.cu", "gru_cluster_kernel"),
                         ("bigru_shared_bwd.cu", "gru_cluster_bwd_kernel")):
        assert name in _kernels_of(source), (source, name)
    with open(os.path.join(_build.CSRC, "gru_cluster.cuh")) as f:
        assert ("template <int C, int NB, bool POOL, bool TRAIN, bool ROWS = false, typename TS = float>\n"
                "__global__") in f.read()


def test_the_bf16_step_check_tells_recurrences_apart():
    """Phase 14's warm bf16 steps count the GRU recurrences in a trace by
    the one kernel each wrapper call launches, forward or chain, bf16 or
    f32: the cluster recurrence by its stream type, K3's, K4b's and K5b's
    chain by the backward template's third argument (its fourth, SPLIT,
    tells K3's apart); the names it matches are kernels the sources define."""
    assert chip_smoke.recurrence_of(
        "void gru_cluster_kernel<2, 1, false, false, true, __nv_bfloat16>(ClusterRecT<__nv_bfloat16>)") == (
        "forward", True)
    assert chip_smoke.recurrence_of("void gru_cluster_kernel<4, 1, true, false, false, float>(ClusterRecT<float>)") == (
        "forward", False)
    assert chip_smoke.recurrence_of("void gru_cluster_bwd_kernel<2, 8, true, false>(ClusterBwdRec)") == ("chain", True)
    assert chip_smoke.recurrence_of("void gru_cluster_bwd_kernel<2, 8, false, false>(ClusterBwdRec)") == (
        "chain", False)
    assert chip_smoke.recurrence_of(
        "void gru_cluster_bwd_kernel<2, 2, true, true>(ClusterBwdSplitRec<__nv_bfloat16>)") == ("chain", True)
    assert chip_smoke.recurrence_of("void gru_cluster_bwd_kernel<2, 2, false, true>(ClusterBwdSplitRec<float>)") == (
        "chain", False)
    assert chip_smoke.recurrence_of("void gemm_kernel_mixed<0, 0, 128, 64, 4, 1, 2, false>(GemmArgs)") is None
    assert {"gru_cluster_bwd_kernel", "masked_hprev_kernel_bf16"} <= _kernels_of("bigru_masked_bwd.cu")
    assert {"gru_cluster_kernel", "gru_cluster_bwd_kernel"} <= (_kernels_of("bigru_shared_fwd.cu")
                                                                | _kernels_of("bigru_shared_bwd.cu"))
    with open(os.path.join(_build.CSRC, "gru_cluster_bwd.cuh")) as f:
        assert "template <int C, int NB, bool BF = false, bool SPLIT = false>\n__global__" in f.read()


def test_counted_trace_retakes_a_short_trace_and_raises_on_anything_else(monkeypatch):
    """``counted_trace`` takes a trace again only while it is short of the
    counted launches (the profiler dropped events): it returns the first
    complete one, raises on the last short one, and raises at once on any
    other mismatch."""
    traces = iter([{"k": (9, 0.1)}, {"k": (10, 0.1)}, {"k": (12, 0.1)}, {"k": (13, 0.1)}])
    monkeypatch.setattr(chip_smoke, "kernel_table", lambda fn, reps: (1.0, next(traces)))
    resets = []

    def check(table):
        n = table["k"][0]
        return None if n == 10 else (f"{n} against 10", n < 10)

    wall, table, taken = chip_smoke.counted_trace(lambda: None, lambda: resets.append(1), check, "what")
    assert (table["k"][0], taken, len(resets)) == (10, 2, 2)
    with pytest.raises(AssertionError, match="12 against 10"):
        chip_smoke.counted_trace(lambda: None, lambda: None, check, "what")
    traces = iter([{"k": (9, 0.1)}] * 3)
    with pytest.raises(AssertionError, match="9 against 10"):
        chip_smoke.counted_trace(lambda: None, lambda: None, check, "what", tries=3)
