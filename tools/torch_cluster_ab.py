#!/usr/bin/env python3
"""A/Bs of the port's kernels on one GPU: the cluster size of K1, K2 and K4f,
those kernels, K5f, K4b, K5b, K6 and K8 against another checkout's, K7's
cluster size by batch, K7's step with parts of its design taken out, and
K8's launch plans.

    python3 tools/torch_cluster_ab.py [--k1-batches 1 2 4 8 12 16 64]
        [--k2-batches 16 64] [--k4f-batches 1 8 64] [--k4b-batches 8 64]
        [--k5b-batches 64] [--k3-batches 16 64] [--k3-hp] [--parent DIR]
        [--k8-plans 1 16 128 8:16000 ...] [--k8-launch] [--bf16]
        [--k7-sizes] [--k7-variants base skip_gi skip_gh no_kv no_cache ...]
        [--tc-variants no128 bk64]

``--k1-batches``, ``--k2-batches``, ``--k4f-batches``: the kernel's
flagship layers (K4f's with mixed lengths) on clusters of 2 and of 4 CTAs
in turns at each batch (``chip_smoke.cluster_ab``, the other size from the
smoke's ``k1_other_c``, ``k2_other_c`` or ``k4f_other_c`` variant).
``--k4b-batches``, ``--k5b-batches``: the same for the backward chain, K4b
at the seq2seq encoder layer (mixed lengths below B = 64) and K5b's five
layers (``chip_smoke.bwd_cluster_ab``, the ``bwd_other_c`` variant).
``--k3-batches``: the same for K3's chain, the five flagship layers and the
ASR encoder's four at each batch (``chip_smoke.k3_cluster_ab``, the
``k3_other_c`` variant: ``bwd_other_c``'s edits in K3's source).
``--k3-hp``: K3 at bf16 with its chain reading the bf16 h_prev as it is
(the library) against a copy that widens h_prev to f32 before the chain
(``K3_WIDE_HP``, the ``k3_wide_hp`` variant), the flagship's five layers
and the ASR encoder's four at B = 64, outputs equal bit for bit, device
time in turns and by phase.
``--parent DIR``: the kernel library of the checkout at DIR (e.g. the
parent commit unpacked under ``build/``), built with that checkout's own
``_build.py``, against this tree's, in turns parent, this, this, parent:
K1's five layers at B = 16, K2's four at B = 64, K4f's five at B = 8 with
mixed lengths, K5f's five at B = 16, K3's five at B = 64 (through its
wrapper, the library swapped in; also at bf16, and the ASR encoder's
four layers at B = 64), K4b at the seq2seq encoder layer (B = 64, T = 25,
D = 256), K5b's five layers at B = 64, K6's five at B = 1 and
16 and K8 alone on 4 s at B = 1, 16 and 128 (each tree's K8 on its own
entry point's arguments; this tree's on ``frontend_plan``'s plan; by CUDA
graph replays of one launch and, amortized, of 10 launches, beside one
cuDNN f32 conv alone on the same inputs), each output held against its
plain version; K3, K4b and K5b also by phase (``chip_smoke.device_split``
over ``K3_PHASES`` and ``K4B_PHASES``, each tree's chain under its own
name: ``PARENT_CHAINS``), in the same turns. ``--k8-plans``:
K8 alone at the flagship front end at each shape, ``B`` (4 s) or ``B:T`` (T samples), on
every plan ``frontend_plans`` admits, each timed by replays of 10
launches and held against the plain version, ranked by time beside the
model's cost and the plan ``frontend_plan`` picks, and the fastest plan of
two families alone (the whole list in ``build/k8_plans_B<B>_T<T>.txt``).
``--k8-launch``: what a graph replay of one call measures (``k8_launch``).
``--bf16``: K1-K6 at bf16 beside f32 by device time (``bf16_ab``); with
``--parent``, also each bf16 kernel on the parent's library and this
tree's in turns, whole and by phase (``parent_bf16_ab``).
``--k7-sizes``: the cluster size K7 takes at each batch at the flagship
decoder, W = 4, 4 s. ``--k7-variants``:
each variant is ``tpu_slu_torch/csrc/beam_decode.cu`` with one text edit
(``VARIANTS``) and ``TSL_TRACE`` defined, compiled alone into
``build/variants/`` (``chip_smoke.start_variant``) and swapped in for the
kernel library's K7 entry points; K7's whole search at the flagship decoder
(W = 4, U = 200, 4 s, B = 1 and 16) is timed for each in turns (the list,
then the list reversed), with its step split by phase at B = 1 from its
trace. Every variant, ``base`` too, carries the trace's clock reads, so
the variants compare with each other, not with the served kernel. A
variant that skips work gives wrong tokens: it measures time only.
``--tc-variants``: K3 at bf16 (five layers, B = 64) on copies of its
source whose GEMM core's tensor-core kernel changes one choice
(``TC_VARIANTS``), against the library, whole and by phase
(``tc_variants_ab``). Run from the root of a checkout.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAG = (2, 256, 100, 200, 102)  # all_real_seq2seq.cfg's decoder: layers, H, K, V, L
_DOT_GI = "dot_rows<G, 3>(wi, in, off_in, in4, lane, ai);"
_DOT_GH = "dot_rows<G, 3>(wh, hprev, off_h, Hp / 4, lane, ah);"
_UNROLL = "#pragma unroll 2\n  for (int c = lane; c < n4; c += kLanes)"
# the one-CTA chains a parent may run instead of the cluster chain: K3's (bwd_chain_kernel and its
# bf16 copy), K4b's and K5b's (masked_bwd_chain_kernel)
PARENT_CHAINS = ("bwd_chain_kernel",)
# K3 at bf16 with h_prev widened to f32 before the chain, in a buffer of the copy's own, and the
# chain reading f32 words: the other way its bf16 h_prev could reach the chain
_WIDEN = """__global__ void widen_hp_kernel(const __nv_bfloat16* __restrict__ hp_f,
                                const __nv_bfloat16* __restrict__ hp_b, float* __restrict__ out,
                                size_t n) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < 2 * n;
       e += (size_t)gridDim.x * blockDim.x)
    out[e] = __bfloat162float(e < n ? hp_f[e] : hp_b[e - n]);
}

"""
_HPS = "  a.hps[0] = hp_f;\n  a.hps[1] = hp_b;\n"
K3_WIDE_HP = [
    ("using BwdHp = std::conditional_t<SPLIT && BF, __nv_bfloat16, float>;", "using BwdHp = float;"),
    ("// The three phases on streams of type TS", _WIDEN + "// The three phases on streams of type TS"),
    (_HPS, """  if constexpr (kBF) {
    static float* wide = nullptr;
    static size_t cap = 0;
    const size_t need = (size_t)2 * M * H;
    if (cap < need) {
      cudaFree(wide);
      cap = 0;
      err = cudaMalloc(&wide, need * sizeof(float));
      if (err != cudaSuccess) return err;
      cap = need;
    }
    widen_hp_kernel<<<grid_for(need, sms), 256, 0, st>>>(hp_f, hp_b, wide, (size_t)M * H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    a.hps[0] = wide;
    a.hps[1] = wide + (size_t)M * H;
  } else {
""" + _HPS + "  }\n"),
]
# name -> [(text in beam_decode.cu or a header it includes, its replacement)]
VARIANTS = {
    "base": [],
    "skip_gi": [(_DOT_GI, "")],  # no products of the layers' inputs
    "skip_gh": [(_DOT_GH, "")],  # no recurrent products
    "skip_attention": [("for (int t0 = 0; t0 < n; t0 += kFB) {", "for (int t0 = 0; t0 < 0; t0 += kFB) {")],
    "no_kv": [("const bool kv_resident = plan + bias + kv <= kSmemLimit;", "const bool kv_resident = false;")],
    "no_cache": [("const unsigned cache = pick_cache(d, C, kSmemLimit - fixed, &smem);", "const unsigned cache = 0;")],
    "unroll1": [(_UNROLL, _UNROLL.replace("unroll 2", "unroll 1"))],
    "unroll4": [(_UNROLL, _UNROLL.replace("unroll 2", "unroll 4"))],
    "test_wait": [("mbarrier.try_wait.parity.shared::cta.b64", "mbarrier.test_wait.parity.shared::cta.b64")],
}


def k7_variants(names: list[str], dev, card: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpu_slu_torch.models.slu import Seq2SeqArch, Seq2SeqDecoder
    from tpu_slu_torch.ops import _build
    from tpu_slu_torch.ops.attention import attention_kv
    from tpu_slu_torch.ops.beam_fused import beam_decode

    builds = {n: cs.start_variant(f"k7_{n}", "beam_decode.cu", VARIANTS[n], ["-DTSL_TRACE"]) for n in names}
    libs = {n: cs.load_variant(f"k7_{n}", *b) for n, b in builds.items()}
    nl, H, K, V, L = FLAG
    arch = Seq2SeqArch(num_labels=L, num_encoder_layers=1, encoder_dim=128, num_decoder_layers=nl,
                       decoder_dim=H, key_dim=K, value_dim=V, sos=0)
    dec = Seq2SeqDecoder(arch, torch.Generator().manual_seed(0)).eval().to(dev)
    kv = {}
    for B in (1, 16):
        enc = np.random.default_rng(B).standard_normal((B, 25, 256)).astype(np.float32)
        with torch.inference_mode():
            kv[B] = attention_kv(dec.attention, torch.from_numpy(enc).to(dev))
    real = _build.library()
    ms = {}
    try:
        for name in names + names[::-1]:
            _build._lib = libs[name]
            for B, (keys, values) in kv.items():
                with torch.inference_mode():
                    ms.setdefault((name, B), []).append(
                        cs.cuda_ms(lambda: beam_decode(dec, keys, values, None, 4, 200), reps=10, warmup=2))
        for name in names:
            _build._lib = libs[name]
            print(f"[k7-variant] {name:15s} " + "; ".join(
                f"B={B} {ms[name, B][0]:.4f}, {ms[name, B][1]:.4f} ms" for B in kv) + f" on {card}")
            cs.k7_round_split(libs[name], dec, *kv[1], 200, sum(ms[name, 1]) / 2, card)
    finally:
        _build._lib = real


def k8_case(rng, B: int, dev, T: int = 64000):
    """K8's flagship inputs on T samples (4 s) at batch B: (filter bank, x,
    out, the plain version's (B, F, t_pool) output)."""
    import numpy as np
    import torch

    from tpu_slu_torch.ops.frontend_fused import sinc_frontend_reference
    from tpu_slu_torch.ops.sinc import mel_init, sinc_filters

    b1, band = (torch.from_numpy(a).to(dev) for a in mel_init(80, 16000))
    x = torch.from_numpy((0.1 * rng.standard_normal((B, T))).astype(np.float32)).to(dev)
    filt = sinc_filters(b1, band, 401, 16000).contiguous()
    ref = sinc_frontend_reference(b1, band, x, filt_dim=401, fs=16000, stride=80, padding=200, pool=2)
    return filt, x, torch.empty(ref.transpose(1, 2).shape, device=dev), ref.transpose(1, 2)


def k8_plans(shapes, dev, card: str) -> None:
    """``[k8-plans]``: K8 alone on every admitted plan at each ``B`` (4 s) or
    ``B:T`` shape."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpu_slu_torch.ops import _build
    from tpu_slu_torch.ops.frontend_fused import PLAN_ARGS, frontend_plan, frontend_plans

    lib = _build.library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    for B, T in ((int(a), int(b or 64000)) for a, _, b in (s.partition(":") for s in shapes)):
        filt, x, out, ref = k8_case(np.random.default_rng(B + T), B, dev, T)
        shape = (B, T, 80, 401, 80, 200, 2)
        chosen = frontend_plan(*shape, sms)
        rows = []
        for plan in frontend_plans(*shape, sms):
            def launch(plan=plan):
                _build.check(lib.tsl_sinc_frontend_fwd(
                    x.data_ptr(), filt.data_ptr(), out.data_ptr(), *shape, 1, *(plan[k] for k in PLAN_ARGS),
                    torch.cuda.current_stream(dev).cuda_stream), f"K8 plan {plan}")
            out.fill_(float("nan"))
            ms = cs.graph_ms(launch, calls=10)
            err = cs.rel_err(out, ref)
            if not err <= cs.CONV_RTOL:
                raise AssertionError(f"K8 B={B} plan {plan}: off its plain version by {err:.3g}")
            rows.append((ms, plan))
        rows.sort(key=lambda r: r[0])
        rank = [p for _, p in rows].index(chosen)
        keys = ("rows", "ftile", "ksplit", "threads", "grid", "smem", "cost")
        with open(os.path.join(HERE, "build", f"k8_plans_B{B}_T{T}.txt"), "w") as f:
            for ms, p in rows:
                f.write(f"{ms:.5f} ms " + " ".join(f"{k}={p[k]:.0f}" for k in keys) + "\n")
        for ms, p in rows[:6] + [rows[rank]]:
            print(f"[k8-plans] B={B:3d} T={T}: {ms:.5f} ms " + " ".join(f"{k}={p[k]:.0f}" for k in keys)
                  + (" (frontend_plan's)" if p is chosen else ""))
        print(f"[k8-plans] B={B:3d} T={T}: frontend_plan's plan ranks {rank + 1} of {len(rows)}, "
              f"{rows[rank][0]:.5f} against the fastest {rows[0][0]:.5f} ms ({rows[rank][0] / rows[0][0]:.3f}x) "
              f"on {card}")
        # the fastest plan of two families alone: the whole bank in one tap group, and
        # 16-filter tiles with the taps in 16 groups
        two = min(ms for ms, p in rows if (p["ftile"], p["ksplit"]) in ((80, 1), (16, 16)))
        print(f"[k8-plans] B={B:3d} T={T}: the fastest plan of the whole bank in one tap group or of 16 filters "
              f"with the taps in 16 groups {two:.5f} ms ({two / rows[0][0]:.3f}x) on {card}")


def k8_launch(dev, card: str) -> None:
    """``[k8-launch]``: what a CUDA graph replay of one call measures, for K8
    alone and one cuDNN f32 conv alone on 4 s at B = 1, 16 and 128: the
    replay between CUDA events on an idle device (the host's graph launch
    falls inside the events), the same replay queued behind a ~50 us sleep
    kernel (its launch hidden behind the sleep: device time alone), a
    replay of 10 calls over 10, and torch.profiler's kernel time of direct
    launches."""
    import statistics

    import numpy as np
    import torch

    import chip_smoke as cs
    from tpu_slu_torch.ops import _build
    from tpu_slu_torch.ops.frontend_fused import PLAN_ARGS, frontend_plan

    lib = _build.library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B in (1, 16, 128):
        filt, x, out, ref = k8_case(np.random.default_rng(B), B, dev)
        shape = (B, 64000, 80, 401, 80, 200, 2)
        plan = frontend_plan(*shape, sms)
        x4, filt4 = x[:, None, None, :], filt[:, None, None, :]

        def k8():
            _build.check(lib.tsl_sinc_frontend_fwd(x.data_ptr(), filt.data_ptr(), out.data_ptr(), *shape, 1,
                                                   *(plan[k] for k in PLAN_ARGS),
                                                   torch.cuda.current_stream(dev).cuda_stream), "K8")

        def cudnn():  # TF32 off, without |.|, pool and act
            torch.cudnn_convolution(x4, filt4, (0, 200), (1, 80), (1, 1), 1, False, False, False)

        for name, fn in (("K8", k8), ("cuDNN conv", cudnn)):
            with torch.inference_mode():
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    fn()
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    fn()
                idle = cs.cuda_ms(graph.replay, reps=20)
                behind = []
                for _ in range(22):
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    torch.cuda._sleep(100_000)
                    start.record()
                    graph.replay()
                    end.record()
                    end.synchronize()
                    behind.append(start.elapsed_time(end))
                ten = cs.graph_ms(fn, calls=10)
                prof = cs.device_ms(fn)
            if name == "K8" and not cs.rel_err(out, ref) <= cs.CONV_RTOL:
                raise AssertionError(f"K8 B={B} disagrees with its plain version")
            print(f"[k8-launch] {name:10s} B={B:3d} 4 s, ms a call: one call a replay {idle:.5f} (device idle), "
                  f"{statistics.median(behind[2:]):.5f} (behind a sleep kernel); 10 calls a replay {ten:.5f}; "
                  f"torch.profiler {prof:.5f} on {card}")


def parent_library(parent: str):
    """The kernel library of the checkout at ``parent``, built by that
    checkout's own ``_build.py``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "parent_build", os.path.join(os.path.abspath(parent), "tpu_slu_torch", "ops", "_build.py"))
    parent_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent_build)
    return parent_build.library()


# The bf16 kernels' launches by phase, under the names of either tree: the GEMM core's bf16 products
# on the tensor cores (gemm_kernel_tc) or, in a parent before it, on the FMA core (gemm_kernel_mixed)
BF16_PHASES = {"h_prev": "masked_hprev_kernel", "gates": "bwd_gates_kernel", "chain": "gru_cluster_bwd_kernel",
               "recurrence": "gru_cluster_kernel", "core gi/gh": ("gemm_kernel_tc<0, 0", "gemm_kernel_mixed<0, 0"),
               "core dX": ("gemm_kernel_tc<0, 1", "gemm_kernel_mixed<0, 1"), "dX sum": "dx_pair_sum_kernel",
               "core dW": ("gemm_kernel_mixed<1, 1", "gemm_kernel<1, 1"), "reduce": "dw_reduce_kernel"}


def bf16_layers() -> dict:
    """K1 (five flagship layers, B = 16), K2 (four, B = 64) and K3 (five, B =
    64): (B, shapes) as ``chip_smoke.bf16_layer`` takes them."""
    import chip_smoke as cs

    return {"K1": (16, [s[:4] for s in cs.FLAGSHIP_LAYERS]), "K2": (64, cs.ENC_SHAPES),
            "K3": (64, cs.ENC_SHAPES + [cs.INTENT_SHAPE])}


def bf16_more_shapes(rng) -> dict:
    """The shapes of PERF.md's table for K6 (five layers, B = 16), K4f (five,
    B = 8, seeded mixed lengths), K4b (the seq2seq encoder layer, B = 64),
    K5f (five unidirectional layers, B = 16) and K5b (five, B = 64), as
    ``chip_smoke.bf16_more_case`` takes them."""
    import chip_smoke as cs

    more = {"K6": [(name, d * n, T, 16, {"n_parts": n, "pool": pool}) for name, d, n, T, pool in cs.FLAGSHIP_LAYERS],
            "K4f": [], "K4b": [(*cs.S2S_LAYER, 64, {})],
            "K5f": [(name, D, T, 16, {}) for name, D, T in cs.UNI_SHAPES],
            "K5b": [(name, D, T, 64, {}) for name, D, T in cs.UNI_SHAPES]}
    for name, d, n, T, _ in cs.FLAGSHIP_LAYERS:
        lengths = rng.integers(1, T + 1, cs.SERVE_BATCH)
        lengths[0], lengths[-1] = T, 0
        more["K4f"].append((name, d * n, T, cs.SERVE_BATCH, {"lengths": lengths.tolist()}))
    return more


def parent_bf16_ab(parent: str, dev, card: str) -> None:
    """``[parent-bf16]``: the bf16 instantiations of K1 (five layers, B =
    16), K2 (four, B = 64), K3 (five, B = 64), K6 (five, B = 16), K4f (five,
    B = 8, mixed lengths), K4b (the seq2seq encoder layer, B = 64), K5f
    (five, B = 16) and K5b (five, B = 64), the shapes of ``bf16_ab``, through
    this tree's wrappers on the library of the checkout at ``parent`` and on
    this tree's (``_build._lib`` swapped), by device time (profiler) in
    turns parent, this, this, parent, and by phase (``BF16_PHASES``: the
    core's gi/gh, dX and dW, the chain, the recurrence, ...). Each case is
    held against its plain version first."""
    import numpy as np

    import chip_smoke as cs
    from tpu_slu_torch.ops import _build

    libs = {"parent": parent_library(parent), "this": _build.library()}
    rng = np.random.default_rng(0)
    sets = {}
    for k, (B, shapes) in bf16_layers().items():
        held = [cs.bf16_layer(rng, dev, name, d, n, T, B, (k,)) for name, d, n, T in shapes]
        sets[f"{k} {len(shapes)} layers B={B}"] = [cs.bf16_layer_call(k, h, "bf16") for h in held]
    for k, shapes in bf16_more_shapes(rng).items():
        held = [cs.bf16_more_case(rng, dev, k, name, D, T, B, **kw) for name, D, T, B, kw in shapes]
        sets[f"{k} {len(shapes)} layer{'s' * (len(shapes) > 1)} B={shapes[0][3]}"] = [
            h["calls"]["bf16"] for h in held]

    def run(lib, fns):
        def f():
            real, _build._lib = _build._lib, lib
            try:
                for fn in fns:
                    fn()
            finally:
                _build._lib = real
        return f

    for what, fns in sets.items():
        turns = {k: [] for k in libs}
        for k in ("parent", "this", "this", "parent"):
            turns[k].append(cs.device_ms(run(libs[k], fns), reps=5))
        print(f"[parent-bf16] {what} at bf16, device time (profiler) in turns: parent {turns['parent'][0]:.4f}, "
              f"this {turns['this'][0]:.4f}, {turns['this'][1]:.4f}, parent {turns['parent'][1]:.4f} ms on {card}")
        for k in ("parent", "this", "this", "parent"):
            split = cs.device_split(run(libs[k], fns), BF16_PHASES, reps=5)
            print(f"[parent-bf16] {what} by phase, {k} (profiler, device ms a call): "
                  + ", ".join(f"{p} {v:.4f}" for p, v in split.items() if v) + f"; sum {sum(split.values()):.4f}")


def parent_ab(parent: str, dev, card: str) -> None:
    """``[parent]``: this tree's K1, K2, K4f, K5f, K3, K4b, K5b, K6 and K8
    against the library of the checkout at ``parent``, through the same C
    entry points, in turns."""
    import statistics

    import numpy as np
    import torch

    import chip_smoke as cs
    from tpu_slu_torch.ops import _build
    from tpu_slu_torch.ops.frontend_fused import PLAN_ARGS, frontend_plan
    from tpu_slu_torch.ops.gru1 import gru1_reference

    libs = {"parent": parent_library(parent), "this": _build.library()}
    rng = np.random.default_rng(0)

    def k5f_layer(D, T, B):
        params, parts = cs.k1_case(rng, 1, D, T, B, 128, dev)
        one = {"fwd": params["fwd"]}
        x = parts[0].transpose(0, 1).contiguous()
        gi, out = torch.empty((B, T, 384), device=dev), torch.empty((B, T, 128), device=dev)

        def launch(lib):
            return lib.tsl_gru1_fwd(x.data_ptr(), D, None, *[one["fwd"][k].data_ptr() for k in
                                                             ("weight_ih", "bias_ih", "weight_hh", "bias_hh")],
                                    gi.data_ptr(), out.data_ptr(), T, B, 128, torch.cuda.current_stream(dev).cuda_stream)

        def check():
            if not cs.rel_err(out, gru1_reference(one, x)) <= cs.ATOL:
                raise AssertionError(f"K5f T={T} B={B} disagrees with its plain version")
        return launch, check

    def k8_alone(B):
        filt, x, out, ref = k8_case(rng, B, dev)
        shape = (B, 64000, 80, 401, 80, 200, 2, 1)
        plan = frontend_plan(*shape[:-1], torch.cuda.get_device_properties(dev).multi_processor_count)

        def launch(lib):
            args = (x.data_ptr(), filt.data_ptr(), out.data_ptr(), *shape)
            st = torch.cuda.current_stream(dev).cuda_stream
            if len(lib.tsl_sinc_frontend_fwd.argtypes) == len(args) + 1:  # an entry point before the plan
                return lib.tsl_sinc_frontend_fwd(*args, st)
            return lib.tsl_sinc_frontend_fwd(*args, *(plan[k] for k in PLAN_ARGS), st)

        def check():
            if not cs.rel_err(out, ref) <= cs.CONV_RTOL:
                raise AssertionError(f"K8 B={B} disagrees with its plain version")

        x4, filt4 = x[:, None, None, :], filt[:, None, None, :]

        def cudnn():  # the conv alone, TF32 off, without |.|, pool and act
            with torch.inference_mode():
                torch.cudnn_convolution(x4, filt4, (0, 200), (1, 80), (1, 1), 1, False, False, False)
        return launch, check, cudnn

    kernels = {
        "K1 five layers B=16": ([cs.k1_layer(rng, dev, d, n, T, 16, pool) for _, d, n, T, pool in cs.FLAGSHIP_LAYERS],
                                cs.K1_STEPS),
        **{f"K6 five layers B={B}": ([cs.k1_layer(rng, dev, d, n, T, B, pool, rowstack=True)
                                      for _, d, n, T, pool in cs.FLAGSHIP_LAYERS], cs.K1_STEPS) for B in (1, 16)},
        "K2 four layers B=64": ([cs.k2_layer(rng, dev, d, n, T, 64) for _, d, n, T in cs.ENC_SHAPES],
                                sum(T for *_, T in cs.ENC_SHAPES)),
        f"K4f five layers B={cs.SERVE_BATCH} mixed lengths": (
            [cs.k4f_layer(rng, dev, n * d, T, cs.SERVE_BATCH) for _, d, n, T, _ in cs.FLAGSHIP_LAYERS], cs.K1_STEPS),
        "K5f five layers B=16": ([k5f_layer(D, T, 16) for _, D, T in cs.UNI_SHAPES], sum(T for *_, T in cs.UNI_SHAPES)),
        "K3 five layers B=64": ([cs.k3_layer(rng, dev, d, n, T, 64, name != cs.INTENT_SHAPE[0])
                                 for name, d, n, T in cs.ENC_SHAPES + [cs.INTENT_SHAPE]], cs.K1_STEPS),
        "K3 bf16 five layers B=64": ([cs.k3_layer(rng, dev, d, n, T, 64, name != cs.INTENT_SHAPE[0], bf16=True)
                                      for name, d, n, T in cs.ENC_SHAPES + [cs.INTENT_SHAPE]], cs.K1_STEPS),
        "K3 ASR four layers B=64": ([cs.k3_layer(rng, dev, d, n, T, 64, True) for _, d, n, T in cs.asr_shapes()],
                                    sum(T for *_, T in cs.asr_shapes())),
        "K4b seq2seq encoder layer B=64": ([cs.bwd_layer(rng, dev, 2, 256, 25, 64)], 25),
        "K5b five layers B=64": ([cs.bwd_layer(rng, dev, 1, D, T, 64) for _, D, T in cs.UNI_SHAPES],
                                 sum(T for *_, T in cs.UNI_SHAPES)),
        **{f"K8 alone B={B} 4 s": ([k8_alone(B)], None) for B in (1, 16, 128)},
    }
    for what, (layers, steps) in kernels.items():
        def run(lib, layers=layers):
            def f():
                for launch, *_ in layers:
                    _build.check(launch(lib), what)
            return f

        for lib in libs.values():
            run(lib)()
            torch.cuda.synchronize()
            for _, check, *_ in layers:
                check()
        # K8 by graph replay of one call and of 10 calls (amortized), beside one cuDNN f32 conv
        # alone on the same inputs; the others by CUDA events
        timers = ({f"graph replay, {c} call{'s' * (c > 1)} a replay": lambda fn, c=c: cs.graph_ms(fn, calls=c)
                   for c in (1, 10)} if what.startswith("K8") else {"": lambda fn: cs.cuda_ms(fn, reps=10, warmup=2)})
        for how, timer in timers.items():
            turns = {k: [] for k in libs}
            for k in ("parent", "this", "this", "parent"):
                turns[k].append(timer(run(libs[k])))
            per_step = (f" ({1e3 * statistics.mean(turns['parent']) / steps:.3f} against "
                        f"{1e3 * statistics.mean(turns['this']) / steps:.3f} us a step)" if steps else "")
            extra = (f", cuDNN conv alone {timer(layers[0][2]):.5f} ms" if what.startswith("K8") else "")
            print(f"[parent] {what}{', ' + how if how else ''}, in turns: parent {turns['parent'][0]:.5f}, this "
                  f"{turns['this'][0]:.5f}, {turns['this'][1]:.5f}, parent {turns['parent'][1]:.5f} ms{per_step}"
                  f"{extra} on {card}")
        if what.startswith(("K3", "K4b", "K5b")):  # by phase, each tree's chain under its own name
            phases = (BF16_PHASES if what.startswith("K3 bf16") else cs.K3_PHASES if what.startswith("K3")
                      else cs.K4B_PHASES)
            phases = {**phases, "chain": (phases["chain"], *PARENT_CHAINS)}
            for k in ("parent", "this", "this", "parent"):
                split = cs.device_split(run(libs[k]), phases)
                print(f"[parent] {what} by phase, {k} (profiler, device ms a call): "
                      + ", ".join(f"{p} {v:.4f}" for p, v in split.items()) + f"; sum {sum(split.values()):.4f}")


def k3_hp_ab(dev, card: str) -> None:
    """``[k3-hp]``: K3 at bf16 as the library runs it (the chain reads the
    bf16 h_prev as it is) against the ``k3_wide_hp`` variant (h_prev widened
    to f32 first), the flagship's five layers and the ASR encoder's four at
    B = 64 (``chip_smoke.bf16_layer``: each held against its plain version
    first), the two outputs equal bit for bit, device time (profiler) in
    turns library, variant, variant, library, and by phase."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpu_slu_torch.ops import _build

    libs = {"as is": _build.library(), "widened": cs.load_variant("k3_wide_hp", *cs.start_variant(
        "k3_wide_hp", "bigru_shared_bwd.cu", K3_WIDE_HP, []))}
    rng = np.random.default_rng(0)
    sets = {"five flagship layers": cs.ENC_SHAPES + [cs.INTENT_SHAPE], "ASR's four layers": cs.asr_shapes()}
    for what, shapes in sets.items():
        held = [cs.bf16_layer(rng, dev, name, d, n, T, 64, ("K3",)) for name, d, n, T in shapes]
        calls = [cs.bf16_layer_call("K3", h, "bf16") for h in held]

        def run(lib):
            def f():
                real, _build._lib = _build._lib, lib
                try:
                    return [c() for c in calls]
                finally:
                    _build._lib = real
            return f

        outs = {k: run(lib)() for k, lib in libs.items()}
        for (dxs, grads), (wdxs, wgrads) in zip(outs["as is"], outs["widened"]):
            pairs = list(zip(dxs, wdxs)) + [(grads[d][n], wgrads[d][n]) for d in grads for n in grads[d]]
            if not all(torch.equal(a, b) for a, b in pairs):
                raise AssertionError(f"K3 bf16 {what}: h_prev as is and widened give different outputs")
        turns = {k: [] for k in libs}
        for k in ("as is", "widened", "widened", "as is"):
            turns[k].append(cs.device_ms(run(libs[k]), reps=5))
        print(f"[k3-hp] K3 bf16 {what} B=64, outputs equal bit for bit; device time (profiler) in turns: h_prev as "
              f"is {turns['as is'][0]:.4f}, widened {turns['widened'][0]:.4f}, {turns['widened'][1]:.4f}, as is "
              f"{turns['as is'][1]:.4f} ms on {card}")
        phases = {**cs.K3_BF16_PHASES, "widen": "widen_hp_kernel"}
        for k in ("as is", "widened", "widened", "as is"):
            split = cs.device_split(run(libs[k]), phases, reps=5)
            print(f"[k3-hp] K3 bf16 {what} by phase, h_prev {k} (profiler, device ms a call): "
                  + ", ".join(f"{p} {v:.4f}" for p, v in split.items()) + f"; sum {sum(split.values()):.4f}")


# gemm_kernel_tc (csrc/bigru_gemm.cuh) with one design choice changed, compiled into K3's library
_TC_NO128 = [("for (int t = 0; t < 3; ++t) {", "for (int t = 1; t < 3; ++t) {"),
             # the 128 x 64 instantiation, never chosen now, at 64 x 64 (its 64-deep ring would pass 48 KB)
             ("gemm_kernel_tc<LA, LB, MA, MB, OBF, 128, 64>", "gemm_kernel_tc<LA, LB, MA, MB, OBF, 64, 64>")]
TC_VARIANTS = {
    "no128": _TC_NO128,  # the tile rule starts at 64 x 64
    # ... and 64-deep k slices: half the barriers and ring stores, twice the loads in flight
    "bk64": _TC_NO128 + [("constexpr int kTcBK = 32;", "constexpr int kTcBK = 64;")],
}


def tc_variants_ab(names: list[str], dev, card: str) -> None:
    """``[tc-variants]``: K3 at bf16, the flagship's five layers at B = 64
    (``chip_smoke.bf16_layer``, held against its plain version first), on
    the library and on each ``TC_VARIANTS`` copy of ``bigru_shared_bwd.cu``,
    by device time (profiler) in turns (the list, then the list reversed)
    and by phase: what the tensor-core kernel's slice depth and tile rule
    are worth."""
    import numpy as np

    import chip_smoke as cs
    from tpu_slu_torch.ops import _build

    builds = {n: cs.start_variant(f"tc_{n}", "bigru_shared_bwd.cu", TC_VARIANTS[n], []) for n in names}
    libs = {"library": _build.library(), **{n: cs.load_variant(f"tc_{n}", *b) for n, b in builds.items()}}
    rng = np.random.default_rng(0)
    held = [cs.bf16_layer(rng, dev, name, d, n, T, 64, ("K3",)) for name, d, n, T in cs.ENC_SHAPES + [cs.INTENT_SHAPE]]
    calls = [cs.bf16_layer_call("K3", h, "bf16") for h in held]

    def run(lib):
        def f():
            real, _build._lib = _build._lib, lib
            try:
                return [c() for c in calls]
            finally:
                _build._lib = real
        return f

    want = run(libs["library"])()
    for name in names:
        for (dxs, grads), (vdxs, vgrads) in zip(want, run(libs[name])()):
            pairs = list(zip(dxs, vdxs)) + [(grads[d][n], vgrads[d][n]) for d in grads for n in grads[d]]
            err = max((a.float() - b.float()).abs().max().item() / max(a.float().abs().max().item(), 1e-30)
                      for a, b in pairs)
            if not err <= 2.0**-6:  # another order of the f32 sums, within 4 bf16 ulps of the largest
                raise AssertionError(f"tc variant {name}: K3 bf16 off the library's by {err:.3g}")
    order = list(libs) + list(libs)[::-1]
    turns = {k: [] for k in libs}
    for k in order:
        turns[k].append(cs.device_ms(run(libs[k]), reps=5))
    print(f"[tc-variants] K3 bf16 five layers B=64, device time (profiler) in turns {order}: "
          + "; ".join(f"{k} {', '.join(f'{v:.4f}' for v in t)}" for k, t in turns.items()) + f" ms on {card}")
    for k in order:
        split = cs.device_split(run(libs[k]), BF16_PHASES, reps=5)
        print(f"[tc-variants] K3 bf16 by phase, {k} (profiler, device ms a call): "
              + ", ".join(f"{p} {v:.4f}" for p, v in split.items() if v) + f"; sum {sum(split.values()):.4f}")


def bf16_ab(dev, card: str) -> None:
    """``[bf16]``: K1 (five layers, B = 16), K2 (four, B = 64) and K3 (five,
    B = 64) at bf16 beside f32 on the same values (``chip_smoke.bf16_layer``,
    each held against its plain version first), by their device time
    (profiler) in turns f32, bf16, bf16, f32; K3 also by phase. Then K6
    (five layers, B = 16), K4f (five, B = 8, mixed lengths), K4b (the seq2seq
    encoder layer, B = 64), K5f (five unidirectional layers, B = 16) and K5b
    (five, B = 64), the shapes of PERF.md's table, the same way
    (``chip_smoke.bf16_more_case``); K4b and K5b also by phase."""
    import numpy as np

    import chip_smoke as cs

    rng = np.random.default_rng(0)
    for k, shapes in bf16_more_shapes(rng).items():
        held = [cs.bf16_more_case(rng, dev, k, name, D, T, B, **kw) for name, D, T, B, kw in shapes]
        calls = {which: [h["calls"][which] for h in held] for which in ("f32", "bf16")}
        turns = {"f32": [], "bf16": []}
        for which in ("f32", "bf16", "bf16", "f32"):
            turns[which].append(cs.device_ms(lambda fns=calls[which]: [f() for f in fns], reps=5))
        print(f"[bf16] {k} {len(shapes)} layer{'s' * (len(shapes) > 1)} B={shapes[0][3]}, device time (profiler) in "
              f"turns: f32 {turns['f32'][0]:.4f}, bf16 {turns['bf16'][0]:.4f}, {turns['bf16'][1]:.4f}, f32 "
              f"{turns['f32'][1]:.4f} ms; largest share of the bf16-vs-f32 gap {max(h['ratio'] for h in held):.3g} "
              f"on {card}")
        if k in ("K4b", "K5b"):
            for which in ("f32", "bf16", "bf16", "f32"):
                split = cs.device_split(lambda fns=calls[which]: [f() for f in fns],
                                        cs.K4B_BF16_PHASES if which == "bf16" else cs.K4B_PHASES, reps=5)
                print(f"[bf16] {k} {which} by phase (profiler, device ms a call): "
                      + ", ".join(f"{p} {v:.4f}" for p, v in split.items()) + f"; sum {sum(split.values()):.4f}")
    for k, (B, shapes) in bf16_layers().items():
        held = [cs.bf16_layer(rng, dev, name, d, n, T, B, (k,)) for name, d, n, T in shapes]
        calls = {which: [cs.bf16_layer_call(k, h, which) for h in held] for which in ("f32", "bf16")}
        turns = {"f32": [], "bf16": []}
        for which in ("f32", "bf16", "bf16", "f32"):
            turns[which].append(cs.device_ms(lambda fns=calls[which]: [f() for f in fns], reps=5))
        print(f"[bf16] {k} {len(shapes)} layers B={B}, device time (profiler) in turns: f32 {turns['f32'][0]:.4f}, "
              f"bf16 {turns['bf16'][0]:.4f}, {turns['bf16'][1]:.4f}, f32 {turns['f32'][1]:.4f} ms on {card}")
        if k == "K3":
            for which in ("f32", "bf16", "bf16", "f32"):
                split = cs.device_split(lambda fns=calls[which]: [f() for f in fns],
                                        cs.K3_BF16_PHASES if which == "bf16" else cs.K3_PHASES, reps=5)
                print(f"[bf16] K3 {which} by phase (profiler, device ms a step): "
                      + ", ".join(f"{p} {v:.4f}" for p, v in split.items()) + f"; sum {sum(split.values()):.4f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k1-batches", type=int, nargs="*", default=[])
    ap.add_argument("--k2-batches", type=int, nargs="*", default=[])
    ap.add_argument("--k4f-batches", type=int, nargs="*", default=[])
    ap.add_argument("--k4b-batches", type=int, nargs="*", default=[])
    ap.add_argument("--k5b-batches", type=int, nargs="*", default=[])
    ap.add_argument("--k3-batches", type=int, nargs="*", default=[])
    ap.add_argument("--k3-hp", action="store_true", help="K3 at bf16: h_prev as it is against widened")
    ap.add_argument("--parent", help="a checkout whose kernel library to time against this tree's")
    ap.add_argument("--bf16", action="store_true", help="K1-K6 at bf16 beside f32, device time")
    ap.add_argument("--k8-plans", nargs="*", default=[], help="shapes B (4 s) or B:T")
    ap.add_argument("--k8-launch", action="store_true")
    ap.add_argument("--k7-sizes", action="store_true")
    ap.add_argument("--k7-variants", nargs="*", default=[], choices=sorted(VARIANTS))
    ap.add_argument("--tc-variants", nargs="*", default=[], choices=sorted(TC_VARIANTS))
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = cs.smi()
    print(f"[env] {card}")
    for name, batches, ab in (("k1", args.k1_batches, cs.k1_cluster_ab), ("k2", args.k2_batches, cs.k2_cluster_ab),
                              ("k4f", args.k4f_batches, cs.k4f_cluster_ab)):
        if batches:
            other = cs.load_variant(f"{name}_other_c", *cs.start_variant(f"{name}_other_c",
                                                                        *cs.VARIANTS[f"{name}_other_c"]))
            ab(dev, card, np.random.default_rng(0), other, tuple(batches))
    if args.k4b_batches or args.k5b_batches:
        other = cs.load_variant("bwd_other_c", *cs.start_variant("bwd_other_c", *cs.VARIANTS["bwd_other_c"]))
        for what, batches in (("K4b", args.k4b_batches), ("K5b", args.k5b_batches)):
            if batches:
                cs.bwd_cluster_ab(what, dev, card, np.random.default_rng(0), other, tuple(batches))
    if args.k3_batches:
        other = cs.load_variant("k3_other_c", *cs.start_variant("k3_other_c", *cs.VARIANTS["k3_other_c"]))
        for asr in (False, True):
            cs.k3_cluster_ab(dev, card, np.random.default_rng(0), other, tuple(args.k3_batches), asr=asr)
    if args.k3_hp:
        k3_hp_ab(dev, card)
    if args.parent:
        parent_ab(args.parent, dev, card)
    if args.bf16:
        bf16_ab(dev, card)
    if args.parent and args.bf16:
        parent_bf16_ab(args.parent, dev, card)
    if args.k8_plans:
        k8_plans(args.k8_plans, dev, card)
    if args.k8_launch:
        k8_launch(dev, card)
    if args.k7_sizes:
        from tpu_slu_torch.ops.beam_fused import beam_cluster_size

        sizes = {B: beam_cluster_size(B, 25, 4, *FLAG, 200) for B in
                 (1, 8, 12, 15, 16, 17, 24, 28, 30, 32, 34, 40, 64, 66, 67, 100, 133)}
        print(f"[k7-sizes] flagship decoder, W=4, 4 s: cluster size by B {sizes} on {card}")
    if args.k7_variants:
        k7_variants(args.k7_variants, dev, card)
    if args.tc_variants:
        tc_variants_ab(args.tc_variants, dev, card)


if __name__ == "__main__":
    main()
