#!/usr/bin/env python3
"""Drive the PyTorch port (``tpu_slu_torch``) once on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when it fails:

1. environment: torch, the card, its power limit and nvcc; torch's TF32
   flags are left at their defaults, as a user has them;
2. build: compiles ``tpu_slu_torch/csrc/*.cu`` with nvcc;
3. K1 (the shared-stream bi-GRU kernel) against its plain PyTorch version
   on the card, over parts, pools, odd and even T, B and H = 128; the front
   end's convs on the card against an f64 conv on the CPU (f32, not TF32);
4. golden decode: the committed toy checkpoint ``tests/assets/golden`` decodes
   its six wavs exactly on the card, five K1 launches per call;
5. flagship slice: ``decode_intents`` at the width of
   ``experiments/no_unfreezing.cfg`` with seeded random weights at B = 1 and
   16, logits held against the same model on the CPU, then warm timings of
   ``predict_intents`` and of K1 alone against its plain version.

The last lines are the card's name and power limit, one JSON object on the
kernels, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ATOL = RTOL = 1e-4  # K1 vs plain, f32: the sums run in another order
LOGIT_ATOL = 1e-3  # whole slice, card vs CPU: errors compound over 5 GRU layers
CONV_RTOL = 1e-5  # f32 conv vs f64, of the largest output; TF32 (10-bit mantissa) is ~1e-3 off
GOLDEN = os.path.join(HERE, "tests", "assets", "golden")
K1_SOURCE = "tpu_slu_torch/csrc/bigru_shared_fwd.cu"
K1_REPLACES = "tpu_slu/ops/pallas_gru.py:771"


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_case(rng, n_parts, d, T, B, H, dev):
    """Random K1 inputs: (params on dev, parts on dev)."""
    import torch

    bound = 1.0 / H ** 0.5
    D = n_parts * d

    def u(*shape):
        return torch.from_numpy(rng.uniform(-bound, bound, shape).astype("float32")).to(dev)

    params = {k: {"weight_ih": u(3 * H, D), "weight_hh": u(3 * H, H), "bias_ih": u(3 * H),
                  "bias_hh": u(3 * H)} for k in ("fwd", "bwd")}
    parts = tuple(torch.from_numpy(rng.standard_normal((T, B, d)).astype("float32")).to(dev)
                  for _ in range(n_parts))
    return params, parts


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "tpu_slu_torch")):
        raise SystemExit("chip_smoke.py: tpu_slu_torch/ is not beside this script; "
                         "run it from the root of a checkout")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false; this runs only on a GPU")

    import torch.nn.functional as F

    from tpu_slu_torch import read_config
    from tpu_slu_torch.data.audio import read_wav
    from tpu_slu_torch.models.flagship import flagship_model
    from tpu_slu_torch.ops import _build
    from tpu_slu_torch.ops.bigru_shared import bigru_shared, bigru_shared_reference
    from tpu_slu_torch.ops.conv import conv1d
    from tpu_slu_torch.ops.sinc import mel_init, sinc_filters
    from tpu_slu_torch.serving import load_trained_model

    # 1. environment
    dev = torch.device("cuda", 0)
    card = smi()
    print(f"[env] python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    print(f"[env] device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    print(f"[env] nvidia-smi: {card}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[-1]
    print(f"[env] nvcc: {nvcc}")
    print("[env] TF32 flags left at torch's defaults, as a user has them: the port runs its "
          "convs in cuDNN with TF32 off per call (checked below) and K1 in f32 CUDA code")

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.library()
    print(f"[build] {os.path.relpath(lib_path, HERE)} in {time.perf_counter() - t0:.1f} s")

    # 3. K1 against its plain version on the card
    rng = np.random.default_rng(0)
    max_err = 0.0
    n_cases = 0
    for n_parts, d in ((1, 60), (2, 128)):
        for T in (25, 21, 400):
            for B in (1, 16):
                for pool, method in ((1, "avg"), (2, "avg"), (2, "max")):
                    params, parts = k1_case(rng, n_parts, d, T, B, 128, dev)
                    before = bigru_shared.launches
                    h_f, h_b, pooled = bigru_shared(params, parts, pool=pool, pool_method=method)
                    torch.cuda.synchronize()
                    assert bigru_shared.launches == before + 1, "K1 launch counter did not advance"
                    assert pooled == (pool > 1)
                    r_f, r_b = bigru_shared_reference(params, parts, pool=pool, pool_method=method)
                    assert h_f.shape == r_f.shape == h_b.shape == r_b.shape, (h_f.shape, r_f.shape)
                    err = max((h_f - r_f).abs().max().item(), (h_b - r_b).abs().max().item())
                    rel = err / max(r_f.abs().max().item(), r_b.abs().max().item(), 1e-30)
                    max_err = max(max_err, err)
                    if not (torch.allclose(h_f, r_f, atol=ATOL, rtol=RTOL)
                            and torch.allclose(h_b, r_b, atol=ATOL, rtol=RTOL)):
                        raise AssertionError(
                            f"K1 disagrees with its plain version: parts={n_parts} D={n_parts * d} "
                            f"T={T} B={B} pool={pool}/{method}: max abs {err:.3g} rel {rel:.3g}")
                    n_cases += 1
                    print(f"[k1] parts={n_parts} D={n_parts * d:3d} T={T:3d} B={B:2d} "
                          f"pool={pool}/{method}: max abs err {err:.3g} (rel {rel:.3g})")
    print(f"[k1] {n_cases} cases within atol {ATOL} rtol {RTOL}; max abs err {max_err:.3g}")

    # the front end's convs are f32 on the card, whatever cudnn.allow_tf32 says
    b1, band = (torch.from_numpy(a) for a in mel_init(80, 16000))
    conv_cases = [("sinc 80x401/80", rng.standard_normal((16, 1, 4 * 16000)),
                   sinc_filters(b1, band, 401, 16000)[:, None, :].numpy(), 80, 200),
                  ("conv 60x80x5", rng.standard_normal((16, 80, 400)),
                   rng.uniform(-0.1, 0.1, (60, 80, 5)), 1, 2)]
    for name, xs, ws, stride, pad in conv_cases:
        xs, ws = torch.from_numpy(xs).float(), torch.from_numpy(ws).float()
        ref = F.conv1d(xs.double(), ws.double(), stride=stride, padding=pad)  # f64 on the CPU
        xd, wd = xs.to(dev), ws.to(dev)
        err = (conv1d(xd, wd, stride=stride, padding=pad).double().cpu() - ref).abs().max().item()
        lib_err = (F.conv1d(xd, wd, stride=stride, padding=pad).double().cpu() - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not err <= CONV_RTOL * scale:
            raise AssertionError(f"{name}: port's conv1d on the card off the f64 reference by {err:.3g} "
                                 f"> {CONV_RTOL} x {scale:.3g}")
        print(f"[conv] {name}: port conv1d max abs err {err:.3g} vs f64 (limit {CONV_RTOL} x max "
              f"{scale:.3g}); F.conv1d at torch's TF32 default {lib_err:.3g}")

    # 4. golden decode on the card
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        folder = os.path.join(tmp, "exp")
        with open(os.path.join(GOLDEN, "experiment.cfg.template")) as f:
            template = f.read()
        cfg_path = os.path.join(tmp, "exp.cfg")
        with open(cfg_path, "w") as f:
            f.write(template.replace("__GOLDEN_FOLDER__", folder))
        config = read_config(cfg_path)
        for name in ("model_state.npz", "vocab.json"):
            shutil.copyfile(os.path.join(GOLDEN, name), os.path.join(folder, "training", name))
        golden = load_trained_model(config, device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    with open(os.path.join(GOLDEN, "expected.json")) as f:
        expected = json.load(f)["expected"]
    for case in expected:
        wav, fs = read_wav(os.path.join(GOLDEN, case["wav"]))
        assert fs == 16000
        before = bigru_shared.launches
        decoded = golden.decode_intents(wav[None, :])[0]
        launched = bigru_shared.launches - before
        want = [case["action"], case["object"], case["location"]]
        if decoded != want or launched != 5:
            raise AssertionError(f"golden {case['wav']}: decoded {decoded}, want {want}; "
                                 f"K1 launches {launched}, want 5")
        print(f"[golden] {case['wav']}: {decoded} exact, K1 launches +{launched}")

    # 5. flagship slice at no_unfreezing.cfg widths, seeded random weights
    cpu_model = flagship_model()
    model = copy.deepcopy(cpu_model).to(dev)
    x = (0.1 * np.random.default_rng(1).standard_normal((16, 4 * 16000))).astype(np.float32)
    batches = {1: x[:1], 16: x}

    bigru_shared.launches = 0
    decoded = {B: model.decode_intents(xb) for B, xb in batches.items()}
    torch.cuda.synchronize()
    launches = bigru_shared.launches
    if launches != 5 * len(batches):
        raise AssertionError(f"flagship decode launched K1 {launches} times, want {5 * len(batches)}")
    vocab = model.Sy_intent
    for B, dec in decoded.items():
        assert len(dec) == B and all(len(d) == 3 for d in dec), dec
        assert all(v in vocab[s] for d in dec for s, v in zip(vocab, d)), dec
    print(f"[flagship] decode_intents B=1 -> {decoded[1]}; B=16 -> {len(decoded[16])} decodes; "
          f"K1 launches {launches}")

    for B, xb in batches.items():
        logits, preds = model.predict_intents(xb)
        ref, ref_preds = cpu_model.predict_intents(xb)
        assert logits.shape == (B, 24) and torch.isfinite(logits).all()
        err = (logits.cpu() - ref).abs().max().item()
        if not err <= LOGIT_ATOL:
            raise AssertionError(f"flagship B={B}: card vs CPU logits max abs err {err:.3g} > {LOGIT_ATOL}")
        print(f"[flagship] B={B}: logits card vs CPU max abs err {err:.3g} (atol {LOGIT_ATOL}); "
              f"predictions equal: {bool((preds.cpu() == ref_preds).all())}")

    decode_ms = {}
    for B, xb in batches.items():
        xd = torch.from_numpy(xb).to(dev)
        decode_ms[B] = cuda_ms(lambda: model.predict_intents(xd), reps=30, warmup=5)
        print(f"[time] warm predict_intents B={B:2d}, 4 s audio: median {decode_ms[B]:.3f} ms "
              f"of 30 (CUDA events) on {card}")

    # K1 alone at the five flagship layer shapes (input width, parts, T, pool)
    shapes = [("phone_rnn0", 60, 1, 400, 2), ("phone_rnn1", 128, 2, 200, 2),
              ("word_rnn0", 128, 2, 100, 2), ("word_rnn1", 128, 2, 50, 2),
              ("intent_rnn0", 256, 1, 25, 1)]
    totals = {B: [0.0, 0.0] for B in batches}
    for B in batches:
        for name, d, n_parts, T, pool in shapes:
            params, parts = k1_case(rng, n_parts, d, T, B, 128, dev)
            got = bigru_shared(params, parts, pool=pool)[:2]
            ref = bigru_shared_reference(params, parts, pool=pool)
            err = max((g - r).abs().max().item() for g, r in zip(got, ref))
            max_err = max(max_err, err)
            assert all(torch.allclose(g, r, atol=ATOL, rtol=RTOL) for g, r in zip(got, ref)), err
            plain, kern = [], []
            for _ in range(3):  # in turns: plain, kernel, kernel, plain, ...
                plain.append(cuda_ms(lambda: bigru_shared_reference(params, parts, pool=pool), reps=1, warmup=0))
                kern.append(cuda_ms(lambda: bigru_shared(params, parts, pool=pool), reps=10, warmup=1))
                kern.append(cuda_ms(lambda: bigru_shared(params, parts, pool=pool), reps=10, warmup=0))
                plain.append(cuda_ms(lambda: bigru_shared_reference(params, parts, pool=pool), reps=1, warmup=0))
            k_ms, p_ms = statistics.median(kern), statistics.median(plain)
            totals[B][0] += k_ms
            totals[B][1] += p_ms
            print(f"[time] K1 {name:11s} B={B:2d} D={n_parts * d:3d} T={T:3d} pool={pool}: "
                  f"kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, max abs err {err:.3g}")
        print(f"[time] K1 five flagship layers B={B:2d}: kernel {totals[B][0]:.4f} ms, "
              f"plain {totals[B][1]:.3f} ms on {card}")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "bigru_shared_fwd", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches, "max_abs_err": max_err,
        "ms": totals[16][0], "plain_ms": totals[16][1],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
