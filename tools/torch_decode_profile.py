"""Where the PyTorch port's flagship decode (or train step) spends its time on one GPU.

Builds the fixed-slot model at the width of ``experiments/no_unfreezing.cfg``
with seeded random weights (``tpu_slu_torch.models.flagship``), warms it up,
then for each batch size times warm ``predict_intents`` on 4 s of audio with
the host clock (ends in ``torch.cuda.synchronize``), untraced, and traces the
same calls with ``torch.profiler``: device time by kernel name, and the
device's idle share of the traced run's own wall time. ``--train`` does the
same for one ``Trainer.train_step`` (forward, backward, masked Adam) of
``experiments/no_pretraining.cfg``; ``--seq2seq`` for the seq2seq model of
``experiments/all_real_seq2seq.cfg`` (its decode: W = 4, U = 200);
``--seconds`` sets the audio's length; ``--exact`` times the length-exact
decode the ``IntentServer`` runs instead, ``predict_intents(x,
lengths=n)`` of a padded (B, seconds) batch whose seeded lengths lie
between 1 s and the batch's length (row 0 full). ``--unidirectional`` makes every GRU
layer of the fixed-slot model one direction (``UNIDIRECTIONAL``), and
``--no-dropout`` sets its GRU layers' dropout to 0, so that a train step
can be timed with and without its host-drawn dropout masks. With
``--host-ops N`` it also lists the traced run's N operators that took the
most host time (self CPU time). ``--repo`` imports the port from another
checkout, so that one call on the card can time two trees in turns.
``--train --models`` times each listed model's step in one process, at
B = 64 as ``chip_smoke.py`` phase 14 trains them: ``fixed-slot``, ``asr``
(the ``no_unfreezing.cfg`` encoder at ``pretraining_type`` 2 on 2.25 s),
``seq2seq`` (``all_real_seq2seq.cfg``, U = 32), ``unidirectional`` and
``rowstack`` (the fixed-slot model with ``gru_layout="rowstack"``), each on
the batches of ``chip_smoke.py``'s helpers (imported from ``--repo``);
``--compute-dtype bfloat16`` trains them at bf16. Run from the root of a
checkout:

    python3 tools/torch_decode_profile.py --batch 1 16
    python3 tools/torch_decode_profile.py --train --batch 64
    python3 tools/torch_decode_profile.py --exact --batch 8
    python3 tools/torch_decode_profile.py --train --unidirectional --no-dropout --host-ops 12
    python3 tools/torch_decode_profile.py --seq2seq --batch 16 --seconds 30
    python3 tools/torch_decode_profile.py --train --compute-dtype bfloat16 \
        --models fixed-slot asr seq2seq unidirectional rowstack --repo build/parent
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_MODELS = ("fixed-slot", "asr", "seq2seq", "unidirectional", "rowstack")


def step_profile(call, reps: int):
    """(untraced wall median ms, traced wall ms a call, device busy ms a call,
    launches a call, [(ms, launches, name)] by kernel) of ``reps`` warm
    calls of ``call``, after 5 to warm up."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        call()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        traced_wall = (time.perf_counter() - t0) * 1e3 / reps
    # a user annotation (e.g. Optimizer.step) spans kernels listed on their own
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    rows = [(e.self_device_time_total / reps / 1e3, e.count / reps, e.key) for e in kernels]
    return (float(np.median(walls)), traced_wall, sum(r[0] for r in rows), sum(r[1] for r in rows), rows)


def train_models(args) -> None:
    """``--train --models``: each model's warm ``Trainer.train_step`` at B =
    64 and ``--compute-dtype``, its busy time, idle share and launches."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpu_slu_torch import read_config
    from tpu_slu_torch.models.encoder import PretrainedModel
    from tpu_slu_torch.models.flagship import (FLAGSHIP_CFG, TRAIN_CFG, UNIDIRECTIONAL, flagship_model,
                                               flagship_seq2seq_model)
    from tpu_slu_torch.training import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = cs.smi()
    print(f"tpu_slu_torch from {os.path.dirname(os.path.dirname(sys.modules['tpu_slu_torch'].__file__))}, "
          f"compute_dtype {args.compute_dtype}")
    for kind in args.models:
        rng = np.random.default_rng(1)
        if kind == "asr":
            config = read_config(FLAGSHIP_CFG, make_dirs=False)
            config.num_phonemes = 42
            model = PretrainedModel(config, generator=torch.Generator().manual_seed(1)).to(dev)
            batch = cs.asr_batches(rng, 1, 64, cs.ASR_T, 42, config.vocabulary_size,
                                   config.phone_downsample_factor, config.word_downsample_factor)[0]
        else:
            model = (flagship_seq2seq_model(dev, seed=1) if kind == "seq2seq" else
                     flagship_model(dev, cfg=TRAIN_CFG, seed=1, **(UNIDIRECTIONAL if kind == "unidirectional" else {})))
            if kind == "rowstack":
                model.pretrained_model.gru_layout = "rowstack"
            config = model.config
            B = config.training_batch_size
            batch = (cs.s2s_batches(rng, 1, B, model.Sy_intent) if kind == "seq2seq"
                     else cs.synthetic_batches(rng, 1, B, model.values_per_slot))[0]
        config.folder = tempfile.mkdtemp(prefix="train_profile_")
        config.compute_dtype = args.compute_dtype
        trainer = Trainer(model, config, generator=torch.Generator().manual_seed(7))
        dbatch = trainer._to_device(batch)
        wall, traced, busy, launches, rows = step_profile(lambda: trainer.train_step(dbatch), args.reps)
        print(f"{kind}: warm Trainer.train_step B={len(batch['x'])} at {args.compute_dtype}: wall median "
              f"{wall:.3f} ms of {args.reps} (host clock, synchronised); traced: wall {traced:.3f} ms a step, "
              f"device busy {busy:.3f} ms, idle share {1 - busy / traced:.3f}, {launches:.0f} launches a step; "
              f"{card}")
        for ms, n, key in rows[:12]:
            print(f"  {ms:8.4f} ms  {n:5.1f} launches  {key[:90]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--train", action="store_true", help="time Trainer.train_step instead")
    ap.add_argument("--seq2seq", action="store_true", help="the seq2seq model instead")
    ap.add_argument("--seconds", type=float, default=4.0, help="length of the seeded audio")
    ap.add_argument("--exact", action="store_true", help="the length-exact decode of a padded batch")
    ap.add_argument("--unidirectional", action="store_true", help="every GRU layer one direction")
    ap.add_argument("--no-dropout", action="store_true", help="the GRU layers' dropout at 0")
    ap.add_argument("--host-ops", type=int, default=0, help="list the N operators of most host time")
    ap.add_argument("--repo", default=HERE, help="the checkout whose tpu_slu_torch to import")
    ap.add_argument("--models", nargs="+", choices=list(TRAIN_MODELS), help="--train: these models' steps")
    ap.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="--train --models: the trainers' compute_dtype")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    if args.models:
        if not args.train:
            raise SystemExit("--models times train steps: add --train")
        train_models(args)
        return
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_slu_torch.models.flagship import TRAIN_CFG, flagship_model, flagship_seq2seq_model
    from tpu_slu_torch.training import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(f"tpu_slu_torch from {os.path.dirname(os.path.dirname(sys.modules['tpu_slu_torch'].__file__))}")
    overrides = {}
    if args.unidirectional:
        from tpu_slu_torch.models.flagship import UNIDIRECTIONAL

        overrides.update(UNIDIRECTIONAL)
    if args.no_dropout:
        overrides.update(phone_rnn_drop=[0.0, 0.0], word_rnn_drop=[0.0, 0.0], intent_rnn_drop=[0.0])
    if args.train:
        model = flagship_model("cuda", cfg=TRAIN_CFG, **overrides)
        model.config.folder = tempfile.mkdtemp(prefix="train_profile_")
        trainer = Trainer(model, model.config, generator=torch.Generator().manual_seed(0))
        what = f"Trainer.train_step{' ' + str(overrides) if overrides else ''}"
    else:
        model = flagship_seq2seq_model("cuda") if args.seq2seq else flagship_model("cuda", **overrides)
        what = (f"predict_intents{' (seq2seq, W=4)' if args.seq2seq else ''}"
                f"{' (length-exact, seeded lengths)' if args.exact else ''} on {args.seconds:g} s")
    rng = np.random.default_rng(1)
    for B in args.batch:
        x = torch.from_numpy((0.1 * rng.standard_normal((B, int(args.seconds * 16000)))).astype(np.float32)).cuda()
        if args.train:
            batch = {"x": x, "w": torch.ones(B, device="cuda"),
                     "len": torch.full((B,), x.shape[1], dtype=torch.int64, device="cuda"),
                     "y_intent": torch.from_numpy(np.stack(
                         [rng.integers(0, n, B) for n in model.values_per_slot], 1)).cuda()}

            def call():
                trainer.train_step(batch)
        elif args.exact:
            n = torch.from_numpy(rng.integers(16000, x.shape[1] + 1, B)).cuda()
            n[0] = x.shape[1]

            def call():
                model.predict_intents(x, lengths=n)
        else:
            def call():
                model.predict_intents(x)
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = float(np.median(walls))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.reps):
                call()
            torch.cuda.synchronize()
            traced_wall = (time.perf_counter() - t0) * 1e3 / args.reps
        # a user annotation (e.g. Optimizer.step) spans kernels listed on their own
        kernels = [e for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)]
        kernels.sort(key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in kernels) / args.reps / 1e3
        print(f"B={B}: warm {what} untraced: wall median {wall:.3f} ms of {args.reps} "
              f"(host clock, synchronised); traced run: wall {traced_wall:.3f} ms per call "
              f"(mean of {args.reps}), device busy {busy:.3f} ms per call, idle share "
              f"{1 - busy / traced_wall:.3f}; {card}")
        for e in kernels:
            print(f"  {e.self_device_time_total / args.reps / 1e3:8.4f} ms  "
                  f"{e.count / args.reps:5.1f} launches  {e.key[:90]}")
        if args.host_ops:
            ops = [e for e in prof.key_averages() if e.device_type.name == "CPU"]
            ops.sort(key=lambda e: -e.self_cpu_time_total)
            host = sum(e.self_cpu_time_total for e in ops) / args.reps / 1e3
            print(f"B={B}: host self time of the traced operators {host:.3f} ms per call; the "
                  f"{args.host_ops} largest:")
            for e in ops[:args.host_ops]:
                print(f"  {e.self_cpu_time_total / args.reps / 1e3:8.4f} ms  "
                      f"{e.count / args.reps:7.1f} calls  {e.key[:90]}")


if __name__ == "__main__":
    main()
