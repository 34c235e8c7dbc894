"""Where the PyTorch port's flagship decode (or train step) spends its time on one GPU.

Builds the fixed-slot model at the width of ``experiments/no_unfreezing.cfg``
with seeded random weights (``tpu_slu_torch.models.flagship``), warms it up,
then for each batch size times warm ``predict_intents`` on 4 s of audio with
the host clock (ends in ``torch.cuda.synchronize``), untraced, and traces the
same calls with ``torch.profiler``: device time by kernel name, and the
device's idle share of the traced run's own wall time. ``--train`` does the
same for one ``Trainer.train_step`` (forward, backward, masked Adam) of
``experiments/no_pretraining.cfg``. Run from the root of a checkout:

    python3 tools/torch_decode_profile.py --batch 1 16
    python3 tools/torch_decode_profile.py --train --batch 64
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--train", action="store_true", help="time Trainer.train_step instead")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_slu_torch.models.flagship import TRAIN_CFG, flagship_model
    from tpu_slu_torch.training import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    if args.train:
        model = flagship_model("cuda", cfg=TRAIN_CFG)
        model.config.folder = tempfile.mkdtemp(prefix="train_profile_")
        trainer = Trainer(model, model.config, generator=torch.Generator().manual_seed(0))
        what = "Trainer.train_step"
    else:
        model = flagship_model("cuda")
        what = "predict_intents"
    rng = np.random.default_rng(1)
    for B in args.batch:
        x = torch.from_numpy((0.1 * rng.standard_normal((B, 4 * 16000))).astype(np.float32)).cuda()
        if args.train:
            batch = {"x": x, "w": torch.ones(B, device="cuda"),
                     "len": torch.full((B,), x.shape[1], dtype=torch.int64, device="cuda"),
                     "y_intent": torch.from_numpy(np.stack(
                         [rng.integers(0, n, B) for n in model.values_per_slot], 1)).cuda()}

            def call():
                trainer.train_step(batch)
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


if __name__ == "__main__":
    main()
