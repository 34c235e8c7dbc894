"""Where the PyTorch port's flagship decode spends its time on one GPU.

Builds the fixed-slot model at the width of ``experiments/no_unfreezing.cfg``
with seeded random weights (``tpu_slu_torch.models.flagship``), warms it up,
then for each batch size times warm ``predict_intents`` on 4 s of audio with
the host clock (ends in ``torch.cuda.synchronize``), untraced, and traces the
same calls with ``torch.profiler``: device time by kernel name, and the
device's idle share of the traced run's own wall time. Run from the root of a
checkout:

    python3 tools/torch_decode_profile.py --batch 1 16
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_slu_torch.models.flagship import flagship_model

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    model = flagship_model("cuda")
    rng = np.random.default_rng(1)
    for B in args.batch:
        x = torch.from_numpy((0.1 * rng.standard_normal((B, 4 * 16000))).astype(np.float32)).cuda()
        for _ in range(5):
            model.predict_intents(x)
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            model.predict_intents(x)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = float(np.median(walls))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.reps):
                model.predict_intents(x)
            torch.cuda.synchronize()
            traced_wall = (time.perf_counter() - t0) * 1e3 / args.reps
        kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        kernels.sort(key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in kernels) / args.reps / 1e3
        print(f"B={B}: warm predict_intents untraced: wall median {wall:.3f} ms of {args.reps} "
              f"(host clock, synchronised); traced run: wall {traced_wall:.3f} ms per call "
              f"(mean of {args.reps}), device busy {busy:.3f} ms per call, idle share "
              f"{1 - busy / traced_wall:.3f}; {card}")
        for e in kernels:
            print(f"  {e.self_device_time_total / args.reps / 1e3:8.4f} ms  "
                  f"{e.count / args.reps:5.1f} launches  {e.key[:90]}")


if __name__ == "__main__":
    main()
