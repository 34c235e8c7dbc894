#!/usr/bin/env python3
"""One bf16 train step of each model against the CPU, at several seeded
batches, with ``chip_smoke.bf16_step_vs_cpu``'s holds: how far the card's
bf16 step lies from the CPU's, and bf16's own noise floor, as shares of the
bf16-vs-f32 gap. A batch that fails the hold is reported, not raised.

    python3 tools/torch_bf16_steps.py [--fixed-slot 0 1 2 3 4 5] [--asr 0 1 2]
        [--seq2seq 0 1 2] [--unidirectional 0 1 2] [--rowstack 0 1 2 3 4 5]

The fixed-slot, ASR and row-stacked steps at B = 16, the seq2seq and the
unidirectional ones at B = 64 (``chip_smoke.py`` phase 14's batches).

Each seed s draws its batch and weights' nudges from
``np.random.default_rng(100 + s)``. Run from the root of a checkout, on a GPU.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fixed-slot", type=int, nargs="*", default=[0, 1, 2, 3, 4, 5])
    ap.add_argument("--asr", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--seq2seq", type=int, nargs="*", default=[])
    ap.add_argument("--unidirectional", type=int, nargs="*", default=[])
    ap.add_argument("--rowstack", type=int, nargs="*", default=[])
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke

    dev = torch.device("cuda", 0)
    print(f"[env] {chip_smoke.smi()}")
    for kind, seeds, B in (("fixed-slot", args.fixed_slot, 16), ("ASR", args.asr, 16),
                           ("seq2seq", args.seq2seq, 64), ("unidirectional", args.unidirectional, 64),
                           ("rowstack", args.rowstack, 16)):
        for seed in seeds:
            try:
                chip_smoke.bf16_step_vs_cpu(dev, np.random.default_rng(100 + seed), kind, B)
                print(f"[bf16-steps] {kind} seed {seed}: passed", flush=True)
            except AssertionError as e:
                print(f"[bf16-steps] {kind} seed {seed}: FAILED {e}", flush=True)


if __name__ == "__main__":
    main()
