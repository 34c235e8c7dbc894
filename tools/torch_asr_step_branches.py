#!/usr/bin/env python3
"""The ASR train step's gradients on the card against the CPU's, and against
an f64 step that takes the card's front-end branches, over seeded batches.

    python3 tools/torch_asr_step_branches.py [--seeds 0 1 2 3 4] [--parent DIR]

For each seeded batch (``chip_smoke.asr_batches``: B = 64 on 2.25 s, the
flagship's encoder at ``pretraining_type`` 2) it runs one train step
(dropout on) of seeded random weights on the CPU and on the card, and
prints the four gradients farthest from the CPU's, each as its largest
error over its largest element; then the four farthest from an f64 CPU step
that replays the card's front-end branches (leaky ReLU signs, max-pool
argmaxes; ``chip_smoke.FrontEndBranches``), with the number of elements
where the f64 step's own branches part from the card's. Where the CPU's
f32 step takes another branch than the card's at one element, every
gradient upstream of it differs by a whole branch there, which the f64
step on the card's branches does not. ``--parent DIR``: the same card step
also with the kernel library of the checkout at DIR (e.g. the parent
commit unpacked under ``build/``), built by its own ``_build.py``, on the
same batch. Run from the root of a checkout on a machine with a GPU.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--parent", help="a checkout whose kernel library to run the card step with too")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpu_slu_torch.config import read_config
    from tpu_slu_torch.models.encoder import PretrainedModel, encoder_loss
    from tpu_slu_torch.models.flagship import FLAGSHIP_CFG
    from tpu_slu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(f"[env] {cs.smi()}")
    libs = {"this": _build.library()}
    if args.parent:
        spec = importlib.util.spec_from_file_location(
            "parent_build", os.path.join(os.path.abspath(args.parent), "tpu_slu_torch", "ops", "_build.py"))
        parent_build = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(parent_build)
        libs["parent"] = parent_build.library()
    config = read_config(FLAGSHIP_CFG, make_dirs=False)
    config.folder, config.num_phonemes = "", 42

    def step(model, where, batch, dtype=torch.float32):
        b = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        model.zero_grad(set_to_none=True)
        pl, wl, _, _ = encoder_loss(model, b["x"].to(dtype), b["y_phoneme"].long(), b["y_word"].long(), train=True,
                                    generator=torch.Generator().manual_seed(5), weights=b["w"].to(dtype))
        (pl + wl).backward()
        return (pl + wl).item(), {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}

    def worst(got, ref):
        errs = sorted(((cs.rel_err(got[n].to(r.dtype), r), n) for n, r in ref.items()), reverse=True)
        return ", ".join(f"{n} {e:.3g}" for e, n in errs[:4])

    real = _build._lib
    try:
        for seed in args.seeds:
            batch = cs.asr_batches(np.random.default_rng(seed), 1, 64, cs.ASR_T, 42, config.vocabulary_size,
                                   config.phone_downsample_factor, config.word_downsample_factor)[0]
            cpu_model = PretrainedModel(config, generator=torch.Generator().manual_seed(3)).train()
            card_model = copy.deepcopy(cpu_model).to(dev)
            l_cpu, g_cpu = step(cpu_model, torch.device("cpu"), batch)
            branches = cs.FrontEndBranches()
            for name, lib in libs.items():
                _build._lib = lib
                with branches.record():
                    l_card, g_card = step(card_model, dev, batch)
                print(f"[asr-branches] seed {seed}, {name} library: loss {l_card:.6f} against the CPU's {l_cpu:.6f}; "
                      f"farthest from the CPU's gradients: {worst(g_card, g_cpu)}", flush=True)
                if name == "this":
                    with branches.replay():
                        g64 = step(copy.deepcopy(cpu_model).double(), torch.device("cpu"), batch, torch.float64)[1]
                    print(f"[asr-branches] seed {seed}: {branches.flips} front-end branches of the f64 step part "
                          f"from the card's; farthest from the f64 step on the card's branches: "
                          f"{worst(g_card, g64)}", flush=True)
    finally:
        _build._lib = real


if __name__ == "__main__":
    main()
