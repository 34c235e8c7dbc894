"""Seeded weights, made on the device in two calls.

The benchmark makes the weights of both sides from ``--seed``: one
``torch.rand`` of every uniform parameter together and one ``torch.randn``
of every normal one, on a generator on the run's device, then each leaf
scaled to its distribution (:func:`slubench.reference.model.param_specs`).
The program's model receives them through ``load_state_dict``; the
reference makes them again from the same seed after the window.
"""

from __future__ import annotations

import torch

from slubench.reference.model import Arch, mel_init, param_specs


def make_weights(arch: Arch, seed: int, device) -> dict[str, torch.Tensor]:
    """name -> f32 tensor on ``device`` of every parameter of ``arch``."""
    specs = param_specs(arch)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n_uni = sum(_numel(s) for _, s, k, _ in specs if k == "uniform")
    n_norm = sum(_numel(s) for _, s, k, _ in specs if k == "normal")
    uni = torch.rand(n_uni, generator=gen, device=device)
    norm = torch.randn(n_norm, generator=gen, device=device)
    mel = dict(zip(("mel_b1", "mel_band"), mel_init(arch.n_filt[0], arch.fs)))
    out, iu, inorm = {}, 0, 0
    for name, shape, kind, scale in specs:
        n = _numel(shape)
        if kind == "uniform":
            out[name] = ((uni[iu:iu + n] * 2.0 - 1.0) * scale).view(shape)
            iu += n
        elif kind == "normal":
            out[name] = (norm[inorm:inorm + n] * scale).view(shape)
            inorm += n
        else:
            out[name] = torch.from_numpy(mel[kind]).to(device)
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n
