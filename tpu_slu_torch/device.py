"""The device the port's entry points run on."""

from __future__ import annotations

import torch


def entry_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` when one is given; otherwise the CUDA device, and an error
    where there is none. An entry point never carries on on the CPU unless
    the caller asks for it (``device="cpu"`` runs the kernels' plain
    versions)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the port's "
                           "plain PyTorch path on the CPU")
    return torch.device("cuda")
