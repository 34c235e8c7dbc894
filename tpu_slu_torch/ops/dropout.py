"""Counter-based dropout keep mask of the fused train path, in plain PyTorch.

Port of ``_keep_mask`` in ``tpu_slu/ops/pallas_gru.py``: two rounds of a
murmur-style uint32 finaliser over the NATURAL (t, b, h) coordinates and a
per-layer uint32 seed, so that the forward and the backward of a layer
regenerate the same mask with nothing stored between them. For the same seed
the mask is bit-identical to the JAX package's, and to the one the CUDA
kernels compute in device code (``csrc/bigru_common.cuh`` ``keep_hash``).

torch has no uint32 arithmetic, so the hash runs in int64 and is cut back to
its low 32 bits after every multiply and add: a 32 x 32-bit product may wrap
past 2**63, but its low 32 bits survive the wrap.
"""

from __future__ import annotations

import torch

DIR_SALT_F = 0x9E3779B9
DIR_SALT_B = 0x7F4A7C15
_M32 = 0xFFFFFFFF


def keep_threshold(drop_p: float) -> int:
    """The mask's threshold on the top 24 hash bits: round((1 - p) * 2**24)."""
    return int(round((1.0 - drop_p) * (1 << 24)))


def keep_mask(seed: int, dir_salt: int, t0: int, shape, thresh: int, device=None) -> torch.Tensor:
    """(T, B, H) bool keep mask; ``t0`` is the natural time of row 0."""
    T, B, H = shape

    def iota(n, axis):
        view = [1, 1, 1]
        view[axis] = n
        return torch.arange(n, dtype=torch.int64, device=device).view(view)

    t = (iota(T, 0) + t0) & _M32
    x = (int(seed) ^ dir_salt) & _M32
    x = (x + ((t * 0x9E3779B1) & _M32)) & _M32
    x = (x + ((iota(B, 1) * 0x85EBCA77) & _M32)) & _M32
    x = (x + ((iota(H, 2) * 0xC2B2AE3D) & _M32)) & _M32
    for _ in range(2):
        x = x ^ (x >> 16)
        x = (x * 0x7FEB352D) & _M32
        x = x ^ (x >> 15)
        x = (x * 0x846CA68B) & _M32
    x = x ^ (x >> 16)
    return (x >> 8) < thresh
