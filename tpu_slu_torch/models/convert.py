"""Carry the JAX package's parameters into the port's modules.

The JAX package keeps parameters as a nested dict pytree
(``params["pretrained_model"]["phoneme_layers"]["10"]["fwd"]["w_ih"]``) and
writes it to ``.npz`` with the paths flattened by ``/``
(``tpu_slu/training/checkpoint.py``). The port's modules are keyed like the
reference PyTorch checkpoints (``pretrained_model.phoneme_layers.10.weight_ih_l0``).
The mapping needs no architecture, only the leaf names:

* GRU ``{fwd,bwd}/{w_ih,w_hh,b_ih,b_hh}`` -> ``{weight,bias}_{ih,hh}_l0[_reverse]``,
  with the JAX (in, 3H) matrices transposed to torch's (3H, in);
* Linear ``w`` (2-D, (in, out)) -> ``weight`` (out, in), ``b`` -> ``bias``;
* conv ``w`` (3-D) keeps torch's (out, in, k) layout;
* sinc ``filt_b1``/``filt_band`` keep their names.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_GRU_LEAVES = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih", "b_hh": "bias_hh"}
_GRU_DIRS = {"fwd": "_l0", "bwd": "_l0_reverse"}


def read_npz(path: str) -> dict[str, np.ndarray]:
    """The path-flattened arrays of a ``.npz`` checkpoint."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


def params_from_jax(tree_or_flat) -> dict[str, torch.Tensor]:
    """A JAX param pytree (nested dict of arrays) or its ``/``-flattened
    ``.npz`` dict -> a ``state_dict`` for the port's modules.

    Load the result with ``load_state_dict(..., strict=True)``, which raises
    on a missing key, an extra key or a wrong shape.
    """
    out = {}
    for path, arr in _flatten(tree_or_flat).items():
        *head, leaf = path.split("/")
        arr = np.asarray(arr, np.float32)
        if head and head[-1] in _GRU_DIRS and leaf in _GRU_LEAVES:
            name = _GRU_LEAVES[leaf] + _GRU_DIRS[head.pop()]
            if leaf.startswith("w_"):
                arr = arr.T
        elif leaf in ("filt_b1", "filt_band"):
            name = leaf
        elif leaf == "w":
            name = "weight"
            if arr.ndim == 2:
                arr = arr.T
        elif leaf == "b":
            name = "bias"
        else:
            raise KeyError(f"no port parameter for the JAX leaf {path!r}")
        out[".".join([*head, name])] = torch.from_numpy(np.array(arr, order="C"))
    return out
