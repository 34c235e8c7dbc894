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
* sinc ``filt_b1``/``filt_band`` keep their names;
* the seq2seq head (``tpu_slu/models/torch_import.py``): ``encoder/i`` and
  ``decoder/rnn/i`` gain a ``layers`` level, a decoder GRUCell (no direction
  level) maps ``w_ih`` -> ``weight_ih`` transposed, the attention's
  ``key``/``query``/``value`` become ``*_linear``, and
  ``decoder/initial_state`` (layers, H) keeps its name and layout.

:func:`params_to_jax` is the exact inverse: a port ``state_dict`` (of the
whole model, or of the bare encoder that ``pretraining/model_state.npz``
holds) -> the JAX pytree, bit for bit. :func:`jax_leaf` names the JAX leaf
of one port parameter, which the optimizer's export
(``training/optim.py``) also follows.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_GRU_LEAVES = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih", "b_hh": "bias_hh"}
_GRU_DIRS = {"fwd": "_l0", "bwd": "_l0_reverse"}


def read_npz(path: str) -> dict[str, np.ndarray]:
    """The path-flattened arrays of a ``.npz`` checkpoint."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested dict (or list) of arrays -> ``{"a/b/c": array}``, the dict
    keys of each level sorted, as the JAX package writes a checkpoint."""
    out = {}
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def params_from_jax(tree_or_flat) -> dict[str, torch.Tensor]:
    """A JAX param pytree (nested dict of arrays) or its ``/``-flattened
    ``.npz`` dict -> a ``state_dict`` for the port's modules.

    Load the result with ``load_state_dict(..., strict=True)``, which raises
    on a missing key, an extra key or a wrong shape.
    """
    out = {}
    for path, arr in flatten(tree_or_flat).items():
        *head, leaf = path.split("/")
        arr = np.asarray(arr, np.float32)
        if head[:1] == ["encoder"]:
            head.insert(1, "layers")
        elif head[:2] == ["decoder", "rnn"]:
            head.insert(2, "layers")
        elif head[:2] == ["decoder", "attention"] and len(head) == 3:
            head[2] += "_linear"
        if head and head[-1] in _GRU_DIRS and leaf in _GRU_LEAVES:
            name = _GRU_LEAVES[leaf] + _GRU_DIRS[head.pop()]
            if leaf.startswith("w_"):
                arr = arr.T
        elif head[:3] == ["decoder", "rnn", "layers"] and leaf in _GRU_LEAVES:
            name = _GRU_LEAVES[leaf]  # a GRUCell: one direction, no suffix
            if leaf.startswith("w_"):
                arr = arr.T
        elif path == "decoder/initial_state":
            name = leaf
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


_PORT_GRU = re.compile(r"(weight|bias)_(ih|hh)(_l0(_reverse)?)?")


def jax_leaf(name: str, ndim: int) -> tuple[str, bool]:
    """A port parameter name -> (its JAX ``/``-path, whether the JAX array is
    the port's transposed): the inverse of :func:`params_from_jax`'s map."""
    *head, leaf = name.split(".")
    gru = _PORT_GRU.fullmatch(leaf)
    if gru and (gru.group(3) or head[:3] == ["decoder", "rnn", "layers"]):
        if gru.group(3):  # a direction of a (bi)GRU layer; a GRUCell has none
            head.append("bwd" if gru.group(4) else "fwd")
        out, transposed = f"{'w' if gru.group(1) == 'weight' else 'b'}_{gru.group(2)}", gru.group(1) == "weight"
    elif name == "decoder.initial_state" or leaf in ("filt_b1", "filt_band"):
        out, transposed = leaf, False
    elif leaf == "weight":
        out, transposed = "w", ndim == 2
    elif leaf == "bias":
        out, transposed = "b", False
    else:
        raise KeyError(f"no JAX leaf for the port parameter {name!r}")
    if head[:2] == ["encoder", "layers"]:
        del head[1]
    elif head[:3] == ["decoder", "rnn", "layers"]:
        del head[2]
    elif head[:2] == ["decoder", "attention"] and len(head) == 3 and head[2].endswith("_linear"):
        head[2] = head[2][: -len("_linear")]
    return "/".join([*head, out]), transposed


def params_to_jax(state_dict: Mapping) -> dict:
    """A port ``state_dict`` -> the JAX package's nested-dict param tree of
    numpy arrays, which ``params_from_jax`` maps back bit for bit and the
    JAX ``load_pytree`` reads from a ``.npz``. Any leaves keyed by parameter
    name go the same way (the optimizer's per-leaf state, its steps 0-d)."""
    tree: dict = {}
    for name, t in state_dict.items():
        arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        path, transposed = jax_leaf(name, arr.ndim)
        node = tree
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        arr = arr.T if transposed else arr
        node[leaf] = np.ascontiguousarray(arr).reshape(arr.shape)  # a 0-d leaf stays 0-d
    return tree
