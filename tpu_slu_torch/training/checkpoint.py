"""Checkpoint I/O: nested dicts of arrays as ``.npz`` with ``/``-flattened keys.

Port of the ``.npz`` backend of ``tpu_slu/training/checkpoint.py``: the
same file format, so either package reads what the other writes. Dict keys
are written in sorted order; the file is written beside its target and
moved over it with ``os.replace``. A template re-imposes the tree on load,
and a missing key or a wrong shape raises. The orbax backend is not ported.
"""

from __future__ import annotations

import os

import numpy as np

from tpu_slu_torch.models.convert import flatten

_SEP = "/"


def check_backend(config) -> None:
    """Raise for a ``checkpoint_backend`` other than ``npz``."""
    backend = getattr(config, "checkpoint_backend", "npz")
    if backend != "npz":
        raise ValueError(f"checkpoint_backend={backend!r} is not supported by the port; use npz "
                         "(orbax is the JAX package's multi-host backend)")


def save_pytree(path: str, tree) -> None:
    tmp = path + ".tmp"
    np.savez(tmp, **flatten(tree))
    # np.savez appends .npz to names without it
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load_pytree(path: str, template):
    """The arrays of ``path`` in the structure of ``template`` (whose leaves
    give the shapes)."""
    with np.load(path) as data:
        flat = dict(data)

    def rebuild(node, prefix=""):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}{k}{_SEP}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, f"{prefix}{i}{_SEP}") for i, v in enumerate(node))
        key = prefix.rstrip(_SEP)
        if key not in flat:
            raise KeyError(f"checkpoint {path} missing key {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(np.shape(node)):
            raise ValueError(f"checkpoint {path} key {key!r}: shape {arr.shape} != expected "
                             f"{tuple(np.shape(node))}")
        return arr

    return rebuild(template)
