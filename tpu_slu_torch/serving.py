"""Dataset-free loading of a trained model for inference."""

from __future__ import annotations

import json
import os

import torch

from tpu_slu_torch.models.slu import Model


def load_trained_model(config, device: str | torch.device = "cpu") -> Model:
    """Build a :class:`Model` from a trained experiment folder, on ``device``.

    ``<folder>/training/vocab.json`` supplies the slot vocabulary (the port
    does not read datasets); the JAX package's ``model_state.npz`` is
    preferred, a reference ``model_state.pth`` is taken as well.
    """
    training = os.path.join(config.folder, "training")
    vocab_path = os.path.join(training, "vocab.json")
    if not os.path.isfile(vocab_path):
        raise FileNotFoundError(f"no {vocab_path}: the port decodes from a saved vocab only")
    with open(vocab_path) as f:
        Model.attach_vocab(config, json.load(f))
    model = Model(config, load_pretrained=False)
    npz = os.path.join(training, "model_state.npz")
    pth = os.path.join(training, "model_state.pth")
    if os.path.isfile(npz):
        model.load_native_checkpoint(npz)
    elif os.path.isfile(pth):
        model.load_state_dict(torch.load(pth, map_location="cpu"), strict=True)
    else:
        raise FileNotFoundError(f"no trained SLU checkpoint at {npz} or {pth}")
    return model.to(device).eval()
