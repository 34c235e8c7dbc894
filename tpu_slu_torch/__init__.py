"""tpu-slu in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of ``tpu_slu`` (the JAX package, which stays the reference). It
imports neither jax nor pandas; from ``tpu_slu`` it takes only the
standard-library config reader.

    from tpu_slu_torch import read_config, load_trained_model, read_wav
    config = read_config("exp.cfg")
    model = load_trained_model(config, device="cuda")
    signal, fs = read_wav("test.wav")
    model.decode_intents(signal)   # -> [["activate", "lights", "kitchen"]]

Training of the fixed-slot model is in ``tpu_slu_torch.training``
(``Trainer(model, config).train(dataset)``).
"""

from tpu_slu.config import Config, read_config
from tpu_slu_torch.data.audio import read_wav
from tpu_slu_torch.models import Model, PretrainedModel
from tpu_slu_torch.serving import load_trained_model

__all__ = ["Config", "Model", "PretrainedModel", "load_trained_model", "read_config", "read_wav"]
