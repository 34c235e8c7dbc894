"""tpu-slu in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of ``tpu_slu`` (the JAX package, which stays the reference). It
imports neither jax nor pandas, nor any module of ``tpu_slu``.

    from tpu_slu_torch import read_config, load_trained_model, read_wav
    config = read_config("exp.cfg")
    model = load_trained_model(config)   # on the GPU; device="cpu" on the CPU
    signal, fs = read_wav("test.wav")
    model.decode_intents(signal)   # -> [["activate", "lights", "kitchen"]]

Padded batches decode length-exact with ``decode_intents(x, lengths=)`` or
``bucket=True``; ``tpu_slu_torch.serving`` micro-batches concurrent
requests over HTTP (``python -m tpu_slu_torch.serving --config_path ...``).
Training of the fixed-slot model is in ``tpu_slu_torch.training``
(``Trainer(model, config).train(dataset)``).
"""

from tpu_slu_torch.config import Config, read_config
from tpu_slu_torch.data.audio import read_wav
from tpu_slu_torch.models import Model, PretrainedModel
from tpu_slu_torch.serving import load_trained_model

__all__ = ["Config", "Model", "PretrainedModel", "load_trained_model", "read_config", "read_wav"]
