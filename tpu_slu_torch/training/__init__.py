"""Training of the PyTorch port: masked Adam and the fixed-slot SLU Trainer."""

from tpu_slu_torch.training.optim import MaskedAdam, clip_grad_norm
from tpu_slu_torch.training.trainer import Trainer

__all__ = ["MaskedAdam", "Trainer", "clip_grad_norm"]
