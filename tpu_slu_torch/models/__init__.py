"""Models of the PyTorch port."""

from tpu_slu_torch.models.encoder import PretrainedModel
from tpu_slu_torch.models.slu import Model

__all__ = ["Model", "PretrainedModel"]
