"""Utilities of the PyTorch port: profiling and step timing."""

from tpu_slu_torch.utils.profiling import StepTimer, profile_trace

__all__ = ["StepTimer", "profile_trace"]
