"""Ops of the PyTorch port: plain tensor functions and the kernel wrappers.

Kernel modules build their CUDA sources on first use on a CUDA tensor,
never at import.
"""
