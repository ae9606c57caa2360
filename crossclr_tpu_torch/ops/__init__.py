"""Kernels written by hand for Hopper, each beside its plain PyTorch
version.  Importing this package builds nothing: a kernel is compiled at
its first launch on a CUDA tensor."""

from .flash_attention import flash_attention, mha_reference

__all__ = ["flash_attention", "mha_reference"]
