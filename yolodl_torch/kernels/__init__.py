"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  Sources live in ``yolodl_torch/csrc/``; ``_build`` compiles them
with nvcc at first CUDA use."""

from .iou import pairwise_iou, pairwise_iou_reference  # noqa: F401
