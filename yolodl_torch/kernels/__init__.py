"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  Sources live in ``yolodl_torch/csrc/``; ``_build`` compiles them
with nvcc at first CUDA use."""

from .iou import (  # noqa: F401
    nms_conflict_bits,
    nms_conflict_bits_reference,
    nms_keep_from_bits,
    nms_keep_from_bits_reference,
    pairwise_iou,
    pairwise_iou_reference,
)
from .wgrad_db import conv2d_db, wgrad_db, wgrad_db_reference  # noqa: F401
from .wgrad_lowch import conv2d_lowch, wgrad_lowch, wgrad_lowch_reference  # noqa: F401
