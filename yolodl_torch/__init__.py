"""yolodl_torch — the PyTorch/CUDA port of yolodl_tpu for NVIDIA Hopper.

The JAX package ``yolodl_tpu`` stays the reference; this package imports
nothing of it and nothing of JAX.  Every module mirrors its counterpart's
path and names.  Entry points take ``device=`` and default to ``"cuda"``;
without a card they raise unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
