"""The one rule for where the port runs: ``device`` defaults to ``"cuda"``,
and without a card that default raises.  Only an explicit ``"cpu"`` runs on
the CPU; nothing moves there on its own."""

from __future__ import annotations

import torch


class NoCudaDeviceError(RuntimeError):
    """A card was asked for (the default) and there is none."""


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "no CUDA device is available; pass device='cpu' (--device cpu on "
            "the command line) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
