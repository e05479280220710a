"""Exponential moving average of parameters.

Counterpart of ``yolodl_tpu/train/ema.py``: YOLOv5-style warmup decay
d(step) = decay · (1 − exp(−step/τ)), ema ← ema·d + param·(1 − d).  The port
keeps the average as a dict of tensors beside the model and updates it in
place under ``torch.no_grad()``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

Tensor = torch.Tensor


def ema_init(params: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Copies of ``params`` (name → tensor), detached from autograd."""
    return {k: v.detach().clone() for k, v in params.items()}


@torch.no_grad()
def ema_update(ema_params: Dict[str, Tensor], params: Dict[str, Tensor], step,
               decay: float = 0.9999, tau: float = 2000.0) -> Dict[str, Tensor]:
    """ema ← lerp(ema, param, 1 − d), in place; returns ``ema_params``."""
    d = decay * (1.0 - math.exp(-float(step) / tau))
    for k, e in ema_params.items():
        e.lerp_(params[k].to(e.dtype), 1.0 - d)
    return ema_params
