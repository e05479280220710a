"""Parameter bridge between the reference's trees and the port's modules.

The reference keeps parameters as ``{path: {"w": HWIO, "b"?, "bn":
{"scale", "bias"}}}`` and BN state as ``{path: {"bn": {"mean", "var"}}}``
(yolodl_tpu ops/conv.py:62-74, ops/norm.py:32-44), with numpy or JAX arrays
as leaves.  The port's ``state_dict`` names the same tensors
``layers.<path>.w`` (OIHW), ``layers.<path>.b``, ``layers.<path>.bn.scale``
… ``layers.<path>.bn.var``.  Only numpy crosses the boundary, so this
module needs nothing of JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .models.builder import module_key


def _path_of(key: str) -> str:
    return key.replace("/", ".")


def params_from_jax(params: Dict, state: Dict, model: Optional[torch.nn.Module] = None
                    ) -> Dict[str, torch.Tensor]:
    """Reference (params, state) trees → the port's ``state_dict`` (f32,
    CPU).  HWIO kernels become OIHW by ``permute(3, 2, 0, 1)``.

    With ``model``, the values are also copied into the model's own
    parameters and BN buffers in place (on whatever device they live), and
    every entry of the model's ``state_dict`` must be given: two trainers
    can then start from the same weights and running statistics."""
    sd: Dict[str, torch.Tensor] = {}
    for path, p in params.items():
        prefix = f"layers.{module_key(path)}"
        w = torch.from_numpy(np.array(p["w"], np.float32))
        sd[f"{prefix}.w"] = w.permute(3, 2, 0, 1).contiguous()
        if "b" in p:
            sd[f"{prefix}.b"] = torch.from_numpy(np.array(p["b"], np.float32))
        for name, value in p.get("bn", {}).items():
            sd[f"{prefix}.bn.{name}"] = torch.from_numpy(np.array(value, np.float32))
    for path, s in state.items():
        prefix = f"layers.{module_key(path)}"
        for name, value in s.get("bn", {}).items():
            sd[f"{prefix}.bn.{name}"] = torch.from_numpy(np.array(value, np.float32))
    if model is not None:
        target = model.state_dict()
        if set(target) != set(sd):
            raise KeyError(f"reference trees and model disagree: "
                           f"{sorted(set(target) ^ set(sd))[:8]}")
        with torch.no_grad():
            for key, t in target.items():
                t.copy_(sd[key])
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """The port's ``state_dict`` (parameters and BN running stats) →
    reference (params, state) trees of f32 numpy arrays; the inverse of
    :func:`params_from_jax`.  Reads the port's trained weights back for a
    comparison with the reference's."""
    params: Dict = {}
    state: Dict = {}
    for key, t in state_dict.items():
        if not key.startswith("layers."):
            raise KeyError(f"unexpected state_dict entry {key!r}")
        parts = key[len("layers."):].split(".")
        path, leaf = _path_of(parts[0]), parts[1:]
        value = t.detach().to("cpu", torch.float32).numpy()
        if leaf == ["w"]:
            params.setdefault(path, {})["w"] = np.ascontiguousarray(
                value.transpose(2, 3, 1, 0))
        elif leaf == ["b"]:
            params.setdefault(path, {})["b"] = value
        elif leaf[0] == "bn" and leaf[1] in ("scale", "bias"):
            params.setdefault(path, {}).setdefault("bn", {})[leaf[1]] = value
        elif leaf[0] == "bn" and leaf[1] in ("mean", "var"):
            state.setdefault(path, {}).setdefault("bn", {})[leaf[1]] = value
        else:
            raise KeyError(f"unexpected state_dict entry {key!r}")
    return params, state
