"""Parameter bridge between the reference's trees and the port's modules.

The reference keeps parameters as ``{path: {"w": HWIO, "b"?, "bn":
{"scale", "bias"}}}`` and BN state as ``{path: {"bn": {"mean", "var"}}}``
(yolodl_tpu ops/conv.py:62-74, ops/norm.py:32-44), with numpy or JAX arrays
as leaves.  A DarkCsp2D or SppCsp2D block nests one such entry per sub-conv
(``{path: {"skip_conv": {"w", "bn"}, …}}``, ops/blocks.py).  The port's
``state_dict`` names the same tensors ``layers.<path>.w`` (OIHW),
``layers.<path>.b``, ``layers.<path>.bn.scale`` … ``layers.<path>.bn.var``,
and ``layers.<path>.<sub>.w`` … inside a block.  Every kernel, a
DeconvBn2D's included, crosses as ``permute(3, 2, 0, 1)`` of the HWIO
array: the port keeps a deconv kernel ``[out, in, k, k]`` and hands
``F.conv_transpose2d`` its ``transpose(0, 1)`` (ops/conv.py).  A dense
weight (Linear, and the connected sub-layers ``input``/``self``/``output``,
``iz``…``sh`` and ``wf``…``uo`` of the recurrent kinds) is the reference's
2-D ``[in, out]`` and the port's ``[out, in]``, as ``nn.Linear`` keeps it:
it crosses transposed.  A [crnn] node nests three sub-convs, and a dense
BN has a ``scale`` and no ``bias``.  Only numpy crosses the boundary, so
this module needs nothing of JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .models.builder import module_key

_BN_PARAMS = ("scale", "bias")
_BN_STATE = ("mean", "var")


def _path_of(key: str) -> str:
    return key.replace("/", ".")


def _kernel_to_torch(w) -> torch.Tensor:
    """HWIO → OIHW; a dense ``[in, out]`` → ``[out, in]``."""
    t = torch.from_numpy(np.array(w, np.float32))
    return (t.t() if t.dim() == 2 else t.permute(3, 2, 0, 1)).contiguous()


def _kernel_to_jax(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T if w.ndim == 2 else w.transpose(2, 3, 1, 0))


def _leaves(tree: Dict, prefix: str):
    """(state_dict key, leaf name, value) of every leaf under ``prefix``."""
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}.{name}")
        else:
            yield f"{prefix}.{name}", name, value


def params_from_jax(params: Dict, state: Dict, model: Optional[torch.nn.Module] = None
                    ) -> Dict[str, torch.Tensor]:
    """Reference (params, state) trees → the port's ``state_dict`` (f32,
    CPU).  HWIO kernels become OIHW by ``permute(3, 2, 0, 1)``, dense
    weights ``[out, in]`` by a transpose.

    With ``model``, the values are also copied into the model's own
    parameters and BN buffers in place (on whatever device they live), and
    every entry of the model's ``state_dict`` must be given: two trainers
    can then start from the same weights and running statistics."""
    sd: Dict[str, torch.Tensor] = {}
    for tree in (params, state):
        for path, node in tree.items():
            for key, name, value in _leaves(node, f"layers.{module_key(path)}"):
                sd[key] = (_kernel_to_torch(value) if name == "w"
                           else torch.from_numpy(np.array(value, np.float32)))
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
        # a leaf is w, b or bn/<name>, behind at most one sub-layer name
        sub, tail = (leaf[:1], leaf[1:]) if leaf[0] not in ("w", "b", "bn") else ([], leaf)
        if tail == ["w"]:
            tree, value = params, _kernel_to_jax(value)
        elif tail == ["b"] or (len(tail) == 2 and tail[0] == "bn" and tail[1] in _BN_PARAMS):
            tree = params
        elif len(tail) == 2 and tail[0] == "bn" and tail[1] in _BN_STATE:
            tree = state
        else:
            raise KeyError(f"unexpected state_dict entry {key!r}")
        node = tree.setdefault(path, {})
        for name in sub + tail[:-1]:
            node = node.setdefault(name, {})
        node[tail[-1]] = value
    return params, state
