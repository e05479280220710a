"""Deployment artifacts: a ``torch.export`` program plus ``meta.json``.

Counterpart of ``yolodl_tpu/models/export.py``.  The reference serializes
its jitted inference function to StableHLO with ``jax.export``, which torch
cannot load; the port writes its own artifact, a directory:

    model.pt2   — ``torch.export.save`` of the inference module, weights
                  included: no model-building code runs when it is loaded
    meta.json   — the reference's fields (``format_version``,
                  ``input_shape``, ``input_dtype``, ``data_format``,
                  ``serving``, ``num_classes``, ``has_uncertainty``,
                  ``infos``) plus ``device`` (the device type the program
                  was exported on) and ``torch_version``

The exported module is the model with the reference's fixed
``train=False`` and ``data_format``; it returns the tuple ``(cycxhw,
obj_logit, class_logit[, uncertainty])``, and :func:`load_exported`
rebuilds a :class:`~yolodl_torch.ops.detect.MergedDetection` from it for
``loss/nms.py``.  ``serving=True`` bakes in the service's ingest: ``[B, S,
S, 3]`` uint8 NHWC, then ``.to(bfloat16) / 255`` on the device, as
``DetectionService.forward`` does for a live model.

A program holds the device of its weights, so an artifact loads only on the
device type it was exported on: anything else raises, naming both.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..ops.detect import DetectionInfo, MergedDetection

_FORMAT_VERSION = 1
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "uint8": torch.uint8}


class _Inference(nn.Module):
    """The exported function: the model at ``train=False`` in one data
    format, its outputs as a tuple."""

    def __init__(self, model: nn.Module, data_format: str, serving: bool):
        super().__init__()
        self.model = model
        self.data_format = data_format
        self.serving = serving

    def detection(self, images: torch.Tensor) -> MergedDetection:
        if self.serving:  # the service's on-device normalize, baked in
            images = images.to(torch.bfloat16) / 255.0
        return self.model(images, data_format=self.data_format)

    def forward(self, images: torch.Tensor):
        pred = self.detection(images)
        outs = (pred.cycxhw, pred.obj_logit, pred.class_logit)
        if pred.uncertainty is not None:
            outs = outs + (pred.uncertainty,)
        return outs


def export_inference(
    model,
    path: str,
    batch_size: int = 1,
    image_size: int = 0,
    dtype: str = "float32",
    data_format: str = "NCHW",
    serving: bool = False,
) -> str:
    """Export ``model(·, train=False)`` to the artifact directory ``path``,
    on the device the model's weights live on.

    ``dtype`` is the input's (a bf16 input runs the model in bf16, its
    parameters staying f32, as the reference's).  ``serving=True`` makes a
    serving artifact: uint8 NHWC input, the bf16/255 normalize inside.
    """
    if not image_size:
        raise ValueError("image_size is required (e.g. the cfg net height)")
    if serving:
        data_format = "NHWC"
        in_shape = (batch_size, image_size, image_size, 3)
        in_dtype = "uint8"
    elif data_format == "NCHW":
        in_shape = (batch_size, 3, image_size, image_size)
        in_dtype = dtype
    elif data_format == "NHWC":
        in_shape = (batch_size, image_size, image_size, 3)
        in_dtype = dtype
    else:
        raise ValueError(f"unknown data_format {data_format!r}")
    if in_dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}")
    device = next(model.parameters()).device
    module = _Inference(model, data_format, serving)
    example = torch.zeros(in_shape, dtype=_DTYPES[in_dtype], device=device)
    with torch.no_grad():
        # the static head layout, from one image: the traced program's
        # outputs are tensors only
        static = module.detection(example[:1])
        program = torch.export.export(module, (example,), strict=False)

    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, "model.pt2"))
    meta = {
        "format_version": _FORMAT_VERSION,
        "input_shape": list(in_shape),
        "input_dtype": in_dtype,
        "data_format": data_format,
        "serving": serving,
        "num_classes": static.num_classes,
        "has_uncertainty": static.uncertainty is not None,
        "infos": [dataclasses.asdict(i) for i in static.infos],
        "device": device.type,
        "torch_version": torch.__version__,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return path


def load_exported(path: str, device="cuda") -> Tuple[Callable, dict]:
    """Load an exported artifact: (infer, meta).

    ``infer(images) -> MergedDetection`` — feed the result straight to
    ``non_max_suppression`` / ``yolo_inference`` like a live model's output.
    ``device`` defaults to ``"cuda"`` (it raises without a card) and must
    be of the type the artifact was exported on.
    """
    device = resolve_device(device)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path}: no exported artifact directory "
                                "(write one with tool_main export)")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(
            f"{path}: artifact format {meta.get('format_version')} != "
            f"supported {_FORMAT_VERSION}")
    if meta.get("device") != device.type:
        raise ValueError(
            f"{path}: the artifact was exported on device {meta.get('device')!r} and "
            f"cannot run on {device.type!r}; export it again on that device")
    infos = tuple(
        DetectionInfo(
            feature_h=i["feature_h"], feature_w=i["feature_w"],
            anchors=tuple(tuple(a) for a in i["anchors"]),
            flat_begin=i["flat_begin"], flat_end=i["flat_end"],
            class_act=i.get("class_act", "sigmoid"),
        )
        for i in meta["infos"]
    )
    module = torch.export.load(os.path.join(path, "model.pt2")).module()

    def infer(images: torch.Tensor) -> MergedDetection:
        outs = module(images)
        uncertainty = outs[3] if meta["has_uncertainty"] else None
        return MergedDetection(
            cycxhw=outs[0], obj_logit=outs[1], class_logit=outs[2],
            infos=infos, uncertainty=uncertainty)

    return infer, meta
