"""Convenience constructors: one call from config file to runnable model.

Counterpart of ``yolodl_tpu/models/zoo.py``.  Where the reference returns
``(model, params, state)``, the port returns the model, whose parameters and
BN statistics live in it; ``seed`` seeds the port's own init, and
``device`` defaults to ``"cuda"`` (it raises without a card).
"""

from __future__ import annotations

import torch

from ..bridge import params_from_jax, params_to_jax
from ..config import darknet_cfg as dk
from ..graph import Graph
from ..graph.from_darknet import graph_from_darknet
from .builder import GraphModel, YoloModel
from .weights import load_darknet_weights, merge_into_model_tree


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def load_newslab_model(path, seed: int = 0, device="cuda") -> YoloModel:
    """NEWSLABv1 JSON5 → model with fresh init."""
    return YoloModel(Graph.load_newslab_v1_json(path), device=device,
                     generator=_generator(seed))


def _load_darknet(wrapper, cfg_path, weights_path, seed, device):
    """Shared cfg → model path; ``wrapper`` picks the model class
    (YoloModel for detectors, GraphModel for classifiers).  A ``.weights``
    file is overlaid on the seeded init: layers it lacks keep their init,
    shapes are checked."""
    darknet = dk.Darknet.load(cfg_path)
    model = wrapper(graph_from_darknet(darknet), device=device, generator=_generator(seed))
    if weights_path is not None:
        loaded_p, loaded_s, _seen = load_darknet_weights(darknet, weights_path)
        params, state = merge_into_model_tree(loaded_p, loaded_s,
                                              *params_to_jax(model.state_dict()))
        params_from_jax(params, state, model=model)
    return model


def load_darknet_classifier(cfg_path, weights_path=None, seed: int = 0,
                            device="cuda") -> GraphModel:
    """darknet classification or sequence cfg (no [yolo] heads) (+ optional
    .weights) → GraphModel."""
    return _load_darknet(GraphModel, cfg_path, weights_path, seed, device)


def load_darknet_model(cfg_path, weights_path=None, seed: int = 0,
                       device="cuda") -> YoloModel:
    """darknet .cfg (+ optional .weights) → model."""
    return _load_darknet(YoloModel, cfg_path, weights_path, seed, device)
