"""Classifier training: the cross-entropy step for softmax/cost darknet nets.

Counterpart of ``yolodl_tpu/train/classifier.py``.  darknet trains these
cfgs with [softmax] + [cost type=sse], whose combined backward delta on the
logits is ``p − y`` (softmax_layer.c's backward passes the delta through,
cost_layer.c's delta is truth − pred): the gradient of the cross-entropy
through the softmax.  So the step takes ``CE = −log p[y]`` of the graph's
classes, as ``log_softmax`` of the node that feeds the terminal softmax.

Works with any graph whose output is a ``[B, C]`` probability or logit
tensor: the image classifiers (darknet19/53, alexnet, vgg, resnet, …) and
the time-major sequence cfgs, whose ``B`` is ``T·batch`` rows.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import newslab as cfg
from ..models.builder import GraphModel
from .loop import TrainConfig, TrainState, _clip_gradients
from .lr_schedule import make_schedule_fn


def _pre_softmax_key(model: GraphModel) -> Optional[int]:
    """Node key of the input to the graph's terminal [softmax], walking
    back through identity tails ([cost]/[contrastive] map to Identity);
    None when the graph does not end in a softmax."""
    graph = model.graph
    key = model.output_key
    for _ in range(len(graph.nodes)):
        node = graph.nodes[key]
        if isinstance(node.config, cfg.Identity):
            key = node.input_keys.single_key
            continue
        if isinstance(node.config, cfg.Softmax):
            return node.input_keys.single_key
        return None
    return None


def make_classifier_train_step(
    model: GraphModel,
    optimizer: torch.optim.Optimizer,
    config: TrainConfig,
    output_is_prob: bool = True,
    data_format: str = "NCHW",
) -> Callable:
    """(TrainState, images, labels[int64 B]) → (TrainState, metrics).

    ``output_is_prob``: the graph ends in [softmax] (darknet classifiers),
    so CE is ``log(max(p, 1e-12))``; False = raw logits (``log_softmax``).
    When the output node IS a [softmax] (behind any identity tails), CE is
    ``log_softmax`` of the pre-softmax node instead: the same value, and
    the logit-space gradient ``p − y`` never dies where the softmax
    saturates ``p[y]`` to an f32 zero.

    Per step: zero grads → forward(train=True) → CE → backward → clip →
    optimizer step at the scheduled lr → ``clamp_running_vars`` → step += 1.
    The metrics ``loss`` and ``accuracy`` (argmax of the logits, which is
    that of the softmax) are device tensors.  No generator reaches the
    forward, as the reference passes no ``rng``: Dropout is the identity.
    """
    logits_key = _pre_softmax_key(model)
    dtype = getattr(torch, config.compute_dtype) if config.compute_dtype is not None else None
    schedule = make_schedule_fn(config.lr)
    params = list(model.parameters())

    def step(ts: TrainState, images, labels):
        optimizer.zero_grad(set_to_none=False)
        if dtype is not None:
            images = images.to(dtype)
        if logits_key is None:
            out = model(images, data_format, train=True)
        else:
            out = model(images, data_format, train=True, output_keys=(logits_key,))[logits_key]
        out = out.reshape(out.shape[0], -1).to(torch.float32)
        if logits_key is None and output_is_prob:
            log_p = torch.log(torch.clamp(out, min=1e-12))
        else:
            log_p = torch.log_softmax(out, dim=-1)
        labels = labels.to(torch.int64)
        ce = -torch.gather(log_p, 1, labels[:, None]).mean()
        ce.backward()
        _clip_gradients(params, config)
        lr = schedule(ts.step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        model.clamp_running_vars()
        ts.step += 1
        with torch.no_grad():
            acc = torch.mean((torch.argmax(out, -1) == labels).to(torch.float32))
        return ts, {"loss": ce.detach(), "accuracy": acc}

    return step
