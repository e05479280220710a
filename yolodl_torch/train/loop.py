"""Single-device training step.

Counterpart of ``yolodl_tpu/train/loop.py`` (``train/src/train/
single_gpu.rs``): forward → YOLO loss → backward → gradient clipping → Adam
(beta1 = config momentum) or SGD → BN running-var clamp → step count → EMA.

The reference's pure functions over a ``TrainState`` pytree become eager
PyTorch on state that lives where PyTorch keeps it: the parameters and the
BN running statistics in the model (updated in place; the training forward
writes the statistics), the optimizer state in a ``torch.optim`` optimizer,
gradients in each parameter's ``.grad``.  A step returns its metrics as
device tensors and reads nothing back, so a host loop can check the loss
when it chooses (a non-finite total loss must abort training,
multi_gpu.rs:198-204).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..loss import LossConfig, yolo_loss
from ..models.builder import YoloModel
from ..utils.timing import span, spanned
from .ema import ema_init, ema_update
from .lr_schedule import LrScheduleConfig, make_schedule_fn

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's TrainConfig: the same fields and defaults."""

    lr: LrScheduleConfig = LrScheduleConfig(kind="constant", lr=1e-3)
    optimizer: str = "adam"       # "adam" (reference) | "sgd" (darknet native)
    momentum: float = 0.937       # Adam beta1 (multi_gpu.rs:425-434) / SGD momentum
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_grad_value: Optional[float] = None
    clip_grad_norm: Optional[float] = None
    loss: LossConfig = LossConfig()
    use_ema: bool = False
    ema_decay: float = 0.9999
    # per-step obj/class quality metrics (benchmark.rs taxonomy) at this
    # confidence threshold
    benchmark_confidence: Optional[float] = None
    # per-parameter |w|max / |grad|max scalars in the metrics dict
    log_weights_and_grads: bool = False
    # the first image's objectness probabilities (metrics["obj_sample"], [N])
    return_obj_sample: bool = False
    # mean decoded cy/cx/h/w scalars per step
    debug_stat: bool = False
    # training.loss.impl=Darknet: (head-conv node keys, per-head params of
    # loss/darknet_loss.py) — the step trains the raw head outputs through
    # the darknet-exact loss instead of yolo_loss
    darknet_loss: Optional[tuple] = None
    # compute dtype of the forward/backward ("bfloat16" | None).  The images
    # are cast at step entry and every conv casts its f32 weight to the
    # activation dtype (ops/conv.py), so parameters, optimizer state and BN
    # running stats stay float32.  Explicit casts, not autocast, so the same
    # operations run in bf16 as in the reference.  None = the batch's dtype.
    compute_dtype: Optional[str] = None


@dataclasses.dataclass
class TrainState:
    """The reference's TrainState: ``params`` and ``state`` (BN running
    stats) are the model's parameters and buffers, ``opt_state`` is the
    optimizer, ``step`` counts the steps taken (a host int) and
    ``ema_params`` maps parameter names to their averages (None when EMA is
    off)."""

    model: YoloModel
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema_params: Optional[Dict[str, Tensor]] = None


def make_optimizer(config: TrainConfig, params) -> torch.optim.Optimizer:
    """The optimizer the reference's optax chain ends in.

    SGD: ``torch.optim.SGD(momentum, dampening=0, nesterov=False,
    weight_decay)`` = ``optax.add_decayed_weights`` + ``optax.sgd``.  Adam:
    ``torch.optim.Adam``/``AdamW`` with ``betas=(momentum, beta2)`` and
    ``eps``, whose update is optax's ``m̂/(√v̂ + eps)``.  The learning rate
    is not fixed here: the train step writes ``make_schedule_fn(config.lr)``
    of the update count into every param group's ``lr`` before each
    ``optimizer.step()`` (the count before the increment, as optax reads
    it: 0 on the first update).  Gradient clipping is done by the step, in
    the reference's chain order (value, then global norm).
    """
    lr0 = make_schedule_fn(config.lr)(0)
    if config.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr0, momentum=config.momentum, dampening=0.0,
                               nesterov=False, weight_decay=config.weight_decay)
    if config.optimizer == "adam":
        betas = (config.momentum, config.beta2)
        if config.weight_decay:
            return torch.optim.AdamW(params, lr=lr0, betas=betas, eps=config.eps,
                                     weight_decay=config.weight_decay)
        return torch.optim.Adam(params, lr=lr0, betas=betas, eps=config.eps)
    raise ValueError(f"unknown optimizer {config.optimizer!r}")


def train_init(model: YoloModel, config: TrainConfig,
               seed: Optional[int] = None) -> Tuple[TrainState, torch.optim.Optimizer]:
    """Optimizer, step 0 and EMA for ``model``, on the model's device.

    The reference's ``train_init`` also draws the parameters from ``seed``;
    here the model already holds them (drawn from its generator when it was
    built, or loaded).  Pass ``seed`` to draw them again from
    ``torch.Generator().manual_seed(seed)``.  Every parameter gets a zero
    gradient, so that one which receives none (a frozen layer) still takes
    the optimizer's update, as it does in the reference.
    """
    if seed is not None:
        model.init(torch.Generator().manual_seed(seed))
    params = list(model.parameters())
    for p in params:
        p.grad = torch.zeros_like(p)
    optimizer = make_optimizer(config, params)
    ema = ema_init(dict(model.named_parameters())) if config.use_ema else None
    return TrainState(model=model, optimizer=optimizer, step=0, ema_params=ema), optimizer


# torch's per-parameter optimizer state → the optax state field it equals
_MOMENTS = {"adam": ((".mu", "exp_avg"), (".nu", "exp_avg_sq")),
            "sgd": ((".trace", "momentum_buffer"),)}


def _optax_layout(config: TrainConfig) -> Tuple[str, str]:
    """(chain index of the moments' state, chain index of the schedule's
    count) in the reference's ``optax.chain`` (loop.py ``make_optimizer``):
    the clip transforms come first and hold no state; ``optax.adamw`` is
    (scale_by_adam, add_decayed_weights, scale_by_schedule) and
    ``optax.adam`` has no middle entry; SGD's weight decay is a chain entry
    of its own before ``optax.sgd`` = (trace, scale_by_schedule)."""
    first = int(config.clip_grad_value is not None) + int(config.clip_grad_norm is not None)
    if config.optimizer == "adam":
        return f"{first}/0", f"{first}/{2 if config.weight_decay else 1}"
    if config.optimizer == "sgd":
        first += int(bool(config.weight_decay))
        return f"{first}/0", f"{first}/1"
    raise ValueError(f"unknown optimizer {config.optimizer!r}")


def _nest(tree: Dict, path: str) -> Dict:
    for key in path.split("/"):
        tree = tree.setdefault(key, {})
    return tree


def optimizer_state_tree(ts: TrainState, config: TrainConfig) -> Dict:
    """The optimizer state as the reference's optax state tree, nested
    dicts keyed as its checkpoint spells them: ``{"0": {"0": {".count",
    ".mu": {<node>: {"w": HWIO, …}}, ".nu": …}, "2": {".count"}}}`` for
    AdamW (``.trace`` for SGD).  The counts are int32 ``ts.step``; a moment
    that torch has not created yet (no step taken) is zero, as optax
    initializes it."""
    from ..bridge import params_to_jax

    moments_at, count_at = _optax_layout(config)
    count = np.asarray(ts.step, np.int32)
    tree: Dict = {}
    named = dict(ts.model.named_parameters())
    moments = _nest(tree, moments_at)
    for field, torch_key in _MOMENTS[config.optimizer]:
        values = {}
        for name, p in named.items():
            value = ts.optimizer.state.get(p, {}).get(torch_key)
            values[name] = torch.zeros_like(p) if value is None else value
        moments[field] = params_to_jax(values)[0]
    if config.optimizer == "adam":
        moments[".count"] = count
    _nest(tree, count_at)[".count"] = count
    return tree


@torch.no_grad()
def load_optimizer_state_tree(ts: TrainState, config: TrainConfig, tree: Dict) -> None:
    """Set the optimizer's state from a reference optax tree (the inverse of
    :func:`optimizer_state_tree`), on the parameters' devices.  torch's Adam
    keeps the update count as a float tensor per parameter."""
    from ..bridge import params_from_jax

    moments_at, _ = _optax_layout(config)
    moments = tree
    for key in moments_at.split("/"):
        moments = moments[key]
    values = {torch_key: params_from_jax(moments[field], {})
              for field, torch_key in _MOMENTS[config.optimizer]}
    for name, p in ts.model.named_parameters():
        state = {torch_key: v[name].to(p.device) for torch_key, v in values.items()}
        if config.optimizer == "adam":
            state["step"] = torch.tensor(float(np.asarray(moments[".count"])))
        ts.optimizer.state[p] = state


def collect_step_metrics(config: TrainConfig, out, aux, pred) -> dict:
    """Per-step metrics from the loss output: the losses always; the
    benchmark telemetry, the decoded-box debug stats and the objectness
    heatmap sample per the config flags.  Values are detached device
    tensors."""
    metrics = {
        "total_loss": out.total_loss,
        "iou_loss": out.iou_loss,
        "classification_loss": out.classification_loss,
        "objectness_loss": out.objectness_loss,
        "num_matched": aux.matching.num_matched(),
    }
    if out.uncertainty_loss is not None:  # gaussian heads
        metrics["uncertainty_loss"] = out.uncertainty_loss
    if config.benchmark_confidence is not None:
        from ..loss.benchmark import yolo_benchmark

        bench = yolo_benchmark(pred, aux.matching, config.benchmark_confidence)
        metrics.update({
            "obj_accuracy": bench.obj_accuracy,
            "obj_recall": bench.obj_recall,
            "obj_precision": bench.obj_precision,
            "class_accuracy": bench.class_accuracy,
        })
    if config.debug_stat:
        mean = torch.mean(pred.cycxhw.to(torch.float32), dim=(0, 1))
        metrics.update({
            "debug/cy_mean": mean[0], "debug/cx_mean": mean[1],
            "debug/h_mean": mean[2], "debug/w_mean": mean[3],
        })
    if config.return_obj_sample:
        metrics["obj_sample"] = pred.obj_prob()[0]
    return {k: v.detach() for k, v in metrics.items()}


def make_batch_grads(
    model: YoloModel,
    config: TrainConfig,
    data_format: str = "NCHW",
    accum: int = 1,
    gather: Optional[Callable] = None,
    forward: Optional[Callable] = None,
) -> Callable:
    """(images, boxes, classes, mask) → metrics for one logical batch; the
    gradient is left in each parameter's ``.grad`` (which must be zero on
    entry) and the BN running stats are updated in the model.

    ``accum > 1`` is gradient accumulation with darknet's
    ``batch``/``subdivisions`` semantics: ``accum`` sequential micro-batches,
    each running forward and backward before the next starts, the gradient
    averaged over them, the BN running stats threaded through them in
    order.  Loss metrics are micro-batch means; ``num_matched`` is the sum.

    ``gather`` (:meth:`StepHooks.gather`) maps a micro-batch's head outputs
    and targets to the ones the loss reads: the tensor-parallel step
    gathers the data axis's rows there.  ``forward``
    (:meth:`StepHooks.forward`) is the micro-batch's training forward: the
    spatial step runs the height-sharded prefix there.
    """
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    dtype = getattr(torch, config.compute_dtype) if config.compute_dtype is not None else None
    if forward is None:
        forward = StepHooks().forward

    if config.darknet_loss is not None:
        head_keys, head_params = config.darknet_loss
        from ..loss.darknet_loss import darknet_detection_loss_with_metrics, truth_rows

        def micro_batch(images, gt_boxes, gt_classes, gt_mask):
            if dtype is not None:
                images = images.to(dtype)
            outs = forward(model, images, data_format, output_keys=head_keys)
            raws = tuple(outs[k].to(torch.float32) for k in head_keys)
            if gather is not None:
                raws, gt_boxes, gt_classes, gt_mask = gather(raws, gt_boxes, gt_classes, gt_mask)
            with span("yolodl.loss"):
                loss, dk_metrics = darknet_detection_loss_with_metrics(
                    raws, truth_rows(gt_boxes, gt_classes, gt_mask), head_params)
            with span("yolodl.train.backward"):
                loss.backward()
            # the total, the per-term components and darknet's printed
            # training stats (loss/darknet_loss.py _head_cost_delta_stats)
            return {"total_loss": loss.detach(), **dk_metrics}
    else:
        def micro_batch(images, gt_boxes, gt_classes, gt_mask):
            if dtype is not None:
                images = images.to(dtype)
            pred = forward(model, images, data_format)
            if gather is not None:
                pred, gt_boxes, gt_classes, gt_mask = gather(pred, gt_boxes, gt_classes, gt_mask)
            out, aux = yolo_loss(pred, gt_boxes, gt_classes, gt_mask, config.loss)
            with span("yolodl.train.backward"):
                out.total_loss.backward()
            return collect_step_metrics(config, out, aux, pred)

    def batch_grads(images, gt_boxes, gt_classes, gt_mask):
        if accum == 1:
            return micro_batch(images, gt_boxes, gt_classes, gt_mask)
        batch = images.shape[0]
        if batch % accum:
            raise ValueError(
                f"batch size {batch} is not divisible by accumulation_steps {accum}")
        mb = batch // accum
        ys = [micro_batch(*(x[i * mb:(i + 1) * mb]
                            for x in (images, gt_boxes, gt_classes, gt_mask)))
              for i in range(accum)]
        with span("yolodl.train.update"):
            with torch.no_grad():
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(accum)
            return combine_micro_batches(ys)

    return batch_grads


def combine_micro_batches(ys) -> dict:
    """One logical batch's metrics from its micro-batches' (in order):
    ``num_matched`` summed, ``obj_sample`` the first's (the first image
    overall), every other metric averaged."""
    return {
        k: (torch.sum(torch.stack([y[k] for y in ys]), 0) if k == "num_matched"
            else ys[0][k] if k == "obj_sample"
            else torch.mean(torch.stack([y[k] for y in ys]), 0))
        for k in ys[0]
    }


def _sq_norm(grads) -> Tensor:
    return sum(torch.sum(torch.square(g)) for g in grads)


@torch.no_grad()
def _clip_gradients(params, config: TrainConfig, sq_norm: Callable = _sq_norm) -> None:
    """optax.clip, then optax.clip_by_global_norm, on the ``.grad``s;
    ``sq_norm`` gives the squared global norm of the list of gradients."""
    grads = [p.grad for p in params if p.grad is not None]
    if config.clip_grad_value is not None:
        for g in grads:
            g.clamp_(-config.clip_grad_value, config.clip_grad_value)
    if config.clip_grad_norm is not None:
        max_norm = config.clip_grad_norm
        g_norm = torch.sqrt(sq_norm(grads))
        trigger = g_norm < max_norm
        for g in grads:
            g.copy_(torch.where(trigger, g, (g / g_norm) * max_norm))


class StepHooks:
    """What a parallel step changes in the single-device step of
    :func:`make_train_step`: ``parallel/dp.py``, ``zero.py``, ``tp.py`` and
    ``spatial_model.py`` subclass it.  Every method's default is the
    single-device behaviour."""

    def forward(self, model: YoloModel, images: Tensor, data_format: str, **kw):
        """A micro-batch's training forward (``output_keys`` in ``kw`` for
        the darknet loss's raw head outputs)."""
        return model(images, data_format, train=True, **kw)

    def gather(self, outputs, gt_boxes, gt_classes, gt_mask):
        """Before the loss: a micro-batch's head outputs (a MergedDetection,
        or the darknet loss's raw head tensors) and its targets."""
        return outputs, gt_boxes, gt_classes, gt_mask

    def reduce(self, metrics: dict) -> dict:
        """Right after the backward, before anything reads the gradients."""
        return metrics

    def grad_sq_norm(self, grads) -> Tensor:
        """The squared global norm of ``grads`` (``clip_grad_norm``)."""
        return _sq_norm(grads)

    def maxima(self, values: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The ``weights_max/*`` or ``grads_max/*`` scalars of every
        parameter, as this process computed them."""
        return values

    def update(self, optimizer: torch.optim.Optimizer, params, config: TrainConfig,
               lr: float) -> None:
        """Clip the gradients, then the optimizer's step at ``lr``."""
        _clip_gradients(params, config, self.grad_sq_norm)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()


def make_train_step(
    model: YoloModel,
    optimizer: torch.optim.Optimizer,
    config: TrainConfig,
    data_format: str = "NCHW",
    accum: int = 1,
    hooks: Optional[StepHooks] = None,
) -> Callable:
    """The train step: (TrainState, images, gt_boxes, gt_classes, gt_mask)
    → (TrainState, metrics).

    Per step: zero grads → forward(train=True) → ``yolo_loss`` (or, with
    ``config.darknet_loss``, the raw head convs → the darknet-exact loss) → backward
    (per micro-batch, see :func:`make_batch_grads`) → clip → optimizer step
    at the scheduled lr → ``clamp_running_vars`` → step += 1 → EMA.  The
    state is updated in place and returned; the metrics are device tensors.

    ``hooks`` (:class:`StepHooks`) are a parallel step's: the data-parallel
    step (``parallel/dp.py``) averages the gradients, the BN statistics and
    the metrics over the ranks in ``reduce``; ZeRO-1 (``zero.py``) updates
    this rank's slice of the parameters in ``update``; tensor parallelism
    (``tp.py``) gathers the heads before the loss and reduces over its mesh;
    the spatial step (``spatial_model.py``) runs its own ``forward``.

    Under a profiler the step is the span ``yolodl.train.step``; inside it,
    each micro-batch's ``yolodl.model.forward``, ``yolodl.loss`` and
    ``yolodl.train.backward``, then ``yolodl.train.update`` from the end of
    the last micro-batch (``utils/timing.py`` ``span``).
    """
    hooks = StepHooks() if hooks is None else hooks
    batch_grads = make_batch_grads(model, config, data_format, accum, hooks.gather,
                                   hooks.forward)
    schedule = make_schedule_fn(config.lr)
    params = list(model.parameters())

    @spanned("yolodl.train.step")
    def step(ts: TrainState, images, gt_boxes, gt_classes, gt_mask):
        torch._foreach_zero_([p.grad for p in params if p.grad is not None])
        metrics = batch_grads(images, gt_boxes, gt_classes, gt_mask)
        with span("yolodl.train.update"):
            metrics = hooks.reduce(metrics)
            if config.log_weights_and_grads:  # the gradients before clipping
                grad_maxima = hooks.maxima(_maxima("grads_max", (
                    (key, p.grad) for key, p in model.named_parameters())))
            hooks.update(optimizer, params, config, schedule(ts.step))
            model.clamp_running_vars()
            ts.step += 1
            if ts.ema_params is not None:
                ema_update(ts.ema_params, dict(model.named_parameters()), ts.step,
                           config.ema_decay)
            if config.log_weights_and_grads:
                metrics.update(hooks.maxima(param_maxima(model)))
                metrics.update(grad_maxima)
        return ts, metrics

    return step


def _tree_name(key: str) -> str:
    """``layers.<module key>.<leaf…>`` → the reference's tree path
    ``<node path>/<leaf>/…`` (utils/trees.py tree_path_name)."""
    parts = key[len("layers."):].split(".")
    return "/".join([parts[0].replace("/", "."), *parts[1:]])


@torch.no_grad()
def _maxima(prefix: str, named) -> Dict[str, Tensor]:
    return {f"{prefix}/{_tree_name(key)}": torch.max(torch.abs(t)) for key, t in named}


def param_maxima(model: YoloModel, grads: Optional[Dict[str, Tensor]] = None
                 ) -> Dict[str, Tensor]:
    """Per-parameter |w|max (and |grad|max for ``grads``, parameter name →
    gradient) scalars keyed as the reference keys them
    (``weights_max/layer0/w``, ``grads_max/layer0/bn/scale``), so the
    TensorBoard panels stay the same."""
    out = _maxima("weights_max", model.named_parameters())
    if grads is not None:
        out.update(_maxima("grads_max", grads.items()))
    return out


def make_multi_step(
    model: YoloModel,
    optimizer: torch.optim.Optimizer,
    config: TrainConfig,
    k: int,
    data_format: str = "NCHW",
    accum: int = 1,
) -> Callable:
    """``k`` train steps: (TrainState, images[k,b,...], boxes[k,b,...],
    classes[k,b,...], mask[k,b,...]) → (TrainState, metrics stacked [k]).

    A Python loop over :func:`make_train_step`, so the semantics are those
    of ``k`` sequential steps, the lr schedule included.
    """
    step = make_train_step(model, optimizer, config, data_format, accum)

    def multi(ts: TrainState, images, gt_boxes, gt_classes, gt_mask):
        per_step = []
        for i in range(k):
            ts, metrics = step(ts, images[i], gt_boxes[i], gt_classes[i], gt_mask[i])
            per_step.append(metrics)
        return ts, {key: torch.stack([m[key] for m in per_step]) for key in per_step[0]}

    return multi
