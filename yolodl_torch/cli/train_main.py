"""Training CLI: ``python -m yolodl_torch.cli.train_main --config-file train.json5``.

Counterpart of ``yolodl_tpu/cli/train_main.py`` (the reference ``train``
crate, train/src/main.rs), with its flags (``--config-file``,
``--max-steps``, ``--profile-dir``, ``--process-id``) plus ``--device``
(default ``cuda``; ``cpu`` runs on the CPU): load the versioned JSON5 config, create a
timestamped run dir with a config copy (:34-51), start the data pipeline
and the logging worker, train, checkpoint every N steps with the optimizer
state, abort on a non-finite loss (multi_gpu.rs:198-204), and on SIGINT or
SIGTERM save a checkpoint at the next step boundary and exit.

In-training inference (``logging.enable_inference``) and the periodic
evaluation (``evaluation.interval``) run NMS, so on a card they launch B1's
two kernels (``kernels/iou.py``): once each per inference image and once
each per evaluation batch.  ``--profile-dir`` writes a ``torch.profiler``
trace of steps 5-10 there.

``training.loss.impl Darknet`` trains a darknet model cfg's raw head
convs through the darknet-exact loss (``loss/darknet_loss.py``) with
per-head params from its [yolo]/[Gaussian_yolo] sections; under
multi-scale each training size gets its own step, whose params bind
``net_w = net_h`` = that size.

``preprocessor.pipeline.device "cuda"`` (or the reference's "tpu") runs
the pixel augmentation on the device (``data/device_augment.py``): the
pipeline threads draw the parameters and compute the labels, and the
jitter, warp and mix run batched on the training device.  As in the
reference, a multi-step call (``steps_per_call``) or
``logging.enable_images`` keeps the CPU pipeline, with a warning.

Data parallelism (``parallel/``), one process per rank:

- ``device_config`` MultiDevice with N devices: this process starts N
  ranks of itself (``parallel/mesh.py`` ``launch_ranks``, a rendezvous
  file of the launch), rank i on the config's i-th device (every
  rank on the CPU with ``--device cpu``), passes SIGINT and SIGTERM on to
  them, and exits with the first failed rank's error line.
- MultiProcess: this process is one rank, joined from the environment
  (``env://``, as torchrun sets it) or from the config's ``coordinator`` +
  ``num_processes`` and ``--process-id`` / ``YDL_PROCESS_ID``; its device
  is ``cuda:LOCAL_RANK`` (or the CPU with ``--device cpu``).

Each rank streams ``records[rank::N]`` with ``seed=rank`` and a local batch
of ``batch_size / N`` (the reference's MultiProcess data, for MultiDevice
too), trains through ``parallel/dp.py``'s step, and agrees with the others
on the step to stop at (an all-reduce MAX of a stop flag each step).  Rank
0 alone runs the in-training inference and evaluation and writes
checkpoints; the others log into a ``-r{rank}`` run dir.

``training.zero_optimizer`` with several devices trains through
``parallel/zero.py`` (ZeRO-1: the optimizer state cut over the ranks; its
checkpoints hold the reference's flat ``opt/`` vectors, gathered onto rank
0).  ``training.tensor_parallel M`` trains through ``parallel/tp.py`` on a
``N/M × M`` data × model mesh: each data index d streams
``records[d::N/M]`` with ``seed=d`` and a local batch of ``batch_size /
(N/M)``, and the M ranks of its model group stream the same records (a
hash of their first batch is compared).  Every rank joins the gathers of
the state at the steps that evaluate, infer or save, and rank 0 evaluates
and writes the full model in the standard layout.  As in the reference,
``zero_optimizer`` is ignored under ``tensor_parallel``, and MultiProcess
rejects both.

``training.pipeline_parallel S`` trains through ``parallel/pipeline.py``
(GPipe, ``accumulation_steps`` micro-batches a step) on ``S`` stages × ``dp
= N/S`` ranks: rank r holds stage ``r // dp`` at data index ``r % dp``.  It
draws the whole model's parameters and cuts them to that stage's before it
makes the optimizer state or restores a checkpoint, which it then reads
for that stage's tensors only.  Stage 0 of data index d streams ``records[d::dp]`` with
``seed=d`` and ``batch_size / dp`` rows and sends the targets to the last
stage; the other stages read no data.  The losses reach rank 0 from the
last stage once a step.  At the steps that evaluate, infer or save, every
rank joins the merge of the stages' trees onto rank 0, which writes the
checkpoint in the standard layout and evaluates a whole model built for
that step (with the reference's warning at start-up).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time


def _resolve_auto_loss_options(config, graph):
    """Resolve the "auto" loss options from the darknet model cfg: adopt
    the per-[yolo]-layer ignore_thresh, iou_thresh (multi-anchor match
    gate), objectness_smooth, and max_delta values (darknet-config
    yolo.rs:15-49 surface) so darknet cfgs train with darknet's
    objectness masking / multi-positive matching / delta clamping out of
    the box.  NEWSLABv1 models (no [yolo] sections) resolve to disabled —
    the Rust reference's behavior.  A uniform per-layer set collapses to
    a scalar; mixed values stay a per-head tuple (loss/yolo_loss.py maps
    them per flat range).  truth_thresh < 1 (darknet's per-cell
    best-IoU-overwrite branch) is not implemented in the production loss —
    warn loudly instead of silently diverging (all 83 corpus cfgs carry
    truth_thresh=1, where it is a no-op)."""
    import dataclasses as _dc

    loss = config.loss
    tt = getattr(graph, "detect_truth_thresh", None)
    if tt and any(t < 1.0 for t in tt):
        print(f"warning: model cfg truth_thresh={tt} < 1 is not "
              "implemented; training without the multi-positive branch")

    def _adopt(field, attr, collapse=True):
        vals = getattr(graph, attr, None)
        if not vals or all(v is None for v in vals):
            new = None
        elif collapse and len(set(vals)) == 1:
            new = vals[0]
        else:
            new = tuple(vals)
        if new is not None and new != 1.0 and new is not False:
            print(f"loss.{field}: auto -> {new} (from the model cfg)")
        return new

    updates = {}
    if loss.ignore_thresh == "auto":
        updates["ignore_thresh"] = _adopt("ignore_thresh",
                                          "detect_ignore_thresh")
    if loss.iou_thresh == "auto":
        # per-head iou_thresh values of 1.0 are no-ops — collapse to None
        # when every head carries the default
        v = _adopt("iou_thresh", "detect_iou_thresh")
        if isinstance(v, float) and v >= 1.0:
            v = None
        updates["iou_thresh"] = v
    if loss.objectness_smooth == "auto":
        vals = getattr(graph, "detect_objectness_smooth", None)
        new = bool(vals and any(vals))
        if new:
            print("loss.objectness_smooth: auto -> True (from the model cfg)")
        updates["objectness_smooth"] = new
    if loss.max_delta == "auto":
        updates["max_delta"] = _adopt("max_delta", "detect_max_delta")
    if not updates:
        return config
    return _dc.replace(config, loss=_dc.replace(loss, **updates))


def _join_ranks(config, args):
    """Join this process's data-parallel group: MultiProcess from the config
    or the environment, a MultiDevice rank from the variables its parent
    set.  → the rank's DataMesh."""
    from ..config.app_config import training_devices
    from ..parallel.mesh import init_process_group, parse_device, rank_environment

    mp = config.multi_process
    if mp is not None and mp.coordinator:
        pid = args.process_id if args.process_id >= 0 else int(
            os.environ.get("YDL_PROCESS_ID", "-1"))
        if pid < 0:
            raise SystemExit(
                "MultiProcess with an explicit coordinator needs "
                "--process-id (or YDL_PROCESS_ID)")
        init = dict(init_method=f"tcp://{mp.coordinator}", rank=pid,
                    world_size=mp.num_processes)
        rank = pid
    else:
        env = rank_environment()
        if env is None:
            raise SystemExit(
                "MultiProcess without a coordinator joins from the environment: "
                "start the ranks with torchrun (RANK, WORLD_SIZE, MASTER_ADDR, "
                "MASTER_PORT)")
        init, rank = {}, env[0]
    if mp is None:  # a MultiDevice rank: the config's rank-th device
        devices = training_devices(args.config_file)
        device = parse_device(devices[rank], args.device)
    else:
        import torch

        device = torch.device(args.device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return init_process_group(device, **init)


def resize_images(images, size: int):
    """``jax.image.resize(images, (b, c, size, size), "bilinear")`` in
    PyTorch: half-pixel centres, and a triangle filter widened by the
    scale when shrinking (antialias), as jax.image does."""
    import torch.nn.functional as F

    return F.interpolate(images, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description="yolodl_torch trainer")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--max-steps", type=int, default=0,
                        help="stop after N steps (0 = run forever)")
    parser.add_argument("--profile-dir", default="",
                        help="write a torch.profiler trace of steps 5-10 "
                             "into this directory")
    parser.add_argument("--process-id", type=int, default=-1,
                        help="this process's rank under MultiProcess with an "
                             "explicit coordinator (else YDL_PROCESS_ID)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    argv = sys.argv[1:] if argv is None else list(argv)

    import numpy as np
    import torch

    from .._device import resolve_device
    from ..bridge import params_from_jax, params_to_jax
    from ..config.app_config import TrainAppConfig
    from ..data.cache import FileCache, MemoryCache, make_decode_loader
    from ..data.datasets import SanitizedDataset
    from ..data.mosaic import MosaicMixer
    from ..data.pipeline import TrainingStream, TrainingStreamConfig, device_prefetch
    from ..graph import Graph
    from ..graph.from_darknet import load_darknet_graph
    from ..models import YoloModel
    from ..train import TrainConfig, make_train_step, train_init
    from ..train.checkpoint import (AsyncCheckpointer, load_checkpoint,
                                    load_recent_checkpoint_in_runs)
    from ..train.ema import ema_init
    from ..train.logging import LoggingWorker
    from ..train.loop import load_optimizer_state_tree, optimizer_state_tree
    from ..train.lr_schedule import lr_at_step
    from ..utils.timing import RateCounter

    config = TrainAppConfig.load(args.config_file)
    base_dir = os.path.dirname(os.path.abspath(args.config_file))
    # the config's loss errors, before any rank starts
    if config.loss_impl not in ("production", "darknet"):
        raise SystemExit(
            f"unknown training.loss.impl {config.loss_impl!r} "
            "(expected Production or Darknet)")
    if config.loss_impl == "darknet":
        if config.model_kind != "darknet":
            raise SystemExit(
                "training.loss.impl Darknet needs a darknet model cfg")
        if config.pipeline_parallel > 1:
            raise SystemExit(
                "training.loss.impl Darknet does not support "
                "pipeline_parallel (single-device, DP, TP, ZeRO all work)")

    # data parallelism: a MultiDevice parent starts one rank per device and
    # waits; a rank (MultiDevice or MultiProcess) joins its group before
    # anything touches a device
    from ..parallel.mesh import rank_environment

    mesh = None
    if config.multi_process is None and config.n_devices > 1 and rank_environment() is None:
        from ..config.app_config import training_devices
        from ..parallel.mesh import launch_ranks, parse_device

        resolve_device(args.device)  # no card, no ranks
        for d in map(parse_device, training_devices(args.config_file),
                     [args.device] * config.n_devices):
            if d.type == "cuda" and d.index >= torch.cuda.device_count():
                raise ValueError(f"device_config lists {d}, but this machine has "
                                 f"{torch.cuda.device_count()} card(s)")
        print(f"dp: starting {config.n_devices} ranks", flush=True)
        return launch_ranks([sys.executable, "-m", "yolodl_torch.cli.train_main", *argv],
                            config.n_devices)
    if config.multi_process is not None or config.n_devices > 1:
        import dataclasses

        mesh = _join_ranks(config, args)
        if config.multi_process is None and mesh.world_size != config.n_devices:
            raise SystemExit(
                f"device_config lists {config.n_devices} devices but "
                f"{mesh.world_size} ranks joined")
        config = dataclasses.replace(config, n_devices=mesh.world_size)
        replicas = config.n_devices // (config.tensor_parallel * config.pipeline_parallel)
        if config.batch_size % (replicas * config.accumulation_steps):
            raise SystemExit(
                f"training.batch_size ({config.batch_size}) must be "
                f"divisible by global devices x accumulation_steps "
                f"({replicas} x {config.accumulation_steps})")
        if config.multi_process is not None:
            print(f"multi-process: rank {mesh.rank}/{mesh.world_size}, "
                  f"1 local / {config.n_devices} global devices", flush=True)
        if mesh.is_chief:
            print(f"dp: {mesh.world_size} ranks, backend {mesh.backend} ({mesh.reason})",
                  flush=True)
        device = mesh.device
    else:
        device = resolve_device(args.device)
    rank, world = (mesh.rank, mesh.world_size) if mesh is not None else (0, 1)
    is_chief = rank == 0

    # ZeRO-1 and tensor parallelism (yolodl_tpu/cli/train_main.py:412-436)
    use_tp = config.tensor_parallel > 1
    use_zero = config.zero_optimizer and config.n_devices > 1 and not use_tp
    if config.zero_optimizer and config.n_devices <= 1:
        print("zero_optimizer requires a MultiDevice config; ignoring "
              "(optimizer-state sharding is a no-op on one device)")
    if config.zero_optimizer and use_tp and is_chief:
        print("tensor_parallel already shards the optimizer state on the "
              "model axis; ignoring zero_optimizer")
    tp_mesh = None
    if use_tp:
        from ..parallel.mesh import make_tp_mesh

        tp_mesh = make_tp_mesh(config.n_devices // config.tensor_parallel,
                               config.tensor_parallel)
        if is_chief:
            print(f"mesh: data={tp_mesh.n_data} x model={tp_mesh.n_model} "
                  "(tensor parallel)", flush=True)
    # pipeline parallelism (yolodl_tpu/cli/train_main.py:482-513)
    use_pp = config.pipeline_parallel > 1
    pp_mesh = None
    if use_pp:
        from ..parallel.mesh import make_pp_mesh

        pp_mesh = make_pp_mesh(config.pipeline_parallel,
                               config.n_devices // config.pipeline_parallel)
    if use_zero and is_chief:
        from ..parallel.mesh import reduce_scatter_route

        print(f"zero: optimizer state over {world} ranks, reduce-scatter by "
              f"{reduce_scatter_route(mesh.backend)} ({mesh.backend})", flush=True)
    # the data streams: one per data index (a TP model group streams one, a
    # pipeline's stage 0 of each data index reads it)
    data_rank, data_world = ((tp_mesh.data_index, tp_mesh.n_data) if use_tp
                             else (pp_mesh.data_index, pp_mesh.n_data) if use_pp
                             else (rank, world))

    # timestamped run dir + config copy (main.rs:34-51); other ranks get a
    # rank-suffixed dir (no checkpoints land there, so FromRecent resume
    # scans only ever find the chief's)
    stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
    rank_tag = f"-r{rank}" if rank else ""
    run_dir = os.path.join(config.logging.dir, stamp + rank_tag)
    # the stamp has second resolution: two runs in the same second must not
    # share a dir (interleaved checkpoints would poison FromRecent resume)
    dedupe = 1
    while True:
        try:
            os.makedirs(run_dir)
            break
        except FileExistsError:
            dedupe += 1
            run_dir = os.path.join(config.logging.dir, f"{stamp}.{dedupe}{rank_tag}")
    shutil.copy(args.config_file, os.path.join(run_dir, "train.json5"))
    ckpt_dir = os.path.join(run_dir, "checkpoints")

    # model
    model_path = os.path.join(base_dir, config.model_file)
    if config.model_kind == "darknet":
        graph = load_darknet_graph(model_path)
    else:
        graph = Graph.load_newslab_v1_json(model_path)
    if config.freeze or config.freeze_through:
        # frozen-layer fine-tuning: merge with any cfg-level stopbackward
        frozen = set(graph.stop_gradient_paths)
        for p in config.freeze:
            try:
                graph.resolve_path(p)
            except ValueError as e:
                raise SystemExit(f"training.freeze: {e}")
            frozen.add(p)
        if config.freeze_through:
            try:
                frozen |= graph.ancestor_paths(config.freeze_through)
            except ValueError as e:
                raise SystemExit(f"training.freeze_through: {e}")
        graph.stop_gradient_paths = frozenset(frozen)
        print(f"freezing {len(frozen)} node(s): "
              + ", ".join(sorted(frozen)[:8])
              + (" ..." if len(frozen) > 8 else ""))
    config = _resolve_auto_loss_options(config, graph)
    # seed 0, as the reference's train_init(seed=0)
    model = YoloModel(graph, device=device, generator=torch.Generator().manual_seed(0),
                      remat="blocks" if config.remat else "off")

    # lr_schedule {type: FromModelCfg}: adopt the darknet [net] policy
    if config.lr.kind == "from_model_cfg":
        if config.model_kind != "darknet":
            raise SystemExit(
                "optimizer.lr_schedule FromModelCfg needs a darknet model "
                "cfg (NEWSLABv1 models carry no [net] policy)")
        import dataclasses as _dc

        from ..config import darknet_cfg as _dk
        from ..train.lr_schedule import lr_schedule_from_darknet

        config = _dc.replace(
            config, lr=lr_schedule_from_darknet(_dk.Darknet.load(model_path).net))

    # preprocessor.from_model_cfg: adopt the darknet cfg's data recipe
    if config.preprocessor.from_model_cfg:
        if config.model_kind != "darknet":
            raise SystemExit(
                "preprocessor.from_model_cfg needs a darknet model cfg "
                "(NEWSLABv1 models carry no [net]/[yolo] aug knobs)")
        from ..config import darknet_cfg as _dk2
        from ..config.app_config import adopt_darknet_data_recipe

        config = adopt_darknet_data_recipe(config, _dk2.Darknet.load(model_path))
        pre2 = config.preprocessor
        print(
            f"data recipe from model cfg: mosaic_prob={pre2.mosaic_prob}, "
            f"color_jitter={pre2.color_jitter}, affine={pre2.affine}, "
            f"multi_scale={list(config.multi_scale_sizes) or None}")

    # dataset + pipeline; one cache_dir, resolved against the config-file dir
    pre = config.preprocessor
    cache_dir = (
        os.path.join(base_dir, pre.cache_dir)
        if pre.cache_dir and not os.path.isabs(pre.cache_dir)
        else pre.cache_dir
    )
    records_cache_dir = cache_dir if pre.cache_records else ""
    dataset = SanitizedDataset(
        config.dataset.open(base_dir, records_cache_dir=records_cache_dir),
        out_of_bound_tolerance=config.preprocessor.out_of_bound_tolerance,
        min_bbox_size=config.preprocessor.min_bbox_size,
    )
    size = config.dataset.image_size
    if pre.cache_method == "file":
        loader = FileCache(cache_dir or os.path.join(run_dir, "cache"),
                           (size, size), dtype=pre.cache_dtype)
    elif pre.cache_method == "tfrecord":
        from ..data.tfrecord_cache import TfrecordCache

        # a shard file per rank: appends to one file are not safe across
        # processes, and the ranks' records are disjoint anyway
        loader = TfrecordCache(cache_dir or os.path.join(run_dir, "cache"), (size, size),
                               shard_tag=f"-r{rank}" if world > 1 else "")
    elif pre.cache_method == "memory":
        loader = MemoryCache((size, size))
    else:
        loader = make_decode_loader((size, size))
    # several ranks: each streams its strided share of the records and
    # makes its local slice of the global batch
    records = dataset.records()
    local_batch = config.batch_size
    if data_world > 1:
        if len(records) <= data_rank:
            raise ValueError(f"rank {data_rank} of {data_world} gets no records: the "
                             f"dataset holds {len(records)}")
        records = records[data_rank::data_world]
        local_batch = config.batch_size // data_world
    # preprocessor.pipeline.device "cuda" ("tpu" in the config's own words):
    # defer the pixel augmentation to the batched device program
    # (data/device_augment.py).  A multi-step call stacks HOST arrays, the
    # debug images need the host's per-stage pixels, and a MultiProcess rank
    # keeps the reference's host pipeline, so these keep the CPU pipeline,
    # with the reference's warnings; a MultiDevice rank augments on its card.
    defer_images = False
    if pre.pipeline_device == "tpu":
        eff_scan = (config.steps_per_call
                    if config.steps_per_call > 1 and world == 1
                    and not config.multi_scale_sizes else 1)
        if eff_scan > 1 or (config.multi_process is not None and world > 1):
            print("warning: preprocessor.pipeline.device='tpu' requires "
                  "single-process, non-scanned training; using the CPU "
                  "pipeline", file=sys.stderr)
        elif config.logging.enable_images:
            print("warning: logging.enable_images needs host-side pipeline "
                  "stages for debug images; using the CPU pipeline instead "
                  "of pipeline.device='tpu'", file=sys.stderr)
        else:
            defer_images = True
    ordered = not pre.unordered
    if use_tp and not ordered:
        # the ranks of a model group must draw the same batches
        if is_chief:
            print("tensor_parallel: the ranks of a model group stream the same "
                  "records; ignoring unordered records/batches")
        ordered = True
    stream_cfg = TrainingStreamConfig(
        batch_size=local_batch,
        defer_images=defer_images,
        seed=data_rank,  # decorrelate the data ranks' augmentation streams
        mosaic_prob=pre.mosaic_prob,
        mixup_prob=pre.mixup_prob,
        cutmix_prob=pre.cutmix_prob,
        mosaic=MosaicMixer(mosaic_margin=pre.mosaic_margin),
        color_jitter=pre.color_jitter,
        color_jitter_prob=pre.color_jitter_prob,
        random_affine=pre.affine,
        affine_prob=pre.affine_prob,
        bbox_scaling=pre.bbox_scaling,
        workers=pre.workers,
        ordered=ordered,
    )
    stream = TrainingStream(records, loader, stream_cfg)

    logger_holder = {}
    current_step = {"n": 0}  # host-side optimizer step, for telemetry tags
    if config.logging.enable_images:
        # per-stage debug images with boxes (logging.rs:428-500 taxonomy)
        from ..train.logging import draw_boxes_on_image

        debug_counter = {"n": 0}

        def debug_hook(stage, rec):
            lg = logger_holder.get("logger")
            sampled = debug_counter["n"] % 50 == 0
            debug_counter["n"] += 1
            if lg is None or not sampled:
                return
            boxes = rec.boxes
            if len(boxes):
                cy, cx, h, w = (boxes[:, k] for k in range(4))
                tlbr = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)
                canvas = draw_boxes_on_image(rec.image, tlbr)
            else:
                canvas = rec.image
            # tag with the optimizer step (approximate: the hook runs on
            # pipeline threads ahead of the trainer)
            lg.log_image(current_step["n"], f"pipeline/{stage}", canvas)

        stream_cfg.debug_hook = debug_hook

    # training.loss.impl=Darknet: the step trains the raw head-conv outputs
    # (graph.detect_head_input_keys) through the darknet-exact loss, with
    # per-head params from the model cfg's [yolo]/[Gaussian_yolo] sections
    darknet_loss_spec = None
    dk_heads = []
    if config.loss_impl == "darknet":
        from ..config import darknet_cfg as _dkl
        from ..loss.darknet_loss import head_params_from_darknet

        _dn = _dkl.Darknet.load(model_path)
        dk_heads = [l for l in _dn.layers if isinstance(l, _dkl.Yolo)]
        if not dk_heads:
            raise SystemExit(
                "training.loss.impl Darknet needs [yolo]/[Gaussian_yolo] "
                "heads ([region]/[detection] exact losses are library-"
                "level only: loss/darknet_loss.py)")
        _h, _w, _ = _dn.net.input_shape_hwc
        _head_params = []
        for _li, _l in enumerate(_dn.layers):
            if not isinstance(_l, _dkl.Yolo):
                continue
            try:
                _head_params.append(head_params_from_darknet(_l, _w, _h))
            except ValueError as e:
                # cfg-validation-time rejection with the offender named
                raise SystemExit(f"{model_path}: layer {_li}: {e}") from None
        darknet_loss_spec = (graph.detect_head_input_keys(), tuple(_head_params))
        print(f"loss impl: darknet-exact ({len(dk_heads)} heads; per-term "
              "losses + darknet avg_iou/obj/no_obj/recall telemetry from "
              "the delta buffers)")

    # trainer
    train_cfg = TrainConfig(
        lr=config.lr, optimizer=config.optimizer,
        momentum=config.momentum, weight_decay=config.weight_decay,
        loss=config.loss,
        darknet_loss=darknet_loss_spec,
        use_ema=config.use_ema, ema_decay=config.ema_decay,
        benchmark_confidence=(
            config.nms_conf_thresh if config.logging.enable_benchmark else None
        ),
        log_weights_and_grads=config.logging.enable_gradients,
        return_obj_sample=config.logging.enable_images,
        debug_stat=config.logging.enable_debug_stat,
        compute_dtype={"float32": None}.get(config.precision, config.precision),
    )
    head_infos = None
    if config.logging.enable_images:
        # static per-head layout for the objectness heatmap, from the whole
        # model (a pipeline stage holds only its own nodes)
        with torch.no_grad():
            head_infos = model(torch.zeros((1, 3, size, size), device=device)).infos
    pp_model = None
    if use_zero:
        from ..parallel.zero import (load_zero_optimizer_state_tree, place_zero_state,
                                     zero_init, zero_optimizer_state_tree)

        ts, optimizer = zero_init(model, train_cfg, mesh)
    elif use_pp:
        from ..parallel.pipeline import PipelineModel, PipelineTrainStep

        # cut ``model`` to this rank's stage before it has optimizer state
        # and before a checkpoint is restored into it: the restore then
        # reads only the stage's tensors
        pp_model = PipelineModel(model, pp_mesh)
        ts = PipelineTrainStep(pp_model, train_cfg,
                               n_micro=config.accumulation_steps).init_opt()
        optimizer = ts.optimizer
    else:
        ts, optimizer = train_init(model, train_cfg)

    def host_trees(ts, opt=None):
        """(params, state, opt, ema) of ``ts`` as the reference's trees, on
        the host; ``opt`` in place of the optimizer's own tree."""
        params, state = params_to_jax(ts.model.state_dict())
        ema = params_to_jax(ts.ema_params)[0] if ts.ema_params is not None else None
        return params, state, (optimizer_state_tree(ts, train_cfg) if opt is None else opt), ema

    # checkpoint restore (utils/checkpoint.rs:24-81 semantics)
    restored = None
    if config.checkpoint.mode in ("from_recent", "from_file"):
        # a ZeRO run's template is the flat layout (every rank gathers it)
        params_t, state_t, opt_t, _ = host_trees(
            ts, zero_optimizer_state_tree(ts, train_cfg, mesh) if use_zero else None)
        if config.checkpoint.mode == "from_recent":
            # scan prior runs under the logging dir, not this run's empty dir
            restored = load_recent_checkpoint_in_runs(
                config.logging.dir, params_t, state_t, opt_t)
        else:
            restored = load_checkpoint(
                os.path.join(base_dir, config.checkpoint.file), params_t, state_t, opt_t)
    if restored is not None:
        params, state, opt_state, meta = restored
        params_from_jax(params, state, model=model)
        if opt_state is not None:
            ts.step = int(meta["step"])
            (load_zero_optimizer_state_tree if use_zero else load_optimizer_state_tree)(
                ts, train_cfg, opt_state)
        ts.step = int(meta["step"])
        # restored EMA (if present) continues accumulating; otherwise the
        # EMA shadow restarts from the restored params
        if ts.ema_params is not None:
            if meta.get("ema") is not None:
                ema = params_from_jax(meta["ema"], {})
                ts.ema_params = {k: ema[k].to(device) for k in ts.ema_params}
            else:
                ts.ema_params = ema_init(dict(model.named_parameters()))
        print(f"restored checkpoint at step {meta['step']}")
    if config.override_initial_step is not None:
        ts.step = int(config.override_initial_step)

    # exact-resume data order: a FromRecent restore continues THIS run's
    # data stream (per-slot RNG keys make the skip bitwise-faithful)
    if restored is not None and config.checkpoint.mode == "from_recent":
        stream_cfg.start_records = int(restored[3]["step"]) * local_batch
        if stream_cfg.start_records:
            print(f"data stream resumed at record {stream_cfg.start_records}")

    accum = config.accumulation_steps
    full_ts = None  # under TP: rank 0's full single-device state
    if mesh is not None:
        from ..parallel.dp import (make_dp_train_step, replicate_state,
                                   shard_batch_multiprocess)

    if mesh is not None and not use_pp:
        # every rank starts from rank 0's state (restored or drawn); ZeRO
        # keeps this rank's slice of the optimizer state, TP its shards.
        # Under pipeline parallelism every rank drew or restored its own
        # stage's part of the same state.
        ts = (place_zero_state if use_zero else replicate_state)(mesh, ts)
    if use_pp:
        if is_chief:
            print(f"pipeline: {config.pipeline_parallel} stages "
                  f"({', '.join(str(len(p.keys)) + ' nodes' for p in pp_model.stages)})"
                  f" x dp={pp_mesh.n_data}, {accum} microbatches/step")
            print(f"pipeline: boundary tensors over {pp_mesh.route} ({mesh.reason})",
                  flush=True)
            if config.eval_interval or config.logging.enable_inference:
                print("warning: in-training evaluation/inference merges the "
                      "full model onto the default device; if the model needs "
                      "pipeline_parallel to fit in one chip's HBM, run eval "
                      "offline instead (eval CLI on a bigger host)")
    if use_tp:
        from ..parallel.tp import (check_model_group_batch, gather_train_state,
                                   make_tp_train_step, place_tp_state)

        ts = place_tp_state(tp_mesh, ts)
        # rank 0 keeps a full model for the evaluation, the inference and the
        # checkpoints, refilled by every rank's gather (memory: a second
        # model and its moments on rank 0's device)
        full_ts = gather_train_state(tp_mesh, ts, train_cfg)
    if use_zero:
        from ..parallel.zero import make_zero_train_step
    # under pipeline parallelism rank 0 builds a whole model at each step
    # that evaluates or infers (eval_net)
    eval_model = full_ts.model if full_ts is not None else None if use_pp else model

    def train_step(cfg):
        if use_pp:
            return PipelineTrainStep(pp_model, cfg, n_micro=accum).step_fn()
        if use_tp:
            return make_tp_train_step(model, optimizer, cfg, tp_mesh, accum=accum)
        if use_zero:
            return make_zero_train_step(model, optimizer, cfg, mesh, accum=accum)
        if mesh is not None:
            return make_dp_train_step(model, optimizer, cfg, mesh, accum=accum)
        return make_train_step(model, optimizer, cfg, accum=accum)

    step_fn = train_step(train_cfg)

    # multi_scale × darknet-exact loss: the head params bind net_w/net_h
    # (darknet's resize_network updates them per random=1 resize, and
    # delta_yolo_box normalizes the anchors by them), so each training size
    # gets its own step with head params of that size, built once
    dk_steps = {}

    def step_for_size(size):
        if darknet_loss_spec is None or not config.multi_scale_sizes:
            return step_fn
        fn = dk_steps.get(size)
        if fn is None:
            import dataclasses as _dc

            from ..loss.darknet_loss import head_params_from_darknet as _hp

            spec = (darknet_loss_spec[0], tuple(_hp(l, size, size) for l in dk_heads))
            fn = dk_steps[size] = train_step(_dc.replace(train_cfg, darknet_loss=spec))
        return fn

    logger = LoggingWorker(run_dir).start()
    logger_holder["logger"] = logger if config.logging.enable_images else None
    last_batch = {"images": None, "infos": None}

    # in-training inference visualization (logging.enable_inference,
    # multi_gpu.rs:239-261, logging.rs:379-422), with the model cfg's
    # nms_kind + beta_nms like the detect CLI
    nms_kind, nms_beta = "greedy", 0.6
    if config.model_kind == "darknet":
        from ..config import darknet_cfg as dk
        from ..loss.nms import nms_options_from_darknet

        nms_kind, nms_beta = nms_options_from_darknet(dk.Darknet.load(model_path))

    infer_one = None
    if config.logging.enable_inference and is_chief:
        from ..loss import non_max_suppression, to_host_detections, yolo_inference
        from ..train.logging import draw_boxes_on_image as _draw

        _palette = [
            (1.0, 0.2, 0.2), (0.2, 1.0, 0.2), (0.2, 0.4, 1.0),
            (1.0, 0.6, 0.1), (0.8, 0.2, 1.0), (0.1, 0.9, 0.9),
        ]

        def infer_one(net, step, image_chw, gt_boxes, gt_mask):
            """Run inference of ``net`` on one training image and log the
            overlay: GT yellow, predictions per-class colors (detect-CLI
            taxonomy)."""
            with torch.no_grad():
                pred = net(torch.from_numpy(np.asarray(image_chw)[None]).to(device))
                nms = non_max_suppression(
                    pred,
                    iou_threshold=config.nms_iou_thresh,
                    confidence_threshold=config.nms_conf_thresh,
                    suppress_by_class=False,
                    class_mode="argmax",
                    kind=nms_kind,
                    beta=nms_beta,
                )
                dets = to_host_detections(yolo_inference(nms, pred.num_flats))[0]
            canvas = np.asarray(image_chw, np.float32)
            gt = np.asarray(gt_boxes)[np.asarray(gt_mask)]
            if len(gt):
                cy, cx, h, w = (gt[:, k] for k in range(4))
                gt_tlbr = np.stack(
                    [cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)
                canvas = _draw(canvas, gt_tlbr, color=(1.0, 1.0, 0.0))
            # one draw call (= one canvas copy) per palette color, not per box
            by_color = {}
            for det in dets:
                by_color.setdefault(det["class"] % len(_palette), []).append(
                    det["tlbr"])
            for ci, boxes in by_color.items():
                canvas = _draw(canvas, np.asarray(boxes), color=_palette[ci])
            logger.log_image(step, "inference/detections", np.clip(canvas, 0, 1))

    # periodic in-training validation (evaluation.interval)
    evaluator = None
    if config.eval_interval and is_chief:
        from ..train.evaluation import DatasetEvaluator

        ev_cfg = config.eval_dataset or config.dataset
        ev_ds = SanitizedDataset(
            ev_cfg.open(base_dir, records_cache_dir=records_cache_dir),
            out_of_bound_tolerance=config.preprocessor.out_of_bound_tolerance,
            min_bbox_size=config.preprocessor.min_bbox_size,
        )
        ev_records = ev_ds.records()
        if config.eval_limit:
            ev_records = ev_records[: config.eval_limit]
        ev_size = ev_cfg.image_size
        evaluator = DatasetEvaluator(
            eval_model, ev_records, make_decode_loader((ev_size, ev_size)),
            num_classes=len(ev_ds.classes),
            batch_size=config.eval_batch_size or config.batch_size,
            iou_threshold=config.nms_iou_thresh,
            confidence_threshold=config.eval_conf_thresh,
            nms_kind=nms_kind,
            nms_beta=nms_beta,
            # validation runs at the training precision
            precision=config.precision,
        )

    last_batch["infos"] = head_infos
    batch_rate = RateCounter()
    record_rate = RateCounter()

    # multi-scale training (darknet random=1): boxes are ratio units, so
    # rescaling is image-only
    ms_sizes = list(config.multi_scale_sizes)

    def size_at(step):
        """The training size of the step after ``step`` steps."""
        if not ms_sizes:
            return size
        return ms_sizes[(step // config.multi_scale_interval) % len(ms_sizes)]

    def maybe_rescale(images, step):
        target = size_at(step)
        if images.shape[-1] == target:
            return images
        return resize_images(images, target)

    # multi-step calls (training.steps_per_call): K optimizer steps per call
    # on K stacked batches; incompatible with multi-scale and several ranks
    scan_k = config.steps_per_call
    if scan_k > 1 and (world > 1 or ms_sizes):
        print("steps_per_call > 1 requires single-device, fixed-size "
              "training; falling back to per-step dispatch")
        scan_k = 1
    if scan_k > 1 and args.max_steps and args.max_steps % scan_k:
        print(f"warning: --max-steps {args.max_steps} is not a multiple of "
              f"steps_per_call {scan_k}; the run stops at step "
              f"{-(-args.max_steps // scan_k) * scan_k} (window end)")
    if scan_k > 1:
        from ..train import make_multi_step

        step_fn = make_multi_step(model, optimizer, train_cfg, scan_k, accum=accum)

    # graceful preemption: SIGTERM/SIGINT request a checkpoint + clean exit
    # at the next step boundary; a second signal falls through to the
    # default handler
    import signal

    stop_signal = {"num": None}

    def _request_stop(signum, frame):
        stop_signal["num"] = signum
        signal.signal(signum, signal.SIG_DFL)

    for _sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(_sig, _request_stop)

    saver = AsyncCheckpointer()
    best_eval = {"map": -1.0}
    synced = {"step": None, "opt": None}

    def sync_state(step):
        """Every rank, once a step, at each step that evaluates, infers or
        saves: under TP the full state gathered into rank 0's ``full_ts``,
        under ZeRO the optimizer's flat moments gathered for the checkpoint.
        The ranks decide these steps alike, so none waits in a gather the
        others skip."""
        if synced["step"] == step:
            return
        synced["step"] = step
        if use_tp:
            gather_train_state(tp_mesh, ts, train_cfg, into=full_ts)
        if use_zero:
            synced["opt"] = zero_optimizer_state_tree(ts, train_cfg, mesh)
        if use_pp:
            synced["trees"] = ts.merged(pp_model, train_cfg)

    def eval_net():
        """The whole model rank 0 evaluates and infers with at a synced
        step: under pipeline parallelism one built from the merged trees,
        dropped at the end of the step."""
        if not use_pp:
            return eval_model
        if synced.get("net") is None:
            params, state, _ = synced["trees"]
            synced["net"] = YoloModel(graph, device=device)
            params_from_jax(params, state, model=synced["net"])
        return synced["net"]

    def save_checkpoint(step, total):
        sync_state(step)
        if not is_chief:  # rank 0 writes the (gathered) state
            return
        if use_pp:
            (params, state, opt), ema = synced["trees"], None
        else:
            params, state, opt, ema = host_trees(full_ts if use_tp else ts, synced["opt"])
        saver.save(ckpt_dir, step, total, params, state, opt, ema_params=ema)

    def stop_requested():
        """A signal on this rank, agreed over the ranks."""
        here = stop_signal["num"] is not None
        return mesh.agree(here) if mesh is not None else here

    def log_step(step, metrics, pick, index):
        """The finite check, TensorBoard logging and rates of one step's
        metrics → its total loss."""
        total = float(pick(metrics["total_loss"]))
        if not np.isfinite(total):
            raise RuntimeError(f"non-finite total loss at step {step}: {total}")
        if os.environ.get("YOLODL_DEBUG_ASSERT"):
            # per-term guard (the reference's debug_assert tier)
            for k, v in metrics.items():
                val = pick(v)
                if np.ndim(val) == 0 and not np.isfinite(float(val)):
                    raise RuntimeError(
                        f"non-finite metric {k!r} at step {step}")
        # the schedule is read at the 0-based pre-update count — log the
        # rate the update used
        lr = lr_at_step(config.lr, step - 1)
        bench_keys = ("obj_accuracy", "obj_recall", "obj_precision",
                      "class_accuracy", "num_matched",
                      # darknet console taxonomy (loss.impl=Darknet;
                      # yolo_layer.c:560-575 printed stats)
                      "avg_iou", "avg_obj", "avg_cat", "recall50",
                      "recall75", "no_obj")
        wg_keys = [k for k in metrics
                   if k.startswith(("weights_max/", "grads_max/"))]
        logger.log_training_output(
            step, lr,
            {k: float(pick(v)) for k, v in metrics.items()
             if k not in bench_keys and k not in wg_keys
             and k != "obj_sample"},
            benchmark={k: float(pick(metrics[k])) for k in bench_keys
                       if k in metrics} or None,
        )
        if wg_keys:
            # per-parameter |w|max / |grad|max (logging.rs:361-376)
            logger.log_scalars(
                step, {k: float(pick(metrics[k])) for k in wg_keys})
        if ("obj_sample" in metrics and (step % 200 == 0 or step == 1)
                and logger_holder.get("logger") is not None
                and last_batch.get("infos") is not None):
            if index is not None and last_batch.get("window"):
                imgs = last_batch["window"][index]
            else:
                imgs = last_batch.get("images")
            obj = np.asarray(pick(metrics["obj_sample"]), np.float32)
            # multi-scale steps at a non-base size have another flat layout
            if imgs is not None and \
                    obj.shape[0] == last_batch["infos"][-1].flat_end:
                logger.log_objectness_heatmap(
                    step, _host(imgs[0]), obj, last_batch["infos"])
        current_step["n"] = step
        batch_rate.add(1)
        record_rate.add(config.batch_size)
        if step % 10 == 0:
            print(
                f"step {step}  loss {total:.5f}  "
                f"{batch_rate.rate():.2f} batches/s  {record_rate.rate():.1f} records/s"
            )
        return total

    def handle_step(step, metrics, index=None, final=True, window=1):
        """Per-optimizer-step host work: finite check, TB logging, rates,
        checkpoints.  Returns True when training should stop.  With
        steps_per_call > 1 only the last step of a window has ``final``:
        the model then matches ``step``, so checkpoints and stops happen
        there only."""
        pick = (lambda v: v[index]) if index is not None else (lambda v: v)
        if "total_loss" in metrics:
            total = log_step(step, metrics, pick, index)
        else:  # a middle pipeline stage, which has no loss
            total = None
        if not final:
            return False
        # decided alike on every rank: each joins sync_state at these steps
        infer_due = (config.logging.enable_inference
                     and (step <= window or step % 200 < window))
        eval_due = bool(config.eval_interval) and (
            (step // config.eval_interval) > ((step - window) // config.eval_interval))
        if infer_due or eval_due:
            sync_state(step)
        if (infer_due and infer_one is not None and last_batch.get("images") is not None
                and last_batch.get("gt") is not None):
            imgs = last_batch["images"]
            gt_boxes, gt_mask = last_batch["gt"]
            infer_one(eval_net(), step, _host(imgs[0]), gt_boxes[0], gt_mask[0])
        saved = False
        if eval_due and evaluator is not None:
            evaluator.model = eval_net()
            report = evaluator()
            logger.log_scalars(step, {
                "val/mAP@0.5": report["mAP@0.5"],
                "val/mAP@0.5:0.95": report["mAP@0.5:0.95"],
            })
            print(f"step {step}  val mAP@0.5 {report['mAP@0.5']:.4f}  "
                  f"mAP@0.5:0.95 {report['mAP@0.5:0.95']:.4f}")
            if report["mAP@0.5"] > best_eval["map"]:
                # keep a checkpoint of the best validation mAP so far and
                # point best.json at it
                best_eval["map"] = report["mAP@0.5"]
                save_checkpoint(step, total)
                saved = True
                import json as _json

                with open(os.path.join(run_dir, "best.json"), "w") as bf:
                    _json.dump({"step": step,
                                "mAP@0.5": report["mAP@0.5"],
                                "mAP@0.5:0.95": report["mAP@0.5:0.95"]}, bf)
        if use_pp:  # the whole model lives for this step only
            synced["net"] = None
            if evaluator is not None:
                evaluator.model = None
        save = config.checkpoint.save_steps
        if save and not saved and (step // save) > ((step - window) // save):
            save_checkpoint(step, total)
            saved = True
        if args.max_steps and step >= args.max_steps:
            if not saved:
                save_checkpoint(step, total)
            return True
        if stop_requested():
            if not saved:
                save_checkpoint(step, total)
            saver.flush()  # raises if the write failed — do not lie below
            cause = (f"received signal {stop_signal['num']}" if stop_signal["num"] is not None
                     else "another rank received a signal")
            if is_chief:
                print(f"{cause} — checkpoint saved at step {step}, exiting")
            else:
                print(f"{cause} — stopping at step {step} (rank 0 saves the checkpoint)")
            return True
        return False

    def host_metrics(metrics):
        """One copy of the step's metrics to the host."""
        return {k: v.detach().to("cpu", torch.float32).numpy() for k, v in metrics.items()}

    profiler = None
    profiled = False
    pending = []
    host_step = first_step = ts.step
    # multi-step calls stack HOST arrays into one k-step upload
    if use_pp and not pp_model.is_first:
        def placeholders():
            """The later stages read no data: each step takes the shapes of
            this data index's batch, on the meta device."""
            while True:
                n, at, gt = local_batch, size_at(host_step), stream_cfg.max_gt
                specs = (((n, 3, at, at), torch.float32), ((n, gt, 4), torch.float32),
                         ((n, gt), torch.int32), ((n, gt), torch.bool))
                yield None, tuple(torch.empty(shape, dtype=dtype, device="meta")
                                  for shape, dtype in specs)

        source = placeholders()
    elif scan_k > 1:
        source = ((rec, None) for rec in iter(stream))
    elif stream_cfg.defer_images:
        # the augment program runs on the device and yields device-resident
        # batches, the contract of device_prefetch
        from ..data.device_augment import apply_device_augmentation

        source = apply_device_augmentation(iter(stream), stream_cfg, device)
    else:
        source = device_prefetch(iter(stream), device)
    try:
        for record, arrays in source:
            if args.profile_dir and not profiled:
                # trace ONE steady-state window after warm-up
                if host_step >= 5 and profiler is None:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if device.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=activities)
                    profiler.start()
                elif host_step >= 10 and profiler is not None:
                    profiler.stop()
                    os.makedirs(args.profile_dir, exist_ok=True)
                    profiler.export_chrome_trace(
                        os.path.join(args.profile_dir, f"trace{rank_tag}.json"))
                    profiler, profiled = None, True
                    print(f"wrote device trace to {args.profile_dir}")
            if scan_k > 1:
                pending.append((record.images, record.boxes,
                                record.classes, record.mask))
                last_batch["images"] = record.images
                last_batch["gt"] = (record.boxes, record.mask)
                if len(pending) < scan_k:
                    continue
                stacked = tuple(torch.from_numpy(np.stack(parts)).to(device)
                                for parts in zip(*pending))
                last_batch["window"] = [p[0] for p in pending]
                pending.clear()
                ts, metrics = step_fn(ts, *stacked)
                metrics = host_metrics(metrics)
                host_step += scan_k
                done = False
                for j in range(scan_k):
                    step = host_step - scan_k + 1 + j
                    if handle_step(step, metrics, index=j,
                                   final=(j == scan_k - 1), window=scan_k):
                        done = True
                        break
                if done:
                    break
                continue
            images, gt_boxes, gt_classes, gt_mask = arrays
            if mesh is not None:  # each rank's local rows, as they are
                images, gt_boxes, gt_classes, gt_mask = shard_batch_multiprocess(
                    mesh, (images, gt_boxes, gt_classes, gt_mask))
            if use_tp and host_step == first_step:  # a model group streams alike
                check_model_group_batch(tp_mesh, (images, gt_boxes, gt_classes, gt_mask))
            if record is not None:
                images = maybe_rescale(images, host_step)
                last_batch["images"] = record.images
                last_batch["gt"] = (record.boxes, record.mask)
            ts, metrics = step_for_size(int(images.shape[-1]))(
                ts, images, gt_boxes, gt_classes, gt_mask)
            metrics = host_metrics(metrics)  # one transfer per step
            host_step += 1
            if handle_step(host_step, metrics):
                break
    finally:
        if profiler is not None:
            profiler.stop()
        saver.flush()
        logger.close()
        if mesh is not None:
            from ..parallel.mesh import destroy_process_group

            destroy_process_group()


def _host(image):
    """An image of the last batch as a host f32 array: the CPU pipeline's
    are numpy already, the device augmentation's are tensors on the device."""
    import numpy as np
    import torch

    if isinstance(image, torch.Tensor):
        return image.detach().to("cpu", torch.float32).numpy()
    return np.asarray(image)


def cli():
    """Console-script entry: guarded main."""
    from ._guard import run
    run(main)


if __name__ == "__main__":
    cli()
