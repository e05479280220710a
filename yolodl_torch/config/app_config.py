"""train.json5 / detect.json5 application config schemas.

Equivalent capability to ``train/src/config.rs`` and ``detect/src/config.rs``:
the same JSON5 files drive this framework — config compatibility is a
deliberate parity surface (SURVEY §7.1).  Version is pinned to "0.1.0" like
the reference's SemverReq derive (config.rs:9-11); tagged enums use the same
"type"/"kind" discriminants.

Device configs map onto the TPU mesh: SingleDevice → 1 chip,
MultiDevice/NonUniformMultiDevice → a data-parallel mesh over that many
chips (non-uniform minibatch splits are meaningless under SPMD and are
normalized to uniform — documented divergence).

Counterpart of ``yolodl_tpu/config/app_config.py``: the same dataclasses,
fields, defaults, parsers and error messages.  JSON5 is read by
:mod:`yolodl_torch.config.json5_reader`; the loss, matcher and schedule
configs are the port's own; :func:`compute_dtype_of` gives a torch dtype.
A MultiDevice config trains one rank per listed device and a MultiProcess
config joins ranks started elsewhere (``parallel/mesh.py``); the device
list itself is read by :func:`training_devices`; ``train_main`` runs its
``zero_optimizer``, ``tensor_parallel`` and ``pipeline_parallel`` through
``parallel/zero.py``, ``tp.py`` and ``pipeline.py``.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import Optional, Tuple

import torch

from ..data.affine import RandomAffine
from ..data.color import ColorJitter
from ..data.datasets import CocoDataset, CsvDataset, IiiDataset, VocDataset
from ..loss.matcher import MatcherConfig
from ..loss.yolo_loss import LossConfig
from ..train.lr_schedule import LrScheduleConfig
from . import json5_reader

SUPPORTED_VERSION = "0.1.0"


def _check_version(raw: dict, path) -> None:
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: config root must be an object")
    version = raw.get("version")
    if version != SUPPORTED_VERSION:
        raise ValueError(
            f"{path}: config version {version!r} != supported {SUPPORTED_VERSION!r}"
        )


def _as_dict(val, what: str) -> dict:
    """Coerce an optional sub-config to a dict: null → {}, non-object →
    clean ValueError (corrupt configs must not crash downstream)."""
    if val is None:
        return {}
    if not isinstance(val, dict):
        raise ValueError(f"config entry {what!r} must be an object, "
                         f"got {type(val).__name__}")
    return val


def _parse_freeze(val) -> Tuple[str, ...]:
    """training.freeze: a list of node paths, or a single path as a bare
    string (iterating a string char-by-char would yield nonsense
    one-letter 'paths')."""
    if isinstance(val, str):
        return (val,) if val else ()
    if isinstance(val, (list, tuple)):
        bad = [p for p in val if not isinstance(p, str)]
        if bad:
            raise ValueError(
                f"training.freeze entries must be node-path strings, got "
                f"{bad[0]!r}")
        return tuple(val)
    raise ValueError(
        f"training.freeze must be a node path or list of node paths, got "
        f"{type(val).__name__}")


def parse_precision(value, where: str) -> str:
    """training.precision → "float32" | "bfloat16" (accepts common aliases)."""
    norm = str(value).lower()
    if norm in ("bf16", "bfloat16"):
        return "bfloat16"
    if norm in ("f32", "fp32", "float32"):
        return "float32"
    raise ValueError(
        f"{where}: training.precision must be \"float32\" or \"bfloat16\", "
        f"got {value!r}")


def compute_dtype_of(value, where: str = "--precision") -> torch.dtype:
    """Precision string (any parse_precision alias) → the activation
    compute dtype: ``torch.float32`` (the reference's semantics) or
    ``torch.bfloat16``.

    The single boundary for the precision→dtype mapping: every consumer
    routes through here so aliases like "bf16" behave identically
    everywhere and bad values fail with one clean ValueError."""
    norm = parse_precision(value, where)
    return torch.float32 if norm == "float32" else torch.bfloat16


def _dict_section(raw: dict, key: str, path, required: bool = True) -> dict:
    """A top-level config section that must be a JSON object — corrupt
    files get one clean ValueError, not an AttributeError downstream."""
    if key not in raw or raw[key] is None:
        if required:
            raise ValueError(f"{path}: missing required section {key!r}")
        return {}
    val = raw[key]
    if not isinstance(val, dict):
        raise ValueError(f"{path}: section {key!r} must be an object, "
                         f"got {type(val).__name__}")
    return val


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    kind: str  # coco | voc | csv | iii
    image_size: int
    dataset_dir: str = ""
    classes_file: str = ""
    image_dir: str = ""
    label_file: str = ""
    input_channels: int = 3
    dataset_name: str = ""
    class_whitelist: Tuple[str, ...] = ()
    blacklist_files: Tuple[str, ...] = ()

    @staticmethod
    def parse(raw: dict, class_whitelist=()) -> "DatasetConfig":
        """``class_whitelist`` overrides ``raw["class_whitelist"]`` when
        given (programmatic callers); the config key is the default."""
        kind_raw = _as_dict(raw["kind"], "dataset.kind")
        t = str(kind_raw["type"]).lower()
        return DatasetConfig(
            kind=t,
            image_size=int(kind_raw["image_size"]),
            dataset_dir=kind_raw.get("dataset_dir", ""),
            classes_file=kind_raw.get("classes_file", ""),
            image_dir=kind_raw.get("image_dir", ""),
            label_file=kind_raw.get("label_file", ""),
            input_channels=int(kind_raw.get("input_channels", 3)),
            dataset_name=kind_raw.get("dataset_name", ""),
            class_whitelist=tuple(
                class_whitelist or raw.get("class_whitelist", ()) or ()),
            blacklist_files=tuple(kind_raw.get("blacklist_files", ()) or ()),
        )

    def _resolver(self, base_dir: str):
        base = pathlib.Path(base_dir)

        def resolve(p):
            q = pathlib.Path(p)
            return str(q if q.is_absolute() else base / q)

        return resolve

    def source_files(self, base_dir: str = ".") -> list:
        """The annotation-source files whose (mtime, size) signature
        validates a records-cache entry (data/records_cache.py)."""
        from ..data.datasets import (
            coco_annotation_file, csv_source_files, iii_source_files,
            voc_source_files,
        )

        resolve = self._resolver(base_dir)
        if self.kind == "coco":
            return [coco_annotation_file(resolve(self.dataset_dir),
                                         dataset_name=self.dataset_name)]
        if self.kind == "voc":
            return voc_source_files(resolve(self.dataset_dir))
        if self.kind == "csv":
            return csv_source_files(
                resolve(self.image_dir), resolve(self.label_file),
                resolve(self.classes_file))
        if self.kind == "iii":
            return iii_source_files(
                resolve(self.dataset_dir), resolve(self.classes_file))
        raise ValueError(f"unknown dataset kind {self.kind!r}")

    def open(self, base_dir: str = ".", records_cache_dir: str = ""):
        """Instantiate the dataset loader (train/src dataset dispatch parity).

        ``records_cache_dir`` (preprocessor ``cache.records`` knob) caches
        the PARSED record list — the label-cache capability of the
        reference's ``cache`` crate (cache/src/label.rs), redesigned for
        where the cost actually is: annotation parsing at startup, not the
        per-record ratio transform (deterministic, recomputed at load)."""
        if records_cache_dir:
            from ..data.datasets import PrebuiltDataset
            from ..data.records_cache import (
                cache_file_path, load_records_cache, save_records_cache,
                source_signature,
            )

            sig = source_signature(self.source_files(base_dir))
            resolve = self._resolver(base_dir)
            key = dataclasses.asdict(self)
            # resolve the path-valued fields so the key is location-stable
            for field in ("dataset_dir", "classes_file", "image_dir",
                          "label_file"):
                if key[field]:
                    key[field] = os.path.abspath(resolve(key[field]))
            path = cache_file_path(resolve(records_cache_dir), key)
            hit = load_records_cache(path, sig)
            if hit is not None:
                records, classes, input_channels = hit
                return PrebuiltDataset(records, classes, input_channels)
            dataset = self.open(base_dir)
            save_records_cache(
                path, dataset.records(), dataset.classes,
                dataset.input_channels, sig)
            return dataset

        resolve = self._resolver(base_dir)
        whitelist = list(self.class_whitelist) or None
        if self.kind == "coco":
            return CocoDataset(
                resolve(self.dataset_dir), classes_whitelist=whitelist,
                dataset_name=self.dataset_name,
            )
        if self.kind == "voc":
            return VocDataset(resolve(self.dataset_dir))
        if self.kind == "csv":
            return CsvDataset(
                resolve(self.image_dir), resolve(self.label_file),
                resolve(self.classes_file), self.input_channels,
            )
        if self.kind == "iii":
            return IiiDataset(
                resolve(self.dataset_dir), resolve(self.classes_file),
                classes_whitelist=whitelist,
                blacklist_files=list(self.blacklist_files),
            )
        raise ValueError(f"unknown dataset kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class PreprocessorConfig:
    cache_method: str = "none"  # none | memory | file | tfrecord
    cache_dir: str = ""
    cache_dtype: str = "f32"  # f32 (reference format) | u8 (4x smaller)
    # cache.records: also cache the PARSED annotation records (label cache;
    # skips COCO-JSON / VOC-XML / CSV-image-size parsing on warm starts)
    cache_records: bool = False
    mosaic_prob: float = 0.0
    mixup_prob: float = 0.0
    cutmix_prob: float = 0.0
    mosaic_margin: float = 0.25
    affine: Optional[RandomAffine] = None
    color_jitter: Optional[ColorJitter] = None
    bbox_scaling: float = 1.0
    out_of_bound_tolerance: float = 0.0  # pixels (sanitized.rs:45-46)
    min_bbox_size: float = 0.0  # image ratio in [0,1] (sanitized.rs:22)
    workers: int = 2
    affine_prob: float = 1.0  # P(apply the whole affine) per record
    color_jitter_prob: float = 1.0  # P(apply HSV jitter) per record
    # preprocessor.pipeline.unordered_records / unordered_batches
    # (training_stream.rs:597-609): true lets the stream yield records as
    # workers finish instead of reassembling plan order (faster under
    # skewed decode times, non-deterministic batch composition)
    unordered: bool = False
    # preprocessor.pipeline.device: "cpu" (host pipeline + native kernels)
    # or "tpu" — pixel augmentation (HSV jitter / affine warp / mosaic /
    # mixup / cutmix) deferred to one jitted batched device program
    # (data/device_augment.py); the reference's preprocessor can likewise
    # run on its CUDA device.  Same RNG stream, host-computed labels.
    pipeline_device: str = "cpu"
    # preprocessor.from_model_cfg=true: adopt the darknet model cfg's own
    # data recipe ([net] mosaic/mixup/hue/saturation/exposure/angle/flip +
    # per-[yolo] jitter/random/resize) in place of the JSON5 aug fields —
    # the data-path sibling of optimizer.lr_schedule FromModelCfg.
    # Resolved by the train CLI via adopt_darknet_data_recipe.
    from_model_cfg: bool = False

    @staticmethod
    def parse(raw: dict) -> "PreprocessorConfig":
        raw = _as_dict(raw, "preprocessor")
        cache = _as_dict(raw.get("cache"), "preprocessor.cache")
        method_raw = cache.get("method", "NoCache")
        methods = {
            "NoCache": "none", "MemoryCache": "memory", "FileCache": "file",
            "TfrecordCache": "tfrecord",
        }
        if method_raw not in methods:
            raise ValueError(
                f"unknown cache method {method_raw!r}; expected one of "
                f"{sorted(methods)}")
        method = methods[method_raw]

        mixup = _as_dict(raw.get("mixup"), "preprocessor.mixup")
        affine_raw = _as_dict(raw.get("random_affine"), "preprocessor.random_affine")
        affine = None
        affine_prob = 1.0
        if affine_raw:
            # affine_prob gates the WHOLE affine per record (applied in the
            # pipeline); the sub-probabilities stay independent within an
            # applied affine — folding prob into each sub-prob would change
            # the joint distribution (e.g. rotate XOR flip instead of both)
            affine_prob = float(affine_raw.get("affine_prob", 1.0))
            affine = RandomAffine(
                rotate_prob=float(affine_raw.get("rotate_prob", 0.0)),
                rotate_degrees=float(affine_raw.get("rotate_degrees", 0.0)),
                translation_prob=float(affine_raw.get("translation_prob", 0.0)),
                translation=float(affine_raw.get("translation", 0.0)),
                scale_prob=float(affine_raw.get("scale_prob", 0.0)),
                scale=tuple(affine_raw["scale"]) if "scale" in affine_raw else None,
                horizontal_flip_prob=float(affine_raw.get("horizontal_flip_prob", 0.0)),
                vertical_flip_prob=float(affine_raw.get("vertical_flip_prob", 0.0)),
                min_bbox_size=_as_dict(raw.get("cleanse"), "preprocessor.cleanse").get("min_bbox_size"),
                min_bbox_cropping_ratio=_as_dict(raw.get("cleanse"), "preprocessor.cleanse").get("min_bbox_cropping_ratio"),
            )

        jitter_raw = _as_dict(raw.get("color_jitter"), "preprocessor.color_jitter")
        jitter = None
        jitter_prob = 1.0
        if jitter_raw:
            jitter_prob = float(jitter_raw.get("color_jitter_prob", 1.0))
            if jitter_prob > 0:
                jitter = ColorJitter(
                    hue_shift=jitter_raw.get("hue_shift"),
                    saturation_shift=jitter_raw.get("saturation_shift"),
                    value_shift=jitter_raw.get("value_shift"),
                )

        pipeline = _as_dict(raw.get("pipeline"), "preprocessor.pipeline")
        # unordered_records=true PERMITS out-of-order record reassembly
        # (the perf knob); unordered_batches alone is a no-op here — batch
        # assembly is single-threaded downstream of the record stream, so
        # batch composition stays deterministic and emission order is
        # already in-order (a valid refinement: the flag only permits
        # disorder, it never requires it; training_stream.rs:597-609)
        unordered = bool(pipeline.get("unordered_records", False))
        pipe_dev = str(pipeline.get("device", "cpu")).lower()
        if pipe_dev in ("tpu", "jax", "device", "accelerator", "cuda"):
            # the reference runs its preprocessor on a CUDA device when
            # asked; the TPU equivalent defers pixel augmentation to one
            # jitted batched program (data/device_augment.py)
            pipe_dev = "tpu"
        elif pipe_dev not in ("cpu", ""):
            import sys

            print(f"warning: preprocessor.pipeline.device {pipe_dev!r} is "
                  "not supported; the host pipeline runs on CPU (native "
                  "decode/affine/HSV kernels) with device-side batching",
                  file=sys.stderr)
            pipe_dev = "cpu"
        else:
            pipe_dev = "cpu"

        cleanse = _as_dict(raw.get("cleanse"), "preprocessor.cleanse")
        cache_records = bool(cache.get("records", False))
        if cache_records and not cache.get("cache_dir"):
            raise ValueError("preprocessor.cache.records requires cache_dir")

        return PreprocessorConfig(
            cache_method=method,
            cache_dir=cache.get("cache_dir", ""),
            cache_dtype=str(cache.get("dtype", "f32")),
            cache_records=cache_records,
            mosaic_prob=float(mixup.get("mosaic_prob", 0.0)),
            mixup_prob=float(mixup.get("mixup_prob", 0.0)),
            cutmix_prob=float(mixup.get("cutmix_prob", 0.0)),
            mosaic_margin=float(mixup.get("mosaic_margin", 0.25)),
            affine=affine,
            color_jitter=jitter,
            bbox_scaling=float(cleanse.get("bbox_scaling", 1.0)),
            out_of_bound_tolerance=float(cleanse.get("out_of_bound_tolerance", 0.0)),
            min_bbox_size=float(cleanse.get("min_bbox_size", 0.0)),
            workers=int(raw.get("workers", 2)),
            affine_prob=affine_prob,
            color_jitter_prob=jitter_prob,
            unordered=unordered,
            pipeline_device=pipe_dev,
            from_model_cfg=bool(raw.get("from_model_cfg", False)),
        )


def adopt_darknet_data_recipe(config, darknet):
    """preprocessor.from_model_cfg=true: derive the augmentation recipe
    from the darknet cfg so `train --config` on a raw darknet model
    reproduces darknet's data pipeline without hand-written JSON5 — the
    data-path sibling of ``lr_schedule_from_darknet``.

    Mapping (AlexeyAB data/detector semantics → this pipeline's knobs):

    - [net] mosaic=1 (mixup=3/4) → mosaic_prob=0.5: darknet gates mosaic
      per batch with random_gen()%2 (data.c:1069); mixup=1 → mixup_prob=0.5
    - [net] hue/saturation/exposure → ColorJitter shifts.  darknet samples
      MULTIPLICATIVE sat/exposure scales in [1/s, s] (rand_scale); this
      pipeline's jitter is additive-shift — mapped as shift = s-1, a
      documented approximation of the same strength
    - [net] flip (default 1, parser.c) → horizontal_flip_prob=0.5
      (per-image coin flip, data.c:1149)
    - [net] angle → rotate_degrees (rotate_prob=1); darknet's detector
      path only uses angle for classifier data — adopted here as the
      closest analogue
    - [yolo] jitter → translation=jitter (random crop/pad of up to
      ±jitter per side ≈ translation in the ±1 frame); [yolo] resize →
      scale=(1/resize, resize)
    - [yolo] random=r → training.multi_scale: dims
      round(v·init/32+1)·32 for v ∈ [1/coef, coef], coef = 1.4 when r==1
      else r (detector.c:195-206), interval 10
    """
    from . import darknet_cfg as dk

    net = darknet.net
    pre = config.preprocessor
    updates = {}

    mixup_raw = int(net.raw.get("mixup", 0) or 0)
    if net.mosaic or mixup_raw in (3, 4):
        updates["mosaic_prob"] = 0.5
    if mixup_raw == 1:
        updates["mixup_prob"] = 0.5

    jitter_fields = {}
    if net.hue:
        jitter_fields["hue_shift"] = float(net.hue)
    if net.saturation and net.saturation != 1.0:
        jitter_fields["saturation_shift"] = abs(float(net.saturation) - 1.0)
    if net.exposure and net.exposure != 1.0:
        jitter_fields["value_shift"] = abs(float(net.exposure) - 1.0)
    if jitter_fields:
        updates["color_jitter"] = ColorJitter(**jitter_fields)
        updates["color_jitter_prob"] = 1.0

    yolos = [l for l in darknet.layers if isinstance(l, dk.Yolo)]
    affine_fields = {}
    if int(net.raw.get("flip", 1) or 0):
        affine_fields["horizontal_flip_prob"] = 0.5
    if net.angle:
        affine_fields["rotate_prob"] = 1.0
        affine_fields["rotate_degrees"] = float(net.angle)
    if yolos:
        jit = float(yolos[0].jitter)
        if jit:
            affine_fields["translation_prob"] = 1.0
            affine_fields["translation"] = jit
        rsz = float(yolos[0].resize)
        if rsz and rsz != 1.0:
            affine_fields["scale_prob"] = 1.0
            affine_fields["scale"] = (1.0 / rsz, rsz)
    if affine_fields:
        updates["affine"] = RandomAffine(**affine_fields)
        updates["affine_prob"] = 1.0

    config = dataclasses.replace(
        config, preprocessor=dataclasses.replace(pre, **updates))

    rand = float(yolos[0].random) if yolos else 0.0
    if rand > 0.0:
        coef = 1.4 if rand == 1.0 else rand
        init = int(net.width)
        step = 32
        lo = int(round((init / coef) / step + 1)) * step
        hi = int(round((init * coef) / step + 1)) * step
        sizes = tuple(range(max(lo, step), hi + 1, step))
        config = dataclasses.replace(
            config, multi_scale_sizes=sizes, multi_scale_interval=10)
    return config


@dataclasses.dataclass(frozen=True)
class LoggingConfig:
    dir: str = "logs"
    enable_images: bool = False
    enable_debug_stat: bool = False
    enable_inference: bool = False
    enable_benchmark: bool = False
    enable_gradients: bool = False

    @staticmethod
    def parse(raw: dict) -> "LoggingConfig":
        raw = _as_dict(raw, "logging")
        return LoggingConfig(
            dir=raw.get("dir", "logs"),
            enable_images=bool(raw.get("enable_images", False)),
            enable_debug_stat=bool(raw.get("enable_debug_stat", False)),
            enable_inference=bool(raw.get("enable_inference", False)),
            enable_benchmark=bool(raw.get("enable_benchmark", False)),
            enable_gradients=bool(raw.get("enable_gradients", False)),
        )


def parse_loss_config(raw: dict) -> LossConfig:
    """training.loss block → LossConfig (train/src config loss parity)."""
    matcher = MatcherConfig(
        match_grid=str(raw.get("match_grid_method", "Rect4")).lower(),
        anchor_scale_thresh=float(raw.get("anchor_scale_thresh", 4.0)),
    )
    return LossConfig(
        box_metric=str(raw.get("box_metric", "DIoU")).lower(),
        objectness_loss_kind=str(raw.get("objectness_loss_fn", "Bce")).lower(),
        classification_loss_kind={
            "bce": "bce", "focal": "focal", "crossentropy": "cross_entropy",
            "cross_entropy": "cross_entropy", "l2": "l2",
        }[str(raw.get("classification_loss_fn", "Bce")).lower()],
        objectness_pos_weight=raw.get("objectness_positive_weight"),
        iou_loss_weight=float(raw.get("iou_loss_weight", 0.05)),
        objectness_loss_weight=float(raw.get("objectness_loss_weight", 1.0)),
        classification_loss_weight=float(raw.get("classification_loss_weight", 0.58)),
        smooth_classification_coef=float(raw.get("smooth_classification_coef", 0.01)),
        smooth_objectness_coef=float(raw.get("smooth_objectness_coef", 0.0)),
        # absent = "auto" (train CLI adopts darknet cfg values); an
        # explicit null disables, a number/array overrides
        ignore_thresh=(
            tuple(float(t) for t in raw["ignore_thresh"])
            if isinstance(raw.get("ignore_thresh"), (list, tuple))
            else raw.get("ignore_thresh", "auto")),
        # darknet [yolo] training-option adoption — absent = "auto" (train
        # CLI adopts the model cfg's per-head values), null disables,
        # number/array overrides
        iou_thresh=(
            tuple(float(t) for t in raw["iou_thresh"])
            if isinstance(raw.get("iou_thresh"), (list, tuple))
            else raw.get("iou_thresh", "auto")),
        objectness_smooth=raw.get("objectness_smooth", "auto"),
        max_delta=(
            tuple((None if t is None else float(t)) for t in raw["max_delta"])
            if isinstance(raw.get("max_delta"), (list, tuple))
            else raw.get("max_delta", "auto")),
        uncertainty_loss_weight=raw.get("uncertainty_loss_weight"),
        matcher=matcher,
    )


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    mode: str = "disabled"  # disabled | from_recent | from_file
    file: str = ""
    save_steps: int = 0

    @staticmethod
    def parse(raw: dict, save_steps: int) -> "CheckpointPolicy":
        raw = _as_dict(raw, "training.load_checkpoint")
        t = str(raw.get("type", "Disabled")).lower().replace("_", "")
        try:
            mode = {"disabled": "disabled", "fromrecent": "from_recent",
                    "fromfile": "from_file"}[t]
        except KeyError:
            raise ValueError(
                f"load_checkpoint.type must be Disabled/FromRecent/FromFile,"
                f" got {raw.get('type')!r}") from None
        return CheckpointPolicy(mode=mode, file=raw.get("file", ""),
                                save_steps=save_steps)


@dataclasses.dataclass(frozen=True)
class MultiProcessConfig:
    """Multi-controller (multi-host) training over the JAX distributed
    runtime — DCN scaling the reference entirely lacks (SURVEY §2.8/§5.8).
    ``coordinator`` empty = auto-discovery (TPU pod metadata); explicit
    ``host:port`` + ``num_processes`` + a per-process ``--process-id``
    support manual clusters."""

    coordinator: str = ""
    num_processes: int = 0


def training_devices(path) -> list:
    """``training.device_config``'s device entries as written (MultiDevice
    ``devices``; SingleDevice's ``device`` as a list of one).  The loaded
    config keeps only their count, as the reference's does."""
    with open(path, encoding="utf-8") as f:
        raw = json5_reader.load(f)
    device_cfg = (raw.get("training") or {}).get("device_config") or {}
    if device_cfg.get("devices"):
        return list(device_cfg["devices"])
    if device_cfg.get("minibatch_sizes"):  # NonUniformMultiDevice by index
        return list(range(len(device_cfg["minibatch_sizes"])))
    return [device_cfg.get("device", "cuda:0")]


@dataclasses.dataclass(frozen=True)
class TrainAppConfig:
    model_kind: str            # newslab_v1 | darknet
    model_file: str
    dataset: DatasetConfig
    preprocessor: PreprocessorConfig
    logging: LoggingConfig
    batch_size: int
    n_devices: int
    lr: LrScheduleConfig
    optimizer: str
    momentum: float
    weight_decay: float
    loss: LossConfig
    checkpoint: CheckpointPolicy
    override_initial_step: Optional[int]
    nms_iou_thresh: float
    nms_conf_thresh: float
    multi_scale_sizes: Tuple[int, ...] = ()
    multi_scale_interval: int = 10
    # training.loss.impl: "Production" (vectorized device loss, default) |
    # "Darknet" (the oracle-exact delta semantics of
    # loss/darknet_loss.py — bitwise darknet training through the CLI;
    # darknet model cfgs with [yolo]/[Gaussian_yolo] heads only)
    loss_impl: str = "production"
    # training.ema: {"enabled": true, "decay": 0.9999} — EMA parameter
    # shadow, checkpointed alongside params and evaluable via eval --ema
    use_ema: bool = False
    ema_decay: float = 0.9999
    # scan this many optimizer steps into one XLA program
    # (train.make_multi_step); 1 = classic per-step dispatch
    steps_per_call: int = 1
    # periodic in-training validation: every eval_interval optimizer steps,
    # run full inference+NMS+COCO-AP over the evaluation dataset (default:
    # the training dataset) and log val/mAP to TensorBoard + console.
    # Beyond-reference: the reference has only per-step benchmark telemetry
    # (benchmark.rs), never dataset mAP during training.
    eval_interval: int = 0          # 0 = disabled
    eval_limit: int = 0             # cap the number of evaluated records
    eval_conf_thresh: float = 0.005
    eval_batch_size: int = 0        # 0 = training batch size
    eval_dataset: Optional[DatasetConfig] = None
    # ZeRO-1: shard the optimizer state over the data axis
    # (reduce_scatter grads → per-shard update → all_gather params);
    # Adam state per chip drops from 2·P to 2·P/n. MultiDevice only.
    zero_optimizer: bool = False
    # split each (per-device) batch into this many sequential micro-batches
    # whose gradients are averaged before one optimizer update — darknet's
    # batch/subdivisions semantics ([net] subdivisions, which the reference
    # parses, darknet-config/src/net.rs, but never uses to bound memory).
    # Activation memory scales with batch/(devices*accumulation_steps).
    accumulation_steps: int = 1
    # Tensor (channel) parallelism degree: the device list is folded into a
    # (data = n_devices/tp, model = tp) mesh; conv kernels/optimizer state
    # are sharded on output channels via GSPMD (parallel/tp.py).  Weights +
    # Adam state per chip drop by tp for every divisible layer.
    tensor_parallel: int = 1
    # Pipeline (stage) parallelism degree: the graph is cut into this many
    # balanced contiguous stages, each stage's params + optimizer state on
    # its own device; microbatches (= accumulation_steps) stream through
    # GPipe-style (parallel/pipeline.py).  Uses the whole device list as
    # stages; exclusive with tensor_parallel/zero_optimizer/MultiProcess.
    pipeline_parallel: int = 1
    # training.remat: rematerialize block activations in the backward pass
    # (jax.checkpoint per ConvBn/CSP/SPP node) — trades ~1/3 extra forward
    # FLOPs for the dominant share of activation HBM; the lever for large
    # inputs/batches, composing with accumulation_steps (batch axis)
    remat: bool = False
    # frozen-layer fine-tuning (beyond-reference; the JSON5 face of
    # darknet's stopbackward, network.c:362).  ``freeze`` stop-gradients
    # the listed node paths; ``freeze_through`` freezes a node AND every
    # ancestor (the frozen-backbone idiom).  Frozen params get exactly-zero
    # gradients and XLA prunes their backward; note decoupled weight_decay
    # still applies to them (darknet-exact — frozen kernels keep decaying,
    # test_parity_train pins this).  Merges with cfg-level stopbackward.
    freeze: Tuple[str, ...] = ()
    freeze_through: str = ""
    # device_config {"type": "MultiProcess", ...}: n_devices is resolved at
    # runtime (jax.device_count() after joining the distributed runtime)
    multi_process: Optional[MultiProcessConfig] = None
    # training.precision: "float32" (default, reference semantics) or
    # "bfloat16" — run the forward/backward conv path in bf16 while
    # parameters/optimizer state/BN stats/loss math stay f32 (the loss
    # upcasts its inputs, loss/yolo_loss.py:141).  bf16 is the MXU's fast
    # path on TPU (bench.py and the real-TPU quality loops train this way:
    # flagship mAP@0.5 0.99 in bf16, BASELINE.md)
    precision: str = "float32"

    @staticmethod
    def load(path) -> "TrainAppConfig":
        path = pathlib.Path(path)
        with open(path, encoding="utf-8") as f:
            raw = json5_reader.load(f)
        _check_version(raw, path)

        model = _dict_section(raw, "model", path)
        kind_raw = model.get("kind", "NewslabV1")
        try:
            kind = {"newslabv1": "newslab_v1", "darknet": "darknet"}[
                str(kind_raw).lower()
            ]
        except KeyError:
            raise ValueError(
                f"{path}: model.kind must be NewslabV1 or Darknet, "
                f"got {kind_raw!r}") from None

        training = _dict_section(raw, "training", path)
        device_cfg = training.get("device_config", {"type": "SingleDevice"})
        if not isinstance(device_cfg, dict):
            raise ValueError(
                f"{path}: training.device_config must be an object")
        dtype = str(device_cfg.get("type", "SingleDevice")).lower()
        multi_process = None
        if dtype == "singledevice":
            n_devices = 1
        elif dtype == "multiprocess":
            n_devices = 0  # resolved at runtime after jax.distributed joins
            multi_process = MultiProcessConfig(
                coordinator=str(device_cfg.get("coordinator", "")),
                num_processes=int(device_cfg.get("num_processes", 0)),
            )
        elif dtype in ("multidevice", "nonuniformmultidevice"):
            devices = device_cfg.get("devices", []) or device_cfg.get("minibatch_sizes", [])
            n_devices = max(len(devices), 1)
            # NonUniformMultiDevice carries a per-device minibatch_size
            # (train/src/config.rs:263-271); SPMD shards the batch uniformly,
            # so non-uniform sizes are normalized — warn instead of silently
            # changing behavior (documented divergence, README)
            sizes = [
                int(d["minibatch_size"]) if isinstance(d, dict) else int(d)
                for d in devices
                if (isinstance(d, dict) and "minibatch_size" in d)
                or isinstance(d, (int, float))
            ]
            if sizes and len(set(sizes)) > 1:
                import sys

                print(
                    f"warning: {path}: NonUniformMultiDevice minibatch sizes "
                    f"{sizes} are normalized to a uniform split of "
                    f"training.batch_size over {n_devices} devices (SPMD "
                    f"shards the batch axis evenly)",
                    file=sys.stderr,
                )
        else:
            raise ValueError(f"unknown device_config type {dtype!r}")

        opt = _as_dict(training.get("optimizer"), "training.optimizer")
        benchmark = _as_dict(raw.get("benchmark"), "benchmark")
        evaluation = _as_dict(raw.get("evaluation"), "evaluation")
        ms = _as_dict(training.get("multi_scale"), "training.multi_scale")
        batch_size = int(training["batch_size"])
        accum = int(training.get("accumulation_steps", 1))
        if accum < 1:
            raise ValueError(
                f"{path}: training.accumulation_steps must be >= 1, got {accum}")
        tp = int(training.get("tensor_parallel", 1))
        if tp < 1:
            raise ValueError(
                f"{path}: training.tensor_parallel must be >= 1, got {tp}")
        if multi_process is not None:
            # multi-controller path is plain DP (+ accumulation) for now;
            # GSPMD TP / ZeRO sharding across processes is untested
            if tp > 1:
                raise ValueError(
                    f"{path}: tensor_parallel is single-controller only; "
                    "MultiProcess runs data-parallel")
            if training.get("zero_optimizer"):
                raise ValueError(
                    f"{path}: zero_optimizer is single-controller only; "
                    "MultiProcess runs data-parallel")
            # batch divisibility vs the (runtime) device count is checked
            # by the train CLI once the distributed runtime has joined
        if n_devices % tp:
            raise ValueError(
                f"{path}: training.tensor_parallel ({tp}) must divide the "
                f"device count ({n_devices})")
        pp = int(training.get("pipeline_parallel", 1))
        if pp < 1:
            raise ValueError(
                f"{path}: training.pipeline_parallel must be >= 1, got {pp}")
        if pp > 1:
            if tp > 1 or training.get("zero_optimizer"):
                raise ValueError(
                    f"{path}: pipeline_parallel is exclusive with "
                    "tensor_parallel/zero_optimizer")
            if multi_process is not None:
                raise ValueError(
                    f"{path}: pipeline_parallel is single-controller only")
            if n_devices % pp:
                raise ValueError(
                    f"{path}: pipeline_parallel ({pp}) must divide the "
                    f"device count ({n_devices}); devices fold into "
                    "(stages x per-stage data-parallel groups)")
            if _as_dict(training.get("ema"), "training.ema").get("enabled"):
                raise ValueError(
                    f"{path}: ema is not supported under pipeline_parallel")
            pp_dp = n_devices // pp
            if batch_size % (accum * pp_dp):
                raise ValueError(
                    f"{path}: training.batch_size ({batch_size}) must be "
                    f"divisible by accumulation_steps x per-stage "
                    f"data-parallel degree ({accum} x {pp_dp}) — microbatches "
                    "shard over each stage's device group")
        # with TP the batch is sharded over data = n_devices/tp replicas
        # only; under PP the batch is not sharded at all (it splits into
        # microbatches, checked above)
        n_data = n_devices // tp if pp == 1 else 0
        if n_data and batch_size % (n_data * accum):
            raise ValueError(
                f"{path}: training.batch_size ({batch_size}) must be divisible "
                f"by data-parallel replicas x accumulation_steps "
                f"({n_data} x {accum})")
        precision = parse_precision(
            training.get("precision", "float32"), str(path))
        return TrainAppConfig(
            model_kind=kind,
            model_file=model["cfg_file"],
            dataset=DatasetConfig.parse(raw["dataset"]),
            preprocessor=PreprocessorConfig.parse(raw.get("preprocessor", {})),
            logging=LoggingConfig.parse(raw.get("logging", {})),
            batch_size=batch_size,
            n_devices=n_devices,
            multi_process=multi_process,
            accumulation_steps=accum,
            lr=LrScheduleConfig.parse(opt.get("lr_schedule", opt.get("lr"))),
            optimizer=str(opt.get("type", "adam")).lower(),
            momentum=float(opt.get("momentum", 0.937)),
            weight_decay=float(opt.get("weight_decay", 0.0)),
            loss=parse_loss_config(_as_dict(training.get("loss"), "training.loss")),
            loss_impl=str(_as_dict(training.get("loss"), "training.loss")
                          .get("impl", "Production")).lower(),
            checkpoint=CheckpointPolicy.parse(
                training.get("load_checkpoint", {}),
                int(training.get("save_checkpoint_steps", 0)),
            ),
            override_initial_step=training.get("override_initial_step"),
            nms_iou_thresh=float(benchmark.get("nms_iou_thresh", 0.6)),
            nms_conf_thresh=float(benchmark.get("nms_conf_thresh", 0.1)),
            multi_scale_sizes=tuple(int(x) for x in ms.get("sizes", ())),
            steps_per_call=int(training.get("steps_per_call", 1)),
            eval_interval=int(evaluation.get("interval", 0)),
            eval_limit=int(evaluation.get("limit", 0)),
            eval_conf_thresh=float(evaluation.get("conf_thresh", 0.005)),
            eval_batch_size=int(evaluation.get("batch_size", 0)),
            eval_dataset=(DatasetConfig.parse(evaluation["dataset"])
                          if "dataset" in evaluation else None),
            zero_optimizer=bool(training.get("zero_optimizer", False)),
            tensor_parallel=tp,
            pipeline_parallel=pp,
            remat=bool(training.get("remat", False)),
            freeze=_parse_freeze(training.get("freeze", ())),
            freeze_through=str(training.get("freeze_through", "")),
            multi_scale_interval=int(ms.get("interval", 10)),
            use_ema=bool(_as_dict(training.get("ema"), "training.ema").get("enabled", False)),
            ema_decay=float(_as_dict(training.get("ema"), "training.ema").get("decay", 0.9999)),
            precision=precision,
        )


@dataclasses.dataclass(frozen=True)
class DetectAppConfig:
    model_file: str
    model_kind: str
    minibatch_size: int
    n_devices: int
    dataset: DatasetConfig
    output_dir: str
    nms_iou_thresh: float
    nms_conf_thresh: float
    weights_file: str = ""
    # detect preprocess block (detect/src/config.rs preprocess): GT
    # sanitize/scale knobs applied before drawing/evaluation
    bbox_scaling: float = 1.0
    out_of_bound_tolerance: float = 0.0
    min_bbox_size: float = 0.0

    @staticmethod
    def load(path) -> "DetectAppConfig":
        path = pathlib.Path(path)
        with open(path, encoding="utf-8") as f:
            raw = json5_reader.load(f)
        _check_version(raw, path)
        model = _dict_section(raw, "model", path)
        output = _as_dict(raw.get("output"), "output")
        pre = _as_dict(raw.get("preprocess"), "preprocess")
        pre_dev = str(pre.get("device", "cpu")).lower()
        if pre_dev not in ("cpu", ""):
            import sys

            print(f"warning: preprocess.device {pre_dev!r} is not "
                  "supported; host preprocessing runs on CPU",
                  file=sys.stderr)
        # preprocess.min_bbox_cropping_ratio is accepted but inert: it
        # gates affine-crop box survival and detect performs no cropping
        # (same in the reference's detect input stream)
        return DetectAppConfig(
            model_file=model["cfg_file"],
            model_kind={"newslabv1": "newslab_v1", "darknet": "darknet"}[
                str(model.get("kind", "NewslabV1")).lower()
            ],
            minibatch_size=int(model.get("minibatch_size", 1)),
            n_devices=max(len(model.get("devices", [0])), 1),
            dataset=DatasetConfig.parse(_dict_section(raw, "input", path)),
            output_dir=output.get("output_dir", "detect_output"),
            nms_iou_thresh=float(output.get("nms_iou_thresh", 0.6)),
            nms_conf_thresh=float(output.get("nms_conf_thresh", 0.1)),
            weights_file=model.get("weights_file", ""),
            bbox_scaling=float(pre.get("bbox_scaling", 1.0)),
            out_of_bound_tolerance=float(
                pre.get("out_of_bound_tolerance", 0.0)),
            min_bbox_size=float(pre.get("min_bbox_size", 0.0)),
        )
