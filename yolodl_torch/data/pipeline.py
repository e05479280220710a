"""Staged, threaded training data pipeline with device prefetch.

Equivalent capability to ``train/src/training_stream.rs`` (TrainingStream):
per-epoch independent shuffles ×4 (one per mosaic quadrant, :229-255),
stages load → color jitter → random affine → mosaic mix → batch
(:266-647), weighted mix-kind choice with non-mosaic kinds degrading to
"use first record" (the reference warns MixUp/CutMix unimplemented and does
the same, :548-555).

A thread pool feeds a bounded queue (backpressure like the reference's
worker_buf_size), and finished batches are copied to the device ahead of
use (:func:`device_prefetch`).  Targets are padded to ``max_gt`` with a
mask — the fixed-shape contract of the on-device matcher.

Counterpart of ``yolodl_tpu/data/pipeline.py``, with the same slot RNG keys
``(seed, epoch, slot)`` and the same draws, so ``ordered=True`` batches are
bit-identical to the reference's and a ``start_records`` resume replays its
order.  With ``defer_images`` (``preprocessor.pipeline.device`` "cuda") a
slot draws the same parameters, computes the labels here and leaves the
pixels to ``data/device_augment.py``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.timing import Timing
from .affine import RandomAffine
from .color import ColorJitter
from .mosaic import MosaicMixer
from .records import DataRecord, FileRecord


@dataclasses.dataclass
class TrainingStreamConfig:
    batch_size: int = 8
    max_gt: int = 64
    # mix-kind weights; the remainder is "none".  Unlike the reference,
    # mixup and cutmix are real implementations (mosaic.py), not warnings.
    mosaic_prob: float = 0.0
    mixup_prob: float = 0.0
    cutmix_prob: float = 0.0
    mosaic: MosaicMixer = dataclasses.field(default_factory=MosaicMixer)
    mixup: "MixUpMixer" = None  # type: ignore[assignment]
    cutmix: "CutMixMixer" = None  # type: ignore[assignment]
    color_jitter: Optional[ColorJitter] = None
    color_jitter_prob: float = 1.0  # P(apply jitter) per record
    random_affine: Optional[RandomAffine] = None
    affine_prob: float = 1.0  # P(apply the whole affine) per record
    bbox_scaling: float = 1.0  # cleanse.bbox_scaling (training_stream.rs:320-329)
    seed: int = 0
    workers: int = 2
    queue_depth: int = 4
    # ordered=True reassembles records in plan order (deterministic batches,
    # the reference's unordered_records=false); False yields as they finish
    ordered: bool = True
    # resume the data order mid-run: skip this many records before the
    # first yield.  Because every slot's augmentation RNG is keyed by
    # (seed, epoch, slot), the continuation is bitwise-identical to an
    # uninterrupted run — checkpoint resume replays the exact data order
    # it would have seen (the reference restarts its shuffles from
    # scratch on resume).  Set by the train CLI to step x batch_size.
    start_records: int = 0
    # optional per-stage debug hook: called as hook(stage_name, DataRecord)
    # after each augmentation stage (the reference broadcasts per-stage debug
    # images to its logger, training_stream.rs:340-577)
    debug_hook: Optional[object] = None
    # defer_images: ship the pack's image slots as u8 (a quarter of the
    # host-to-device bytes; exact for decoded u8/255 sources, 1/255-rounded
    # for synthetic floats).  False keeps f32 for bitwise host-parity tests.
    pack_uint8: bool = True
    # defer_images=True: sample every augmentation parameter from the SAME
    # per-slot RNG stream but leave the pixel work (jitter/warp/mix) to the
    # device augment program (preprocessor.pipeline.device "cuda"; see
    # data/device_augment.py).  Label geometry is still computed here on the
    # host, so boxes/classes/mask are identical to the CPU path.
    defer_images: bool = False

    def __post_init__(self):
        from .mosaic import CutMixMixer, MixUpMixer

        if self.mosaic_prob + self.mixup_prob + self.cutmix_prob > 1.0 + 1e-9:
            raise ValueError("mix-kind probabilities must sum to <= 1")
        if self.mixup is None:
            self.mixup = MixUpMixer()
        if self.cutmix is None:
            self.cutmix = CutMixMixer()


@dataclasses.dataclass
class TrainingRecord:
    epoch: int
    step: int
    images: np.ndarray   # [B, 3, H, W] float32 (None while deferred)
    boxes: np.ndarray    # [B, M, 4] float32 ratio cycxhw
    classes: np.ndarray  # [B, M] int32
    mask: np.ndarray     # [B, M] bool
    timing: Timing
    # device_prefetch / apply_device_augmentation on a card: CUDA events
    # recorded before and after the batch's copies on the upload stream (its
    # device time of the H2D copy)
    upload_events: Optional[Tuple] = None
    # defer_images: the packed augmentation inputs and parameters of the
    # device program (device_augment.pack_deferred_batch); images is None
    # until apply_device_augmentation fills it with the augmented batch
    deferred: Optional[dict] = None


def pad_targets(
    records: Sequence[DataRecord], max_gt: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    b = len(records)
    boxes = np.zeros((b, max_gt, 4), np.float32)
    classes = np.zeros((b, max_gt), np.int32)
    mask = np.zeros((b, max_gt), bool)
    for i, rec in enumerate(records):
        n = min(len(rec.boxes), max_gt)
        boxes[i, :n] = rec.boxes[:n]
        classes[i, :n] = rec.classes[:n]
        mask[i, :n] = True
    return boxes, classes, mask


class TrainingStream:
    """Iterable over TrainingRecords; ``loader`` maps FileRecord→DataRecord
    (OnDemandLoader / FileCache / MemoryCache)."""

    def __init__(
        self,
        records: Sequence[FileRecord],
        loader,
        config: TrainingStreamConfig,
    ):
        if len(records) == 0:
            raise ValueError("empty dataset")
        self.records = list(records)
        self.loader = loader
        self.config = config

    @property
    def k_max(self) -> int:
        """Static image-slot count a deferred batch ships per record (the
        most any enabled mix kind needs; unused slots stay zero)."""
        if self.config.mosaic_prob > 0:
            return 4
        if self.config.mixup_prob > 0 or self.config.cutmix_prob > 0:
            return 2
        return 1

    # -- single-record processing (one pipeline slot) --------------------

    def _make_record(self, indices: Tuple[int, ...], rng: np.random.Generator,
                     timing: Timing) -> DataRecord:
        cfg = self.config
        # weighted mix-kind choice (training_stream.rs:299-307)
        draw = rng.random()
        if draw < cfg.mosaic_prob:
            mix_kind = "mosaic"
        elif draw < cfg.mosaic_prob + cfg.mixup_prob:
            mix_kind = "mixup"
        elif draw < cfg.mosaic_prob + cfg.mixup_prob + cfg.cutmix_prob:
            mix_kind = "cutmix"
        else:
            mix_kind = "none"
        use_mosaic = mix_kind == "mosaic"
        need = {"mosaic": 4, "mixup": 2, "cutmix": 2, "none": 1}[mix_kind]

        loaded: List[DataRecord] = []
        with timing.timed("load"):
            for idx in indices[:need]:
                rec = self.loader.load(self.records[idx])
                if cfg.bbox_scaling != 1.0 and len(rec.boxes):
                    rec.boxes[:, 2:] *= cfg.bbox_scaling
                loaded.append(rec)

        if cfg.debug_hook is not None:
            cfg.debug_hook("load", loaded[0])

        if cfg.defer_images:
            return self._make_deferred(mix_kind, loaded, rng, timing)

        # probability gates draw from rng only when < 1 so fully-on configs
        # keep their exact augmentation streams (determinism tests)
        if cfg.color_jitter is not None and (
                cfg.color_jitter_prob >= 1.0
                or rng.random() < cfg.color_jitter_prob):
            with timing.timed("color_jitter"):
                for rec in loaded:
                    rec.image = cfg.color_jitter(rec.image, rng)
            if cfg.debug_hook is not None:
                cfg.debug_hook("color_jitter", loaded[0])

        if cfg.random_affine is not None and (
                cfg.affine_prob >= 1.0 or rng.random() < cfg.affine_prob):
            with timing.timed("random_affine"):
                for i, rec in enumerate(loaded):
                    img, boxes, classes = cfg.random_affine(
                        rec.image, rec.boxes, rec.classes, rng
                    )
                    loaded[i] = DataRecord(img, boxes, classes)
            if cfg.debug_hook is not None:
                cfg.debug_hook("random_affine", loaded[0])

        result = None
        if mix_kind == "mosaic":
            with timing.timed("mosaic"):
                result = cfg.mosaic(loaded, rng)
        elif mix_kind == "mixup":
            with timing.timed("mixup"):
                result = cfg.mixup(loaded[0], loaded[1], rng)
        elif mix_kind == "cutmix":
            with timing.timed("cutmix"):
                result = cfg.cutmix(loaded[0], loaded[1], rng)
        else:
            result = loaded[0]
        if cfg.debug_hook is not None and mix_kind != "none":
            cfg.debug_hook(mix_kind, result)
        return result

    def _make_deferred(self, mix_kind: str, loaded: List[DataRecord],
                       rng: np.random.Generator, timing: Timing):
        """defer_images mode: draw the EXACT RNG stream the host path draws
        (applying a sampled augmentation consumes no randomness, so
        sampling-then-deferring keeps every later draw aligned), compute the
        label geometry here, and leave the pixel work to the device program."""
        from .device_augment import (
            MIX_CUTMIX, MIX_MIXUP, MIX_MOSAIC, MIX_NONE, DeferredRecord,
        )

        cfg = self.config
        jit_params = None
        if cfg.color_jitter is not None and (
                cfg.color_jitter_prob >= 1.0
                or rng.random() < cfg.color_jitter_prob):
            jit_params = [cfg.color_jitter.sample(rng) for _ in loaded]

        transforms: List[Optional[np.ndarray]] = [None] * len(loaded)
        if cfg.random_affine is not None and (
                cfg.affine_prob >= 1.0 or rng.random() < cfg.affine_prob):
            with timing.timed("affine_boxes"):
                eye = np.eye(3)
                for i, rec in enumerate(loaded):
                    t = cfg.random_affine.sample_transform(rng)
                    if np.allclose(t, eye):
                        continue  # the host path skips identity outright
                    transforms[i] = t
                    boxes, classes = cfg.random_affine.transform_boxes(
                        t, rec.boxes, rec.classes)
                    loaded[i] = DataRecord(rec.image, boxes, classes)

        with timing.timed("mix_boxes"):
            if mix_kind == "mosaic":
                pivot = cfg.mosaic.sample(rng)
                boxes, classes = cfg.mosaic.mix_boxes(loaded, *pivot)
                kind, params = MIX_MOSAIC, pivot
            elif mix_kind == "mixup":
                lam = cfg.mixup.sample(rng)
                boxes = np.concatenate([loaded[0].boxes, loaded[1].boxes], axis=0)
                classes = np.concatenate(
                    [loaded[0].classes, loaded[1].classes], axis=0)
                kind, params = MIX_MIXUP, (lam,)
            elif mix_kind == "cutmix":
                bnd = cfg.cutmix.sample(rng)
                boxes, classes = cfg.cutmix.mix_boxes(loaded[0], loaded[1], bnd)
                kind, params = MIX_CUTMIX, bnd
            else:
                boxes, classes = loaded[0].boxes, loaded[0].classes
                kind, params = MIX_NONE, ()
        return DeferredRecord(
            images=[rec.image for rec in loaded],
            jit_params=jit_params,
            transforms=transforms,
            mix_kind=kind,
            mix_params=params,
            boxes=boxes,
            classes=classes,
        )

    # -- epoch/step index plan -------------------------------------------

    def _epoch_plan(self, epoch: int) -> List[Tuple[int, ...]]:
        """4 independent shuffles per epoch; record i of the epoch uses the
        i-th entry from each shuffle (training_stream.rs:229-255)."""
        rng = np.random.default_rng((self.config.seed, epoch))
        shuffles = [rng.permutation(len(self.records)) for _ in range(4)]
        return [tuple(int(s[i]) for s in shuffles) for i in range(len(self.records))]

    # -- iteration --------------------------------------------------------

    def __iter__(self) -> Iterator[TrainingRecord]:
        cfg = self.config
        out_q: "queue.Queue" = queue.Queue(maxsize=cfg.queue_depth * cfg.batch_size)
        stop = threading.Event()
        workers = max(1, cfg.workers)
        # bound total in-flight records (loaded but not yet consumed): in
        # ordered mode the reorder buffer drains out_q, so without a cap a
        # single slow slot would let the other workers run arbitrarily far
        # ahead and grow `pending` without bound (~4.4 MB per record).
        # The cap is a serial-ordered WINDOW, not a semaphore: a producer
        # may start serial s only once s < consumed + cap, so the producer
        # of the oldest outstanding serial can never be blocked (a plain
        # ticket pool deadlocks when the reorder buffer absorbs every
        # ticket while the needed serial is still unproduced).
        window_cap = out_q.maxsize + 2 * workers
        window = threading.Condition()
        start = max(0, int(cfg.start_records))
        consumed = [start]
        n_slots_total = len(self.records)

        def put_or_stop(item) -> bool:
            """Bounded put that re-checks ``stop``: a producer must never
            block forever on a full queue after the consumer has gone away
            (that would pin a full queue of decoded images for the rest of
            the process)."""
            while True:
                try:
                    out_q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    if stop.is_set():
                        return False

        def producer(worker_id: int):
            """Each worker handles epoch slots ≡ worker_id (mod workers) —
            the unordered parallel-stage model of the reference's
            try_par_then_unordered (training_stream.rs:208-223); per-slot
            RNG keys keep augmentation deterministic regardless of
            interleaving."""
            if worker_id >= n_slots_total:
                return  # its strided slot range is empty in every epoch
            epoch = start // n_slots_total  # resume: skip whole epochs
            try:
                while not stop.is_set():
                    plan = self._epoch_plan(epoch)
                    for slot in range(worker_id, len(plan), workers):
                        serial = epoch * n_slots_total + slot
                        if serial < start:
                            continue  # resume: partial first epoch
                        with window:
                            while (serial >= consumed[0] + window_cap
                                   and not stop.is_set()):
                                window.wait(0.5)
                        if stop.is_set():
                            return
                        rng = np.random.default_rng((cfg.seed, epoch, slot))
                        timing = Timing("pipeline")
                        rec = self._make_record(plan[slot], rng, timing)
                        if not put_or_stop((epoch, slot, rec, timing)):
                            return
                    epoch += 1
            except Exception as e:  # surface worker errors to the consumer
                put_or_stop(e)

        threads = [
            threading.Thread(target=producer, args=(i,), daemon=True)
            for i in range(workers)
        ]
        for t in threads:
            t.start()

        n_slots = len(self.records)
        pending = {}
        next_serial = start

        def advance_window():
            with window:
                consumed[0] += 1
                window.notify_all()

        def get_next():
            """Next record, in plan order when cfg.ordered.  Every consumed
            record advances the producers' in-flight window."""
            nonlocal next_serial
            if not cfg.ordered:
                item = out_q.get()
                if isinstance(item, Exception):
                    raise item
                advance_window()
                return item
            while next_serial not in pending:
                item = out_q.get()
                if isinstance(item, Exception):
                    raise item
                epoch_i, slot_i, rec_i, timing_i = item
                pending[epoch_i * n_slots + slot_i] = item
            item = pending.pop(next_serial)
            next_serial += 1
            advance_window()
            return item

        step = 0
        try:
            while True:
                batch: List[DataRecord] = []
                epoch = 0
                timing = Timing("batch")
                with timing.timed("collect"):
                    while len(batch) < cfg.batch_size:
                        item = get_next()
                        epoch, _serial, rec, rec_timing = item
                        timing.merge(rec_timing)
                        batch.append(rec)
                with timing.timed("batchify"):
                    deferred = None
                    if cfg.defer_images:
                        from .device_augment import pack_deferred_batch

                        images = None
                        deferred = pack_deferred_batch(
                            batch, self.k_max, uint8=cfg.pack_uint8)
                    else:
                        images = np.stack([r.image for r in batch]).astype(np.float32)
                    boxes, classes, mask = pad_targets(batch, cfg.max_gt)
                yield TrainingRecord(
                    epoch=epoch, step=step, images=images, boxes=boxes,
                    classes=classes, mask=mask, timing=timing,
                    deferred=deferred,
                )
                step += 1
        finally:
            stop.set()


def lookahead_map(iterator, transform, depth: int = 2):
    """Run ``transform(item)`` on a worker thread ``depth`` items ahead of
    consumption — the generic double-buffer behind device_prefetch and the
    device augmentation, replacing the reference's flume channel +
    spawn_blocking to_device at multi_gpu.rs:139-153."""
    buf: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put_or_stop(item) -> bool:
        # never block forever on a consumer that stopped: a wedged put
        # would pin depth+1 device-resident batches in device memory for
        # the rest of the process (e.g. during the final eval after training)
        while True:
            try:
                buf.put(item, timeout=0.5)
                return True
            except queue.Full:
                if stop.is_set():
                    return False

    def worker():
        try:
            for record in iterator:
                if stop.is_set():
                    return
                if not put_or_stop(transform(record)):
                    return
            put_or_stop(None)
        except Exception as e:
            put_or_stop(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = buf.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()


def device_prefetch(iterator, device="cuda", depth: int = 2):
    """Move TrainingRecord arrays to ``device`` ahead of consumption →
    (record, (images, boxes, classes, mask)) tensors.

    On a card each batch is copied into pinned host memory of its own
    (``pin_memory()``) and uploaded with ``non_blocking=True`` on a side
    stream of the worker thread, so the upload of the next batch overlaps
    the current step.  An event recorded behind each batch's copies is
    waited for by the consumer's stream before the batch is handed out, and
    every tensor is marked as used on that stream (``record_stream``), so
    its device memory is not reused while a step still reads it.  A pinned
    buffer is never refilled while its copy is in flight: each batch has its
    own, and PyTorch's pinned-memory cache hands a freed block out again
    only once the copy's event has completed.  On the CPU the arrays become
    tensors as they are."""
    device = torch.device(device)
    if device.type != "cuda":
        def to_tensors(record: TrainingRecord):
            return record, tuple(torch.from_numpy(a) for a in (
                record.images, record.boxes, record.classes, record.mask))

        yield from lookahead_map(iterator, to_tensors, depth)
        return

    copy_stream = torch.cuda.Stream(device)

    def upload(record: TrainingRecord):
        pinned = tuple(torch.from_numpy(a).pin_memory() for a in (
            record.images, record.boxes, record.classes, record.mask))
        with torch.cuda.stream(copy_stream):
            start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(copy_stream)
            arrays = tuple(t.to(device, non_blocking=True) for t in pinned)
            done.record(copy_stream)
        record.upload_events = (start, done)
        return record, arrays, done

    for record, arrays, done in lookahead_map(iterator, upload, depth):
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in arrays:
            t.record_stream(consumer)
        yield record, arrays
