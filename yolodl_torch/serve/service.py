"""Micro-batching detection service.

Counterpart of ``yolodl_tpu/serve/service.py``, with the same public API,
threads, stats, shutdown and error semantics.  A single dispatcher thread
drains a request queue, packs up to B requests arriving within
``window_ms`` into one device batch of fixed shape ``[B, S, S, 3]`` uint8
(padding the tail by repeating the last image), runs forward → NMS →
class selection, and hands the result to a completer thread that unpacks it
on the host and wakes the callers.  Decode and letterbox run in the
caller's thread.

The device program: the u8 NHWC batch is copied into a pinned host buffer
and uploaded with ``non_blocking``, converted to bf16 and divided by 255
on the device, then ``model(x,
data_format="NHWC")``, ``non_max_suppression(class_mode="argmax")`` and
``yolo_inference``.  On a CUDA device the NMS runs on B1's two hand-written
kernels (``kernels/iou.py``).  :meth:`DetectionService.from_artifact`
serves an exported serving artifact (``models/export.py``) in place of the
model: its program holds the same ingest, and the NMS stays live.

``devices=N`` serves data-parallel in this one process, as the reference's
``devices`` (service.py:134-146) does over a mesh: one model replica per
device (``parallel/mesh.py`` ``ModelReplicas``), the batch split into N
equal parts, each replica's upload, forward and NMS issued in order from
the dispatcher thread so that the devices overlap, and the parts' outputs
joined in order on the host.  So B1's kernels launch once per replica per
batch.  A list of devices names each replica's device (two may share a
card).

Coordinates are mapped back to original-image pixels with the inverse
letterbox transform (detect/src/main.rs:169 Transform::from_sizes_letterbox).
"""

from __future__ import annotations

import dataclasses
import io
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import ModelReplicas, device_guard, join_outputs, replica_devices
from ..data.letterbox import (letterbox_geometry, letterbox_u8, letterbox_u8_pil,
                              letterbox_unit_transform)
from ..loss import non_max_suppression, to_host_detections, yolo_inference

COMPUTE_DTYPE = torch.bfloat16  # activations on the device, as the reference


class ServiceOverloadedError(RuntimeError):
    """Raised when the request queue is full — a retryable client-side
    condition, distinct from internal device/runtime failures."""


class ServiceShutdownError(RuntimeError):
    """Raised on requests caught by (or arriving after) shutdown()."""


@dataclass
class ServiceStats:
    """Monotonic counters + latency quantiles (thread-safe via the lock)."""

    requests: int = 0
    images_done: int = 0
    batches: int = 0
    batch_fill_sum: int = 0  # Σ real images per batch, for mean fill ratio
    errors: int = 0
    _lat_ms: List[float] = field(default_factory=list)  # ring buffer
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _RING = 2048

    def record(self, latency_ms: float) -> None:
        with self._lock:
            self.images_done += 1
            self._lat_ms.append(latency_ms)
            if len(self._lat_ms) > self._RING:
                del self._lat_ms[: -self._RING]

    def snapshot(self, batch_size: int) -> Dict:
        with self._lock:  # one lock scope: no torn counter pairs
            lat = np.asarray(self._lat_ms, np.float64)
            out = {
                "requests": self.requests,
                "images_done": self.images_done,
                "batches": self.batches,
                "errors": self.errors,
                "mean_batch_fill": (
                    round(self.batch_fill_sum / (self.batches * batch_size), 3)
                    if self.batches else 0.0
                ),
            }
        if len(lat):
            out["latency_ms"] = {
                "p50": round(float(np.percentile(lat, 50)), 2),
                "p95": round(float(np.percentile(lat, 95)), 2),
                "p99": round(float(np.percentile(lat, 99)), 2),
                "max": round(float(lat.max()), 2),
            }
        return out


class _Pending:
    __slots__ = ("image", "src_hw", "event", "result", "error", "t_submit",
                 "err_counted")

    def __init__(self, image: np.ndarray, src_hw: Tuple[int, int]):
        self.image = image
        self.src_hw = src_hw
        self.event = threading.Event()
        self.result: Optional[List[dict]] = None
        self.error: Optional[Exception] = None
        self.t_submit = time.perf_counter()
        # an errored request counts ONCE even when two paths see it (a
        # client timeout followed by the batch failing on-device)
        self.err_counted = False


class DetectionService:
    """Keeps a detector warm and serves micro-batched requests.

    ``model`` is a :class:`yolodl_torch.models.YoloModel` on ``device``, or
    None when ``forward_fn`` (u8 NHWC device batch → MergedDetection, e.g. a
    loaded serving artifact) takes its place, as the reference's
    ``forward_fn`` does; ``window_ms`` bounds how long the dispatcher waits
    to fill a batch.  ``device`` defaults to ``"cuda"`` and raises without a
    card.  ``devices`` is the number of replicas (on ``device``: n CPU
    replicas, or the cards from ``cuda:0``) or a list of their devices;
    ``batch_size`` must divide evenly over them, and an artifact
    (``forward_fn``) serves on one.
    """

    def __init__(
        self,
        model,
        *,
        image_size: int,
        batch_size: int = 8,
        window_ms: float = 5.0,
        nms_iou_thresh: float = 0.45,
        nms_conf_thresh: float = 0.25,
        nms_kind: str = "greedy",
        nms_beta: float = 0.6,
        class_names: Optional[List[str]] = None,
        max_queue: int = 256,
        devices: int = 1,
        device="cuda",
        forward_fn=None,
    ):
        n_devices = len(devices) if isinstance(devices, (list, tuple)) else int(devices)
        if n_devices > 1:
            if forward_fn is not None:
                raise ValueError(
                    "artifact serving is single-device (the exported program "
                    "is one device's); use live-model serving for devices > 1")
            if batch_size % n_devices:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by devices {n_devices}")
        if (model is None) == (forward_fn is None):
            raise ValueError("give DetectionService a model or a forward_fn, not both")
        if isinstance(devices, (list, tuple)):
            self.devices = replica_devices(list(devices))
        else:
            self.devices = replica_devices(device, n_devices)
        self.device = self.devices[0]
        params = list(model.parameters()) if model is not None else []
        if params and params[0].device.type != self.device.type:
            raise ValueError(
                f"model lives on {params[0].device}, service on {self.device}")
        self.model = model
        self._forward_fn = forward_fn
        self._replicas = ModelReplicas(model, self.devices) if model is not None else None
        self.image_size = int(image_size)
        self.batch_size = int(batch_size)
        self.window_s = window_ms / 1e3
        self.class_names = class_names
        self.nms_iou_thresh = nms_iou_thresh
        self.nms_conf_thresh = nms_conf_thresh
        self.nms_kind = nms_kind
        self.nms_beta = nms_beta
        self.stats = ServiceStats()
        self._queue: "queue.Queue[_Pending]" = queue.Queue(maxsize=max_queue)
        self._inflight: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()

        # on a card: two pinned upload buffers a replica, alternated; each is
        # refilled only after the upload that last read it has finished
        n = len(self.devices) if self._replicas is not None else 1
        self._host_bufs = [[] for _ in range(n)]
        if self.device.type == "cuda":
            shape = (self.batch_size // n, self.image_size, self.image_size, 3)
            self._host_bufs = [[torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                                for _ in range(2)] for _ in range(n)]
        self._upload_done = [[None, None] for _ in range(n)]
        self._next_buf = [0] * n

        self._thread = threading.Thread(
            target=self._dispatch_loop, name="detection-dispatcher", daemon=True)
        self._completer = threading.Thread(
            target=self._complete_loop, name="detection-completer", daemon=True)

    @classmethod
    def from_artifact(
        cls,
        path: str,
        *,
        window_ms: float = 5.0,
        nms_iou_thresh: float = 0.45,
        nms_conf_thresh: float = 0.25,
        nms_kind: str = "greedy",
        nms_beta: float = 0.6,
        class_names: Optional[List[str]] = None,
        max_queue: int = 256,
        device="cuda",
    ) -> "DetectionService":
        """Serve an exported *serving* artifact (``tool_main export
        --serving``): no model-building code on the inference path; image
        size and batch come from the artifact's fixed input shape.  The
        artifact must have been exported on ``device``'s type."""
        from ..models.export import load_exported

        infer, meta = load_exported(path, device=device)
        if not meta.get("serving"):
            raise ValueError(
                f"{path} is a plain inference artifact; serving needs the "
                "uint8 NHWC ingest baked in — re-export with --serving")
        batch, size = meta["input_shape"][0], meta["input_shape"][1]
        return cls(
            None, image_size=size, batch_size=batch, window_ms=window_ms,
            nms_iou_thresh=nms_iou_thresh, nms_conf_thresh=nms_conf_thresh,
            nms_kind=nms_kind, nms_beta=nms_beta, class_names=class_names,
            max_queue=max_queue, device=device, forward_fn=infer)

    # -- device program ----------------------------------------------------

    def _upload(self, stacked: np.ndarray, replica: int = 0) -> torch.Tensor:
        """u8 NHWC host rows → the replica's device (pinned, non_blocking)."""
        device = self.devices[replica]
        if device.type == "cpu":
            return torch.from_numpy(stacked)
        i = self._next_buf[replica]
        self._next_buf[replica] = 1 - i
        done = self._upload_done[replica]
        if done[i] is not None:
            done[i].synchronize()
        buf = self._host_bufs[replica][i]
        buf.numpy()[...] = stacked
        dev = buf.to(device, non_blocking=True)
        done[i] = torch.cuda.Event()
        done[i].record()
        return dev

    def forward(self, images_u8: torch.Tensor, replica: int = 0):
        """u8 NHWC device batch → MergedDetection (on ``replica``'s model)."""
        if self._forward_fn is not None:
            return self._forward_fn(images_u8)
        x = images_u8.to(COMPUTE_DTYPE) / 255.0
        return self._replicas.models[replica](x, data_format="NHWC")

    def postprocess(self, pred):
        nms = non_max_suppression(
            pred,
            iou_threshold=self.nms_iou_thresh,
            confidence_threshold=self.nms_conf_thresh,
            suppress_by_class=False,
            class_mode="argmax",
            kind=self.nms_kind,
            beta=self.nms_beta,
        )
        return yolo_inference(nms, pred.num_flats)

    def _run(self, stacked: np.ndarray) -> list:
        """[B, S, S, 3] u8 host batch → the outputs of each replica's rows,
        in order, each still on its device."""
        with torch.inference_mode():
            if self._replicas is None or len(self._replicas) == 1:
                return [self.postprocess(self.forward(self._upload(stacked)))]
            return self._replicas.map(
                lambda i, part: self.postprocess(
                    self.forward(self._upload(part, i), replica=i)),
                stacked)

    def _download(self, outs: list):
        """(host copies of the replicas' ``outs``, events after the copies;
        None on the CPU).

        The copies to pinned host memory are queued right behind each
        replica's own device work.  A blocking copy made later by the
        completer would wait on the stream for every kernel the dispatcher
        has queued since, the next batch's forward included."""
        hosts, events = [], []
        with torch.inference_mode():
            for out in outs:
                if out.valid.device.type != "cuda":
                    hosts.append(out)
                    continue
                with device_guard(out.valid.device):
                    hosts.append(dataclasses.replace(out, **{
                        f.name: getattr(out, f.name).to("cpu", non_blocking=True)
                        for f in dataclasses.fields(out)}))
                    done = torch.cuda.Event()
                    done.record()
                    events.append(done)
        return hosts, events or None

    # -- lifecycle ---------------------------------------------------------

    def warmup(self) -> float:
        """Run one dummy batch to completion; returns seconds spent."""
        t0 = time.perf_counter()
        dummy = np.zeros(
            (self.batch_size, self.image_size, self.image_size, 3), np.uint8)
        for out in self._run(dummy):
            out.valid.cpu()  # value readout = completion fence
        return time.perf_counter() - t0

    def start(self) -> None:
        self._thread.start()
        self._completer.start()

    def shutdown(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)
        if self._completer.is_alive():
            self._completer.join(timeout=timeout)
        # fail requests still sitting in the queue so their callers wake
        # immediately instead of blocking out their full client timeout
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            self._fail_batch([p], ServiceShutdownError("service shut down"))

    # -- request path ------------------------------------------------------

    def submit_bytes(self, data: bytes, timeout: float = 30.0) -> List[dict]:
        """Decode an encoded image (JPEG/PNG/...), run detection, return
        per-detection dicts with original-pixel COCO-style boxes."""
        from PIL import Image

        with Image.open(io.BytesIO(data)) as im:
            w, h = im.size
            # JPEG DCT-scaled decode; geometry stays keyed to the ORIGINAL
            # size via src_hw so box mapping is unchanged
            new_h, new_w, _, _ = letterbox_geometry(
                (h, w), (self.image_size, self.image_size))
            im.draft("RGB", (new_w, new_h))
            rgb = im.convert("RGB")
            boxed = letterbox_u8_pil(
                rgb, (self.image_size, self.image_size), src_hw=(h, w))
        return self._submit_boxed(boxed, (h, w), timeout)

    def submit_u8(self, image_hwc: np.ndarray, timeout: float = 30.0) -> List[dict]:
        """Submit a decoded [H,W,3] uint8 image (the fast path: pixels stay
        uint8 through letterbox and upload; a frame of the model's size
        needs no PIL)."""
        if image_hwc.ndim != 3 or image_hwc.shape[2] != 3 \
                or image_hwc.dtype != np.uint8:
            raise ValueError(
                f"expected [H,W,3] uint8 image, got "
                f"{image_hwc.shape} {image_hwc.dtype}")
        boxed = letterbox_u8(image_hwc, (self.image_size, self.image_size))
        return self._submit_boxed(boxed, image_hwc.shape[:2], timeout)

    def submit_array(self, image_chw: np.ndarray, timeout: float = 30.0) -> List[dict]:
        """Submit a [3,H,W] float32 image in [0,1]; blocks for the result."""
        if image_chw.ndim != 3 or image_chw.shape[0] != 3:
            raise ValueError(f"expected [3,H,W] image, got {image_chw.shape}")
        u8 = np.rint(
            np.clip(np.transpose(image_chw, (1, 2, 0)), 0, 1) * 255
        ).astype(np.uint8)
        return self.submit_u8(u8, timeout=timeout)

    def _count_error(self, pending: "_Pending") -> None:
        with self.stats._lock:
            if not pending.err_counted:
                pending.err_counted = True
                self.stats.errors += 1

    def _submit_boxed(self, boxed: np.ndarray, src_hw, timeout: float) -> List[dict]:
        if self._stop.is_set():
            raise ServiceShutdownError("service shut down")
        pending = _Pending(boxed, src_hw)
        with self.stats._lock:
            self.stats.requests += 1
        deadline = time.perf_counter() + timeout  # one budget for put+wait
        try:
            self._queue.put(pending, timeout=timeout)
        except queue.Full:
            self._count_error(pending)
            raise ServiceOverloadedError(
                "service overloaded: request queue full")
        if self._stop.is_set() and not pending.event.is_set():
            # shutdown raced the enqueue: its one-shot queue drain may have
            # already passed this entry, and no dispatcher will — fail
            # deterministically instead of blocking out the client timeout
            pending.error = pending.error or ServiceShutdownError(
                "service shut down")
            pending.event.set()
        if not pending.event.wait(max(0.0, deadline - time.perf_counter())):
            self._count_error(pending)
            raise TimeoutError("detection timed out")
        if pending.error is not None:
            self._count_error(pending)
            raise pending.error
        self.stats.record((time.perf_counter() - pending.t_submit) * 1e3)
        return pending.result

    # -- dispatcher --------------------------------------------------------

    def _collect_batch(self) -> List[_Pending]:
        """Block for the first request, then fill up to batch_size within
        the window."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.window_s
        while len(batch) < self.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _dispatch_loop(self) -> None:
        """Stage 1: pack batches and issue device work.  Results go through
        a depth-2 in-flight queue to the completer thread, so the device
        computes batch N+1 while batch N's outputs go to the host."""
        while not self._stop.is_set():
            batch = self._collect_batch()
            if not batch:
                continue
            try:
                images = [p.image for p in batch]
                while len(images) < self.batch_size:  # fixed-shape pad
                    images.append(images[-1])
                out = self._run(np.stack(images))
                if not self._put_inflight((batch, *self._download(out))):
                    self._fail_batch(
                        batch, ServiceShutdownError("service shut down"))
            except Exception as e:  # deliver the failure, don't kill the loop
                self._fail_batch(batch, e)
        self._put_inflight(None)  # unblock the completer

    def _put_inflight(self, item) -> bool:
        """Bounded put that keeps observing _stop: a wedged completer must
        not be able to hang shutdown() behind a full in-flight queue."""
        while True:
            try:
                self._inflight.put(item, timeout=0.2)
                return True
            except queue.Full:
                if self._stop.is_set():
                    return False

    def _complete_loop(self) -> None:
        """Stage 2: host-side unpack + coordinate mapping + fan-out."""
        while True:
            try:
                item = self._inflight.get(timeout=0.2)
            except queue.Empty:
                # normal exit is the dispatcher's None sentinel; this guards
                # the case where the dispatcher died without delivering it
                if self._stop.is_set() and not self._thread.is_alive():
                    return
                continue
            if item is None:
                return
            batch, outs, done = item
            try:
                for event in done or ():
                    event.synchronize()
                dets = to_host_detections(join_outputs(outs))
                with self.stats._lock:
                    self.stats.batches += 1
                    self.stats.batch_fill_sum += len(batch)
                for i, p in enumerate(batch):
                    p.result = self._to_original_pixels(dets[i], p.src_hw)
                    p.event.set()
            except Exception as e:
                self._fail_batch(batch, e)

    def _fail_batch(self, batch: List[_Pending], e: Exception) -> None:
        with self.stats._lock:
            for p in batch:
                if not p.err_counted:
                    p.err_counted = True
                    self.stats.errors += 1
        for p in batch:
            p.error = e
            p.event.set()

    def _to_original_pixels(self, dets: List[dict], src_hw) -> List[dict]:
        src_h, src_w = src_hw
        inv = letterbox_unit_transform(
            (src_h, src_w), (self.image_size, self.image_size)).inverse()
        out = []
        for det in dets:
            t, l, b, r = det["tlbr"]
            (ot, ol), (ob, orr) = inv.apply_points(np.asarray([[t, l], [b, r]]))
            # clip to the image (decoded boxes can overhang)
            x0 = min(max(float(ol * src_w), 0.0), src_w)
            y0 = min(max(float(ot * src_h), 0.0), src_h)
            x1 = min(max(float(orr * src_w), 0.0), src_w)
            y1 = min(max(float(ob * src_h), 0.0), src_h)
            entry = {
                "class": det["class"],
                "score": round(det["confidence"], 5),
                # COCO-style [x, y, w, h] in original-image pixels
                "bbox": [round(x0, 2), round(y0, 2),
                         round(x1 - x0, 2), round(y1 - y0, 2)],
            }
            if self.class_names and 0 <= det["class"] < len(self.class_names):
                entry["class_name"] = self.class_names[det["class"]]
            out.append(entry)
        return out
