"""Asynchronous TensorBoard logging worker.

Equivalent capability to ``train/src/logging.rs``: a dedicated worker thread
consumes a **lossy** bounded queue (the reference uses a tokio broadcast
channel and skips Lagged messages, logging.rs:71-75) and writes TensorBoard
events with the same scalar/image taxonomy: lr + 4 losses (:280-304),
benchmark accuracy/recall/precision (:323-359), per-parameter |w|max and
|grad|max when gradients are enabled (:361-376), and box-overlay images.

Counterpart of ``yolodl_tpu/train/logging.py``.  Events are written by
``torch.utils.tensorboard.SummaryWriter``, as in the reference; the
``tensorboard`` package it needs is present on the card's machine as here.
"""

from __future__ import annotations

import queue
import sys
import threading
from typing import Any, Dict, Optional

import numpy as np


def draw_boxes_on_image(
    image_chw: np.ndarray,
    boxes_tlbr_ratio: np.ndarray,
    color=(1.0, 1.0, 0.0),
    thickness: int = 1,
) -> np.ndarray:
    """Rect outlines on a [3,H,W] float image (TensorExt batch-draw parity,
    tch-goodies/src/tensor.rs:419-714)."""
    out = image_chw.copy()
    _, h, w = out.shape
    for t, l, b, r in np.asarray(boxes_tlbr_ratio).reshape(-1, 4):
        t_px = int(np.clip(t * h, 0, h - 1))
        b_px = int(np.clip(b * h, 0, h - 1))
        l_px = int(np.clip(l * w, 0, w - 1))
        r_px = int(np.clip(r * w, 0, w - 1))
        for k in range(thickness):
            # thicken INWARD on every edge: top/left move down/right,
            # bottom/right move up/left — the outline stays h x w pixels
            tt, bb = min(t_px + k, h - 1), max(b_px - k, 0)
            ll, rr = min(l_px + k, w - 1), max(r_px - k, 0)
            for c in range(3):
                out[c, tt, l_px:r_px + 1] = color[c]
                out[c, bb, l_px:r_px + 1] = color[c]
                out[c, t_px:b_px + 1, ll] = color[c]
                out[c, t_px:b_px + 1, rr] = color[c]
    return out


class LoggingWorker:
    """Background TensorBoard writer with a lossy bounded queue."""

    def __init__(self, log_dir: str, queue_size: int = 16):
        self.log_dir = log_dir
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._thread: Optional[threading.Thread] = None
        self._writer = None
        self.dropped = 0
        self._warned_write_failure = False

    def start(self) -> "LoggingWorker":
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(self.log_dir)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while True:
            item = self._queue.get()
            if item is None:
                break
            kind, step, payload = item
            try:
                if kind == "scalars":
                    for key, value in payload.items():
                        self._writer.add_scalar(key, float(value), step)
                elif kind == "image":
                    name, image = payload
                    self._writer.add_image(name, image, step)
            except Exception as e:
                # never crash training over telemetry, but don't be silent
                # about it either: count it and warn once
                self.dropped += 1
                if not self._warned_write_failure:
                    self._warned_write_failure = True
                    print(f"warning: TensorBoard write failed ({e!r}); "
                          "further failures counted in .dropped",
                          file=sys.stderr)
        self._writer.flush()
        self._writer.close()  # stop the writer's own thread, finalize file

    def _offer(self, item) -> None:
        """Lossy put: drop when the queue is full (logging.rs:71-75)."""
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            self.dropped += 1

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        self._offer(("scalars", step, dict(scalars)))

    def log_training_output(
        self,
        step: int,
        lr: float,
        metrics: Dict[str, Any],
        benchmark: Optional[Dict[str, float]] = None,
    ) -> None:
        """The reference's scalar taxonomy (logging.rs:280-359)."""
        scalars = {
            "params/learning_rate": lr,
            "loss/total_loss": metrics["total_loss"],
            "loss/iou_loss": metrics["iou_loss"],
            "loss/classification_loss": metrics["classification_loss"],
            "loss/objectness_loss": metrics["objectness_loss"],
        }
        if benchmark:
            scalars.update({f"benchmark/{k}": v for k, v in benchmark.items()})
        # enable_debug_stat box statistics (logging.rs:135-146,307-320)
        scalars.update({k: v for k, v in metrics.items()
                        if k.startswith("debug/")})
        self.log_scalars(step, scalars)

    def log_weights_and_grads(self, step: int, params, grads=None) -> None:
        """|w|max (and |grad|max) per parameter (logging.rs:361-376); the
        trees are nested dicts of numpy arrays or tensors, as
        ``bridge.params_to_jax`` gives them."""
        from ..utils.trees import flatten_tree

        scalars = {}
        for prefix, tree in (("weights_max/", params), ("grads_max/", grads)):
            for name, leaf in flatten_tree(tree or {}, prefix).items():
                if hasattr(leaf, "detach"):
                    leaf = leaf.detach().cpu().numpy()
                scalars[name] = float(np.abs(np.asarray(leaf)).max())
        self.log_scalars(step, scalars)

    def log_image(self, step: int, name: str, image_chw: np.ndarray) -> None:
        self._offer(("image", step, (name, np.asarray(image_chw))))

    def log_objectness_heatmap(
        self, step: int, image_chw: np.ndarray, obj_prob_flat: np.ndarray,
        infos, layer: int = 0,
    ) -> None:
        """Objectness probabilities of one head resized over the input
        (logging.rs:379-422 objectness-image equivalent)."""
        info = infos[layer]
        per_layer = obj_prob_flat[info.flat_begin:info.flat_end].reshape(
            info.num_anchors, info.feature_h, info.feature_w
        )
        heat = per_layer.max(axis=0)
        _, h, w = image_chw.shape
        ry = max(1, h // info.feature_h)
        rx = max(1, w // info.feature_w)
        heat_up = np.kron(heat, np.ones((ry, rx)))[:h, :w]
        overlay = image_chw * 0.5
        overlay[0, : heat_up.shape[0], : heat_up.shape[1]] += 0.5 * heat_up
        self.log_image(step, "objectness/heatmap", np.clip(overlay, 0, 1))

    def close(self):
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=30)
            if self._thread.is_alive():  # e.g. a stalled filesystem
                print("warning: TensorBoard worker did not drain within "
                      "30 s; late events may be unflushed", file=sys.stderr)
            self._thread = None
