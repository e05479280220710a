"""Checkpoint save/load with the reference's filename discipline.

Counterpart of ``yolodl_tpu/train/checkpoint.py`` (``train/src/utils/
checkpoint.rs``), with the same file format, so that a checkpoint written by
either package loads into the other: files named
``{timestamp}_{step:06}_{loss:08.5f}.ckpt`` under a checkpoints dir; one
numpy ``.npz`` per file holding the ``/``-joined key paths of the trees
(``params/…``, ``state/…``, ``ema/…``, and ``opt/…`` from the reference)
plus a JSON ``__meta__`` entry (step, loss, has_opt, has_ema, extra).

The trees are nested dicts in the reference's layout, as
``yolodl_torch.bridge.params_to_jax`` gives them from a model's
``state_dict``; leaves may be numpy arrays or tensors, and loads return
numpy.  The optimizer state (``opt/``) is the reference's optax tree, as
``train/loop.py`` ``optimizer_state_tree`` spells it (chain indices,
``.count`` int32, ``.mu``/``.nu`` or ``.trace`` in HWIO), so a resume takes
the same next step whichever package wrote the checkpoint.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.trees import flatten_tree, tree_map_with_path, tree_path_name

_CKPT_RE = re.compile(
    # step: 6+ digits (runs past 1M must stay resumable); loss: any numeric
    # rendering INCLUDING nan/inf — a diverged run's preemption checkpoint
    # must not become invisible to FromRecent (ordering is by the leading
    # timestamp, so the loss text never affects recency)
    r"^(?P<timestamp>[0-9-]+)_(?P<step>\d{6,})_(?P<loss>[0-9a-z.+-]+)\.ckpt$"
)

def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array of its own (a tensor is copied off its
    device; the copy does not follow later in-place updates)."""
    if isinstance(leaf, torch.Tensor):
        return np.array(leaf.detach().cpu().numpy())
    return np.asarray(leaf)


def _flatten(tree: Any, prefix: str) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in flatten_tree(tree, prefix).items()}


def _read(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    meta = json.loads(bytes(flat.pop("__meta__").tobytes()).decode())
    return flat, meta


def _unflatten_into(template: Any, flat: Dict[str, np.ndarray], prefix: str) -> Any:
    def take(path, leaf):
        key = prefix + tree_path_name(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing tensor {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"{key}: checkpoint shape {arr.shape} != model shape {tuple(leaf.shape)}"
            )
        return arr

    return tree_map_with_path(take, template)


def save_checkpoint(
    checkpoint_dir: str,
    step: int,
    loss: float,
    params: Any,
    state: Any,
    opt_state: Any = None,
    extra: Optional[Dict[str, Any]] = None,
    ema_params: Any = None,
) -> str:
    """Write ``{timestamp}_{step:06}_{loss:08.5f}.ckpt``; returns the path."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    timestamp = time.strftime("%Y-%m-%d-%H-%M-%S")
    filename = f"{timestamp}_{step:06d}_{loss:08.5f}.ckpt"
    path = os.path.join(checkpoint_dir, filename)

    payload = {}
    payload.update(_flatten(params, "params/"))
    payload.update(_flatten(state, "state/"))
    if opt_state is not None:
        payload.update(_flatten(opt_state, "opt/"))
    if ema_params is not None:
        payload.update(_flatten(ema_params, "ema/"))
    meta = {"step": step, "loss": loss, "has_opt": opt_state is not None,
            "has_ema": ema_params is not None}
    if extra:
        meta["extra"] = extra
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )

    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)  # atomic publish; avoids the reference's documented
    # open-vs-write cache race (file_cache.rs:111-113)
    return path


def load_checkpoint(
    path: str,
    params_template: Any,
    state_template: Any,
    opt_template: Any = None,
) -> Tuple[Any, Any, Any, Dict[str, Any]]:
    """Load a .ckpt → (params, state, opt_state_or_None, meta).

    ``opt/`` is read when an ``opt_template`` is given and the checkpoint
    has it; ``meta["ema"]`` carries EMA parameters when present.
    """
    flat, meta = _read(path)
    params = _unflatten_into(params_template, flat, "params/")
    state = _unflatten_into(state_template, flat, "state/")
    opt_state = None
    if opt_template is not None and meta.get("has_opt"):
        opt_state = _unflatten_into(opt_template, flat, "opt/")
    if meta.get("has_ema"):
        meta["ema"] = _unflatten_into(params_template, flat, "ema/")
    return params, state, opt_state, meta


def load_checkpoint_partial(
    path: str,
    params_template: Any,
    state_template: Any,
) -> Tuple[Any, Any, Dict[str, Any], list]:
    """Non-strict load (VarStore::load_partial parity, checkpoint.rs:24-81):
    tensors present in the checkpoint with matching shapes overlay the
    templates; everything else keeps the template value.  Returns
    (params, state, meta, skipped_keys)."""
    flat, meta = _read(path)
    skipped = []

    def overlay(template, prefix):
        def take(path_, leaf):
            key = prefix + tree_path_name(path_)
            arr = flat.get(key)
            if arr is None or tuple(arr.shape) != tuple(leaf.shape):
                skipped.append(key)
                return leaf
            return arr

        return tree_map_with_path(take, template)

    params = overlay(params_template, "params/")
    state = overlay(state_template, "state/")
    return params, state, meta, skipped


def find_recent_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """Newest checkpoint by filename timestamp (checkpoint.rs:39-64)."""
    if not os.path.isdir(checkpoint_dir):
        return None
    candidates = [
        name for name in os.listdir(checkpoint_dir) if _CKPT_RE.match(name)
    ]
    if not candidates:
        return None
    return os.path.join(checkpoint_dir, max(candidates))


def load_recent_checkpoint(
    checkpoint_dir: str,
    params_template: Any,
    state_template: Any,
    opt_template: Any = None,
):
    path = find_recent_checkpoint(checkpoint_dir)
    if path is None:
        return None
    return load_checkpoint(path, params_template, state_template, opt_template)


class AsyncCheckpointer:
    """Checkpoint writes off the training thread.

    The device→host copy happens on the caller (a snapshot that later
    in-place updates of the model do not reach), then the npz serialization
    + disk write run on a worker thread so the train loop is not blocked for
    the write (the reference saves synchronously, multi_gpu.rs:317-333). At
    most one write is in flight: a new save first joins the previous one,
    preserving filename-timestamp order.
    """

    def __init__(self):
        self._thread = None
        self._exc = None

    def _write(self, *args, **kwargs):
        try:
            save_checkpoint(*args, **kwargs)
        except BaseException as e:  # surfaced by the next flush()/save()
            self._exc = e

    def save(self, checkpoint_dir: str, step: int, loss: float, params: Any,
             state: Any, opt_state: Any = None,
             extra: Optional[Dict[str, Any]] = None,
             ema_params: Any = None) -> None:
        host = [None if t is None else tree_map_with_path(lambda _, x: _host(x), t)
                for t in (params, state, opt_state, ema_params)]
        self.flush()
        self._thread = threading.Thread(
            target=self._write,
            args=(checkpoint_dir, step, loss, host[0], host[1], host[2]),
            kwargs={"extra": extra, "ema_params": host[3]},
            daemon=True,
        )
        self._thread.start()

    def flush(self) -> None:
        """Block until the in-flight write (if any) has been published.

        Re-raises a failed write — callers must not report a checkpoint as
        saved (or exit on preemption) before flush() returns.
        """
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError("async checkpoint write failed") from exc


def find_recent_checkpoint_in_runs(logging_dir: str) -> Optional[str]:
    """Newest checkpoint across all timestamped run dirs under a logging dir.

    FromRecent in the reference scans the *previous* runs' checkpoint dirs
    (checkpoint.rs:39-64), not the just-created empty one — a fresh run dir
    is made per invocation, so scanning only it would never resume.
    Newest = lexicographically greatest basename (timestamp prefix sorts).
    """
    if not os.path.isdir(logging_dir):
        return None
    best = None
    for run in os.listdir(logging_dir):
        ckpt_dir = os.path.join(logging_dir, run, "checkpoints")
        path = find_recent_checkpoint(ckpt_dir)
        if path is not None and (
            best is None or os.path.basename(path) > os.path.basename(best)
        ):
            best = path
    return best


def load_recent_checkpoint_in_runs(
    logging_dir: str,
    params_template: Any,
    state_template: Any,
    opt_template: Any = None,
):
    path = find_recent_checkpoint_in_runs(logging_dir)
    if path is None:
        return None
    return load_checkpoint(path, params_template, state_template, opt_template)
