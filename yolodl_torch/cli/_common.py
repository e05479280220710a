"""Shared plumbing for the inference-side CLIs (detect / eval / serve).

Counterpart of ``yolodl_tpu/cli/_common.py``: one definition of "config →
live model" so the entry points cannot drift.  The port's model holds its
own parameters, so :func:`build_model` returns ``(model, model_path)``;
:func:`load_artifact` loads an exported program in its place.
``--devices`` (:func:`devices_arg`, :func:`inference_devices`) gives one
model replica per device, in one process (``parallel/mesh.py``).
"""

from __future__ import annotations

import os


def devices_arg(text):
    """``--devices``: a count (0 = the config's device list) or a
    comma-separated list of devices (``cuda:0,cuda:0``: two replicas on one
    card)."""
    text = str(text).strip()
    if text.lstrip("-").isdigit():
        return int(text)
    return [d.strip() for d in text.split(",") if d.strip()]


def inference_devices(devices, config_devices: int, device):
    """The replicas' devices (``parallel/mesh.py`` ``replica_devices``) for
    ``--devices`` (``devices_arg``), the config's device count when it is 0,
    on ``device``'s kind."""
    from ..parallel.mesh import replica_devices

    if isinstance(devices, list):
        return replica_devices(devices)
    return replica_devices(device, devices or config_devices)


def load_artifact(path: str, image_size: int, device):
    """``--artifact``: the exported program (``models/export.py``) on
    ``device`` → (infer, meta), its input size checked against the
    config's dataset."""
    from ..models.export import load_exported

    infer, meta = load_exported(path, device=device)
    nhwc = meta.get("data_format") == "NHWC"
    px = meta["input_shape"][1 if nhwc else -1]
    if px != image_size:
        raise ValueError(
            f"artifact expects {px}px input but the config dataset is {image_size}px")
    return infer, meta


def build_model(config, base_dir: str, weights: str = "", checkpoint: str = "",
                ema: bool = False, seed: int = 0, device="cuda"):
    """DetectAppConfig → (model, model_path), the model on ``device``.

    ``weights`` loads a darknet ``.weights`` file (darknet cfgs only, as
    in the reference);
    ``checkpoint`` overlays a framework ``.ckpt``; ``ema`` selects the
    checkpoint's EMA parameters and is rejected without a checkpoint —
    silently evaluating raw weights as "the EMA model" would be worse
    than an error.  A NEWSLAB model with node kinds the port's builder
    lacks raises ``NotImplementedError`` naming its ROADMAP item.
    """
    from ..bridge import params_from_jax, params_to_jax
    from ..models.zoo import load_darknet_model, load_newslab_model
    from ..train.checkpoint import load_checkpoint

    model_path = os.path.join(base_dir, config.model_file)
    if config.model_kind == "darknet":
        model = load_darknet_model(model_path, weights or None, seed=seed, device=device)
    else:  # .weights files are darknet's; a NEWSLAB model ignores them
        model = load_newslab_model(model_path, seed=seed, device=device)
    if checkpoint:
        params, state = params_to_jax(model.state_dict())
        params, state, _, meta = load_checkpoint(checkpoint, params, state)
        if ema:
            if "ema" not in meta:
                raise SystemExit("checkpoint has no EMA parameters")
            params = meta["ema"]
        params_from_jax(params, state, model=model)
    elif ema:
        raise SystemExit(
            "--ema needs --checkpoint: EMA parameters live in framework "
            "checkpoints, not in .weights files")
    return model, model_path


def nms_options(config, model_path: str):
    """(nms_kind, beta) honoring the darknet cfg's nms_kind/beta_nms
    (yolo.rs NmsKind; parser.c:490 beta default) — greedy defaults when
    the cfg is absent."""
    nms_kind, nms_beta = "greedy", 0.6
    if config.model_kind == "darknet" and os.path.exists(model_path):
        from ..config import darknet_cfg as dk
        from ..loss.nms import nms_options_from_darknet

        nms_kind, nms_beta = nms_options_from_darknet(
            dk.Darknet.load(model_path))
    return nms_kind, nms_beta
