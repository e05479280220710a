"""BN-folding export: produce a BN-free darknet cfg+weights pair.

Counterpart of ``yolodl_tpu/models/fold.py``.  A new ``.cfg`` with
``batch_normalize`` stripped and a ``.weights`` file whose conv kernels and
biases absorb the running statistics, loadable by darknet-C and by either
package.  The functions are numpy on the reference's HWIO trees
(``models/weights.py``), so a fold writes the reference's bytes; the
port's ``ops/norm.py`` ``fold_batch_norm`` is the same formula on
``[out, in, k, k]`` tensors.

Valid only for darknet's conv→BN→activation order, which every
``[convolutional]`` section uses.  BN inside ``[crnn]`` sub-convs and
``[connected]`` layers stays in place, and so do shared-weight convs.  In
the port's eager forward the fold does what XLA's fusion does for the
reference: each folded conv drops its BN pass.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np

from ..config import darknet_cfg as dk
from ..ops.norm import DEFAULT_EPS


def fold_conv_bn_arrays(
    w: np.ndarray,
    scale: np.ndarray,
    bias: np.ndarray,
    mean: np.ndarray,
    var: np.ndarray,
    eps: float = DEFAULT_EPS,
) -> Tuple[np.ndarray, np.ndarray]:
    """conv(x, fw) + fb == bn(conv(x, w)) in eval mode.  ``w`` is HWIO; the
    fold broadcasts over the output-channel (last) axis."""
    w = np.asarray(w, np.float64)
    inv = np.asarray(scale, np.float64) / np.sqrt(
        np.asarray(var, np.float64) + eps
    )
    fw = w * inv
    fb = np.asarray(bias, np.float64) - np.asarray(mean, np.float64) * inv
    return fw.astype(np.float32), fb.astype(np.float32)


def _share_sources(darknet: dk.Darknet) -> set:
    """Absolute indices of layers whose weights another conv shares."""
    out = set()
    for i, layer in enumerate(darknet.layers):
        if isinstance(layer, dk.Convolutional) and layer.share_index is not None:
            try:
                out.add(dk.resolve_index(layer.share_index, i))
            except ValueError:
                pass  # out-of-range reference: the graph build rejects it
    return out


def fold_darknet(
    darknet: dk.Darknet,
    params: Dict[str, Any],
    state: Dict[str, Any],
    eps: float = DEFAULT_EPS,
) -> Tuple[dk.Darknet, Dict[str, Any], Dict[str, Any]]:
    """Fold every plain ``[convolutional]``'s BN into its kernel/bias.

    Returns (cfg', params', state') where cfg' has ``batch_normalize=0`` on
    the folded layers.  Keys follow the darknet graph's ``layer{i}`` naming
    (graph/from_darknet.py).  Shared-weight convs (``share_index``, either
    end) are skipped — folding one alias would corrupt the other.
    """
    shared = _share_sources(darknet)
    new_layers = []
    new_params = dict(params)
    new_state = dict(state)
    for i, layer in enumerate(darknet.layers):
        key = f"layer{i}"
        foldable = (
            isinstance(layer, dk.Convolutional)
            and layer.batch_normalize
            and layer.share_index is None
            and i not in shared
            and key in params
            and "bn" in params[key]
            # a params/state skew skips the layer rather than failing on
            # the stats lookup below
            and "bn" in state.get(key, {})
        )
        if not foldable:
            new_layers.append(layer)
            continue
        p = params[key]
        bn_s = state[key]["bn"]
        fw, fb = fold_conv_bn_arrays(
            np.asarray(p["w"], np.float32),
            np.asarray(p["bn"]["scale"], np.float32),
            np.asarray(p["bn"].get("bias", np.zeros_like(bn_s["mean"])),
                       np.float32),
            np.asarray(bn_s["mean"], np.float32),
            np.asarray(bn_s["var"], np.float32),
            eps,
        )
        new_params[key] = {"w": fw, "b": fb}
        rest = {k: v for k, v in state[key].items() if k != "bn"}
        if rest:
            new_state[key] = rest
        else:
            del new_state[key]
        new_layers.append(dataclasses.replace(layer, batch_normalize=False))
    return (
        dataclasses.replace(darknet, layers=tuple(new_layers)),
        new_params,
        new_state,
    )


def fold_darknet_files(
    cfg_path,
    weights_path,
    out_cfg_path,
    out_weights_path,
    eps: float = DEFAULT_EPS,
) -> Tuple[int, int]:
    """File-level fold: cfg+weights in, BN-free cfg+weights out, on the
    host in numpy.  Returns (n_folded, n_kept_bn) layer counts."""
    from .weights import load_darknet_weights, save_darknet_weights

    darknet = dk.Darknet.load(cfg_path)
    params, state, seen = load_darknet_weights(darknet, weights_path)
    folded_cfg, fp, fs = fold_darknet(darknet, params, state, eps)
    n_folded = sum(
        1
        for a, b in zip(darknet.layers, folded_cfg.layers)
        if getattr(a, "batch_normalize", False)
        and not getattr(b, "batch_normalize", True)
    )
    n_kept = sum(
        1
        for lyr in folded_cfg.layers
        if getattr(lyr, "batch_normalize", False)
    )
    with open(out_cfg_path, "w") as f:
        f.write(dk.to_cfg_string(folded_cfg))
    save_darknet_weights(folded_cfg, fp, fs, out_weights_path, seen=seen)
    return n_folded, n_kept
