"""AlexeyAB darknet ``.weights`` binary loader/saver.

The reference *lost* this capability (its darknet→trainable path is
``todo!()``, train/src/model.rs:31-33; the old loader was removed from
darknet-config — SURVEY §2.3).  Re-implemented here from the darknet binary
layout so cfg+weights pairs run end-to-end:

    header:  int32 major, int32 minor, int32 revision,
             seen = uint64 if major*10+minor >= 2 else uint32
    per [convolutional] (in cfg order):
             if batch_normalize: beta[f], gamma[f], mean[f], var[f]
             else:               bias[f]
             conv weights f32[f, in/g, k, k]   (OIHW)
    per [connected]: bias[out], weights[out*in],
             if batch_normalize: scale[out], mean[out], var[out]
             (save_connected_weights, parser.c)
    per [rnn]:  3 connected blocks input/self/output (parser.c:1919-1922)
    per [gru]:  6 connected blocks iz/ir/ih/sz/sr/sh (parser.c:1923-1929)
    per [lstm]: 8 connected blocks wf/wi/wg/wo/uf/ui/ug/uo (parser.c:1930-1938)
    per [crnn]: 3 convolutional blocks input/self/output (parser.c:1955-1958)

Conv kernels are transposed OIHW→HWIO into the NHWC/HWIO param layout used
on TPU.  ``save_darknet_weights`` writes the inverse for round-trip tests
and darknet-C parity harnesses.

Counterpart of ``yolodl_tpu/models/weights.py``: the trees are numpy, in the
reference's layout (``{"layer{i}": {"w": HWIO, "b" | "bn": ...}}``), so a
file reads and writes byte for byte as the reference does.
``yolodl_torch.bridge`` turns them into a model's tensors and back.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

from ..config import darknet_cfg as dk


class WeightsReader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def ints(self, n: int, size: int = 4) -> Tuple[int, ...]:
        fmt = "<" + ("i" if size == 4 else "q") * n
        out = struct.unpack_from(fmt, self.data, self.off)
        self.off += size * n
        return out

    def floats(self, n: int) -> np.ndarray:
        out = np.frombuffer(self.data, dtype="<f4", count=n, offset=self.off).copy()
        self.off += 4 * n
        return out

    @property
    def remaining(self) -> int:
        return len(self.data) - self.off


def _read_dense(reader: WeightsReader, in_f: int, out_f: int, bn: bool):
    """One darknet connected block → (params, state|None)."""
    b = reader.floats(out_f)
    w = reader.floats(out_f * in_f).reshape(out_f, in_f)
    p: Dict[str, Any] = {"w": np.ascontiguousarray(w.T), "b": b}
    s = None
    if bn:
        p["bn"] = {"scale": reader.floats(out_f)}
        s = {"bn": {"mean": reader.floats(out_f), "var": reader.floats(out_f)}}
    return p, s


def _write_dense(chunks, p: Dict[str, Any], s) -> None:
    chunks.append(np.asarray(p["b"], "<f4").tobytes())
    chunks.append(np.ascontiguousarray(np.asarray(p["w"], "<f4").T).tobytes())
    if "bn" in p:
        for arr in (p["bn"]["scale"], s["bn"]["mean"], s["bn"]["var"]):
            chunks.append(np.asarray(arr, "<f4").tobytes())


def _zero_dense(in_f: int, out_f: int, bn: bool):
    """Identity-init placeholder matching :func:`_read_dense`'s layout."""
    p: Dict[str, Any] = {"w": np.zeros((in_f, out_f), np.float32),
                         "b": np.zeros(out_f, np.float32)}
    s = None
    if bn:
        p["bn"] = {"scale": np.ones(out_f, np.float32)}
        s = {"bn": {"mean": np.zeros(out_f, np.float32),
                    "var": np.ones(out_f, np.float32)}}
    return p, s


def _zero_conv(in_c: int, f: int, k: int, bn: bool):
    """Identity-init placeholder matching :func:`_read_conv_block`."""
    p: Dict[str, Any] = {"w": np.zeros((k, k, in_c, f), np.float32)}
    s = None
    if bn:
        p["bn"] = {"scale": np.ones(f, np.float32),
                   "bias": np.zeros(f, np.float32)}
        s = {"bn": {"mean": np.zeros(f, np.float32),
                    "var": np.ones(f, np.float32)}}
    else:
        p["b"] = np.zeros(f, np.float32)
    return p, s


def _chw_to_hwc_in_dim(w, h0: int, w0: int, c0: int):
    """Dense in-dim permute: darknet flattens a spatial input (c, h, w);
    our dense/recurrent cells flatten NHWC → (h, w, c)."""
    w = np.asarray(w)  # (in_chw, out)
    return np.ascontiguousarray(
        w.reshape(c0, h0, w0, -1).transpose(1, 2, 0, 3)
        .reshape(h0 * w0 * c0, -1))


def _hwc_to_chw_in_dim(w, h0: int, w0: int, c0: int):
    """Inverse of :func:`_chw_to_hwc_in_dim` (for saving)."""
    w = np.asarray(w)  # (in_hwc, out)
    return np.ascontiguousarray(
        w.reshape(h0, w0, c0, -1).transpose(2, 0, 1, 3)
        .reshape(h0 * w0 * c0, -1))


def _read_conv_block(reader: WeightsReader, in_c: int, f: int, k: int, bn: bool):
    """One darknet convolutional block → (params, state|None), HWIO kernel."""
    p: Dict[str, Any] = {}
    s = None
    if bn:
        beta = reader.floats(f)
        gamma = reader.floats(f)
        mean = reader.floats(f)
        var = reader.floats(f)
        p["bn"] = {"scale": gamma, "bias": beta}
        s = {"bn": {"mean": mean, "var": var}}
    else:
        p["b"] = reader.floats(f)
    w = reader.floats(f * in_c * k * k).reshape(f, in_c, k, k)  # OIHW
    p["w"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # HWIO
    return p, s


def _write_conv_block(chunks, p: Dict[str, Any], s) -> None:
    if "bn" in p:
        for arr in (p["bn"]["bias"], p["bn"]["scale"], s["bn"]["mean"], s["bn"]["var"]):
            chunks.append(np.asarray(arr, "<f4").tobytes())
    else:
        chunks.append(np.asarray(p["b"], "<f4").tobytes())
    w = np.asarray(p["w"], "<f4").transpose(3, 2, 0, 1)  # HWIO → OIHW
    chunks.append(np.ascontiguousarray(w).tobytes())


# (sub_key, in_features_selector, out_features_selector) per recurrent kind;
# order matches parser.c save/load order exactly
_RNN_SUBS = (("input", "in", "hidden"), ("self", "hidden", "hidden"),
             ("output", "hidden", "out"))
_GRU_SUBS = (("iz", "in", "out"), ("ir", "in", "out"), ("ih", "in", "out"),
             ("sz", "out", "out"), ("sr", "out", "out"), ("sh", "out", "out"))
_LSTM_SUBS = (("wf", "out", "out"), ("wi", "out", "out"), ("wg", "out", "out"),
              ("wo", "out", "out"), ("uf", "in", "out"), ("ui", "in", "out"),
              ("ug", "in", "out"), ("uo", "in", "out"))


def _recurrent_dims(layer, in_f: int) -> Dict[str, int]:
    return {
        "in": in_f,
        "out": layer.output,
        "hidden": getattr(layer, "hidden", layer.output),
    }


def load_darknet_weights(
    darknet: dk.Darknet, path, strict: bool = True
) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
    """Read a .weights file → (params, state, seen) keyed "layer{i}".

    params/state match the builder's tree for a graph from
    :func:`yolodl_tpu.graph.from_darknet.graph_from_darknet`.
    """
    with open(path, "rb") as f:
        reader = WeightsReader(f.read())

    major, minor, _rev = reader.ints(3)
    if major * 10 + minor >= 2:
        (seen,) = reader.ints(1, size=8)
    else:
        (seen,) = reader.ints(1)

    shapes = darknet.output_shapes()
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}

    for i, layer in enumerate(darknet.layers):
        prev = darknet.net.input_shape_hwc if i == 0 else shapes[i - 1]
        if isinstance(layer, dk.Connected):
            # darknet connected: bias[out], weights[out, in] row-major with
            # the in-dim in darknet's (c, h, w) flatten order; our Linear
            # flattens NHWC → permute to (h, w, c) when prev is spatial
            h0, w0, c0 = prev
            in_f = h0 * w0 * c0
            p, s = _read_dense(reader, in_f, layer.output,
                               layer.batch_normalize)
            if h0 * w0 > 1:
                p["w"] = _chw_to_hwc_in_dim(p["w"], h0, w0, c0)
            params[f"layer{i}"] = p
            if s:
                state[f"layer{i}"] = s
            continue
        if isinstance(layer, (dk.Rnn, dk.Gru, dk.Lstm)):
            subs = {dk.Rnn: _RNN_SUBS, dk.Gru: _GRU_SUBS,
                    dk.Lstm: _LSTM_SUBS}[type(layer)]
            h0, w0, c0 = prev
            dims = _recurrent_dims(layer, h0 * w0 * c0)
            p: Dict[str, Any] = {}
            s: Dict[str, Any] = {}
            for key, fin, fout in subs:
                sp, ss = _read_dense(reader, dims[fin], dims[fout],
                                     layer.batch_normalize)
                if fin == "in" and h0 * w0 > 1:
                    # input-facing gates flatten the spatial input: same
                    # CHW→HWC in-dim permute as Connected above (the cells
                    # reshape NHWC, ops/recurrent.py *_apply)
                    sp["w"] = _chw_to_hwc_in_dim(sp["w"], h0, w0, c0)
                p[key] = sp
                if ss:
                    s[key] = ss
            params[f"layer{i}"] = p
            if s:
                state[f"layer{i}"] = s
            continue
        if isinstance(layer, dk.Crnn):
            p, s = {}, {}
            for key, in_c, out_c in (
                ("input", prev[2], layer.hidden),
                ("self", layer.hidden, layer.hidden),
                ("output", layer.hidden, layer.output),
            ):
                sp, ss = _read_conv_block(
                    reader, in_c // layer.groups, out_c, layer.size,
                    layer.batch_normalize)
                p[key] = sp
                if ss:
                    s[key] = ss
            params[f"layer{i}"] = p
            if s:
                state[f"layer{i}"] = s
            continue
        if not isinstance(layer, dk.Convolutional):
            continue
        if layer.share_index is not None:
            continue  # shared weights: resolved at build time
        in_c = (darknet.net.channels if i == 0 else shapes[i - 1][2]) // layer.groups
        p, s = _read_conv_block(reader, in_c, layer.filters, layer.size,
                                layer.batch_normalize)
        params[f"layer{i}"] = p
        if s:
            state[f"layer{i}"] = s

    if strict and reader.remaining != 0:
        raise ValueError(
            f"{reader.remaining} bytes left after loading weights — cfg/weights mismatch"
        )
    return params, state, seen


def save_darknet_weights(
    darknet: dk.Darknet,
    params: Dict[str, Any],
    state: Dict[str, Any],
    path,
    seen: int = 0,
) -> None:
    """Write params back to the darknet binary layout (round-trip/testing)."""
    shapes = darknet.output_shapes()
    chunks = [struct.pack("<iii", 0, 2, 0), struct.pack("<q", seen)]
    for i, layer in enumerate(darknet.layers):
        # graph-pruned training-only tails (e.g. the terminal
        # [route]→[conv]→[contrastive] branch of yolov4-tiny_contrastive.cfg,
        # pruned by from_darknet) have no model-tree entry — but the
        # .weights format is positional, so darknet-C still expects every
        # block: write identity-init placeholders (zero kernels/biases,
        # BN γ=1/var=1 so the file stays numerically loadable) to keep
        # every later layer's offsets right.  Applies to EVERY weighted
        # layer family, not just [convolutional].
        pruned = f"layer{i}" not in params
        prev = darknet.net.input_shape_hwc if i == 0 else shapes[i - 1]
        if isinstance(layer, dk.Connected):
            h0, w0, c0 = prev
            if pruned:
                p, s = _zero_dense(h0 * w0 * c0, layer.output,
                                   layer.batch_normalize)
                _write_dense(chunks, p, s)
                continue
            p = params[f"layer{i}"]
            if h0 * w0 > 1:
                # our (h, w, c) in-dim order → darknet's (c, h, w)
                p = {**p, "w": _hwc_to_chw_in_dim(p["w"], h0, w0, c0)}
            _write_dense(chunks, p, state.get(f"layer{i}"))
            continue
        if isinstance(layer, (dk.Rnn, dk.Gru, dk.Lstm)):
            subs = {dk.Rnn: _RNN_SUBS, dk.Gru: _GRU_SUBS,
                    dk.Lstm: _LSTM_SUBS}[type(layer)]
            h0, w0, c0 = prev
            dims = _recurrent_dims(layer, h0 * w0 * c0)
            p = {} if pruned else params[f"layer{i}"]
            s = {} if pruned else state.get(f"layer{i}", {})
            for key, fin, fout in subs:
                if pruned:
                    zp, zs = _zero_dense(dims[fin], dims[fout],
                                         layer.batch_normalize)
                    _write_dense(chunks, zp, zs)
                    continue
                sp = p[key]
                if fin == "in" and h0 * w0 > 1:
                    sp = {**sp, "w": _hwc_to_chw_in_dim(sp["w"], h0, w0, c0)}
                _write_dense(chunks, sp, s.get(key))
            continue
        if isinstance(layer, dk.Crnn):
            p = {} if pruned else params[f"layer{i}"]
            s = {} if pruned else state.get(f"layer{i}", {})
            for key, in_c, out_c in (
                ("input", prev[2], layer.hidden),
                ("self", layer.hidden, layer.hidden),
                ("output", layer.hidden, layer.output),
            ):
                if pruned:
                    zp, zs = _zero_conv(in_c // layer.groups, out_c,
                                        layer.size, layer.batch_normalize)
                    _write_conv_block(chunks, zp, zs)
                else:
                    _write_conv_block(chunks, p[key], s.get(key))
            continue
        if not isinstance(layer, dk.Convolutional) or layer.share_index is not None:
            continue
        if pruned:
            in_c = (darknet.net.channels if i == 0
                    else shapes[i - 1][2]) // layer.groups
            zero_p, zero_s = _zero_conv(in_c, layer.filters, layer.size,
                                        layer.batch_normalize)
            _write_conv_block(chunks, zero_p, zero_s)
            continue
        _write_conv_block(chunks, params[f"layer{i}"],
                          state.get(f"layer{i}"))
    with open(path, "wb") as f:
        f.write(b"".join(chunks))


def merge_into_model_tree(
    loaded_params: Dict[str, Any],
    loaded_state: Dict[str, Any],
    init_params: Dict[str, Any],
    init_state: Dict[str, Any],
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Overlay loaded darknet tensors onto a freshly-initialized tree,
    validating shapes (a partial-load helper like VarStore::load_partial).
    Layers absent from the loaded trees keep their init; leaves are f32
    numpy arrays."""
    def deep_merge(ref: Dict[str, Any], new: Dict[str, Any], where: str):
        merged = dict(ref)
        for k, v in new.items():
            if isinstance(v, dict):
                sub_ref = ref.get(k)
                merged[k] = deep_merge(
                    sub_ref if isinstance(sub_ref, dict) else {}, v,
                    f"{where}.{k}")
            else:
                expect = ref.get(k)
                if expect is not None and tuple(expect.shape) != tuple(np.shape(v)):
                    raise ValueError(
                        f"{where}.{k}: shape {np.shape(v)} != expected "
                        f"{tuple(expect.shape)}"
                    )
                merged[k] = np.asarray(v, np.float32)
        return merged

    params = dict(init_params)
    state = dict(init_state)
    for name, p in loaded_params.items():
        if name not in params:
            # a layer present in the .weights file but absent from the
            # model tree is a graph-pruned training-only tail (e.g. the
            # [contrastive] branch); dropping it keeps real darknet-written
            # weights loadable into the pruned graph
            continue
        params[name] = deep_merge(params[name], p, name)
    for name, s in loaded_state.items():
        if name not in params:
            continue
        state[name] = deep_merge(state.get(name, {}), s, name)
    return params, state
