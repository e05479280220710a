"""darknet's connected and recurrent layers: [connected], [rnn], [gru],
[lstm], [crnn].

Counterpart of ``yolodl_tpu/ops/recurrent.py``, from the same darknet C
semantics:

- connected (connected_layer.c): ``y = act(BN(x·Wᵀ)·γ + b)``.  BN, when
  enabled, has a scale and no shift, and scales *before* the bias is
  added, unlike a conv layer's BN whose β takes the bias's place.
- [rnn] (rnn_layer.c): three connected sub-layers ``input``, ``self``,
  ``output``; ``h_t = act(W_i x_t) + self_act(W_s h_{t-1}) (+ h_{t-1}
  with shortcut)``, ``y_t = act(W_o h_t)``; each activation applies
  before the sum.
- [gru] (gru_layer.c): six linear sub-layers ``iz ir ih sz sr sh``;
  ``z = σ(iz(x)+sz(h))``, ``r = σ(ir(x)+sr(h))``, ``h̃ = σ(ih(x) +
  sh(r·h))`` (logistic, not tanh: darknet compiles the tanh branch out),
  ``y = z·h + (1−z)·h̃``.
- [lstm] (lstm_layer.c): eight linear sub-layers; ``w*`` read h, ``u*``
  read x; σ gates, tanh candidate and cell.
- [crnn] (crnn_layer.c): the [rnn] recurrence with conv sub-layers in
  darknet's conv → BN → act order.

A dense weight is kept ``[out, in]``, as ``nn.Linear`` keeps it;
``bridge.py`` transposes the reference's ``[in, out]``.  A 4-D input is
flattened in the reference's NHWC order (:func:`flatten_nhwc`), so a
``.weights`` file and bridged parameters line up with the reference's.

Time layout is darknet's: the leading axis is ``T*B``, time-major (row
``t*B + b``), the initial state zero.  The reference scans the steps with
``lax.scan``; here the loop over ``T`` is a Python loop in the same order.
Each step's train-mode BN normalizes over that step's ``B`` rows only, and
the running statistics are updated ``T`` times in sequence, as the scan's
carry threads them.

Under tensor or pipeline parallelism a node's apply function takes its
parallel context ``shard`` (``parallel/tp.py`` ``SequenceShard``).  Over
several data ranks, ``shard.enter`` gathers the node's input rows, the
micro-batch's global rows in order, so the time split and the whole loop
run on them, as the reference's ``x.reshape(T, N/T, …)`` does on the
global batch; ``shard.leave`` keeps this rank's block of the output rows,
which lines up with its input block since ``torch.cat(ys)`` keeps the
time-major order.  Each sub-layer runs under its own ``LayerShard``
(``shard.subs``), cut on its output features over the model axis where the
leaf rule cuts it; its BN uses the rows it is given, which are already the
global ones.  Without a context (``shard=None``) a node runs on the rows it
is given.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .. import activations
from . import conv as conv_ops
from .norm import batch_norm_apply

Tensor = torch.Tensor
Params = Dict[str, Any]
State = Dict[str, Any]

RNN_SUBS = ("input", "self", "output")
GRU_SUBS = ("iz", "ir", "ih", "sz", "sr", "sh")
LSTM_SUBS = ("wf", "wi", "wg", "wo", "uf", "ui", "ug", "uo")


def flatten_nhwc(x: Tensor) -> Tensor:
    """``[N, …]`` → ``[N, F]`` in the reference's order: a 4-D NCHW map is
    flattened as NHWC (h, w, c), anything else as it is."""
    if x.dim() == 4:
        x = x.permute(0, 2, 3, 1)
    return x.reshape(x.shape[0], -1)


def dense_apply(params: Params, state: State, x: Tensor, act: str, train: bool,
                shard=None) -> Tuple[Tensor, State]:
    """darknet forward_connected_layer: gemm → BN (scale only) → +bias → act.
    ``shard`` runs it on this rank's output features under tensor
    parallelism, as ``ops/conv.py`` ``conv_bn_apply`` runs a conv."""
    if shard is not None:
        x, _ = shard.enter(x, 1)
    y = x @ params["w"].to(x.dtype).t()
    new_state = state
    if "bn" in params:
        bn = batch_norm_apply if shard is None else shard.batch_norm
        y, bn_s = bn(params["bn"], state["bn"], y, train)
        new_state = {**state, "bn": bn_s}
    y = activations.apply(act, y + params["b"].to(y.dtype))
    if shard is not None:
        y = shard.leave(y)
    return y, new_state


def _split_time(x: Tensor, time_steps: int) -> Tensor:
    n = x.shape[0]
    if n % time_steps != 0:
        raise ValueError(f"batch {n} is not divisible by time_steps {time_steps}")
    return x.reshape((time_steps, n // time_steps) + tuple(x.shape[1:]))


def _detached(state: State) -> State:
    """A running-statistics tree cut from the autograd graph: the next
    step reads the values, and no gradient flows through them (the
    reference returns them as ``new_state``, outside its gradient)."""
    return {k: _detached(v) if isinstance(v, dict) else v.detach()
            for k, v in state.items()}


def _final_state(state: State, subs) -> State:
    return {k: state[k] for k in subs if state.get(k)}


def _enter(shard, x: Tensor) -> Tensor:
    return x if shard is None else shard.enter(x)


def _leave(shard, y: Tensor) -> Tensor:
    return y if shard is None else shard.leave(y)


def _sub_shards(shard, names) -> Dict[str, Any]:
    """Each sub-layer's ``LayerShard`` of the node's context (None each
    without one)."""
    return {k: None if shard is None else shard.subs.get(k) for k in names}


def rnn_apply(params: Params, state: State, x: Tensor, *, hidden: int, act: str,
              self_act: str, shortcut: bool, time_steps: int, train: bool, shard=None
              ) -> Tuple[Tensor, State]:
    xs = _split_time(flatten_nhwc(_enter(shard, x)), time_steps)
    h = torch.zeros((xs.shape[1], hidden), dtype=x.dtype, device=x.device)
    ss = {k: state.get(k, {}) for k in RNN_SUBS}
    cut = _sub_shards(shard, RNN_SUBS)
    ys = []
    for x_t in xs:
        in_out, s_i = dense_apply(params["input"], ss["input"], x_t, act, train,
                                  shard=cut["input"])
        self_out, s_s = dense_apply(params["self"], ss["self"], h, self_act, train,
                                    shard=cut["self"])
        h_new = in_out + self_out
        if shortcut:
            h_new = h_new + h
        y, s_o = dense_apply(params["output"], ss["output"], h_new, act, train,
                             shard=cut["output"])
        h, ss = h_new, _detached({"input": s_i, "self": s_s, "output": s_o})
        ys.append(y)
    return _leave(shard, torch.cat(ys)), _final_state(ss, RNN_SUBS)


def gru_apply(params: Params, state: State, x: Tensor, *, out_f: int, time_steps: int,
              train: bool, shard=None) -> Tuple[Tensor, State]:
    xs = _split_time(flatten_nhwc(_enter(shard, x)), time_steps)
    h = torch.zeros((xs.shape[1], out_f), dtype=x.dtype, device=x.device)
    ss = {k: state.get(k, {}) for k in GRU_SUBS}
    cut = _sub_shards(shard, GRU_SUBS)
    ys = []
    for x_t in xs:
        outs, new_ss = {}, {}
        for name in ("iz", "ir", "ih"):
            outs[name], new_ss[name] = dense_apply(params[name], ss[name], x_t, "linear", train,
                                                   shard=cut[name])
        for name in ("sz", "sr"):
            outs[name], new_ss[name] = dense_apply(params[name], ss[name], h, "linear", train,
                                                   shard=cut[name])
        z = torch.sigmoid(outs["iz"] + outs["sz"])
        r = torch.sigmoid(outs["ir"] + outs["sr"])
        sh_out, new_ss["sh"] = dense_apply(params["sh"], ss["sh"], r * h, "linear", train,
                                           shard=cut["sh"])
        h_cand = torch.sigmoid(outs["ih"] + sh_out)  # darknet's logistic candidate
        h = z * h + (1.0 - z) * h_cand               # weighted_sum_cpu(state, h̃, z)
        ss = _detached(new_ss)
        ys.append(h)
    return _leave(shard, torch.cat(ys)), _final_state(ss, GRU_SUBS)


def lstm_apply(params: Params, state: State, x: Tensor, *, out_f: int, time_steps: int,
               train: bool, shard=None) -> Tuple[Tensor, State]:
    xs = _split_time(flatten_nhwc(_enter(shard, x)), time_steps)
    h = torch.zeros((xs.shape[1], out_f), dtype=x.dtype, device=x.device)
    c = torch.zeros_like(h)
    ss = {k: state.get(k, {}) for k in LSTM_SUBS}
    cut = _sub_shards(shard, LSTM_SUBS)
    ys = []
    for x_t in xs:
        outs, new_ss = {}, {}
        for name in LSTM_SUBS:
            src = h if name.startswith("w") else x_t
            outs[name], new_ss[name] = dense_apply(params[name], ss[name], src, "linear", train,
                                                   shard=cut[name])
        f = torch.sigmoid(outs["wf"] + outs["uf"])
        i = torch.sigmoid(outs["wi"] + outs["ui"])
        g = torch.tanh(outs["wg"] + outs["ug"])
        o = torch.sigmoid(outs["wo"] + outs["uo"])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ss = _detached(new_ss)
        ys.append(h)
    return _leave(shard, torch.cat(ys)), _final_state(ss, LSTM_SUBS)


def crnn_apply(params: Params, state: State, x: Tensor, *, sub_cfgs, hidden: int,
               shortcut: bool, time_steps: int, train: bool, shard=None
               ) -> Tuple[Tensor, State]:
    """[crnn] on NCHW: ``sub_cfgs`` maps input/self/output to the ConvBn2D
    geometry of each sub-layer (darknet conv → BN → act order)."""
    if x.dim() == 2:  # after a connected layer: darknet treats it as 1×1×c
        x = x[:, :, None, None]
    xs = _split_time(_enter(shard, x), time_steps)
    _, b, _, h_dim, w_dim = xs.shape
    h = torch.zeros((b, hidden, h_dim, w_dim), dtype=x.dtype, device=x.device)
    ss = {k: state.get(k, {}) for k in RNN_SUBS}
    cut = _sub_shards(shard, RNN_SUBS)
    ys = []
    for x_t in xs:
        in_out, s_i = conv_ops.conv_bn_apply(params["input"], ss["input"], x_t,
                                             sub_cfgs["input"], train, shard=cut["input"])
        self_out, s_s = conv_ops.conv_bn_apply(params["self"], ss["self"], h,
                                               sub_cfgs["self"], train, shard=cut["self"])
        h_new = in_out + self_out
        if shortcut:
            h_new = h_new + h
        y, s_o = conv_ops.conv_bn_apply(params["output"], ss["output"], h_new,
                                        sub_cfgs["output"], train, shard=cut["output"])
        h, ss = h_new, _detached({"input": s_i, "self": s_s, "output": s_o})
        ys.append(y)
    return _leave(shard, torch.cat(ys)), _final_state(ss, RNN_SUBS)
