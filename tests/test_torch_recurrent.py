"""yolodl_torch/ops/recurrent.py against yolodl_tpu/ops/recurrent.py, part
1: dense_apply (with and without BN, train and eval), rnn_apply (logistic
and loggy self activation, shortcut) and gru_apply on the same seeded
inputs and parameters (``_torch_parity.seeded_trees`` of the reference's
init, carried across by the bridge's leaf mapping), the ``T*B``
divisibility error and the NHWC flatten order.  Part 2
(test_torch_recurrent_lstm.py): lstm_apply and crnn_apply.

Time layout is darknet's ``T*B`` time-major; T is 3 (the reference scans
it with ``lax.scan``, the port loops) and B is 8: with 2 rows a step,
train-mode BN's one-pass variance leaves either package's f32 output
further from an f64 run of the same math than the tolerance.
Tolerance (``_torch_parity.recurrent_matches``): outputs and the new BN
state within 1e-5 of the largest reference entry, gradients within 1e-5
of the largest reference gradient of the call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_tree, recurrent_matches, seeded_trees
from yolodl_torch.ops import recurrent as t_rec
from yolodl_tpu.ops import recurrent as j_rec

torch.set_num_threads(2)

T, B, IN_F, HID, OUT_F = 3, 8, 7, 5, 6


def seq_input(seed, feat=IN_F):
    return np.random.default_rng(seed).normal(size=(T * B, feat)).astype(np.float32)


@pytest.mark.parametrize("bn", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_dense_apply(bn, train):
    params, state = seeded_trees(lambda k: j_rec.dense_init(k, IN_F, OUT_F, bn), 1)
    recurrent_matches(lambda p, s, x, tr: j_rec.dense_apply(p, s, x, "leaky", tr),
                      lambda p, s, x, tr: t_rec.dense_apply(p, s, x, "leaky", tr),
                      params, state, seq_input(2), train)


@pytest.mark.parametrize("self_act,shortcut,train", [
    ("logistic", False, True), ("loggy", False, True), ("logistic", True, True),
    ("loggy", True, False)])
def test_rnn_apply(self_act, shortcut, train):
    params, state = seeded_trees(lambda k: j_rec.rnn_init(k, IN_F, HID, OUT_F, True), 3)
    kw = dict(hidden=HID, act="leaky", self_act=self_act, shortcut=shortcut, time_steps=T)
    out = recurrent_matches(lambda p, s, x, tr: j_rec.rnn_apply(p, s, x, train=tr, **kw),
                            lambda p, s, x, tr: t_rec.rnn_apply(p, s, x, train=tr, **kw),
                            params, state, seq_input(4), train)
    assert out.shape == (T * B, OUT_F)


@pytest.mark.parametrize("train", [False, True])
def test_gru_apply(train):
    params, state = seeded_trees(lambda k: j_rec.gru_init(k, IN_F, OUT_F, True), 5)
    kw = dict(out_f=OUT_F, time_steps=T)
    recurrent_matches(lambda p, s, x, tr: j_rec.gru_apply(p, s, x, train=tr, **kw),
                      lambda p, s, x, tr: t_rec.gru_apply(p, s, x, train=tr, **kw),
                      params, state, seq_input(6), train)


def test_time_steps_must_divide_the_batch():
    params, state = seeded_trees(lambda k: j_rec.lstm_init(k, IN_F, OUT_F, False), 0)
    x = np.zeros((T * B + 1, IN_F), np.float32)
    with pytest.raises(ValueError, match="not divisible by time_steps 3"):
        j_rec.lstm_apply(params, state, jnp.asarray(x), out_f=OUT_F, time_steps=T, train=False)
    with pytest.raises(ValueError, match="not divisible by time_steps 3"):
        t_rec.lstm_apply(port_tree(params), port_tree(state), torch.from_numpy(x),
                         out_f=OUT_F, time_steps=T, train=False)


def test_flatten_nhwc_is_the_references_order():
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 4, 5, 3)  # NHWC
    got = t_rec.flatten_nhwc(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_array_equal(got.numpy(), x.reshape(2, -1))
