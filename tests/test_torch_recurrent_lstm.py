"""yolodl_torch/ops/recurrent.py against yolodl_tpu/ops/recurrent.py, part
2: lstm_apply (with and without BN) and crnn_apply after a conv (a 4-D
map, shortcut) and after a connected layer (a 2-D input, a 1×1 map), in
train and eval mode, on seeded inputs and parameters; sizes and
tolerances as part 1 (test_torch_recurrent.py)."""

import numpy as np
import pytest
import torch

from _torch_parity import recurrent_matches, seeded_trees
from yolodl_torch.config import newslab as t_cfg
from yolodl_torch.models.builder import crnn_sub_cfgs
from yolodl_torch.ops import recurrent as t_rec
from yolodl_tpu.config import newslab as j_cfg
from yolodl_tpu.models.builder import GraphModel as JGraphModel
from yolodl_tpu.ops import conv as j_conv
from yolodl_tpu.ops import recurrent as j_rec

torch.set_num_threads(2)

T, B, IN_F, HID, OUT_F = 3, 8, 7, 5, 6


@pytest.mark.parametrize("bn,train", [(True, False), (True, True), (False, True)])
def test_lstm_apply(bn, train):
    params, state = seeded_trees(lambda k: j_rec.lstm_init(k, IN_F, OUT_F, bn), 7)
    x = np.random.default_rng(8).normal(size=(T * B, IN_F)).astype(np.float32)
    kw = dict(out_f=OUT_F, time_steps=T)
    recurrent_matches(lambda p, s, x, tr: j_rec.lstm_apply(p, s, x, train=tr, **kw),
                      lambda p, s, x, tr: t_rec.lstm_apply(p, s, x, train=tr, **kw),
                      params, state, x, train)


def crnn_case(in_c, k, p, shortcut, seed):
    """(reference params, state, reference fn, port fn) of a [crnn] with
    hidden HID and OUT_F outputs; each package's sub-conv geometry comes
    from its own builder (the reference's ``GraphModel._crnn_sub_cfgs``,
    the port's ``crnn_sub_cfgs``)."""
    fields = dict(out=OUT_F, hidden=HID, k=k, p=p, act="leaky", bn=True, time_steps=T)
    j_subs = JGraphModel._crnn_sub_cfgs(j_cfg.DarknetCrnn(**fields))
    t_subs = crnn_sub_cfgs(t_cfg.DarknetCrnn(**fields))

    def init(key):
        trees = {name: j_conv.conv_bn_init(key, sub, in_c if name == "input" else HID)
                 for name, sub in j_subs.items()}
        return {n: t[0] for n, t in trees.items()}, {n: t[1] for n, t in trees.items()}

    params, state = seeded_trees(init, seed)
    kw = dict(hidden=HID, shortcut=shortcut, time_steps=T)
    return (params, state,
            lambda p, s, x, tr: j_rec.crnn_apply(p, s, x, sub_cfgs=j_subs, train=tr, **kw),
            lambda p, s, x, tr: t_rec.crnn_apply(p, s, x, sub_cfgs=t_subs, train=tr, **kw))


@pytest.mark.parametrize("train", [False, True])
def test_crnn_after_conv(train):
    params, state, j_fn, t_fn = crnn_case(4, 3, 1, True, 9)
    x = np.random.default_rng(10).normal(size=(T * B, 5, 6, 4)).astype(np.float32)  # NHWC
    out = recurrent_matches(j_fn, t_fn, params, state, x, train, nchw=True)
    assert out.shape == (T * B, 5, 6, OUT_F)


@pytest.mark.parametrize("train", [False, True])
def test_crnn_after_connected(train):
    """A 2-D input is a 1×1 map: ``[N, C]`` → ``[N, C, 1, 1]`` (NHWC
    ``[N, 1, 1, C]`` in the reference)."""
    params, state, j_fn, t_fn = crnn_case(IN_F, 1, 0, False, 11)

    def t_nhwc(p, s, x, tr):
        out, new_state = t_fn(p, s, x, tr)
        return out.permute(0, 2, 3, 1), new_state

    x = np.random.default_rng(12).normal(size=(T * B, IN_F)).astype(np.float32)
    out = recurrent_matches(j_fn, t_nhwc, params, state, x, train)
    assert out.shape == (T * B, 1, 1, OUT_F)
