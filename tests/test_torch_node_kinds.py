"""The darknet node kinds of ROADMAP A4 in yolodl_torch's builder against
yolodl_tpu's GraphModel: Reorg2D (plain, reverse, old), DarknetSam,
DarknetScaleChannels (SE and scale_wh), GlobalAvgPool2D, Identity, Dropout,
Softmax and Yolov1Detection, each on a small synthetic cfg, every node's
output compared (the reference's NHWC maps transposed to NCHW).  Channel
counts are ragged (5, 12, 13): no multiple of 8 hides an index-map error.

Tolerance: rtol 1e-4 with atol 1e-4 · max|ref|, as tests/test_torch_model.py.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import seeded_trees
from yolodl_tpu.config import darknet_cfg as j_dk
from yolodl_tpu.graph.from_darknet import graph_from_darknet as j_graph
from yolodl_tpu.models.builder import GraphModel as JGraphModel
from yolodl_torch.bridge import params_from_jax
from yolodl_torch.config import darknet_cfg as t_dk
from yolodl_torch.graph.from_darknet import graph_from_darknet as t_graph
from yolodl_torch.models import GraphModel

torch.set_num_threads(2)


def conv(filters, size=3, stride=1, act="leaky", bn=1):
    return (f"[convolutional]\nbatch_normalize={bn}\nfilters={filters}\nsize={size}\n"
            f"stride={stride}\npad=1\nactivation={act}\n")


def net(size=16, channels=3):
    return f"[net]\nwidth={size}\nheight={size}\nchannels={channels}\n"


CFGS = {
    "reorg_old": net() + conv(12) + "[reorg]\nstride=2\n" + conv(5, 1),
    "reorg_old_stride3": net(18) + conv(18) + "[reorg]\nstride=3\n",
    "reorg3d_plain": net() + conv(5) + "[reorg3d]\nstride=2\n" + conv(7, 1),
    "reorg3d_reverse": net() + conv(12) + "[reorg3d]\nstride=2\nreverse=1\n" + conv(5, 1),
    "reorg_old_reverse": net() + conv(20) + "[reorg]\nstride=2\nreverse=1\n",
    "sam": net() + conv(6) + conv(6, act="logistic") + "[sam]\nfrom=-2\n" + conv(5, 1),
    "scale_channels_se": (net() + conv(6) + "[avgpool]\n" + conv(6, 1, act="logistic", bn=0)
                          + "[scale_channels]\nfrom=-3\n" + conv(5, 1)),
    "scale_channels_wh": (net() + conv(6) + conv(1, 1, act="logistic", bn=0)
                          + "[scale_channels]\nfrom=-2\nscale_wh=1\n"),
    "avgpool_softmax_cost": (net() + conv(10) + "[avgpool]\n" + "[softmax]\ngroups=1\n"
                             + "[cost]\ntype=sse\n"),
    "softmax_4d": net() + conv(13) + "[softmax]\n",
    "dropout": net() + conv(6) + "[dropout]\nprobability=.25\n" + conv(5, 1),
    # 4 x 4 cells, 3 classes, 2 boxes: 13 channels = 3 + 2 * 5
    "detection": net() + conv(13, 3, 4, act="linear") + "[detection]\nclasses=3\nside=4\nnum=2\n",
    "detection_softmax": (net() + conv(13, 3, 4, act="linear")
                          + "[detection]\nclasses=3\nside=4\nnum=2\nsoftmax=1\n"),
}


def build_pair(text, seed=0):
    """(reference model, params, state, port model) with the same seeded
    weights, BN statistics away from init."""
    jm = JGraphModel(j_graph(j_dk.Darknet.from_str(text)), spd_stem="off")
    params, state = seeded_trees(jm.init, seed)
    tm = GraphModel(t_graph(t_dk.Darknet.from_str(text)), device="cpu")
    tm.load_state_dict(params_from_jax(params, state))
    return jm, params, state, tm


def nchw(a):
    a = np.asarray(a)
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a


def assert_nodes_match(jm, params, state, tm, x):
    """Every tensor node of the graph: port = reference (NCHW)."""
    _, _, named = jm.apply(params, state, x, train=False, return_intermediates=True)
    keys = tuple(k for k in tm.graph.order if tm.graph.nodes[k].output_shape.is_tensor)
    with torch.no_grad():
        outs = tm(torch.from_numpy(x), output_keys=keys)
    checked = 0
    for key in keys:
        name = tm._pname[key]
        if name not in named:
            continue
        r, o = nchw(named[name]), outs[key].numpy()
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4 * np.abs(r).max() + 1e-7,
                                   err_msg=name)
        checked += 1
    assert checked == len(keys)
    return outs


@pytest.mark.parametrize("name", sorted(CFGS))
def test_node_kind_matches_reference(name):
    jm, params, state, tm = build_pair(CFGS[name])
    size = jm.graph.nodes[jm.graph.order[0]].output_shape.tensor_shape()[2].size
    x = np.random.default_rng(1).uniform(0, 1, (2, 3, size, size)).astype(np.float32)
    outs = assert_nodes_match(jm, params, state, tm, x)
    last = outs[tm.graph.order[-1]]
    assert torch.isfinite(last).all()
    if name.startswith("detection"):
        assert tuple(last.shape) == (2, 16 * 13)


def test_reorg_modes_are_index_maps():
    """Each mode moves values without changing them: the plain and reverse
    modes are inverse, and the old mode is a permutation of its input."""
    from yolodl_torch.models.builder import _reorg
    from yolodl_torch.config import newslab as cfg

    x = torch.arange(2 * 12 * 6 * 4, dtype=torch.float32).reshape(2, 12, 6, 4)
    plain = _reorg(x, cfg.Reorg2D(stride=2, old=False))
    assert plain.shape == (2, 48, 3, 2)
    back = _reorg(plain, cfg.Reorg2D(stride=2, old=False, reverse=True))
    assert torch.equal(back, x)
    old = _reorg(x, cfg.Reorg2D(stride=2, old=True))
    assert old.shape == (2, 48, 3, 2)
    assert torch.equal(old.flatten().sort().values, x.flatten().sort().values)


def test_dropout_uses_the_generator_only_in_training():
    _, _, _, tm = build_pair(CFGS["dropout"])
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 3, 16, 16))
                         .astype(np.float32))
    keys = (1, 2)  # the conv's output, the dropout's
    assert [tm.graph.nodes[k].config.kind for k in keys] == ["ConvBn2D", "Dropout"]
    with torch.no_grad():
        eval_out = tm(x, output_keys=keys, generator=torch.Generator().manual_seed(0))
        no_gen = tm(x, output_keys=keys, train=True)
        a = tm(x, output_keys=keys, train=True, generator=torch.Generator().manual_seed(5))
        b = tm(x, output_keys=keys, train=True, generator=torch.Generator().manual_seed(5))
    assert torch.equal(eval_out[2], eval_out[1])
    assert torch.equal(no_gen[2], no_gen[1])
    assert torch.equal(a[2], b[2])
    h, d = a[1], a[2]
    kept = d != 0
    torch.testing.assert_close(d[kept], h[kept] / 0.75, rtol=1e-6, atol=0)
    share = float(kept.float().mean())
    assert 0.65 < share < 0.85


def test_norm_helpers_match_reference():
    from yolodl_tpu.ops import norm as j_norm
    from yolodl_torch.ops import norm as t_norm

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 7, 12)).astype(np.float32)  # NHWC
    params = {"scale": rng.uniform(0.5, 1.5, 12).astype(np.float32),
              "bias": rng.normal(size=12).astype(np.float32)}
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    for p, tp_ in ((params, tp), ({}, {})):
        ref = np.asarray(j_norm.instance_norm_apply(p, x))
        out = t_norm.instance_norm_apply(tp_, tx).numpy().transpose(0, 2, 3, 1)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        for groups in (1, 3, 4):
            ref = np.asarray(j_norm.group_norm_apply(p, x, groups))
            out = t_norm.group_norm_apply(tp_, tx, groups).numpy().transpose(0, 2, 3, 1)
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        t_norm.group_norm_apply({}, tx, 5)


def test_flat_instance_maps_match_reference():
    from yolodl_tpu.ops import detect as j_detect
    from yolodl_torch.ops import detect as t_detect

    dims = [(3, 8, 6), (3, 4, 3), (2, 2, 2)]
    j_infos, t_infos, begin = [], [], 0
    for a, h, w in dims:
        anchors = tuple((0.1 * (i + 1), 0.1) for i in range(a))
        kw = dict(feature_h=h, feature_w=w, anchors=anchors, flat_begin=begin,
                  flat_end=begin + a * h * w)
        j_infos.append(j_detect.DetectionInfo(**kw))
        t_infos.append(t_detect.DetectionInfo(**kw))
        begin += a * h * w
    for flat in range(begin):
        inst = t_detect.flat_to_instance(t_infos, flat)
        assert inst == j_detect.flat_to_instance(j_infos, flat)
        assert t_detect.instance_to_flat(t_infos, *inst) == flat
    anchor, row, col = torch.tensor([0, 2, 1]), torch.tensor([1, 7, 3]), torch.tensor([5, 0, 2])
    ref = j_detect.instance_to_flat(j_infos, 0, anchor.numpy(), row.numpy(), col.numpy())
    np.testing.assert_array_equal(
        t_detect.instance_to_flat(t_infos, 0, anchor, row, col).numpy(), np.asarray(ref))
    with pytest.raises(IndexError):
        t_detect.flat_to_instance(t_infos, begin)


def test_recurrent_and_dense_kinds_still_name_a12():
    """The dense and recurrent kinds raised naming ROADMAP A12 until they
    were ported; now a [connected] after a conv (with and without BN) and a
    [crnn] after a [connected] build and match the reference node by node
    (tests/test_torch_linear.py and test_torch_recurrent*.py hold the rest)."""
    text = (net(8) + conv(4) + "[connected]\noutput=10\nbatch_normalize=1\n"
            "activation=leaky\n" + "[crnn]\nbatch_normalize=1\nsize=1\npad=0\noutput=6\n"
            "hidden=5\nactivation=leaky\n" + "[connected]\noutput=3\nactivation=linear\n")
    jm, params, state, tm = build_pair(text, 3)
    assert {"Linear", "DarknetCrnn"} <= {n.config.kind for n in tm.graph.nodes.values()}
    x = np.random.default_rng(4).uniform(0, 1, (2, 3, 8, 8)).astype(np.float32)
    outs = assert_nodes_match(jm, params, state, tm, x)
    assert tuple(outs[tm.graph.order[-1]].shape) == (2, 3)
