"""Loss parameters from darknet cfgs: the port's ``head_params_from_darknet``,
``region_params_from_darknet`` and ``v1_params_from_darknet`` (reading the
port's own ``config/darknet_cfg.py``) against the reference's on the
repo's cfgs — every field equal, ``counters_per_class`` multipliers and
the ``total_anchors`` truncation included — and their cfg-time errors with
the reference's messages.
"""

import dataclasses
import os

import pytest

from _torch_parity import REPO
from yolodl_tpu.config import darknet_cfg as jdk
from yolodl_tpu.loss import darknet_loss as jl
from yolodl_torch.config import darknet_cfg as tdk
from yolodl_torch.loss import darknet_loss as tl

YOLO_CFGS = ["yolov4-csp", "Gaussian_yolov3_BDD", "yolov4", "yolov3", "yolov4-tiny",
             "yolov4x-mish", "cspx-p7-mish_hp", "yolov3.coco-giou-12", "yolov3_5l"]


def layers(mod, name, kind):
    net = mod.Darknet.load(os.path.join(REPO, "cfg", "darknet", f"{name}.cfg"))
    return net, [l for l in net.layers if isinstance(l, getattr(mod, kind))]


@pytest.mark.parametrize("name", YOLO_CFGS)
def test_head_params_match_reference(name):
    jnet, j_heads = layers(jdk, name, "Yolo")
    _, t_heads = layers(tdk, name, "Yolo")
    assert j_heads and len(j_heads) == len(t_heads)
    h, w, _ = jnet.net.input_shape_hwc
    for size in ((w, h), (w + 64, h + 64)):
        for jlay, tlay in zip(j_heads, t_heads):
            want = dataclasses.asdict(jl.head_params_from_darknet(jlay, *size))
            got = dataclasses.asdict(tl.head_params_from_darknet(tlay, *size))
            assert got == want
            assert (got["net_w"], got["net_h"]) == size


def test_head_params_of_the_slice_configs():
    """yolov4-csp at 608²: new_coords, ciou, iou_thresh 0.2, scale 2;
    Gaussian_yolov3_BDD at 512²: Gaussian, giou, iou_thresh 0.213."""
    _, csp = layers(tdk, "yolov4-csp", "Yolo")
    ps = [tl.head_params_from_darknet(l, 608, 608) for l in csp]
    assert len(ps) == 3 and all(p.new_coords and p.iou_loss == "ciou" and p.iou_thresh == 0.2
                                and p.scale_x_y == 2.0 and p.classes == 80 for p in ps)
    _, bdd = layers(tdk, "Gaussian_yolov3_BDD", "Yolo")
    ps = [tl.head_params_from_darknet(l, 512, 512) for l in bdd]
    assert len(ps) == 3 and all(p.gaussian and p.iou_loss == "giou" and p.iou_thresh == 0.213
                                and p.classes == 10 and p.entries == 19 for p in ps)


@pytest.mark.parametrize("name,kind,fn", [
    ("yolo-voc", "Region", "region_params_from_darknet"),
    ("tiny-yolo", "Region", "region_params_from_darknet"),
    ("t1.test", "Detection", "v1_params_from_darknet"),
])
def test_region_and_v1_params_match_reference(name, kind, fn):
    _, j_layers = layers(jdk, name, kind)
    _, t_layers = layers(tdk, name, kind)
    assert j_layers
    for jlay, tlay in zip(j_layers, t_layers):
        try:
            want = dataclasses.asdict(getattr(jl, fn)(jlay))
        except NotImplementedError as e:
            with pytest.raises(NotImplementedError, match=str(e)[:30]):
                getattr(tl, fn)(tlay)
            continue
        assert dataclasses.asdict(getattr(tl, fn)(tlay)) == want


YOLO_SECTION = """[net]
width=64
height=64
channels=3
[convolutional]
filters={filters}
size=1
activation=linear
[{section}]
mask=0,1,2
anchors=6,8, 10,14, 18,24
classes=3
num=3
{extra}
"""


@pytest.mark.parametrize("section,extra,filters,error", [
    ("Gaussian_yolo", "new_coords=1", 36, ValueError),
    ("yolo", "counters_per_class=10,20", 24, ValueError),
    ("yolo", "yolo_point=left_top", 24, NotImplementedError),
])
def test_head_params_errors_match_reference(section, extra, filters, error):
    text = YOLO_SECTION.format(section=section, extra=extra, filters=filters)
    (jlay,) = [l for l in jdk.Darknet.from_str(text).layers if isinstance(l, jdk.Yolo)]
    (tlay,) = [l for l in tdk.Darknet.from_str(text).layers if isinstance(l, tdk.Yolo)]
    with pytest.raises(error) as want:
        jl.head_params_from_darknet(jlay, 64, 64)
    with pytest.raises(error) as got:
        tl.head_params_from_darknet(tlay, 64, 64)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fields,error", [
    (dict(gaussian=True, new_coords=True), ValueError),
    (dict(iou_loss="l1"), ValueError),
    (dict(iou_thresh_kind="l2"), ValueError),
    (dict(classes_multipliers=(1.0,)), ValueError),
])
def test_params_validation_matches_reference(fields, error):
    base = dict(anchors=((6, 8),), mask=(0,), classes=3, net_w=64, net_h=64)
    with pytest.raises(error) as want:
        jl.DarknetHeadParams(**base, **fields)
    with pytest.raises(error) as got:
        tl.DarknetHeadParams(**base, **fields)
    assert str(got.value) == str(want.value)
