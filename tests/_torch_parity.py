"""Shared set-up of the parity tests of the port (test_torch_*.py): the JAX
reference and the port with the same weights, random predictions and
targets, and the training tests' models, batches and step loops."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolodl_tpu.graph.from_darknet import load_darknet_graph as j_load
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_tpu.train import loop as j_loop
from yolodl_tpu.train.lr_schedule import LrScheduleConfig as JLr
from yolodl_torch.bridge import params_from_jax, params_to_jax
from yolodl_torch.graph.from_darknet import load_darknet_graph as t_load
from yolodl_torch.models import YoloModel
from yolodl_torch.train import loop as t_loop
from yolodl_torch.train.lr_schedule import LrScheduleConfig as TLr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def randomize_bn(params, state, seed):
    """Numpy copies of the reference trees with BN stats that keep the
    activation scale near 1 (scale ~1, var ~0.2 after a uniform-init conv)."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    for p in params.values():
        if "bn" in p:
            c = p["bn"]["scale"].shape[0]
            p["bn"]["scale"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
            p["bn"]["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
    for s in state.values():
        c = s["bn"]["mean"].shape[0]
        s["bn"]["mean"] = rng.normal(0, 0.05, c).astype(np.float32)
        s["bn"]["var"] = rng.uniform(0.1, 0.3, c).astype(np.float32)
    return params, state


def seeded_trees(init, seed):
    """Numpy (params, state) trees of the shapes ``init(key)`` gives,
    filled from ``np.random.default_rng(seed)`` without running ``init``
    (the reference's eager init takes seconds for a block and tens of
    seconds for a 100 M-parameter model): kernels uniform in ±1/√fan_in,
    conv biases in ±0.1, BN scale in [0.8, 1.2], bias N(0, 0.2), mean
    N(0, 0.05) and var in [0.15, 0.35], which keeps the activations of the
    act_bn NEWSLAB models near unit scale through 100+ layers."""
    rng = np.random.default_rng(seed)

    def fill(path, spec):
        name = path[-1].key
        in_bn = len(path) > 1 and getattr(path[-2], "key", None) == "bn"
        shape = spec.shape
        if name == "w":
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            value = rng.uniform(-bound, bound, shape)
        elif name == "b":
            value = rng.uniform(-0.1, 0.1, shape)
        elif in_bn and name == "scale":
            value = rng.uniform(0.8, 1.2, shape)
        elif in_bn and name == "bias":
            value = rng.normal(0, 0.2, shape)
        elif in_bn and name == "mean":
            value = rng.normal(0, 0.05, shape)
        elif in_bn and name == "var":
            value = rng.uniform(0.15, 0.35, shape)
        else:
            raise KeyError(f"no fill for {path}")
        return value.astype(np.float32)

    p_spec, s_spec = jax.eval_shape(init, jax.random.PRNGKey(0))
    return (jax.tree_util.tree_map_with_path(fill, p_spec),
            jax.tree_util.tree_map_with_path(fill, s_spec))


def flat_leaves(tree, prefix=""):
    """{'<node>/<sub>/…/<leaf>': np.ndarray} of a nested params or state
    tree, the reference's tree-path spelling."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def reference_and_port(cfg_name, seed=0):
    path = os.path.join(REPO, "cfg", "darknet", f"{cfg_name}.cfg")
    jm = JYoloModel(j_load(path), spd_stem="off")
    params, state = randomize_bn(*jm.init(jax.random.PRNGKey(seed)), seed)
    tm = YoloModel(t_load(path), device="cpu")
    tm.load_state_dict(params_from_jax(params, state))
    return jm, params, state, tm


NEWSLAB_MODELS = ("yolov4-csp-custom-64x64-2021-08-21", "yolov4-csp-custom-128x128-2021-07-17",
                  "yolov4-csp-custom-2021-03-08", "yolov4-csp-custom-2021-03-11",
                  "yolov4-csp-custom-2021-03-11-1", "yolov4-csp-custom-2021-03-11-2")


def small_newslab_spec():
    """A 16² graph of every NEWSLAB kind: stem 8² → DarkCsp2D → SppCsp2D →
    DeconvBn2D 16² → reflection pad → avg pool → conv 8², summed with a side
    branch and concatenated with the SppCsp2D output."""
    return {"main_group": "m", "groups": {"m": [
        {"name": "input", "kind": "Input", "shape": ["_", 3, 16, 16]},
        {"name": "stem", "kind": "ConvBn2D", "c": 8, "k": 3, "s": 2},
        {"name": "csp", "kind": "DarkCsp2D", "c": 8, "repeat": 2},
        {"name": "spp", "kind": "SppCsp2D", "c": 8, "k": [1, 3, 5]},
        {"name": "up", "kind": "DeconvBn2D", "c": 6, "k": 3, "s": 2, "op": 1},
        {"name": "pad", "kind": "DynamicPad2D", "pad_kind": "reflection",
         "t": 1, "b": 1, "l": 1, "r": 1},
        {"name": "pool", "kind": "MaxPool", "size": 3, "stride_y": 1, "stride_x": 1,
         "pool_kind": "avg"},
        {"name": "back", "kind": "ConvBn2D", "c": 6, "k": 3, "s": 2},
        {"name": "side", "kind": "ConvBn2D", "c": 6, "k": 1, "from": "spp"},
        {"name": "sum", "kind": "Sum2D", "from": ["back", "side"]},
        {"name": "cat", "kind": "Concat2D", "from": ["sum", "spp"]},
        {"name": "head", "kind": "Conv2D", "c": 2 * 7, "k": 1},
        {"name": "det", "kind": "Detect2D", "classes": 2, "anchors": [[0.3, 0.4], [0.6, 0.5]]},
        {"name": "output", "kind": "MergeDetect2D", "from": ["det"]},
    ]}}


def small_newslab_batch(seed):
    """A seeded (images, boxes, classes, mask) batch of two 16² images for
    :func:`small_newslab_spec`."""
    x = np.random.default_rng(seed).uniform(0, 1, (2, 3, 16, 16)).astype(np.float32)
    return (x, *random_targets(2, 4, seed, num_classes=2))


def newslab_reference_and_port(name, seed=0):
    """(reference model, params, state, port model) of ``cfg/model/<name>.json5``
    with seeded numpy trees (:func:`seeded_trees`) loaded into both."""
    from yolodl_tpu.graph import Graph as JGraph
    from yolodl_torch.graph import Graph as TGraph

    path = os.path.join(REPO, "cfg", "model", f"{name}.json5")
    jm = JYoloModel(JGraph.load_newslab_v1_json(path), spd_stem="off")
    params, state = seeded_trees(jm.init, seed)
    tm = YoloModel(TGraph.load_newslab_v1_json(path), device="cpu")
    params_from_jax(params, state, model=tm)
    return jm, params, state, tm


NEWSLAB_STEP_CASES = {"sgd": dict(optimizer="sgd", lr=3e-4),
                      "adamw": dict(optimizer="adam", lr=1e-5, weight_decay=5e-4)}


def newslab_one_step_matches(name, case):
    """One step of ``cfg/model/<name>.json5`` in both packages from the same
    seeded trees; see test_torch_newslab_train.py for the tolerances."""
    jm, params, state, tm = newslab_reference_and_port(name)
    rng = np.random.default_rng(11)
    batch = (rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32),
             *random_targets(2, 8, 12, num_classes=tm.num_classes))
    j_cfg, t_cfg = train_configs(**NEWSLAB_STEP_CASES[case])
    j_ts, j_losses = train_reference(jm, params, state, j_cfg, [batch])
    t_ts, t_losses = train_port(tm, t_cfg, [batch])
    assert t_ts.step == 1 and np.isfinite(j_losses[0])
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    t_params, t_state = params_to_jax(tm.state_dict())
    jp, tp = flat_leaves(j_ts.params), flat_leaves(t_params)
    assert jp.keys() == tp.keys()
    tol = 3e-4 if case == "sgd" else 1e-2
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0,
                                   atol=tol * float(np.abs(jp[k]).max()), err_msg=k)
    js, ts = flat_leaves(j_ts.state), flat_leaves(t_state)
    assert js.keys() == ts.keys()
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=0,
                                   atol=1e-4 * float(np.abs(js[k]).max()), err_msg=k)


def head_infos(cfg_name, size=64):
    """(port infos, reference infos, num_classes) of a darknet cfg's detect
    heads at ``size``², read from one port forward on zeros."""
    from yolodl_tpu.ops.detect import DetectionInfo as JInfo

    path = os.path.join(REPO, "cfg", "darknet", f"{cfg_name}.cfg")
    tm = YoloModel(t_load(path), device="cpu")
    with torch.no_grad():
        pred = tm(torch.zeros((1, 3, size, size)))
    j_infos = tuple(JInfo(**{f: getattr(i, f) for f in
                             ("feature_h", "feature_w", "anchors", "flat_begin",
                              "flat_end", "class_act")}) for i in pred.infos)
    return pred.infos, j_infos, pred.num_classes


def random_prediction(infos, j_infos, num_classes, batch, seed, sigmas=False):
    """The same random MergedDetection for the port and the reference:
    boxes inside the image with positive sizes, normal logits."""
    from yolodl_tpu.ops.detect import MergedDetection as JMerged
    from yolodl_torch.ops.detect import MergedDetection as TMerged

    rng = np.random.default_rng(seed)
    n = infos[-1].flat_end
    arrays = {
        "cycxhw": np.concatenate([rng.uniform(0.1, 0.9, (batch, n, 2)),
                                  rng.uniform(0.02, 0.5, (batch, n, 2))], -1),
        "obj_logit": rng.normal(0, 2, (batch, n)),
        "class_logit": rng.normal(0, 2, (batch, n, num_classes)),
    }
    if sigmas:
        arrays["sigmas"] = rng.uniform(0.05, 1.0, (batch, n, 4))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    j_pred = JMerged(infos=j_infos, **{k: jnp.asarray(v) for k, v in arrays.items()})
    t_pred = TMerged(infos=infos, **{k: torch.from_numpy(v) for k, v in arrays.items()})
    return arrays, j_pred, t_pred


def random_targets(batch, max_gt, seed, num_classes=80):
    """bench.py's synthetic ground truth: centres in [0.2, 0.8], sizes in
    [0.05, 0.3], random classes; the last two boxes of image 0 masked off."""
    rng = np.random.default_rng(seed)
    boxes = rng.uniform(0.2, 0.8, (batch, max_gt, 4)).astype(np.float32)
    boxes[..., 2:] = rng.uniform(0.05, 0.3, (batch, max_gt, 2))
    classes = rng.integers(0, num_classes, (batch, max_gt)).astype(np.int32)
    mask = np.ones((batch, max_gt), bool)
    mask[0, -2:] = False
    return boxes, classes, mask


def named_leaves(tree):
    """{'<node>/<leaf>' or '<node>/bn/<leaf>': np.ndarray} of a reference
    params or state tree (the spelling of the reference's tree paths)."""
    out = {}
    for path, node in tree.items():
        for k, v in node.items():
            if isinstance(v, dict):
                out.update({f"{path}/{k}/{kk}": np.asarray(vv) for kk, vv in v.items()})
            else:
                out[f"{path}/{k}"] = np.asarray(v)
    return out


def assert_forward_matches(cfg_name, size=64, models=None):
    """Port and reference forward on the same seeded input, NCHW and NHWC:
    rtol 1e-4 with atol 1e-4 * max|ref| (f32 convolutions sum in another
    order, and the difference grows with depth).  ``models`` is a
    (reference, params, state, port) tuple; the darknet cfg's by default."""
    jm, params, state, tm = models or reference_and_port(cfg_name)
    x = np.random.default_rng(1).uniform(0, 1, (2, 3, size, size)).astype(np.float32)
    ref, _ = jax.jit(lambda p, s, x: jm.apply(p, s, x, train=False))(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
        out_nhwc = tm(torch.from_numpy(x).permute(0, 2, 3, 1), data_format="NHWC")
    for f in ("cycxhw", "obj_logit", "class_logit"):
        r = np.asarray(getattr(ref, f))
        o = getattr(out, f).numpy()
        assert o.shape == r.shape
        assert np.abs(r).max() > 0.05, f"{f}: activations collapsed"
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4 * np.abs(r).max())
        np.testing.assert_array_equal(getattr(out_nhwc, f).numpy(), o)
    assert [i.feature_h for i in out.infos] == [i.feature_h for i in ref.infos]


# -- the training tests' set-up: yolov4-tiny at 64², batch 2, f32

TRAIN_B, TRAIN_SIZE, TRAIN_MAX_GT = 2, 64, 8


def train_batches(n, seed=0):
    """``n`` seeded (images, boxes, classes, mask) numpy batches."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        images = rng.uniform(0, 1, (TRAIN_B, 3, TRAIN_SIZE, TRAIN_SIZE)).astype(np.float32)
        out.append((images, *random_targets(TRAIN_B, TRAIN_MAX_GT, seed * 100 + i)))
    return out


def train_configs(**kw):
    """(reference, port) TrainConfigs with a constant lr ``kw["lr"]``."""
    lr = kw.pop("lr")
    return (j_loop.TrainConfig(lr=JLr(kind="constant", lr=lr), **kw),
            t_loop.TrainConfig(lr=TLr(kind="constant", lr=lr), **kw))


_TRAIN_MODELS = {}


def train_models():
    """One reference model and one port model per worker; every test
    reloads the port's weights from the shared numpy trees."""
    if not _TRAIN_MODELS:
        _TRAIN_MODELS["v"] = reference_and_port("yolov4-tiny")
    jm, params, state, tm = _TRAIN_MODELS["v"]
    params_from_jax(params, state, tm)
    return jm, params, state, tm


def train_reference(jm, params, state, j_cfg, batches, accum=1):
    """The reference's train step over ``batches`` → (TrainState, losses)."""
    opt = j_loop.make_optimizer(j_cfg)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    ts = j_loop.TrainState(p, jax.tree_util.tree_map(jnp.asarray, state), opt.init(p),
                           jnp.zeros((), jnp.int32), None)
    step = j_loop.make_train_step(jm, opt, j_cfg, accum=accum)
    losses = []
    for batch in batches:
        ts, m = step(ts, *map(jnp.asarray, batch))
        losses.append(float(m["total_loss"]))
    return ts, losses


def train_port(tm, t_cfg, batches, accum=1):
    """The port's train step over ``batches`` → (TrainState, losses)."""
    ts, opt = t_loop.train_init(tm, t_cfg)
    step = t_loop.make_train_step(tm, opt, t_cfg, accum=accum)
    losses = []
    for batch in batches:
        ts, m = step(ts, *map(torch.from_numpy, batch))
        losses.append(float(m["total_loss"]))
    return ts, losses


# -- the inference CLIs' and evaluator's workspace: a CSV dataset of random
# images at mixed original sizes, 80 COCO class names

ORIGINAL_SIZES = [(48, 64), (72, 128), (64, 64), (38, 50)]  # h x w


def coco_names():
    with open(os.path.join(REPO, "cfg", "class", "coco.class")) as f:
        return [line.strip() for line in f if line.strip()]


def write_csv_dataset(root, n, seed, rows=None):
    """``n`` random PNG images under ``root/images`` at ORIGINAL_SIZES in
    turn, ``root/classes.txt`` and ``root/label.csv``.  ``rows`` maps an
    image index to its (class index, cy, cx, h, w) pixel boxes; without it
    each image gets one random box.  Returns [(path, h, w)]."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    names = coco_names()
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    with open(os.path.join(root, "classes.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    images, lines = [], ["image_file,class_name,cy,cx,h,w"]
    for i in range(n):
        h, w = ORIGINAL_SIZES[i % len(ORIGINAL_SIZES)]
        path = os.path.join(root, "images", f"im{i:02d}.png")
        if not os.path.exists(path):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)
        images.append((path, h, w))
        boxes = rows.get(i, []) if rows is not None else [
            (int(rng.integers(80)), h / 2, w / 2, h / 3, w / 3)]
        for cls, cy, cx, bh, bw in boxes:
            lines.append(f"im{i:02d}.png,{names[cls]},{cy},{cx},{bh},{bw}")
    with open(os.path.join(root, "label.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return images


def rows_from_detections(images, dets_per_image, size, seed, keep=3):
    """Ground truth that makes AP non-trivial: the ``keep`` best detections
    of each image (``to_host_detections`` entries, letterbox-frame ratio
    boxes) mapped to original pixels and clipped, plus one random box that
    no detection matches."""
    from yolodl_torch.data.letterbox import letterbox_unit_transform

    rng = np.random.default_rng(seed)
    rows = {}
    for i, ((_, h, w), dets) in enumerate(zip(images, dets_per_image)):
        inv = letterbox_unit_transform((h, w), (size, size)).inverse()
        out = []
        for det in dets[:keep]:
            t, l, b, r = inv.apply_tlbr(np.asarray([det["tlbr"]], np.float64))[0]
            t, b = np.clip([t, b], 0, 1) * h
            l, r = np.clip([l, r], 0, 1) * w
            if b - t > 1 and r - l > 1:
                out.append((det["class"], (t + b) / 2, (l + r) / 2, b - t, r - l))
        out.append((int(rng.integers(80)), h * 0.3, w * 0.6, h * 0.2, w * 0.25))
        rows[i] = out
    return rows


# -- the training CLIs' workspace


def write_train_workspace(root, **training):
    """The tests/test_cli.py-style training workspace under ``root``: six
    48² PNGs with a red square as a CSV set, a three-conv NEWSLAB model at
    32², mosaic and colour jitter on; ``training`` entries override the
    config's.  Returns the path of its train.json5."""
    from PIL import Image

    rng = np.random.default_rng(0)
    (root / "images").mkdir(parents=True)
    for i in range(6):
        arr = rng.uniform(0, 255, (48, 48, 3)).astype(np.uint8)
        arr[10:30, 10:30] = (255, 0, 0)
        Image.fromarray(arr).save(root / "images" / f"i{i}.png")
    (root / "classes.txt").write_text("square\n")
    (root / "label.csv").write_text("\n".join(
        ["image_file,class_name,cy,cx,h,w"] + [f"i{i}.png,square,20,20,20,20" for i in range(6)])
        + "\n")
    model = {"main_group": "m", "groups": {"m": [
        {"name": "input", "kind": "Input", "shape": ["_", 3, 32, 32]},
        {"kind": "ConvBn2D", "c": 8, "k": 3, "s": 2},
        {"kind": "ConvBn2D", "c": 12, "k": 3, "s": 2},
        {"name": "head", "kind": "ConvBn2D", "c": 6, "k": 1, "act": "linear",
         "bn": {"enabled": False}},
        {"name": "det", "kind": "Detect2D", "classes": 1, "anchors": [[0.4, 0.4]]},
        {"name": "output", "kind": "MergeDetect2D", "from": ["det"]},
    ]}}
    (root / "model.json5").write_text(json.dumps(model))
    config = {
        "version": "0.1.0",
        "model": {"kind": "NewslabV1", "cfg_file": "model.json5"},
        "dataset": {"kind": {"type": "Csv", "image_size": 32, "input_channels": 3,
                             "image_dir": str(root / "images"),
                             "label_file": str(root / "label.csv"),
                             "classes_file": str(root / "classes.txt")}},
        "logging": {"dir": str(root / "logs")},
        "preprocessor": {
            "mixup": {"mosaic_prob": 0.5, "mosaic_margin": 0.3},
            "color_jitter": {"hue_shift": 0.05, "saturation_shift": 0.1, "value_shift": 0.1},
            "cleanse": {"out_of_bound_tolerance": 5, "min_bbox_size": 0.01},
        },
        "training": {
            "batch_size": 2,
            "device_config": {"type": "SingleDevice", "device": "cuda:0"},
            "optimizer": {"momentum": 0.9, "weight_decay": 0.0005,
                          "lr_schedule": {"type": "StepWise",
                                          "steps": [[0, 0.005], [100, 0.001]]}},
            "loss": {"box_metric": "DIoU"},
            "load_checkpoint": {"type": "Disabled"},
            **training,
        },
        "benchmark": {"nms_iou_thresh": 0.5, "nms_conf_thresh": 0.4},
    }
    path = root / "train.json5"
    path.write_text(json.dumps(config))
    return str(path)


def run_main(module, config, *args):
    """``module.main`` in this process; its signal handlers are put back."""
    import signal

    saved = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        return module.main(["--config-file", config, *args])
    finally:
        for s, handler in saved.items():
            signal.signal(s, handler)


# -- the darknet-exact loss: seeded heads, truths and the reference's values


def darknet_params_pair(**fields):
    """(reference, port) DarknetHeadParams with the same fields."""
    from yolodl_tpu.loss import darknet_loss as jl
    from yolodl_torch.loss import darknet_loss as tl

    return jl.DarknetHeadParams(**fields), tl.DarknetHeadParams(**fields)


def darknet_inputs(params, sizes, batch=2, truths=12, real=8, seed=0, scale=1.0):
    """Seeded NCHW raw head outputs ``[B, A·E, H, W]`` (one per entry of
    ``sizes``) and truth rows ``[B, T, 5]``: ``real`` rows, then zeros (the
    `!truth.x` break).  Half of the real rows are the decoded prediction
    of a random cell of the first head, moved by 1 % of its size and
    widened by 3 %, so that the ignore, truth_thresh and recall branches
    see IoUs near 1 (an exact copy would sit on dx_box_iou's corner ties,
    where one ulp of exp switches the branch); the other half are random
    boxes.  Image 0's third-last real row gets x = 0 (darknet's `!truth.x`
    break: the rows after it are skipped too) and the last real row of
    image 1 class -1 (skipped by the class-range check)."""
    from yolodl_tpu.loss import darknet_loss as jl

    rng = np.random.default_rng(seed)
    raws = [rng.normal(0, scale, (batch, p.num_anchors * p.entries, fh, fw)).astype(np.float32)
            for p, (fh, fw) in zip(params, sizes)]
    p0, (fh, fw) = params[0], sizes[0]
    raw0 = raws[0].reshape(batch, p0.num_anchors, p0.entries, fh, fw).transpose(0, 1, 3, 4, 2)
    truth = np.zeros((batch, truths, 5), np.float32)
    for b in range(batch):
        bx, by, bw, bh = (np.asarray(v) for v in jl._pred_boxes(
            jl._activate(jnp.asarray(raw0[b]), p0), p0))
        for t in range(real):
            if t % 2 == 0:
                a, y, x = (int(rng.integers(n)) for n in (p0.num_anchors, fh, fw))
                box = [bx[a, y, x] + 0.01 * bw[a, y, x], by[a, y, x] - 0.01 * bh[a, y, x],
                       bw[a, y, x] * 1.03, bh[a, y, x] * 1.03]
                if not (0.0 < box[0] < 1.0 and 0.0 < box[1] < 1.0
                        and 0.01 < box[2] < 0.95 and 0.01 < box[3] < 0.95):
                    box = list(rng.uniform([0.1, 0.1, 0.05, 0.05], [0.9, 0.9, 0.6, 0.6]))
            else:
                box = list(rng.uniform([0.05, 0.05, 0.02, 0.02], [0.95, 0.95, 0.7, 0.7]))
            truth[b, t] = box + [int(rng.integers(p0.classes))]
    if real > 3:
        truth[0, real - 3, 0] = 0.0
    if batch > 1 and real > 1:
        truth[1, real - 1, 4] = -1
    return raws, truth


def darknet_reference(j_params, raws, truth, plain=False, dtype="float32"):
    """The reference on ``raws`` (NCHW numpy) and ``truth``, in one jit: per
    head the per-image ``_head_deltas(stats=True)`` (delta, tot, count,
    telemetry), and ``darknet_detection_loss_with_metrics`` with its
    gradient (NCHW); with ``plain`` also ``darknet_detection_loss`` and its
    gradient (each loss compiles its own scan, about a second a head)."""
    from yolodl_tpu.loss import darknet_loss as jl

    params = tuple(j_params)

    def ref(rs, tr):
        heads = tuple(
            jax.vmap(lambda x, y, p=p: jl._head_deltas(x, y, p, stats=True))(
                jl.reshape_head_raw(r, p), tr)
            for r, p in zip(rs, params))
        (mloss, metrics), mgrad = jax.value_and_grad(
            lambda r_: jl.darknet_detection_loss_with_metrics(r_, tr, params),
            has_aux=True)(rs)
        out = (heads, mloss, metrics, mgrad)
        if plain:
            out += jax.value_and_grad(lambda r_: jl.darknet_detection_loss(r_, tr, params))(rs)
        return out

    # bf16 raws: the reference's train step casts them to f32 before the loss
    nhwc = tuple(jnp.asarray(r.transpose(0, 2, 3, 1)).astype(dtype).astype(jnp.float32)
                 for r in raws)
    out = jax.jit(ref)(nhwc, jnp.asarray(truth))
    to_nchw = lambda gs: [np.asarray(g, np.float32).transpose(0, 3, 1, 2) for g in gs]
    heads, mloss, metrics, mgrad = out[:4]
    ref = {"heads": jax.tree_util.tree_map(np.asarray, heads),
           "metrics_loss": float(mloss),
           "metrics": {k: np.asarray(v) for k, v in metrics.items()},
           "metrics_grad": to_nchw(mgrad)}
    if plain:
        ref["loss"], ref["grad"] = float(out[4]), to_nchw(out[5])
    return ref


def assert_darknet_matches(j_params, t_params, raws, truth, delta_tol=1e-5, cost_rtol=1e-5,
                           plain=False, dtype="float32", grad_tol=None):
    """The port against the reference on the same inputs, f32: every
    head's delta within ``delta_tol`` · max|ref| and its telemetry counts
    (applications, recall) exact, the sums rel 1e-5; both losses within
    ``cost_rtol`` and their gradients within ``delta_tol`` · max|ref|;
    the metrics' counts exact.  The port's ``darknet_detection_loss`` is
    held against the reference's (``plain``) or, to save its compile,
    against the reference's ``darknet_detection_loss_with_metrics``, whose
    value and gradient the reference defines as the same.  Returns the
    reference's values.  With ``dtype="bfloat16"`` both get the same
    bf16-rounded raws: the port's loss computes in f32, as the reference's
    train step does after casting them; the port's gradient is then bf16
    (``grad_tol`` replaces ``delta_tol`` for the gradients)."""
    from yolodl_torch.loss import darknet_loss as tl

    ref = darknet_reference(j_params, raws, truth, plain=plain, dtype=dtype)
    tr = torch.from_numpy(truth)
    as_port = lambda r: torch.from_numpy(r).to(getattr(torch, dtype))
    for k, (p, raw) in enumerate(zip(t_params, raws)):
        delta, tot, cnt, stats = tl._head_deltas(
            tl.reshape_head_raw(as_port(raw), p), tr, p, stats=True)
        j_delta, j_tot, j_cnt, j_stats = ref["heads"][k]
        scale = float(np.abs(j_delta).max())
        np.testing.assert_allclose(delta.numpy(), j_delta, rtol=0, atol=delta_tol * scale,
                                   err_msg=f"head {k} delta")
        np.testing.assert_array_equal(cnt.numpy(), j_cnt, err_msg=f"head {k} count")
        np.testing.assert_allclose(tot.numpy(), j_tot, rtol=1e-5, atol=1e-5,
                                   err_msg=f"head {k} tot_iou_loss")
        for name, got, want in zip(("tot_iou", "recall50", "recall75", "obj_sum", "cat_sum",
                                    "sobj_sum"), stats, j_stats):
            if name.startswith("recall"):
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"head {k} {name}")
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                           err_msg=f"head {k} {name}")
    for with_metrics in (False, True):
        rs = [as_port(r).requires_grad_() for r in raws]
        if with_metrics:
            loss, metrics = tl.darknet_detection_loss_with_metrics(rs, tr, t_params)
            want_loss, want_grad = ref["metrics_loss"], ref["metrics_grad"]
            for key, want in ref["metrics"].items():
                got = metrics[key].detach().numpy()
                assert not metrics[key].requires_grad, key
                if key == "num_matched":
                    assert got.dtype == np.int32 and int(got) == int(want), (key, got, want)
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=key)
        else:
            loss = tl.darknet_detection_loss(rs, tr, t_params)
            key = "" if plain else "metrics_"
            want_loss, want_grad = ref[key + "loss"], ref[key + "grad"]
        assert float(loss.detach()) == pytest.approx(want_loss, rel=cost_rtol)
        loss.backward()
        for k, (r, want) in enumerate(zip(rs, want_grad)):
            np.testing.assert_allclose(
                r.grad.to(torch.float32).numpy(), want, rtol=0,
                atol=(grad_tol or delta_tol) * float(np.abs(want).max()),
                err_msg=f"head {k} gradient")
    return ref


DARKNET_TRAIN_CFG = """[net]
width=64
height=64
channels=3
[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky
[convolutional]
filters=18
size=1
activation=linear
[yolo]
mask=0,1,2
anchors=6,8, 10,14, 18,24
classes=1
num=3
iou_loss=ciou
iou_thresh=0.2
max_delta=5
ignore_thresh=0.6
"""


def write_darknet_train_workspace(root, cfg_text=DARKNET_TRAIN_CFG, size=64, **training):
    """:func:`write_train_workspace` with a darknet model cfg (default: two
    BN convs and a one-class [yolo] head with ciou, iou_thresh 0.2, at
    64²) in place of the NEWSLAB model, the dataset at ``size``, and
    ``training.loss.impl`` Darknet."""
    path = write_train_workspace(root, **{"loss": {"impl": "Darknet"}, **training})
    (root / "model.cfg").write_text(cfg_text)
    config = json.loads((root / "train.json5").read_text())
    config["model"] = {"kind": "Darknet", "cfg_file": "model.cfg"}
    config["dataset"]["kind"]["image_size"] = size
    (root / "train.json5").write_text(json.dumps(config))
    return path


# -- the darknet corpus sweep (test_torch_corpus_*.py), port only

CORPUS_DIR = os.path.join(REPO, "cfg", "darknet")
# the cfgs with a dense or recurrent node kind (Linear, rnn, gru, lstm, crnn)
CORPUS_DENSE = ("alexnet.cfg", "crnn.train.cfg", "extraction.conv.cfg", "extraction22k.cfg",
                "gru.cfg", "lstm.train.cfg", "rnn.cfg", "rnn.train.cfg", "strided.cfg",
                "t1.test.cfg", "vgg-16.cfg", "yolov3-tiny_occlusion_track.cfg")
# ... of which these run 576 time steps (test_torch_corpus_3.py)
CORPUS_LONG = ("crnn.train.cfg", "lstm.train.cfg", "rnn.train.cfg")
# cfgs that stop at a node kind the port lacks (none since ROADMAP A12)
CORPUS_A12 = ()
CORPUS_UNPARSABLE = ("resnet152_trident.cfg",)  # its route sizes do not unify


def corpus_names():
    return sorted(os.path.basename(p) for p in os.listdir(CORPUS_DIR) if p.endswith(".cfg"))


def corpus_slice(part, parts):
    """Every ``parts``-th buildable corpus cfg, from ``part``, but the
    576-step ones of CORPUS_LONG."""
    names = [n for n in corpus_names()
             if n not in CORPUS_A12 + CORPUS_UNPARSABLE + CORPUS_LONG]
    return names[part::parts]


def corpus_text(name):
    """The cfg with its input cut to 64² (128² for the p7 models, whose
    stride is 128, and for alexnet, whose last pool has nothing left to
    pool below 99²), as scripts/corpus_forward_sweep.py shrinks it."""
    import re

    with open(os.path.join(CORPUS_DIR, name)) as f:
        text = f.read()
    size = 128 if "p7" in name or name == "alexnet.cfg" else 64
    text = re.sub(r"(?m)^height *= *\d+", f"height={size}", text)
    return re.sub(r"(?m)^width *= *\d+", f"width={size}", text)


def corpus_forward(name):
    """Build the port's GraphModel of a corpus cfg and run one eval forward
    on a seeded input: every tensor node's output must have the graph's
    shape and the graph's output must be finite."""
    from yolodl_torch.config import darknet_cfg as t_dk
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.models import GraphModel

    darknet = t_dk.Darknet.from_str(corpus_text(name))
    model = GraphModel(graph_from_darknet(darknet), device="cpu")
    h, w, c = darknet.net.input_shape_hwc
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(max(darknet.net.time_steps, 1), c, h, w)).astype(np.float32) * 0.1)
    graph = model.graph
    keys = tuple(k for k in graph.order if graph.nodes[k].output_shape.is_tensor)
    with torch.no_grad():
        outs = model(x, output_keys=keys)
        final = model(x)
    for key in keys:
        dims = graph.nodes[key].output_shape.tensor_shape()
        got = tuple(outs[key].shape)
        assert len(got) == len(dims), (name, model._pname[key], got, dims)
        for d, g in zip(dims, got):
            assert not d.is_known or d.size == g, (name, model._pname[key], got, dims)
    fields = [final] if isinstance(final, torch.Tensor) else [
        final.cycxhw, final.obj_logit, final.class_logit]
    assert all(bool(torch.isfinite(f).all()) for f in fields), name
    return final


# -- the dense and recurrent layers (test_torch_recurrent*.py): reference
# trees carried to the port's nested parameter dicts, and one comparison of
# outputs, new BN state and gradients

def port_tree(tree, grad=False):
    """A reference params or state tree as the port's ops take it: ``w``
    through the bridge's mapping (HWIO → OIHW, ``[in, out]`` → ``[out,
    in]``), other leaves as they are; ``grad`` marks every leaf as a leaf
    of autograd."""
    from yolodl_torch.bridge import _kernel_to_torch

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = port_tree(v, grad)
        else:
            t = _kernel_to_torch(v) if k == "w" else torch.from_numpy(np.array(v, np.float32))
            out[k] = t.requires_grad_(grad)
    return out


def recurrent_matches(j_fn, t_fn, params, state, x, train, nchw=False, tol=1e-5, seed=0):
    """``j_fn(params, state, x, train)`` (the reference, NHWC maps) and
    ``t_fn`` on the port's trees (NCHW maps when ``nchw``) give the same
    output and new BN state within ``tol`` · max|ref| of each, and the same
    gradients of a seeded weighted sum of the output (every parameter and
    the input; ``jax.grad`` against autograd) within ``tol`` · the largest
    reference gradient of the call: train-mode BN's backward sums in another
    order in each package, and a small leaf's gradient, such as a bias
    behind a BN, keeps the absolute error of the large ones.  Returns the
    reference output."""
    from yolodl_torch.bridge import _kernel_to_jax

    out_shape = jax.eval_shape(lambda xx: j_fn(params, state, xx, train)[0], x).shape
    r = np.random.default_rng(seed + 1).normal(size=out_shape).astype(np.float32)

    def j_loss(p, xx):
        out, new_state = j_fn(p, state, xx, train)
        return jnp.sum(out * r), (out, new_state)

    # one jit of forward and gradient (op by op, XLA compiles every scan again)
    (_, (j_out, j_state)), (j_gp, j_gx) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))

    tp, ts = port_tree(params, grad=True), port_tree(state)
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy() if nchw else x.copy())
    tx.requires_grad_(True)
    t_out, t_state = t_fn(tp, ts, tx, train)
    out = t_out.permute(0, 2, 3, 1) if nchw else t_out
    (out * torch.from_numpy(r)).sum().backward()

    def close(got, want, what, scale):
        assert got.shape == want.shape, (what, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(scale, 1e-6), err_msg=what)

    j_out = np.asarray(j_out)
    close(out.detach().numpy(), j_out, "output", float(np.abs(j_out).max()))
    j_flat, t_flat = flat_leaves(j_state), flat_leaves(
        jax.tree_util.tree_map(lambda t: t.detach().numpy(), t_state))
    assert set(j_flat) == set(t_flat)
    for k, v in j_flat.items():
        close(t_flat[k], v, f"state {k}", float(np.abs(v).max()))
    t_params = {k: t for k, t in _named(tp)}
    gx = tx.grad.permute(0, 2, 3, 1) if nchw else tx.grad
    grads = [("input", gx.numpy(), np.asarray(j_gx))]
    for k, g in flat_leaves(j_gp).items():
        got = t_params[k].grad.numpy()
        grads.append((k, _kernel_to_jax(got) if k.endswith("w") else got, g))
    g_max = max(float(np.abs(g).max()) for _, _, g in grads)
    for k, got, want in grads:
        close(got, want, f"gradient {k}", g_max)
    return j_out


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# -- data parallelism (test_torch_dp*.py): ranks over gloo in subprocesses

# One rank of a data-parallel run, as ``python -c DP_RANK_SCRIPT spec.json``:
# joins the group from torchrun's variables (start_ranks sets them), then
# for each case of the spec builds the model, loads the shared initial
# weights (rank 1 first perturbs its own, so that replicate_state must
# undo it), takes the case's steps on its rows of each global batch, and
# writes its metrics, its state after the first step and its final state
# to <out>.r<rank>.npz.  It imports
# neither JAX nor the reference.
DP_RANK_SCRIPT = r'''
import dataclasses, json, sys
import numpy as np, torch
torch.set_num_threads(1)
from yolodl_torch.graph import Graph
from yolodl_torch.graph.from_darknet import load_darknet_graph
from yolodl_torch.models import YoloModel
from yolodl_torch.parallel import (init_process_group, make_dp_train_step, replicate_state,
                                   shard_batch)
from yolodl_torch.parallel.mesh import destroy_process_group
from yolodl_torch.train import loop
from yolodl_torch.train.lr_schedule import LrScheduleConfig

spec = json.load(open(sys.argv[1]))
mesh = init_process_group(spec.get("device", "cpu"))
data = np.load(spec["batches"])
out = {}
for name, case in spec["cases"].items():
    path = case["model"]
    graph = load_darknet_graph(path) if path.endswith(".cfg") else Graph.load_newslab_v1_json(path)
    model = YoloModel(graph, device=mesh.device, remat=case.get("remat", "off"))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in np.load(case["init"]).items()})
    if mesh.rank:
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.5)
    kw = dict(case["config"])
    cfg = loop.TrainConfig(lr=LrScheduleConfig(kind="constant", lr=kw.pop("lr")), **kw)
    if case.get("darknet"):
        from yolodl_torch.config import darknet_cfg as dk
        from yolodl_torch.loss.darknet_loss import head_params_from_darknet
        size = data["images0"].shape[-1]
        net = dk.Darknet.load(path)
        cfg = dataclasses.replace(cfg, darknet_loss=(
            graph.detect_head_input_keys(),
            tuple(head_params_from_darknet(l, size, size) for l in net.layers
                  if isinstance(l, dk.Yolo))))
    ts, opt = loop.train_init(model, cfg)
    ts = replicate_state(mesh, ts)
    step = make_dp_train_step(model, opt, cfg, mesh, accum=case.get("accum", 1))
    for i in range(case["steps"]):
        batch = [torch.from_numpy(data[f"{k}{i}"]).to(mesh.device)
                 for k in ("images", "boxes", "classes", "mask")]
        ts, metrics = step(ts, *shard_batch(mesh, batch))
        for k, v in metrics.items():
            out[f"{name}/step{i}/{k}"] = v.cpu().numpy()
        if i == 0 and case["steps"] > 1:
            for k, v in model.state_dict().items():
                out[f"{name}/first/{k}"] = v.cpu().numpy().copy()
    for k, v in model.state_dict().items():
        out[f"{name}/state/{k}"] = v.cpu().numpy()
    if ts.ema_params is not None:
        for k, v in ts.ema_params.items():
            out[f"{name}/ema/{k}"] = v.cpu().numpy()
    out[f"{name}/step"] = np.asarray(ts.step)
np.savez(f"{spec['out']}.r{mesh.rank}.npz", **out)
destroy_process_group()
'''


# One rank of a ZeRO-1 or tensor-parallel run, as ``python -c TP_RANK_SCRIPT
# spec.json``: joins the group from torchrun's variables; for each case
# builds the model, loads the shared initial weights and takes the case's
# steps on its rows of each global batch through the case's ``mode``:
# "tp" / "tp_zero" (make_tp_mesh(*case["mesh"]), shard_batch_tp), "zero" or
# "dp" (the whole group, shard_batch), "infer" (make_tp_infer on the first
# batch's images).  Rank 0 writes, per case, the metrics of every step, the
# full state after the first step and after the last (gathered from the
# shards under TP), its local parameter shapes, its optimizer's flat slice
# length and the inference output; every rank writes its parameters'
# digest.  It imports neither JAX nor the reference.
TP_RANK_SCRIPT = r"""
import dataclasses, hashlib, json, sys
import numpy as np, torch
torch.set_num_threads(1)
from yolodl_torch.graph import Graph
from yolodl_torch.graph.from_darknet import load_darknet_graph
from yolodl_torch.models import YoloModel
from yolodl_torch import parallel as par
from yolodl_torch.parallel.mesh import destroy_process_group
from yolodl_torch.train import loop
from yolodl_torch.train.lr_schedule import LrScheduleConfig

spec = json.load(open(sys.argv[1]))
world = par.init_process_group("cpu")
out = {}

def full_state(ts, mesh, cfg, mode):
    if mode in ("tp", "tp_zero"):
        full = par.gather_train_state(mesh, ts, cfg)
        return None if full is None else full.model.state_dict()
    return ts.model.state_dict()

for name, case in spec["cases"].items():
    path, mode = case["model"], case["mode"]
    data = np.load(case.get("batches", spec["batches"]))
    graph = load_darknet_graph(path) if path.endswith(".cfg") else Graph.load_newslab_v1_json(path)
    model = YoloModel(graph, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in np.load(case["init"]).items()})
    kw = dict(case["config"])
    cfg = loop.TrainConfig(lr=LrScheduleConfig(kind="constant", lr=kw.pop("lr")), **kw)
    if case.get("darknet"):
        from yolodl_torch.config import darknet_cfg as dk
        from yolodl_torch.loss.darknet_loss import head_params_from_darknet
        size = data["images0"].shape[-1]
        cfg = dataclasses.replace(cfg, darknet_loss=(
            graph.detect_head_input_keys(),
            tuple(head_params_from_darknet(l, size, size)
                  for l in dk.Darknet.load(path).layers if isinstance(l, dk.Yolo))))
    accum = case.get("accum", 1)
    mesh = par.make_tp_mesh(*case["mesh"]) if mode in ("tp", "tp_zero", "infer") else world
    if mode == "zero":
        ts, opt = par.zero_init(model, cfg, world)
        ts = par.place_zero_state(world, ts)
        step = par.make_zero_train_step(model, opt, cfg, world, accum=accum)
    else:
        ts, opt = loop.train_init(model, cfg)
        ts = par.replicate_state(world, ts)
    if mode == "dp":
        step = par.make_dp_train_step(model, opt, cfg, world, accum=accum)
    elif mode == "tp":
        ts = par.place_tp_state(mesh, ts)
        step = par.make_tp_train_step(model, opt, cfg, mesh, accum=accum)
    elif mode == "tp_zero":
        ts = par.place_tp_zero_state(mesh, ts, cfg)
        step = par.make_tp_zero_train_step(model, ts.optimizer, cfg, mesh, accum=accum)
    elif mode == "infer":
        par.place_tp_state(mesh, ts)
        images = torch.from_numpy(data["images0"])
        rows = par.shard_batch_tp(mesh, (images,))[0]
        pred = par.make_tp_infer(model, mesh)(rows)
        fields = ("cycxhw", "obj_logit", "class_logit")
        every = [mesh.data.all_gather(getattr(pred, f)) for f in fields]
        if world.rank == 0:
            for f, v in zip(fields, every):
                out[f"{name}/infer/{f}"] = v.numpy()
            out[f"{name}/local_shapes"] = np.asarray(json.dumps(
                {k: list(v.shape) for k, v in model.state_dict().items()}))
        continue
    for i in range(case["steps"]):
        batch = [torch.from_numpy(data[f"{k}{i}"]) for k in ("images", "boxes", "classes", "mask")]
        rows = (par.shard_batch_tp(mesh, batch, accum) if mode in ("tp", "tp_zero")
                else par.shard_batch(world, batch))
        ts, metrics = step(ts, *rows)
        for k, v in metrics.items():
            out[f"{name}/step{i}/{k}"] = v.numpy()
        if i == 0 and case["steps"] > 1:
            sd = full_state(ts, mesh, cfg, mode)
            for k, v in (sd or {}).items():
                out[f"{name}/first/{k}"] = v.numpy().copy()
    sd = full_state(ts, mesh, cfg, mode)
    for k, v in (sd or {}).items():
        out[f"{name}/state/{k}"] = v.numpy()
    out[f"{name}/local_shapes"] = np.asarray(json.dumps(
        {k: list(v.shape) for k, v in model.state_dict().items()}))
    slices = [len(v) for p in ts.optimizer.param_groups[0]["params"]
              for v in ts.optimizer.state.get(p, {}).values() if v.dim() == 1]
    out[f"{name}/opt_slices"] = np.asarray(slices if mode in ("zero", "tp_zero") else [])
    digest = hashlib.sha256()
    for v in model.state_dict().values():
        digest.update(v.numpy().tobytes())
    out[f"{name}/digest"] = np.asarray(digest.hexdigest())
    out[f"{name}/step"] = np.asarray(ts.step)
np.savez(f"{spec['out']}.r{world.rank}.npz", **out)
destroy_process_group()
"""


def start_tp_ranks(tmp_path, cases, batches, n):
    """Write the batches and the spec of ``cases`` ({name: {mode, model,
    init state_dict, config, steps, mesh?, accum?, darknet?, batches?}}; a
    case's own ``batches`` replace the shared ones) under ``tmp_path`` and
    start ``n`` ranks of TP_RANK_SCRIPT; → (processes, the output
    prefix)."""
    def save(path, batches):
        keys = ("images", "boxes", "classes", "mask")
        np.savez(path, **{f"{k}{i}": x for i, b in enumerate(batches) for k, x in zip(keys, b)})
        return str(path)

    save(tmp_path / "batches.npz", batches)
    spec_cases = {}
    for name, case in cases.items():
        init = tmp_path / f"{name}.init.npz"
        np.savez(init, **{k: v.numpy() for k, v in case["init"].items()})
        spec_cases[name] = {**{k: v for k, v in case.items() if k != "init"}, "init": str(init)}
        if "batches" in case:
            spec_cases[name]["batches"] = save(tmp_path / f"{name}.batches.npz", case["batches"])
    spec = {"batches": str(tmp_path / "batches.npz"), "cases": spec_cases,
            "out": str(tmp_path / "tp")}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    procs = start_ranks(["-c", TP_RANK_SCRIPT, str(tmp_path / "spec.json")], n)
    return procs, str(tmp_path / "tp")


def rank_state(rank, name, which="state"):
    """The state a rank wrote for case ``name`` as the reference's
    (params, state) trees of numpy leaves, flattened by path."""
    prefix = f"{name}/{which}/"
    sd = {k[len(prefix):]: torch.from_numpy(v) for k, v in rank.items() if k.startswith(prefix)}
    params, state = params_to_jax(sd)
    return flat_leaves(params), flat_leaves(state)


def assert_trees_close(mine, ref, atol, rel=False):
    """Every leaf of ``mine`` within ``atol`` of ``ref``'s (times max|ref|
    when ``rel``), the same keys on both."""
    assert mine.keys() == ref.keys(), set(mine) ^ set(ref)
    for k in ref:
        tol = atol * float(np.abs(ref[k]).max()) if rel else atol
        np.testing.assert_allclose(mine[k], ref[k], rtol=0, atol=tol, err_msg=k)


def start_ranks(cmd, n, env=None):
    """``cmd`` as ranks 0 … n-1 of one gloo group on 127.0.0.1 (torchrun's
    variables); → the processes, stderr piped."""
    import subprocess
    import sys

    from yolodl_torch.parallel.mesh import free_port

    port = free_port()
    base = {**os.environ, "PYTHONPATH": REPO, **(env or {})}
    return [subprocess.Popen([sys.executable, *cmd], cwd=REPO, stderr=subprocess.PIPE, text=True,
                             env={**base, "RANK": str(r), "WORLD_SIZE": str(n),
                                  "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
                                  "MASTER_PORT": str(port)})
            for r in range(n)]


def wait_ranks(procs, timeout=120):
    """Wait for every rank; each must exit 0."""
    for r, p in enumerate(procs):
        _, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err}"


def dp_batches(n, batch, size=TRAIN_SIZE, seed=0, num_classes=80):
    """``n`` seeded global (images, boxes, classes, mask) numpy batches."""
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 1, (batch, 3, size, size)).astype(np.float32),
             *random_targets(batch, TRAIN_MAX_GT, seed * 100 + i, num_classes=num_classes))
            for i in range(n)]


def start_dp_ranks(tmp_path, cases, batches, n=2):
    """Write the batches and the spec of ``cases`` ({name: {model, init
    state_dict, config, steps, accum?, remat?, darknet?}}) under
    ``tmp_path`` and start ``n`` ranks of DP_RANK_SCRIPT; → (processes,
    the output prefix)."""
    np.savez(tmp_path / "batches.npz", **{f"{k}{i}": x for i, b in enumerate(batches)
                                          for k, x in zip(("images", "boxes", "classes", "mask"), b)})
    spec_cases = {}
    for name, case in cases.items():
        init = tmp_path / f"{name}.init.npz"
        np.savez(init, **{k: v.numpy() for k, v in case.pop("init").items()})
        spec_cases[name] = {**case, "init": str(init)}
    spec = {"batches": str(tmp_path / "batches.npz"), "cases": spec_cases,
            "out": str(tmp_path / "dp")}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    procs = start_ranks(["-c", DP_RANK_SCRIPT, str(tmp_path / "spec.json")], n)
    return procs, str(tmp_path / "dp")


def reference_dp(jm, params, state, j_cfg, batches, n=2, accum=1):
    """The reference's make_dp_train_step on a ``n``-device mesh over
    ``batches`` → (TrainState after the first step, final TrainState,
    [metrics as numpy])."""
    from yolodl_tpu.parallel import make_dp_train_step, make_mesh, shard_batch
    from yolodl_tpu.parallel.dp import replicate_state

    mesh = make_mesh(n)
    opt = j_loop.make_optimizer(j_cfg)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    ts = j_loop.TrainState(p, jax.tree_util.tree_map(jnp.asarray, state), opt.init(p),
                           jnp.zeros((), jnp.int32),
                           jax.tree_util.tree_map(jnp.copy, p) if j_cfg.use_ema else None)
    ts = replicate_state(mesh, ts)
    step = make_dp_train_step(jm, opt, j_cfg, mesh, accum=accum)
    out, first = [], None
    for batch in batches:
        ts, m = step(ts, *shard_batch(mesh, tuple(map(jnp.asarray, batch))))
        out.append({k: np.asarray(v) for k, v in m.items()})
        if first is None:
            first = jax.tree_util.tree_map(np.array, ts)  # a copy: the step donates ts
    return first, ts, out


def reference_parallel(kind, jm, params, state, j_cfg, batches, mesh_shape=(2,), accum=1):
    """The reference's ``kind`` step ("tp", "tp_zero" on
    ``make_tp_mesh(*mesh_shape)``, "zero" on ``make_mesh(*mesh_shape)``)
    over ``batches`` → (TrainState after the first step, final TrainState,
    [metrics as numpy])."""
    from yolodl_tpu import parallel as jp

    p = jax.tree_util.tree_map(jnp.asarray, params)
    st = jax.tree_util.tree_map(jnp.asarray, state)
    if kind == "zero":
        mesh = jp.make_mesh(*mesh_shape)
        ts, opt = jp.zero_init(jm, j_cfg, mesh, seed=0)
        ts = j_loop.TrainState(p, st, ts.opt_state, jnp.zeros((), jnp.int32),
                               jax.tree_util.tree_map(jnp.copy, p) if j_cfg.use_ema else None)
        ts = jp.place_zero_state(mesh, ts)
        step = jp.make_zero_train_step(jm, opt, j_cfg, mesh, accum=accum)
        place = lambda b: jp.shard_batch(mesh, b)  # noqa: E731
    else:
        mesh = jp.make_tp_mesh(*mesh_shape)
        opt = j_loop.make_optimizer(j_cfg)
        ts = j_loop.TrainState(p, st, opt.init(p), jnp.zeros((), jnp.int32),
                               jax.tree_util.tree_map(jnp.copy, p) if j_cfg.use_ema else None)
        zero = kind == "tp_zero"
        ts = (jp.place_tp_zero_state if zero else jp.place_tp_state)(mesh, ts)
        step = (jp.make_tp_zero_train_step if zero else jp.make_tp_train_step)(
            jm, opt, j_cfg, mesh, accum=accum)
        place = lambda b: jp.shard_batch_tp(mesh, b)  # noqa: E731
    out, first = [], None
    for batch in batches:
        ts, m = step(ts, *place(tuple(map(jnp.asarray, batch))))
        out.append({k: np.asarray(v) for k, v in m.items()})
        if first is None:
            first = jax.tree_util.tree_map(np.array, ts)  # a copy: the step donates ts
    return first, ts, out


# tests/test_train.py tiny_model(bn=True): two ConvBn2D of 8 and 16 channels
# and a 7-channel head
TINY_BN = {"main_group": "m", "groups": {"m": [
    {"name": "input", "kind": "Input", "shape": ["_", 3, 32, 32]},
    {"kind": "ConvBn2D", "c": 8, "k": 3, "s": 2},
    {"kind": "ConvBn2D", "c": 16, "k": 3, "s": 2},
    {"name": "head", "kind": "ConvBn2D", "c": 7, "k": 1, "act": "linear",
     "bn": {"enabled": False}},
    {"name": "det", "kind": "Detect2D", "classes": 2, "anchors": [[0.3, 0.3]]},
    {"name": "output", "kind": "MergeDetect2D", "from": ["det"]},
]}}

# tests/test_train.py TestDarknetLossImpl.CFG: BN-free, one [yolo] head
DARKNET_CFG = """[net]
width=64
height=64
channels=3
[convolutional]
filters=8
size=3
stride=4
pad=1
activation=leaky
[convolutional]
filters=24
size=1
activation=linear
[yolo]
mask=0,1,2
anchors=6,8, 10,14, 18,24
classes=3
num=3
iou_loss=ciou
iou_thresh=0.2
max_delta=5
ignore_thresh=0.6
"""


def darknet_batch():
    """tests/test_train.py _setup's batch: two 64² images, one truth each."""
    rng = np.random.default_rng(0)
    return (rng.random((2, 3, 64, 64)).astype(np.float32),
            np.asarray([[[0.5, 0.5, 0.3, 0.3]], [[0.4, 0.6, 0.2, 0.2]]], np.float32),
            np.zeros((2, 1), np.int32), np.ones((2, 1), bool))


def fake_batches(n, rows=8, size=32, seed=0):
    """tests/test_train.py fake_batch: normal images, one box an image,
    classes alternating; seeded numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        images = rng.normal(size=(rows, 3, size, size)).astype(np.float32)
        boxes = np.zeros((rows, 4, 4), np.float32)
        classes = np.zeros((rows, 4), np.int32)
        mask = np.zeros((rows, 4), bool)
        boxes[:, 0] = (0.5, 0.5, 0.3, 0.3)
        classes[:, 0] = np.arange(rows) % 2
        mask[:, 0] = True
        out.append((images, boxes, classes, mask))
    return out


def model_pair(spec, path):
    """(reference model, params, state, port model, port weights) of a
    NEWSLAB dict, the reference's seed-0 init carried through the bridge."""
    path.write_text(json.dumps(spec))
    from yolodl_tpu.config import newslab as jnewslab
    from yolodl_tpu.graph import Graph as JGraph
    from yolodl_torch.graph import Graph

    jm = JYoloModel(JGraph.from_model(jnewslab.parse_model_dict(spec)), spd_stem="off")
    params, state = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = YoloModel(Graph.load_newslab_v1_json(str(path)), device="cpu")
    params_from_jax(params, state, model=tm)
    return jm, params, state, tm, {k: v.clone() for k, v in tm.state_dict().items()}


def port_single(model, t_cfg, batches, accum=1):
    """The port's single-process step over the global ``batches`` → (state
    dict after the first step, final state dict, [total losses])."""
    ts, opt = t_loop.train_init(model, t_cfg)
    step = t_loop.make_train_step(model, opt, t_cfg, accum=accum)
    losses, first = [], None
    for batch in batches:
        losses.append(float(step(ts, *map(torch.from_numpy, batch))[1]["total_loss"]))
        if first is None:
            first = {k: v.clone() for k, v in model.state_dict().items()}
    return first, {k: v.clone() for k, v in model.state_dict().items()}, losses


def state_trees(sd):
    """A port state dict as flat (params, state) leaves of the reference's
    trees."""
    params, state = params_to_jax(sd)
    return flat_leaves(params), flat_leaves(state)


DP_TINY = os.path.join(REPO, "cfg", "darknet", "yolov4-tiny.cfg")


def reference_darknet_spec(jm, path=DP_TINY, size=TRAIN_SIZE):
    """The reference's ``TrainConfig.darknet_loss`` of a darknet cfg."""
    from yolodl_tpu.config import darknet_cfg as jdk
    from yolodl_tpu.loss.darknet_loss import head_params_from_darknet

    net = jdk.Darknet.load(path)
    return (jm.graph.detect_head_input_keys(),
            tuple(head_params_from_darknet(l, size, size) for l in net.layers
                  if isinstance(l, jdk.Yolo)))


def dp_case_runs(tmp, cases, batches, extra=None):
    """Both ranks run every case of ``cases`` ({name: {config, steps,
    accum?, remat?, darknet?}} on yolov4-tiny from train_models()'s
    weights, plus ``extra`` cases as given) while this process runs the
    reference's DP step on each → ({name: reference_dp(…)}, [rank npz])."""
    import copy
    import dataclasses

    from yolodl_tpu.graph.from_darknet import load_darknet_graph as j_graph

    jm, params, state, tm = train_models()
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    spec = {name: {"model": DP_TINY, "init": init, **copy.deepcopy(c)} for name, c in cases.items()}
    procs, out = start_dp_ranks(tmp, {**spec, **(extra or {})}, batches)
    refs = {}
    for name, case in cases.items():
        j_cfg, _ = train_configs(**case["config"])
        model = jm
        if case.get("remat"):
            model = JYoloModel(j_graph(DP_TINY), spd_stem="off", remat="blocks")
        if case.get("darknet"):
            j_cfg = dataclasses.replace(j_cfg, darknet_loss=reference_darknet_spec(jm))
        refs[name] = reference_dp(model, params, state, j_cfg, batches[:case["steps"]],
                                  accum=case.get("accum", 1))
    wait_ranks(procs)
    return refs, [dict(np.load(f"{out}.r{r}.npz")) for r in range(2)]


def assert_ranks_identical(ranks, name):
    """Every array the two ranks wrote for case ``name`` is bit-identical."""
    r0, r1 = ranks
    keys = [k for k in r0 if k.startswith(name + "/")]
    assert keys and keys == [k for k in r1 if k.startswith(name + "/")]
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def _dp_state_matches(rank, name, which, j_ts, tol):
    prefix = f"{name}/{which}/"
    sd = {k[len(prefix):]: torch.from_numpy(v) for k, v in rank.items() if k.startswith(prefix)}
    params, state = params_to_jax(sd)
    for mine, ref in ((flat_leaves(params), named_leaves(j_ts.params)),
                      (flat_leaves(state), named_leaves(j_ts.state))):
        assert mine.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(mine[k], ref[k], rtol=0,
                                       atol=tol * float(np.abs(ref[k]).max()), err_msg=k)


def assert_dp_matches_reference(rank, name, j_first, j_ts, j_metrics):
    """A rank's metrics and state against reference_dp's, with
    test_torch_dp.py's limits."""
    for i, ref in enumerate(j_metrics):
        got = {k.split("/", 2)[2]: v for k, v in rank.items() if k.startswith(f"{name}/step{i}/")}
        assert set(got) == set(ref), (set(got) ^ set(ref))
        np.testing.assert_allclose(got["total_loss"], ref["total_loss"], rtol=1e-5,
                                   err_msg=f"step {i}")
        assert int(got["num_matched"]) == int(ref["num_matched"]) > 0, i
        for k, v in ref.items():  # the other means and the maxima
            np.testing.assert_allclose(got[k], v, rtol=1e-3,
                                       atol=1e-3 * float(np.abs(v).max()) + 1e-7, err_msg=k)
    assert int(rank[f"{name}/step"]) == len(j_metrics)
    if len(j_metrics) == 1:
        _dp_state_matches(rank, name, "state", j_ts, 1e-4)
    else:
        _dp_state_matches(rank, name, "first", j_first, 1e-4)
        _dp_state_matches(rank, name, "state", j_ts, 3e-4)


def write_first_checkpoint(config_path, checkpoint_dir):
    """One step of the port's training step on a train_main workspace's
    model (seed 0, as train_main draws it) and recipe, saved with its
    optimizer state as train_main saves it → the checkpoint's path.  A
    ``FromFile`` start from it gives the next steps restored Adam moments
    (see test_torch_train_cli.py) without a first CLI run."""
    from yolodl_torch.cli import train_main as t_train
    from yolodl_torch.config.app_config import TrainAppConfig
    from yolodl_torch.graph import Graph
    from yolodl_torch.train.checkpoint import save_checkpoint

    config = TrainAppConfig.load(config_path)
    graph = Graph.load_newslab_v1_json(
        os.path.join(os.path.dirname(config_path), config.model_file))
    config = t_train._resolve_auto_loss_options(config, graph)
    model = YoloModel(graph, device="cpu", generator=torch.Generator().manual_seed(0))
    t_cfg = t_loop.TrainConfig(lr=config.lr, optimizer=config.optimizer,
                               momentum=config.momentum, weight_decay=config.weight_decay,
                               loss=config.loss)
    ts, opt = t_loop.train_init(model, t_cfg)
    size = config.dataset.image_size
    rng = np.random.default_rng(0)
    batch = (rng.uniform(0, 1, (config.batch_size, 3, size, size)).astype(np.float32),
             *random_targets(config.batch_size, 4, 0, num_classes=1))
    ts, metrics = t_loop.make_train_step(model, opt, t_cfg)(ts, *map(torch.from_numpy, batch))
    params, state = params_to_jax(model.state_dict())
    return save_checkpoint(checkpoint_dir, ts.step, float(metrics["total_loss"]), params, state,
                           t_loop.optimizer_state_tree(ts, t_cfg))


# -- train_main runs over several ranks (test_torch_dp_cli.py, test_torch_tp_cli.py)

def logged(run_dir, tag="loss/total_loss"):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(run_dir, size_guidance={"scalars": 0})
    acc.Reload()
    return [(e.step, e.value) for e in acc.Scalars(tag)]


def rank_streams(package, config_path, world=2):
    """Each rank's TrainingStream as train_main builds it: records[r::2],
    seed r, the local batch, the config's recipe, decoded with PIL."""
    if package == "ref":
        from yolodl_tpu.config.app_config import TrainAppConfig
        from yolodl_tpu.data import (MosaicMixer, SanitizedDataset, TrainingStream,
                                     TrainingStreamConfig, make_decode_loader)
    else:
        from yolodl_torch.config.app_config import TrainAppConfig
        from yolodl_torch.data.cache import make_decode_loader
        from yolodl_torch.data.datasets import SanitizedDataset
        from yolodl_torch.data.mosaic import MosaicMixer
        from yolodl_torch.data.pipeline import TrainingStream, TrainingStreamConfig
    config = TrainAppConfig.load(config_path)
    pre = config.preprocessor
    records = SanitizedDataset(config.dataset.open(os.path.dirname(config_path)),
                               out_of_bound_tolerance=pre.out_of_bound_tolerance,
                               min_bbox_size=pre.min_bbox_size).records()
    size = config.dataset.image_size
    return [TrainingStream(records[r::world], make_decode_loader((size, size)),
                           TrainingStreamConfig(
                               batch_size=config.batch_size // world, seed=r,
                               mosaic_prob=pre.mosaic_prob, mixup_prob=pre.mixup_prob,
                               cutmix_prob=pre.cutmix_prob,
                               mosaic=MosaicMixer(mosaic_margin=pre.mosaic_margin),
                               color_jitter=pre.color_jitter,
                               color_jitter_prob=pre.color_jitter_prob,
                               random_affine=pre.affine, affine_prob=pre.affine_prob,
                               bbox_scaling=pre.bbox_scaling, workers=pre.workers,
                               ordered=not pre.unordered))
            for r in range(world)]


def first_batches(streams, n):
    out = []
    for stream in streams:
        it = iter(stream)
        out.append([next(it) for _ in range(n)])
        it.close()  # stops the stream's workers
    return out
