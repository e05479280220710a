"""The port's application configs (yolodl_torch/config/app_config.py)
against the reference's: the repo's cfg/train.json5 and cfg/detect.json5
and synthetic variants load to the same fields, config errors raise the same
exception with the same message, and warnings print the same lines."""

import copy
import dataclasses
import json
import os

import json5
import pytest
import torch

from yolodl_tpu.config import app_config as J
from yolodl_tpu.config import darknet_cfg as j_dk
from yolodl_torch.config import app_config as T
from yolodl_torch.config import darknet_cfg as t_dk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "cfg", "train.json5")) as _f:
    TRAIN = json5.load(_f)
with open(os.path.join(REPO, "cfg", "detect.json5")) as _f:
    DETECT = json5.load(_f)


def fields(cfg):
    """A loaded config as plain data, the class names of nested configs
    (RandomAffine, LossConfig …) dropped."""
    return dataclasses.asdict(cfg)


def variant(base, edits):
    out = copy.deepcopy(base)
    for path, value in edits.items():
        node = out
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if value is _DELETE:
            node.pop(keys[-1], None)
        else:
            node[keys[-1]] = value
    return out


_DELETE = object()

TRAIN_VARIANTS = {
    "reference": {},
    "multidevice": {"training.device_config": {"type": "MultiDevice", "devices": [0, 1, 2, 3]},
                    "training.batch_size": 8},
    "nonuniform": {"training.device_config": {
        "type": "NonUniformMultiDevice",
        "devices": [{"minibatch_size": 4}, {"minibatch_size": 2}]}, "training.batch_size": 6},
    "multiprocess": {"training.device_config": {"type": "MultiProcess",
                                                "coordinator": "h:1", "num_processes": 2}},
    "darknet_bf16": {"model.kind": "Darknet", "model.cfg_file": "cfg/darknet/yolov4-csp.cfg",
                     "training.precision": "bf16", "training.ema": {"enabled": True, "decay": 0.999},
                     "training.loss.ignore_thresh": [0.7, 0.6, 0.5], "training.loss.max_delta": None,
                     "training.loss.iou_thresh": 0.2, "training.loss.impl": "Darknet"},
    "caches_and_eval": {"preprocessor.cache": {"method": "MemoryCache", "records": True,
                                               "cache_dir": "c", "dtype": "u8"},
                        "preprocessor.pipeline.device": "tpu",
                        "evaluation": {"interval": 5, "limit": 3, "conf_thresh": 0.01,
                                       "batch_size": 2, "dataset": {"kind": {
                                           "type": "Csv", "image_size": 64, "image_dir": "i",
                                           "label_file": "l", "classes_file": "c"}}},
                        "training.multi_scale": {"sizes": [320, 416], "interval": 3},
                        "training.freeze": "layer0", "training.remat": True,
                        "training.load_checkpoint": {"type": "FromRecent"},
                        "training.save_checkpoint_steps": 100,
                        "training.override_initial_step": 7},
    "parallel": {"training.device_config": {"type": "MultiDevice", "devices": [0, 1, 2, 3]},
                 "training.batch_size": 8, "training.tensor_parallel": 2,
                 "training.zero_optimizer": True, "training.accumulation_steps": 2},
    "pipeline": {"training.device_config": {"type": "MultiDevice", "devices": [0, 1]},
                 "training.batch_size": 4, "training.pipeline_parallel": 2,
                 "training.accumulation_steps": 2, "training.freeze": ["a", "b"]},
    "lr_forms": {"training.optimizer": {"type": "SGD", "lr": 0.01, "momentum": 0.9}},
    "warn_pipeline_device": {"preprocessor.pipeline.device": "fpga"},
}

TRAIN_ERRORS = {
    "version": {"version": "0.2.0"},
    "model_kind": {"model.kind": "Onnx"},
    "no_training": {"training": _DELETE},
    "device_type": {"training.device_config": {"type": "Cluster"}},
    "device_config_not_object": {"training.device_config": "cuda:0"},
    "accumulation": {"training.accumulation_steps": 0},
    "tp_divides": {"training.tensor_parallel": 2},
    "batch_divides": {"training.device_config": {"type": "MultiDevice", "devices": [0, 1, 2]},
                      "training.batch_size": 8},
    "pp_exclusive": {"training.device_config": {"type": "MultiDevice", "devices": [0, 1]},
                     "training.pipeline_parallel": 2, "training.tensor_parallel": 2},
    "precision": {"training.precision": "fp8"},
    "cache_method": {"preprocessor.cache": {"method": "DiskCache"}},
    "records_need_dir": {"preprocessor.cache": {"records": True}},
    "freeze_type": {"training.freeze": [1, 2]},
    "load_checkpoint": {"training.load_checkpoint": {"type": "Latest"}},
    "logging_type": {"logging": [1]},
    "missing_batch": {"training.batch_size": _DELETE},
    "mp_tp": {"training.device_config": {"type": "MultiProcess"},
              "training.tensor_parallel": 2},
}

DETECT_VARIANTS = {
    "reference": {},
    "darknet_csv": {"model": {"kind": "Darknet", "cfg_file": "cfg/darknet/yolov4-csp.cfg",
                              "minibatch_size": 8, "weights_file": "w.weights"},
                    "input": {"kind": {"type": "Csv", "image_size": 608, "image_dir": "i",
                                       "label_file": "l.csv", "classes_file": "c.txt"}},
                    "output": {"output_dir": "out", "nms_iou_thresh": 0.45,
                               "nms_conf_thresh": 0.25}},
    "two_devices_coco": {"model.devices": [0, 1], "preprocess": {"device": "cuda",
                                                                 "bbox_scaling": 1.2},
                         "input": {"kind": {"type": "Coco", "image_size": 320,
                                            "dataset_dir": "d", "dataset_name": "val2017"},
                                   "class_whitelist": ["person"]}},
    "defaults": {"output": _DELETE, "preprocess": _DELETE, "model.minibatch_size": _DELETE,
                 "model.devices": _DELETE},
}

DETECT_ERRORS = {
    "version": {"version": None},
    "no_input": {"input": _DELETE},
    "input_not_object": {"input": [1]},
    "model_kind": {"model.kind": "Onnx"},
    "no_cfg_file": {"model.cfg_file": _DELETE},
    "output_type": {"output": 3},
}


def load_both(cls_name, raw, tmp_path, capsys):
    path = tmp_path / "cfg.json5"
    path.write_text(json.dumps(raw, indent=1))
    out = []
    for mod in (J, T):
        try:
            out.append(("ok", fields(getattr(mod, cls_name).load(path))))
        except Exception as e:  # compared below: same type, same message
            out.append(("error", type(e).__name__, str(e)))
        out.append(capsys.readouterr().err)
    return out


@pytest.mark.parametrize("name", TRAIN_VARIANTS)
def test_train_config(name, tmp_path, capsys):
    ref, ref_err, port, port_err = load_both(
        "TrainAppConfig", variant(TRAIN, TRAIN_VARIANTS[name]), tmp_path, capsys)
    assert ref[0] == "ok", ref
    assert port == ref
    assert port_err == ref_err


@pytest.mark.parametrize("name", TRAIN_ERRORS)
def test_train_config_error(name, tmp_path, capsys):
    ref, _, port, _ = load_both(
        "TrainAppConfig", variant(TRAIN, TRAIN_ERRORS[name]), tmp_path, capsys)
    assert ref[0] == "error", ref
    assert port == ref


@pytest.mark.parametrize("name", DETECT_VARIANTS)
def test_detect_config(name, tmp_path, capsys):
    ref, ref_err, port, port_err = load_both(
        "DetectAppConfig", variant(DETECT, DETECT_VARIANTS[name]), tmp_path, capsys)
    assert ref[0] == "ok", ref
    assert port == ref
    assert port_err == ref_err


@pytest.mark.parametrize("name", DETECT_ERRORS)
def test_detect_config_error(name, tmp_path, capsys):
    ref, _, port, _ = load_both(
        "DetectAppConfig", variant(DETECT, DETECT_ERRORS[name]), tmp_path, capsys)
    assert ref[0] == "error", ref
    assert port == ref


@pytest.mark.parametrize("name", ["train.json5", "detect.json5"])
def test_repo_config_files(name):
    """The repo's own files, read as they are: comments, trailing commas."""
    cls = "TrainAppConfig" if name == "train.json5" else "DetectAppConfig"
    path = os.path.join(REPO, "cfg", name)
    assert fields(getattr(T, cls).load(path)) == fields(getattr(J, cls).load(path))


def test_json5_syntax_error_is_a_value_error(tmp_path):
    path = tmp_path / "bad.json5"
    path.write_text('{"version": "0.1.0", model: {cfg_file: "m.json5",,}}')
    for mod in (J, T):
        with pytest.raises(ValueError):
            mod.DetectAppConfig.load(path)


def test_precision_and_compute_dtype():
    for alias in ("bf16", "BFloat16", "f32", "fp32", "float32"):
        assert T.parse_precision(alias, "x") == J.parse_precision(alias, "x")
    assert T.compute_dtype_of("bf16") is torch.bfloat16
    assert T.compute_dtype_of("float32") is torch.float32
    with pytest.raises(ValueError, match="training.precision must be"):
        T.compute_dtype_of("half")


def test_darknet_data_recipe_adoption(tmp_path):
    """adopt_darknet_data_recipe on yolov4: the same preprocessor from the
    cfg's [net] and [yolo] sections."""
    path = tmp_path / "train.json5"
    path.write_text(json.dumps(variant(TRAIN, {"preprocessor.from_model_cfg": True})))
    cfg_file = os.path.join(REPO, "cfg", "darknet", "yolov4.cfg")  # mosaic=1, hue=.1
    ref, port = (fields(mod.adopt_darknet_data_recipe(mod.TrainAppConfig.load(path),
                                                      dk.Darknet.load(cfg_file)))
                 for mod, dk in ((J, j_dk), (T, t_dk)))
    assert port == ref
    assert port["preprocessor"]["mosaic_prob"] == 0.5
    assert port["preprocessor"]["color_jitter"]["hue_shift"] == 0.1
