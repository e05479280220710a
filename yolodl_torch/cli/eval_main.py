"""Evaluation CLI: dataset mAP.

    python -m yolodl_torch.cli.eval_main --config-file detect.json5 \
        [--weights w.weights | --checkpoint c.ckpt] [--limit N] [--device cpu]

Counterpart of ``yolodl_tpu/cli/eval_main.py``, with its flags and its
printed JSON line, plus ``--device`` (default ``cuda``).  Runs batch
inference + NMS by class over the configured dataset and reports COCO
101-point AP@0.5 and mAP@0.5:0.95 (``train/evaluation.py``).  On a card
the NMS is B1's two kernels with one group per class, one launch of each
per batch and replica: ``--devices N`` (or the config's device list, or a
list such as ``cuda:0,cuda:1``) evaluates with one model replica per device
in this process (``DatasetEvaluator(devices=…)``).
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="yolodl_torch evaluator")
    parser.add_argument("--config-file", required=True,
                        help="detect.json5-style config")
    parser.add_argument("--weights", default="")
    parser.add_argument("--checkpoint", default="")
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--conf-thresh", type=float, default=0.005,
                        help="confidence floor for candidate detections")
    parser.add_argument("--ema", action="store_true",
                        help="evaluate the EMA parameters from the checkpoint")
    parser.add_argument("--per-class", action="store_true",
                        help="include per-class AP@0.5 in the report")
    parser.add_argument("--coco", action="store_true",
                        help="include the 12-number COCO summary (AP by "
                             "object size, AR@1/10/100) with size buckets "
                             "in original-image pixel areas")
    parser.add_argument("--devices", default="0",
                        help="evaluation devices (0 = the config's device "
                             "list, like detect), or a list: cuda:0,cuda:1")
    parser.add_argument("--precision", default="float32",
                        help="forward-pass compute dtype (float32/bfloat16, "
                             "same aliases as training.precision); bfloat16 "
                             "is the serving path's production precision "
                             "(params stay f32)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    from ..config.app_config import DetectAppConfig
    from ..data.cache import make_decode_loader
    from ..data.datasets import SanitizedDataset
    from ..train.evaluation import DatasetEvaluator
    from ._common import build_model, devices_arg, inference_devices, nms_options

    config = DetectAppConfig.load(args.config_file)
    devices = inference_devices(devices_arg(args.devices), config.n_devices, args.device)
    device = devices[0]
    base_dir = os.path.dirname(os.path.abspath(args.config_file))

    model, model_path = build_model(
        config, base_dir, weights=args.weights,
        checkpoint=args.checkpoint, ema=args.ema, device=device)

    dataset = SanitizedDataset(
        config.dataset.open(base_dir),
        out_of_bound_tolerance=config.out_of_bound_tolerance,
        min_bbox_size=config.min_bbox_size,
        bbox_scaling=config.bbox_scaling,
    )
    size = config.dataset.image_size
    loader = make_decode_loader((size, size))

    # honor the model cfg's nms_kind + beta_nms (detect_main does the same)
    nms_kind, nms_beta = nms_options(config, model_path)

    records = dataset.records()
    if args.limit:
        records = records[: args.limit]

    evaluator = DatasetEvaluator(
        model, records, loader,
        num_classes=len(dataset.classes),
        batch_size=config.minibatch_size,
        iou_threshold=config.nms_iou_thresh,
        confidence_threshold=args.conf_thresh,
        nms_kind=nms_kind,
        nms_beta=nms_beta,
        devices=devices,
        extended=args.coco,
        precision=args.precision,
    )
    result = evaluator()
    per_class = result.pop("per_class")
    if args.per_class:
        names = list(dataset.classes)
        result["AP@0.5_per_class"] = {
            (names[cid] if cid < len(names) else str(cid)): round(ap, 4)
            for cid, ap in sorted(per_class.items())
        }
    print(json.dumps(result))
    return result


def cli():
    """Console-script entry: guarded main."""
    from ._guard import run
    run(main)


if __name__ == "__main__":
    cli()
