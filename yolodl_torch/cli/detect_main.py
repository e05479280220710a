"""Detection CLI: ``python -m yolodl_torch.cli.detect_main --config-file detect.json5``.

Counterpart of ``yolodl_tpu/cli/detect_main.py``, with its flags and outputs
plus ``--device`` (default ``cuda``; ``--device cpu`` runs on the CPU).
Equivalent capability to the reference ``detect`` crate
(detect/src/main.rs): batch inference over a dataset, NMS + per-instance
class selection, then draw ground truth (yellow) and predictions
(per-class colors) and save JPEGs into the output dir (:108-213), plus
COCO-format JSON with ``--save-json``.  Drawing is PIL-based.

On a card the NMS is B1's two kernels (``kernels/iou.py``), one launch of
each per batch.  ``--artifact`` runs an exported program (``tool_main
export``, ``models/export.py``) in place of the model, with the
reference's rejections: no ``--weights``/``--checkpoint``/``--devices``,
no ``--precision`` and no multi-device config with it; its batch is the
artifact's.  ``--devices N`` (or the config's device list) runs one model
replica per device in this process (``parallel/mesh.py`` ``ModelReplicas``,
the reference's detect_main.py:144-160): each batch is split into N equal
parts, each replica's forward and NMS issued in order, the outputs joined
in order, so B1 launches once per replica per batch.  ``--devices`` also
takes a device list (``cuda:0,cuda:0``).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="yolodl_torch detector")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--weights", default="", help="darknet .weights file")
    parser.add_argument("--checkpoint", default="", help="framework .ckpt file")
    parser.add_argument("--limit", type=int, default=0, help="max images (0 = all)")
    parser.add_argument("--devices", default="0",
                        help="split inference batches over N devices (0 = the "
                             "config's), or a list: cuda:0,cuda:1")
    parser.add_argument("--save-json", default="",
                        help="also write COCO-format detections (original "
                             "pixel coordinates) to this file")
    parser.add_argument("--precision", default="float32",
                        help="forward-pass compute dtype (float32/bfloat16, "
                             "same aliases as training.precision); bfloat16 "
                             "is the serving path's production precision "
                             "(params stay f32)")
    parser.add_argument("--artifact", default="",
                        help="run an exported artifact dir (tool_main "
                             "export) instead of building the model; "
                             "--weights/--checkpoint/--devices do not apply")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    import numpy as np
    import torch
    from PIL import Image

    from .._device import resolve_device
    from ..config.app_config import DetectAppConfig, compute_dtype_of
    from ..data.cache import make_decode_loader
    from ..data.datasets import SanitizedDataset
    from ..data.letterbox import letterbox_unit_transform
    from ..loss import non_max_suppression, yolo_inference
    from ..loss.inference import to_host_detections
    from ..train.logging import draw_boxes_on_image
    from ..parallel.mesh import ModelReplicas, join_outputs
    from ._common import (build_model, devices_arg, inference_devices, load_artifact,
                          nms_options)

    config = DetectAppConfig.load(args.config_file)
    base_dir = os.path.dirname(os.path.abspath(args.config_file))
    model_path = os.path.join(base_dir, config.model_file)
    compute_dtype = compute_dtype_of(args.precision)
    artifact_infer = None
    replicas = None
    devices = devices_arg(args.devices)
    if args.artifact:
        if args.weights or args.checkpoint or devices:
            raise ValueError(
                "--artifact bakes the weights in and fixes the device "
                "program; --weights/--checkpoint/--devices do not apply")
        if compute_dtype != torch.float32:
            raise ValueError(
                "--precision does not apply to --artifact runs: the "
                "artifact's compute dtype was fixed at export time")
        if config.n_devices > 1:
            raise ValueError(
                "--artifact runs the exported single-device program; the "
                f"config's {config.n_devices}-device block does not apply "
                "(re-export per device or use the live-model path)")
        device = resolve_device(args.device)
        artifact_infer, meta = load_artifact(args.artifact, config.dataset.image_size, device)
        artifact_nhwc = meta.get("data_format") == "NHWC"
        artifact_dtype = getattr(torch, meta["input_dtype"])
    else:
        replica_devs = inference_devices(devices, config.n_devices, args.device)
        device = replica_devs[0]
        model, model_path = build_model(
            config, base_dir, weights=args.weights, checkpoint=args.checkpoint,
            device=device)
        if len(replica_devs) > 1:
            if config.minibatch_size % len(replica_devs):
                raise ValueError(
                    f"minibatch_size {config.minibatch_size} not divisible by "
                    f"devices {len(replica_devs)}")
            replicas = ModelReplicas(model, replica_devs)

    dataset = SanitizedDataset(
        config.dataset.open(base_dir),
        out_of_bound_tolerance=config.out_of_bound_tolerance,
        min_bbox_size=config.min_bbox_size,
        bbox_scaling=config.bbox_scaling,
    )
    size = config.dataset.image_size
    loader = make_decode_loader((size, size))
    os.makedirs(config.output_dir, exist_ok=True)

    # honor the model cfg's nms_kind + beta_nms (yolo.rs NmsKind; e.g.
    # yolov4-csp, cspx-p7 declare nms_kind=diounms; with --artifact the
    # cfg may be absent and greedy defaults apply)
    nms_kind, nms_beta = nms_options(config, model_path)

    def forward(images: np.ndarray, replica: int = 0):
        if replicas is not None:
            x = torch.from_numpy(images).to(replicas.devices[replica])
            return replicas.models[replica](x.to(compute_dtype))
        x = torch.from_numpy(images).to(device)
        if artifact_infer is None:
            return model(x.to(compute_dtype))
        # the loader yields float [0,1] NCHW; a serving artifact ingests
        # uint8 pixels (its /255 is baked in): round, as the reference does
        if artifact_dtype == torch.uint8:
            x = torch.round(x * 255.0).to(torch.uint8)
        else:
            x = x.to(artifact_dtype)
        if artifact_nhwc:
            x = x.permute(0, 2, 3, 1).contiguous()
        return artifact_infer(x)

    def infer(images: np.ndarray):
        if replicas is not None:  # one part a replica, joined in order
            return join_outputs(replicas.map(infer_part, images))
        return infer_part(0, images)

    def infer_part(replica: int, images: np.ndarray):
        with torch.inference_mode():
            pred = forward(images, replica)
            nms = non_max_suppression(
                pred,
                iou_threshold=config.nms_iou_thresh,
                confidence_threshold=config.nms_conf_thresh,
                suppress_by_class=False,
                class_mode="argmax",
                kind=nms_kind,
                beta=nms_beta,
            )
            return yolo_inference(nms, pred.num_flats)

    palette = [
        (1.0, 0.2, 0.2), (0.2, 1.0, 0.2), (0.2, 0.4, 1.0), (1.0, 0.6, 0.1),
        (0.8, 0.2, 1.0), (0.1, 0.9, 0.9),
    ]

    batch_size = config.minibatch_size
    if artifact_infer is not None:
        batch_size = meta["input_shape"][0]  # the artifact's fixed batch
        if batch_size != config.minibatch_size:
            print(f"artifact batch {batch_size} overrides "
                  f"minibatch_size {config.minibatch_size}")
    records = dataset.records()
    if args.limit:
        records = records[: args.limit]
    count = 0
    json_results = []
    for start in range(0, len(records), batch_size):
        chunk = records[start : start + batch_size]
        decoded = [loader.load(r) for r in chunk]
        # pad the trailing batch to the fixed batch shape
        while len(decoded) < batch_size:
            decoded.append(decoded[-1])
        dets = to_host_detections(infer(np.stack([d.image for d in decoded])))
        for i, rec in enumerate(chunk):
            canvas = decoded[i].image.copy()
            # ground truth in yellow (main.rs draws GT yellow)
            if len(decoded[i].boxes):
                cy, cx, h, w = (decoded[i].boxes[:, k] for k in range(4))
                gt_tlbr = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)
                canvas = draw_boxes_on_image(canvas, gt_tlbr, color=(1.0, 1.0, 0.0))
            for det in dets[i]:
                color = palette[det["class"] % len(palette)]
                canvas = draw_boxes_on_image(
                    canvas, np.asarray([det["tlbr"]]), color=color
                )
            out_path = os.path.join(config.output_dir, f"{start + i:06d}.jpg")
            Image.fromarray(
                (np.clip(np.transpose(canvas, (1, 2, 0)), 0, 1) * 255).astype(np.uint8)
            ).save(out_path, quality=92)
            if args.save_json:
                # map letterbox-frame ratio boxes back to original pixel
                # coords (the reference's inverse transform, detect main:169)
                inv = letterbox_unit_transform(
                    (rec.height, rec.width), (size, size)
                ).inverse()
                tlbrs = inv.apply_tlbr(np.asarray(
                    [det["tlbr"] for det in dets[i]], np.float64
                ).reshape(-1, 4))
                for det, (ot, ol, ob, orr) in zip(dets[i], tlbrs):
                    x_px = float(ol * rec.width)
                    y_px = float(ot * rec.height)
                    w_px = float((orr - ol) * rec.width)
                    h_px = float((ob - ot) * rec.height)
                    json_results.append({
                        "image_id": start + i,
                        "file_name": os.path.basename(rec.path),
                        "category_id": det["class"],
                        "bbox": [round(x_px, 2), round(y_px, 2),
                                 round(w_px, 2), round(h_px, 2)],
                        "score": round(det["confidence"], 5),
                    })
            count += 1
    if args.save_json:
        import json as json_mod

        with open(args.save_json, "w") as f:
            json_mod.dump(json_results, f)
        print(f"wrote {len(json_results)} detections to {args.save_json}")
    print(f"wrote {count} images to {config.output_dir}")


def cli():
    """Console-script entry: guarded main."""
    from ._guard import run
    run(main)


if __name__ == "__main__":
    cli()
