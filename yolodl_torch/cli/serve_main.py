"""Detection serving CLI:

    python -m yolodl_torch.cli.serve_main --config-file detect.json5 \\
        --port 8650 --batch-size 8 --window-ms 5 [--device cpu]

Counterpart of ``yolodl_tpu/cli/serve_main.py``, with its flags and printed
lines, plus ``--device`` (default ``cuda``).  Loads the model once, runs a
warm-up batch, then serves HTTP requests with micro-batching
(``yolodl_torch/serve/``).  Model/NMS configuration reuses the
``detect.json5`` schema; the ``input`` dataset block supplies the image size
and (when present) class names.  ``--port 0`` binds a free port, and the
line "serving on http://HOST:PORT" names it.  SIGINT ends the server with
exit code 0.  ``--artifact`` serves an exported serving artifact
(``tool_main export --serving``) through
``DetectionService.from_artifact``: no model build, batch and size from
the artifact, the NMS live on B1's kernels.  ``--devices N`` (or a list
such as ``cuda:0,cuda:1``) serves with one model replica per device in
this process (``DetectionService(devices=…)``); an artifact serves on one.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="yolodl_torch detection server")
    parser.add_argument("--config-file", required=True,
                        help="detect.json5 (model + NMS config)")
    parser.add_argument("--weights", default="", help="darknet .weights file")
    parser.add_argument("--checkpoint", default="", help="framework .ckpt file")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8650)
    parser.add_argument("--batch-size", type=int, default=8,
                        help="device batch (fixed shape)")
    parser.add_argument("--window-ms", type=float, default=5.0,
                        help="micro-batching window")
    parser.add_argument("--classes-file", default="",
                        help="one class name per line (overrides dataset)")
    parser.add_argument("--devices", default="1",
                        help="serving devices: a count, or a list: cuda:0,cuda:1")
    parser.add_argument("--artifact", default="",
                        help="serve an exported serving artifact dir "
                             "(tool_main export --serving) — no model "
                             "build; batch/size come from the artifact")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    from .._device import resolve_device
    from ..config.app_config import DetectAppConfig
    from ..serve import DetectionService, make_http_server
    from ._common import build_model, devices_arg, inference_devices, nms_options

    config = DetectAppConfig.load(args.config_file)
    base_dir = os.path.dirname(os.path.abspath(args.config_file))
    model_path = os.path.join(base_dir, config.model_file)

    weights = args.weights or config.weights_file
    devices = devices_arg(args.devices)
    if args.artifact:
        if args.weights or args.checkpoint:
            raise ValueError(
                "--artifact bakes the weights in; --weights/--checkpoint "
                "do not apply")
        if (len(devices) if isinstance(devices, list) else devices) > 1:
            raise SystemExit(
                "--devices > 1 needs live-model serving: the exported "
                "artifact is a single-device program")
        device = resolve_device(args.device)
    else:
        devices = inference_devices(devices, 1, args.device)  # the flag's, as the reference
        device = devices[0]
        model, model_path = build_model(
            config, base_dir, weights=weights, checkpoint=args.checkpoint,
            device=device)
    # NMS runs live even with --artifact (only the forward is exported), so
    # the cfg's nms_kind/beta_nms apply either way
    nms_kind, nms_beta = nms_options(config, model_path)

    class_names = None
    ds_classes = config.dataset.classes_file
    if ds_classes and not os.path.isabs(ds_classes):
        ds_classes = os.path.join(base_dir, ds_classes)
    classes_path = args.classes_file or ds_classes
    if classes_path and os.path.exists(classes_path):
        with open(classes_path) as f:
            class_names = [ln.strip() for ln in f if ln.strip()]

    if args.artifact:
        service = DetectionService.from_artifact(
            args.artifact,
            window_ms=args.window_ms,
            nms_iou_thresh=config.nms_iou_thresh,
            nms_conf_thresh=config.nms_conf_thresh,
            nms_kind=nms_kind,
            nms_beta=nms_beta,
            class_names=class_names,
            device=device,
        )
        if service.batch_size != args.batch_size:
            print(f"artifact batch {service.batch_size} overrides "
                  f"--batch-size {args.batch_size}")
    else:
        service = DetectionService(
            model,
            image_size=config.dataset.image_size,
            batch_size=args.batch_size,
            window_ms=args.window_ms,
            nms_iou_thresh=config.nms_iou_thresh,
            nms_conf_thresh=config.nms_conf_thresh,
            nms_kind=nms_kind,
            nms_beta=nms_beta,
            class_names=class_names,
            device=device,
            devices=devices,
        )
    print(f"compiling batch={service.batch_size} "
          f"size={service.image_size} ...", flush=True)
    secs = service.warmup()
    service.start()
    server = make_http_server(service, args.host, args.port)
    # report the bound port (not args.port) so --port 0 = OS-assigned
    # ephemeral port is usable by supervisors/tests
    port = server.server_address[1]
    print(f"warm in {secs:.1f}s; serving on http://{args.host}:{port} "
          f"(POST /detect, GET /healthz, GET /stats)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.shutdown()


def cli():
    """Console-script entry: guarded main."""
    from ._guard import run
    run(main)


if __name__ == "__main__":
    cli()
