"""Model inspector and deployment tool:

    python -m yolodl_torch.cli.tool_main info path/to/model.{json5,cfg} [--pipeline-stages N]
    python -m yolodl_torch.cli.tool_main make-dot-file model.json5 out.dot
    python -m yolodl_torch.cli.tool_main anchors --config-file train.json5
    python -m yolodl_torch.cli.tool_main fold-weights model.cfg model.weights
    python -m yolodl_torch.cli.tool_main export model.cfg out_dir --weights model.weights \\
        --serving --batch 8 [--device cpu]

Counterpart of ``yolodl_tpu/cli/tool_main.py``, with its subcommands, flags
and printed lines.  ``export`` writes the port's own artifact
(``models/export.py``: a ``torch.export`` program and ``meta.json``) on
``--device`` (default ``cuda``; ``--device cpu`` on the CPU); the artifact
runs on that device type only.  ``info``, ``make-dot-file``, ``anchors``
and ``fold-weights`` are host work and need no card.
"""

from __future__ import annotations

import argparse


def _load_graph(path: str):
    from ..graph import Graph
    from ..graph.from_darknet import load_darknet_graph

    if path.endswith(".cfg"):
        return load_darknet_graph(path)
    return Graph.load_newslab_v1_json(path)


def main(argv=None):
    parser = argparse.ArgumentParser(description="yolodl_torch model inspector")
    sub = parser.add_subparsers(dest="command", required=True)

    info = sub.add_parser("info", help="print per-node table")
    info.add_argument("model_file")
    info.add_argument("--pipeline-stages", type=int, default=0,
                      help="also print the pipeline-parallel stage plan "
                           "for N stages (balanced cuts, boundary tensors)")

    dot = sub.add_parser("make-dot-file", help="export Graphviz DOT")
    dot.add_argument("model_file")
    dot.add_argument("output_file")

    anchors = sub.add_parser(
        "anchors", help="k-means anchors over a dataset (darknet calc_anchors)"
    )
    anchors.add_argument("--config-file", required=True,
                         help="train/detect JSON5 (dataset block is used)")
    anchors.add_argument("--num", type=int, default=9)
    anchors.add_argument("--iters", type=int, default=100)

    fold = sub.add_parser(
        "fold-weights",
        help="fold BN into conv weights: BN-free deployment cfg+weights pair",
    )
    fold.add_argument("cfg_file")
    fold.add_argument("weights_file")
    fold.add_argument("--out-cfg", default="",
                      help="default: <cfg stem>-folded.cfg")
    fold.add_argument("--out-weights", default="",
                      help="default: <weights stem>-folded.weights")

    export = sub.add_parser(
        "export",
        help="deployment artifact (weights baked in) via torch.export; runs "
             "on the device type it was exported on with no model-building code",
    )
    export.add_argument("model_file", help=".cfg or NEWSLABv1 .json5")
    export.add_argument("output_dir")
    export.add_argument("--weights", default="",
                        help="darknet .weights (darknet cfgs only; "
                             "default: random init)")
    export.add_argument("--checkpoint", default="",
                        help="framework .ckpt to load params from")
    export.add_argument("--batch", type=int, default=1)
    export.add_argument("--size", type=int, default=0,
                        help="input size (default: the cfg net height)")
    export.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    export.add_argument("--serving", action="store_true",
                        help="serving artifact: uint8 NHWC ingest with the "
                             "bf16/255 normalize baked in, consumable by "
                             "serve_main --artifact")
    export.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")

    args = parser.parse_args(argv)

    if args.command == "anchors":
        _calc_anchors(args)
        return
    if args.command == "fold-weights":
        _fold_weights(args)
        return
    if args.command == "export":
        _export(args)
        return

    graph = _load_graph(args.model_file)

    if args.command == "info":
        print(graph.info_table())
        if args.pipeline_stages < 0:
            raise ValueError(
                f"--pipeline-stages must be >= 1, got {args.pipeline_stages}")
        if args.pipeline_stages >= 1:
            # 1 stage is the degenerate whole-model plan (total FLOP
            # estimate, '(output)' boundary row)
            _print_stage_plan(graph, args.pipeline_stages)
    else:
        with open(args.output_file, "w") as f:
            f.write(graph.to_dot())
        print(f"wrote {args.output_file}")


def _print_stage_plan(graph, n_stages: int):
    """The pipeline planner's cut table: per stage the node range, FLOP
    share, and the boundary tensors that cross to the next stage.  The
    planner reads the model's graph and input channels only, so the model
    is built on the CPU."""
    from ..models import YoloModel
    from ..parallel.pipeline import plan_stages

    model = YoloModel(graph, device="cpu")
    plans = plan_stages(model, n_stages)
    total = sum(p.cost for p in plans) or 1.0
    print(f"\npipeline plan ({n_stages} stages):")
    print(f"{'stage':>5}  {'nodes':>6}  {'flops%':>7}  boundary out")
    for s, p in enumerate(plans):
        names = []
        for k in p.out_keys:
            node = graph.nodes[k]
            shape = node.output_shape
            names.append(f"{node.path or k}{shape!r}")
        print(f"{s:>5}  {len(p.keys):>6}  {100 * p.cost / total:>6.1f}%  "
              f"{', '.join(names) or '(output)'}")


def _calc_anchors(args):
    """IoU-distance k-means over dataset box sizes (darknet calc_anchors
    equivalent).  Prints (h, w) ratio anchors sorted by area, plus the mean
    best-IoU fitness.  The config is read with the port's JSON5 reader."""
    import os

    import numpy as np

    from ..config import json5_reader
    from ..config.app_config import DatasetConfig

    with open(args.config_file) as f:
        raw = json5_reader.load(f)
    ds_raw = raw.get("dataset") or raw.get("input")
    if not isinstance(ds_raw, dict):
        raise ValueError(
            f"{args.config_file}: no 'dataset' (train) or 'input' (detect) "
            "section — anchors needs a dataset to cluster")
    config = DatasetConfig.parse(ds_raw, ds_raw.get("class_whitelist", ()))
    dataset = config.open(os.path.dirname(os.path.abspath(args.config_file)))

    sizes = []
    for rec in dataset.records():
        if len(rec.boxes_pixel):
            hw = rec.boxes_pixel[:, 2:4] / np.asarray(
                [rec.height, rec.width], np.float64
            )
            sizes.append(hw)
    if not sizes:
        raise ValueError("dataset has no bounding boxes — nothing to cluster")
    sizes = np.concatenate(sizes, axis=0)
    sizes = sizes[(sizes > 0).all(axis=1)]
    if not len(sizes):
        raise ValueError(
            "every dataset box has a zero-size side — nothing to cluster")
    k = min(args.num, len(sizes))

    def iou_dist(wh, centers):
        inter = np.minimum(wh[:, None, 0], centers[None, :, 0]) * np.minimum(
            wh[:, None, 1], centers[None, :, 1]
        )
        union = wh[:, 0:1] * wh[:, 1:2] + (centers[:, 0] * centers[:, 1])[None] - inter
        return 1.0 - inter / np.maximum(union, 1e-12)

    rng = np.random.default_rng(0)
    centers = sizes[rng.choice(len(sizes), k, replace=False)]
    for _ in range(args.iters):
        assign = np.argmin(iou_dist(sizes, centers), axis=1)
        new = np.stack([
            sizes[assign == i].mean(axis=0) if np.any(assign == i) else centers[i]
            for i in range(k)
        ])
        if np.allclose(new, centers, atol=1e-7):
            break
        centers = new

    order = np.argsort(centers[:, 0] * centers[:, 1])
    centers = centers[order]
    fitness = float(1.0 - iou_dist(sizes, centers).min(axis=1).mean())
    print("anchors (h, w) in image-ratio units:")
    for h, w in centers:
        print(f"  [{h:.4f}, {w:.4f}]")
    print(f"mean best-IoU fitness: {fitness:.4f} over {len(sizes)} boxes")


def _export(args):
    from .._device import resolve_device
    from ..models.export import export_inference

    device = resolve_device(args.device)
    size = args.size
    if args.model_file.endswith(".cfg"):
        from ..config import darknet_cfg as dk
        from ..models.zoo import load_darknet_model

        size = size or dk.Darknet.load(args.model_file).net.height
        model = load_darknet_model(args.model_file, args.weights or None, device=device)
    else:
        if not size:  # before the (expensive) model build + init
            raise SystemExit("--size is required for NEWSLABv1 models")
        from ..models.zoo import load_newslab_model

        model = load_newslab_model(args.model_file, device=device)
    if args.checkpoint:
        from ..bridge import params_from_jax, params_to_jax
        from ..train.checkpoint import load_checkpoint

        params, state, _, _ = load_checkpoint(args.checkpoint,
                                              *params_to_jax(model.state_dict()))
        params_from_jax(params, state, model=model)
    export_inference(model, args.output_dir, batch_size=args.batch, image_size=size,
                     dtype=args.dtype, serving=args.serving)
    kind = "serving u8-NHWC" if args.serving else args.dtype
    print(f"wrote {args.output_dir}/model.pt2 + meta.json "
          f"(batch {args.batch}, {size}x{size}, {kind}, {device.type})")


def _fold_weights(args):
    """BN-folding export (models/fold.py): host-side numpy, no device."""
    import os

    from ..models.fold import fold_darknet_files

    stem_c, _ = os.path.splitext(args.cfg_file)
    stem_w, _ = os.path.splitext(args.weights_file)
    out_cfg = args.out_cfg or f"{stem_c}-folded.cfg"
    out_weights = args.out_weights or f"{stem_w}-folded.weights"
    n_folded, n_kept = fold_darknet_files(
        args.cfg_file, args.weights_file, out_cfg, out_weights
    )
    print(f"folded {n_folded} conv BN layer(s)"
          + (f", kept {n_kept} BN layer(s) (shared-weight convs, crnn or "
             "connected blocks stay unfolded)" if n_kept else ""))
    print(f"wrote {out_cfg}")
    print(f"wrote {out_weights}")


def cli():
    """Console-script entry: guarded main."""
    from ._guard import run
    run(main)


if __name__ == "__main__":
    cli()
