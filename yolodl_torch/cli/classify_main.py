"""Classifier train/eval CLI:
``python -m yolodl_torch.cli.classify_main --config-file classify.json5``.

Counterpart of ``yolodl_tpu/cli/classify_main.py``, with its flags, config
and outputs plus ``--device`` (default ``cuda``; ``--device cpu`` runs on
the CPU).  Trains any darknet classification network (cifar,
darknet19/53, alexnet, vgg, resnet, ...) with the cross-entropy step of
``train/classifier.py`` on a CSV-labelled image folder, and evaluates
top-1 and top-k accuracy.

Config (JSON5, read by ``config/json5_reader.py``):
    {
      "version": "0.1.0",
      "model": {"kind": "Darknet", "cfg_file": "cifar.cfg"},
      "dataset": {"image_dir": ".", "label_file": "labels.csv",
                  "classes_file": "classes.txt"},
      "logging": {"dir": "logs"},
      "training": {"batch_size": 32, "save_checkpoint_steps": 100,
                   "optimizer": {"momentum": 0.9,
                                 "lr_schedule": {"type": "Constant", "lr": 0.001}}}
    }

label_file rows: ``image_file,class_name``.  Images are letterboxed to the
cfg's input size.  Checkpoints go to ``logging.dir/<run>/checkpoints`` in
the reference's npz layout (``opt/`` in optax's), so either package's
``--eval`` reads the other's.  ``--eval`` computes dataset top-1 and
top-k accuracy from the most recent checkpoint instead of training; top-k
ranks by a stable descending sort, so a tie goes to the lower class index
as ``jax.lax.top_k`` puts it.
"""

from __future__ import annotations

import argparse
import csv
import os
import time


def _load_records(image_dir: str, label_file: str, classes):
    class_to_id = {name: i for i, name in enumerate(classes)}
    records = []
    with open(label_file) as f:
        for row in csv.DictReader(f):
            name = row["class_name"].strip()
            if name not in class_to_id:
                raise ValueError(f"unknown class {name!r} in {label_file}")
            records.append((os.path.join(image_dir, row["image_file"].strip()),
                            class_to_id[name]))
    if not records:
        raise ValueError(f"no rows in {label_file}")
    return records


def main(argv=None):
    parser = argparse.ArgumentParser(prog="yolodl-classify")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--max-steps", type=int, default=0)
    parser.add_argument("--eval", action="store_true",
                        help="evaluate top-1 accuracy from the most recent "
                             "checkpoint instead of training")
    parser.add_argument("--topk", type=int, default=5,
                        help="also report top-K accuracy with --eval "
                             "(darknet validate_classifier's topk; 1 = off)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from .._device import resolve_device
    from ..bridge import params_from_jax, params_to_jax
    from ..config import darknet_cfg as dk
    from ..config import json5_reader
    from ..config.app_config import _check_version, parse_precision
    from ..data.cache import make_decode_loader
    from ..data.records import FileRecord
    from ..models.zoo import load_darknet_classifier
    from ..train import LrScheduleConfig, TrainConfig, train_init
    from ..train.checkpoint import load_recent_checkpoint_in_runs, save_checkpoint
    from ..train.classifier import make_classifier_train_step
    from ..train.loop import optimizer_state_tree
    from ..train.lr_schedule import lr_schedule_from_darknet

    device = resolve_device(args.device)
    base_dir = os.path.dirname(os.path.abspath(args.config_file))
    with open(args.config_file) as f:
        raw = json5_reader.load(f)
    _check_version(raw, args.config_file)

    def resolve(p):
        return p if os.path.isabs(p) else os.path.join(base_dir, p)

    cfg_file = resolve(raw["model"]["cfg_file"])
    ds = raw["dataset"]
    with open(resolve(ds["classes_file"])) as f:
        classes = [line.strip() for line in f if line.strip()]
    records = _load_records(resolve(ds.get("image_dir", ".")),
                            resolve(ds["label_file"]), classes)

    model = load_darknet_classifier(cfg_file, device=device)
    darknet = dk.Darknet.load(cfg_file)
    in_h, in_w, _ = darknet.net.input_shape_hwc
    loader = make_decode_loader((in_h, in_w))

    training = raw.get("training", {})
    opt_raw = training.get("optimizer", {})
    lr_cfg = LrScheduleConfig.parse(opt_raw.get("lr_schedule", opt_raw.get("lr")))
    if lr_cfg.kind == "from_model_cfg":
        # adopt the darknet [net] policy (burn_in + steps/poly/sig/sgdr...)
        lr_cfg = lr_schedule_from_darknet(darknet.net)
    precision = parse_precision(training.get("precision", "float32"), args.config_file)
    compute_dtype = None if precision == "float32" else precision
    config = TrainConfig(
        lr=lr_cfg,
        optimizer=str(opt_raw.get("type", "adam")).lower(),
        momentum=float(opt_raw.get("momentum", 0.937)),
        weight_decay=float(opt_raw.get("weight_decay", 0.0)),
        compute_dtype=compute_dtype,
    )
    ts, optimizer = train_init(model, config)

    log_dir = resolve(raw.get("logging", {}).get("dir", "classify_logs"))
    run_dir = os.path.join(log_dir, time.strftime("%Y-%m-%d-%H-%M-%S"))
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    batch_size = int(training.get("batch_size", 32))

    def load_batch(batch_records):
        images = np.stack([loader.load(FileRecord(
            path=p, height=0, width=0,
            boxes_pixel=np.zeros((0, 4), np.float32),
            classes=np.zeros((0,), np.int32),
        )).image for p, _ in batch_records])
        labels = np.asarray([lbl for _, lbl in batch_records], np.int64)
        return torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device)

    if args.eval:
        restored = load_recent_checkpoint_in_runs(log_dir, *params_to_jax(model.state_dict()))
        if restored is not None:
            p2, s2, _, meta = restored
            params_from_jax(p2, s2, model=model)
            print(f"restored checkpoint at step {meta['step']}")
        else:
            print(f"no checkpoint found under {log_dir} — "
                  "evaluating the fresh initialization")

        # darknet's validate_classifier reports top-1 AND top-k
        # (classifier.c: topk_accuracy with [net] top, default 5)
        k = max(1, min(int(args.topk), len(classes)))
        dtype = getattr(torch, compute_dtype) if compute_dtype is not None else None

        correct = correct_k = total = 0
        for i in range(0, len(records), batch_size):
            chunk = records[i:i + batch_size]
            n_real = len(chunk)
            # the tail chunk is padded to the full batch with its last
            # record and cut back, as the reference pads it to keep one
            # compiled shape
            chunk = chunk + [chunk[-1]] * (batch_size - n_real)
            images, labels = load_batch(chunk)
            with torch.inference_mode():
                # evaluate in the dtype trained/deployed
                out = model(images if dtype is None else images.to(dtype), train=False)
                flat = out.reshape(out.shape[0], -1)
                topk = torch.sort(flat, dim=-1, descending=True, stable=True).indices[:, :k]
            topk = topk[:n_real].cpu().numpy()
            labels = labels[:n_real].cpu().numpy()
            correct += int((topk[:, 0] == labels).sum())
            correct_k += int((topk == labels[:, None]).any(-1).sum())
            total += n_real
        print(f"top-1 accuracy: {correct / total:.4f} ({correct}/{total})")
        if k > 1:
            print(f"top-{k} accuracy: {correct_k / total:.4f} "
                  f"({correct_k}/{total})")
        return

    os.makedirs(ckpt_dir, exist_ok=True)
    step_fn = make_classifier_train_step(model, optimizer, config)
    save_steps = int(training.get("save_checkpoint_steps", 0))
    if len(records) < batch_size:
        raise ValueError(
            f"dataset has {len(records)} records < batch_size {batch_size} "
            "— no full batch can ever be formed")

    def save(step, loss):
        save_checkpoint(ckpt_dir, step, loss, *params_to_jax(model.state_dict()),
                        optimizer_state_tree(ts, config))

    rng = np.random.default_rng(0)
    step = 0
    while True:
        order = rng.permutation(len(records))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            batch_records = [records[j] for j in order[i:i + batch_size]]
            images, labels = load_batch(batch_records)
            ts, metrics = step_fn(ts, images, labels)
            step += 1
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise RuntimeError(f"non-finite loss at step {step}")
            if step % 10 == 0 or step == 1:
                print(f"step {step}  loss {loss:.5f}  "
                      f"acc {float(metrics['accuracy']):.3f}")
            if save_steps and step % save_steps == 0:
                save(step, loss)
            if args.max_steps and step >= args.max_steps:
                save(step, loss)
                return


def cli():
    """Console-script entry: guarded main."""
    from ._guard import run
    run(main)


if __name__ == "__main__":
    cli()
