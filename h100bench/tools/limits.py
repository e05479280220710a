"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 -m h100bench.tools.limits --workload <cell> --seeds <n> --controls <m> [--seconds s]

For each of ``--seeds`` seeds it sets the cell up as a run does and reads
the numbers that decide ``correct``: the program's, after a window of
``--seconds`` (a training window also runs at least the three steps the
reference follows).  For the first ``--controls`` seeds
it also reads the control, the reference in float8 (``reference/
precision.py``) put in the program's place, and for training cells the
fault of half of each micro-batch left out.  One JSON line a reading, on
standard output and in ``chiprun_out/limits_<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .. import configs
from ..judge import DetectionTally, training_numbers
from ..reference.precision import fp8, full_precision
from ..run import ROOT, load_cell
from ..trace import Tracer


def detection_control(driver, state_copy, params, quant) -> dict:
    """The reference with ``quant`` in the program's place, judged as the
    program is."""
    net, w = state_copy["net"], state_copy["w"]
    tally = DetectionTally(params["conf_thresh"])
    for batch in state_copy["batches"]:
        x = batch.to(state_copy["device"])
        ref = driver.reference_detections(net, w, x, params, state_copy["kind"], state_copy["beta"])
        low = driver.reference_detections(net, w, x, params, state_copy["kind"], state_copy["beta"],
                                          quant=quant)
        for lo, r in zip(low, ref):
            tally.add([d[:3] for d in lo[0]], *r)
    return tally.numbers()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    args = ap.parse_args(argv)
    import importlib

    bench, cell, params = load_cell(args.workload)
    config = configs.load(cell["config"])
    driver = importlib.import_module(f"h100bench.drivers.{params['driver']}")
    device = torch.device("cuda", 0)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    out = open(os.path.join(ROOT, "chiprun_out", f"limits_{args.workload}.jsonl"), "a")

    def emit(row):
        row.update(workload=args.workload, device=torch.cuda.get_device_name(0))
        print(json.dumps(row), flush=True)
        out.write(json.dumps(row) + "\n")
        out.flush()

    for n in range(args.seeds):
        seed = args.first_seed + 7919 * n
        t = time.time()
        state = driver.setup(config, params, seed, device)
        driver.window(state, args.seconds, Tracer(False, args.seconds, args.seconds))
        keep = {k: state[k] for k in ("net", "w", "w0", "batches", "kind", "beta",
                                      "device", "pool", "train_config", "readings") if k in state}
        numbers = driver.check(state)
        emit({"seed": seed, "role": "program", "numbers": numbers, "s": time.time() - t})
        if n >= args.controls:
            continue
        common_free()
        if params["driver"] == "train":
            ref = driver.reference_readings(keep["net"], keep["w0"], keep["pool"][:3], params,
                                            keep["train_config"])
            roles = [("control_fp8", dict(quant=fp8)),
                     ("fault_half_batch", dict(keep_rows=params["batch"] // params["accum"] // 2))]
            if n == 0:   # how far one ulp of input moves the reference itself
                roles.append(("reference_1ulp", dict(ulp=True)))
            for role, kw in roles:
                low = driver.reference_readings(keep["net"], keep["w0"], keep["pool"][:3], params,
                                                keep["train_config"], **kw)
                emit({"seed": seed, "role": role, "numbers": training_numbers(low, ref)})
            if n == 0:   # a second witness: the program itself in float32, TF32 off
                with full_precision():
                    f32 = driver.setup(dict(config, dtype="float32"), params, seed, device)
                    driver.window(f32, 0.0, Tracer(False, 0.0, 0.0))
                emit({"seed": seed, "role": "program_f32",
                      "numbers": training_numbers(f32["readings"], ref)})
                del f32
        else:
            emit({"seed": seed, "role": "control_fp8",
                  "numbers": detection_control(driver, keep, params, fp8)})
        del keep
        common_free()
    return 0


def common_free():
    from ..drivers.common import free_cuda

    free_cuda()


if __name__ == "__main__":
    raise SystemExit(main())
