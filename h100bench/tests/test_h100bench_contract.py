"""The result line's contract (contract.py) and the lines each workload's
readings build (run.build_line), in both modes."""

import json
import os

import pytest

from h100bench import configs, contract, run
from h100bench.trace import Trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]


def line(traced, **device):
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": 123}
    dev.update(device)
    out = {"correct": True, "attempted": 10, "failed": 0,
           "metrics": {"train_img_s": {"value": 90.5, "unit": "img/s"},
                       "setup_s": {"value": 30.1, "unit": "s"}},
           "device": dev}
    if traced:
        out["metrics"] = {"mfu.train": {"value": 3.1, "unit": "%"},
                          "idle_share.train": {"value": 5.0, "unit": "%"}}
        out["breakdown"] = {"device_ops": [["k", 0.5]], "idle_gaps": [["op", 0.01]]}
    out["checks"] = {"loss_gap": {"value": 0.001, "limit": 0.01}}
    return out


def test_accepts_well_formed_lines():
    contract.validate(line(False), BENCH, "csp608-train-b64", False)
    contract.validate(line(True, window_s=5.0, busy_s=4.5), BENCH, "csp608-train-b64", True)


@pytest.mark.parametrize("device", [{}, {"window_s": 5.0}, {"busy_s": 1.0},
                                    {"window_s": 5.0, "busy_s": 5.5},
                                    {"window_s": 5.0, "busy_s": 0.0}])
def test_rejects_a_traced_device_without_a_sound_window(device):
    with pytest.raises(contract.ContractError):
        contract.validate(line(True, **device), BENCH, "csp608-train-b64", True)


@pytest.mark.parametrize("broken", ["missing_metric", "wrong_unit", "extra_key", "nan",
                                    "checks_not_last"])
def test_rejects_other_breaches(broken):
    bad = line(False)
    if broken == "missing_metric":
        del bad["metrics"]["setup_s"]
    elif broken == "wrong_unit":
        bad["metrics"]["setup_s"]["unit"] = "ms"
    elif broken == "extra_key":
        bad["extra"] = 1
    elif broken == "nan":
        bad["metrics"]["setup_s"]["value"] = float("nan")
    else:
        bad["checks"] = bad.pop("checks")
        bad["device"] = bad.pop("device")
    with pytest.raises(contract.ContractError):
        contract.validate(bad, BENCH, "csp608-train-b64", False)


def synthetic_trace():
    """Kernels on the device, the program's ranges and pinned uploads on
    the host, as a traced window of any cell records them."""
    device, host, launches = [], [], {}
    t = 1_000_000
    for batch in range(4):
        host.append(("h100bench.forward", t, t + 400_000, 1))
        host.append(("h100bench.postprocess", t + 400_000, t + 500_000, 1))
        device.append(("Memcpy HtoD (Pinned -> Device)", t + 10_000, t + 60_000, (10 * batch + 1, 0)))
        launches[10 * batch + 1] = (t + 5_000, 1)
        device.append(("conv", t + 60_000, t + 350_000, (10 * batch + 2, 0)))
        launches[10 * batch + 2] = (t + 100_000, 1)
        device.append(("nms", t + 420_000, t + 480_000, (10 * batch + 3, 0)))
        launches[10 * batch + 3] = (t + 410_000, 1)
        t += 1_000_000
    return Trace(device, host, launches, (1_000_000, t))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_every_workload_builds_a_line_that_passes(cell, traced):
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    params = json.load(open(os.path.join(ROOT, "h100bench", "workloads", f"{cell}.json")))
    config = configs.load(entry["config"])
    e2e = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell]) and m["name"] != "setup_s"]
    window = {"attempted": 64, "failed": 0, "e2e": [(m["name"], 12.5, m["unit"]) for m in e2e],
              "images": 640, "measured_s": 9.5, "flops_per_image": 1e11, "passes": 3,
              "batches": 40, "fill": 600, "batch": params["batch"],
              "nms_samples": [__import__("torch").rand(2, 16, 4).sort(-1).values],
              "dense_bytes": 10_000_000, "box_itemsize": 2, "iou_thresh": 0.5, "nms_kind": "greedy"}
    checks = {k: {"value": 0.0, "limit": v} for k, v in params["limits"].items()}
    trace = synthetic_trace() if traced else None
    built = run.build_line(BENCH, entry, params, config, window, trace, 30.0, 1 << 30, True,
                           checks, "NVIDIA H100 80GB HBM3")
    contract.validate(json.loads(json.dumps(built)), BENCH, cell, traced)
    assert set(built["metrics"]) == set(contract.declared(BENCH, cell, traced))
