"""The benchmark of yolodl_torch on NVIDIA GPUs.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its parameters are ``h100bench/workloads/<cell>.json``, its
configuration ``h100bench/configs/<config>.json``, its traffic a driver
``h100bench/drivers/<driver>.py`` that the parameters name, and each
per-layer metric a reader ``h100bench/metrics/<metric>.py``.  Set-up makes
the weights and inputs from the seed, builds and warms up the program;
the window measures for ``--seconds``; then the program's state is freed
and the reference judges what the window produced.  The last line of
standard output is the result (``contract.py``), the lines before it on
standard error each number compared, with its limit.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "yolodl_tpu")
# caches of compiled code, at fixed places inside the checkout
CACHES = {"TRITON_CACHE_DIR": "build/h100bench/triton",
          "TORCH_EXTENSIONS_DIR": "build/h100bench/torch_extensions"}


def fail(message: str, code: int = 3) -> None:
    print(f"h100bench: {message}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_cell(name: str):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        fail(f"no cell {name!r} in BENCHMARK.json")
    with open(os.path.join(HERE, "workloads", f"{name}.json")) as f:
        params = json.load(f)
    return bench, cells[name], params


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"h100bench_metric_{name.replace('.', '_')}", os.path.join(HERE, "metrics", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = os.path.join(ROOT, path)
    os.environ.setdefault("USE_FLAX", "0")

    bench, cell, params = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        fail(f"the cell needs {cell['chips']} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")

    from . import configs

    line, checks = measure(bench, cell, params, configs.load(cell["config"]), args.seed,
                           args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        fail(f"the process holds {found}, which the measured program must not load")
    from . import contract

    try:
        contract.validate(line, bench, cell["name"], bool(args.trace))
    except contract.ContractError as e:
        fail(f"the result line breaks the contract: {e}")
    for k, v in checks.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


def measure(bench, cell, params, config, seed: int, seconds: float, traced: bool, device):
    """One run of ``cell``: (the result line, {check: {value, limit}})."""
    import torch

    from .judge import verdict
    from .trace import Tracer

    driver = importlib.import_module(f"h100bench.drivers.{params['driver']}")
    tracer = Tracer(traced, seconds, params.get("trace_seconds", seconds))
    state = driver.setup(config, params, seed, device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - T_START
    tracer.prepare()
    window = driver.window(state, seconds, tracer)
    trace = tracer.read() if traced else None
    if traced and trace is None:
        raise RuntimeError("the traced run's profiler never started")
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    numbers = driver.check(state)   # frees the program's state, then the reference
    numbers["failed_requests"] = window["failed"]
    ok, checks = verdict(numbers, dict(params["limits"], failed_requests=0))
    kind = torch.cuda.get_device_name(device) if cuda else device.type
    return build_line(bench, cell, params, config, window, trace, setup_s, peak, ok, checks,
                      kind), checks


def build_line(bench, cell, params, config, window, trace, setup_s, peak, ok, checks, kind):
    """The result line of a run from what the run read."""
    from . import contract

    traced = trace is not None
    if traced:
        values = {}
        wanted = contract.declared(bench, cell["name"], True)
        for m in bench["per_layer"]:
            if m["name"] in wanted:
                value = metric_reader(m["name"])(dict(window, trace=trace, params=params,
                                                      config=config))
                if value is not None:
                    values[m["name"]] = (value, m["unit"])
    else:
        values = {k: (v, u) for k, v, u in window["e2e"]}
        values["setup_s"] = (setup_s, "s")
    device_line = {"platform": "gpu", "kind": kind, "count": cell["chips"],
                   "memory_peak_bytes": peak}
    line = {"correct": bool(ok), "attempted": int(window["attempted"]),
            "failed": int(window["failed"]),
            "metrics": {k: {"value": v, "unit": u} for k, (v, u) in values.items()},
            "device": device_line}
    if traced:
        device_line.update(window_s=trace.window_s, busy_s=trace.busy_s)
        line["breakdown"] = trace.breakdown()
    line["checks"] = {k: {"value": finite(v["value"]), "limit": v["limit"]}
                      for k, v in checks.items()}
    return line


if __name__ == "__main__":
    sys.exit(main())
