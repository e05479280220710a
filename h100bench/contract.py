"""The result line's contract, checked before the line is printed.

The line is one JSON object with ``correct`` (bool), ``attempted`` and
``failed`` (whole numbers), ``metrics`` (every metric the cell declares for
this mode, each ``{"value": finite number, "unit": its unit}``, and no
other), ``device`` (``platform`` "gpu", ``kind``, ``count``,
``memory_peak_bytes``; in a traced run also ``window_s`` and ``busy_s``
with 0 < busy_s <= window_s), in a traced run optionally ``breakdown``
(``device_ops`` and ``idle_gaps``, at most 10 [name, seconds] each), and
last ``checks``: each number compared, with its limit.
"""

from __future__ import annotations

import math
from typing import Dict, List


class ContractError(ValueError):
    pass


def _number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) and math.isfinite(x)


def declared(bench: Dict, cell: str, traced: bool) -> Dict[str, str]:
    """{metric: unit} that ``cell`` reports in this mode."""
    if not traced:
        return {m["name"]: m["unit"] for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])}
    e2e = declared(bench, cell, False)
    return {m["name"]: m["unit"] for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)}


def validate(line: Dict, bench: Dict, cell: str, traced: bool) -> None:
    """Raises ContractError with the reason if ``line`` breaks the contract."""
    errors: List[str] = []
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    allowed = keys + ["breakdown", "checks"] if traced else keys + ["checks"]
    missing = [k for k in keys if k not in line]
    if missing:
        raise ContractError(f"the line lacks {missing}")
    if set(line) - set(allowed):
        errors.append(f"unknown keys {sorted(set(line) - set(allowed))}")
    if list(line)[-1] != "checks":
        errors.append("checks is not the last key")
    if not isinstance(line["correct"], bool):
        errors.append("correct is not a bool")
    for k in ("attempted", "failed"):
        if not isinstance(line[k], int) or isinstance(line[k], bool) or line[k] < 0:
            errors.append(f"{k} is not a whole number")
    want = declared(bench, cell, traced)
    got = line["metrics"]
    if not isinstance(got, dict):
        errors.append("metrics is not an object")
        got = {}
    if set(got) != set(want):
        errors.append(f"metrics {sorted(got)} are not the cell's {sorted(want)}")
    for name, unit in want.items():
        m = got.get(name)
        if not isinstance(m, dict) or set(m) != {"value", "unit"} or not _number(m["value"]) \
                or m["unit"] != unit:
            errors.append(f"metric {name} is not {{value, unit: {unit}}} with a finite value: {m}")
    dev = line["device"]
    need = ["platform", "kind", "count", "memory_peak_bytes"] + (["window_s", "busy_s"] if traced else [])
    lacking = [k for k in need if k not in dev]
    if lacking:
        errors.append(f"device lacks {lacking}")
    else:
        if dev["platform"] != "gpu" or not isinstance(dev["kind"], str) or not dev["kind"]:
            errors.append("device platform or kind is wrong")
        if not isinstance(dev["count"], int) or dev["count"] < 1:
            errors.append("device count is not a positive whole number")
        if not isinstance(dev["memory_peak_bytes"], int) or dev["memory_peak_bytes"] <= 0:
            errors.append("memory_peak_bytes is not a positive whole number")
        if traced:
            w, b = dev["window_s"], dev["busy_s"]
            if not (_number(w) and _number(b) and 0 < b <= w):
                errors.append(f"busy_s {b} and window_s {w} do not satisfy 0 < busy_s <= window_s")
    if "breakdown" in line:
        bd = line["breakdown"]
        for k in ("device_ops", "idle_gaps"):
            rows = bd.get(k) if isinstance(bd, dict) else None
            if not isinstance(rows, list) or len(rows) > 10 or not all(
                    isinstance(r, list) and len(r) == 2 and isinstance(r[0], str) and _number(r[1])
                    for r in rows):
                errors.append(f"breakdown {k} is not at most 10 [name, seconds]")
    checks = line.get("checks")
    if not isinstance(checks, dict) or not checks or not all(
            isinstance(v, dict) and set(v) == {"value", "limit"} and _number(v["limit"])
            for v in checks.values()):
        errors.append("checks is not {name: {value, limit}}")
    if errors:
        raise ContractError("; ".join(errors))
