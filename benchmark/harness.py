"""Runs one cell once: finds its files by name, drives the traffic, reads
the metrics and decides ``correct``.

``run_cell`` is the whole run without the look for a chip, so that the
tests can drive it on the CPU at narrow widths; ``run.py`` adds that look,
the environment and the printing.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

from benchmark.tracing import Recorder

ROOT = Path(__file__).resolve().parent.parent
# Top-level module names that no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "tha4_tpu")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark by its file (names may hold dots)."""
    name = "benchmark._by_path." + "_".join(path.resolve().with_suffix("").parts[1:]).replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def find_cell(spec: dict, workload: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(spec: dict, workload: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that this cell reports:
    those that list it, and those without a list (per-layer ones where the
    cell reports the end-to-end metric that they move)."""
    e2e = [m["name"] for m in cell_metrics(spec, workload, "end_to_end")] if kind == "per_layer" else None
    out = []
    for m in spec[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif e2e is None or m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def device_info(device: str, count: int) -> dict:
    import torch

    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit,clocks.sm", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20).stdout.strip().split(",")
        info["power_limit_w"], info["sm_clock_mhz"] = float(out[0]), float(out[1])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return info


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t0: float, device: str = "cuda",
             program: str = "program", cfg_override: Optional[dict] = None, root: Path = ROOT) -> dict:
    """One run of ``workload``: its result line as a dict, the checks last.
    ``root`` holds ``BENCHMARK.json`` and the ``benchmark/`` files it names."""
    bench = Path(root) / "benchmark"
    spec = load_spec(root)
    cell = find_cell(spec, workload)
    config_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = load_json(Path(root) / config_entry["file"])
    cfg.update(cfg_override or {})
    traffic = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    ctx = SimpleNamespace(
        seed=int(seed), seconds=float(seconds), trace=bool(trace), device=device, program=program, t0=t0,
        cfg=cfg, traffic=traffic, limits=load_json(bench / "limits" / f"{workload}.json"),
        config=load_module(bench / "configs" / f"{cell['config']}.py"), recorder=Recorder(trace),
    )
    record = load_module(bench / "loops" / f"{traffic['loop']}.py").run(ctx)
    record["trace"] = ctx.recorder.reduced
    metrics = {}
    for m in cell_metrics(spec, workload, "per_layer" if trace else "end_to_end"):
        value = load_module(bench / "metrics" / f"{m['name']}.py").read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = device_info(device, cell["chips"])
    dev["memory_peak_bytes"] = int(record["memory_peak_bytes"])
    result = {"correct": False, "attempted": record["attempted"], "failed": record["failed"], "metrics": metrics, "device": dev}
    if record["trace"] is not None:
        dev["busy_s"], dev["window_s"] = record["trace"]["busy_s"], record["trace"]["window_s"]
        result["breakdown"] = record["trace"]["breakdown"]
    result["compared"] = record["compared"]
    checks = {name: {"value": float(value), "limit": float(limit)} for name, value, limit in record["checks"]}
    result["correct"] = record["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result
