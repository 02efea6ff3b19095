"""The harness is driven by data: every cell, configuration, traffic mix,
limit and metric is found by name, and adding one takes new files and new
entries only."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.loops import mocap_live
from benchmark.tests import narrow

ROOT = harness.ROOT
BENCH = ROOT / "benchmark"
SPEC = harness.load_spec()


def test_every_name_in_benchmark_json_has_its_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for cell in SPEC["workloads"]:
        assert cell["config"] in configs
        traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
        assert (BENCH / "loops" / f"{traffic['loop']}.py").is_file()
        assert (BENCH / "configs" / f"{cell['config']}.py").is_file()
        limits = json.loads((BENCH / "limits" / f"{cell['name']}.json").read_text())
        assert limits and all(v >= 0 for v in limits.values())
    for c in SPEC["configs"]:
        assert Path(ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.load_module(BENCH / "metrics" / f"{m['name']}.py").read)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and SPEC["paths"] == ["benchmark"]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["why"]) <= 200
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"} and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"} and UNIT.match(m["unit"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_each_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_one():
    for cell in SPEC["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(SPEC, cell["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = harness.cell_metrics(SPEC, cell["name"], "per_layer")
        assert per_layer and all(m["moves"] in e2e for m in per_layer)


def test_a_new_cell_traffic_limit_and_metric_need_no_edit(tmp_path):
    """A copy of the benchmark with one more cell (a new traffic file read
    by the existing loop, its limits) and one more per-layer metric,
    added as files and entries: the run finds and reports them."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((BENCH / "traffic" / "live.f32.json").read_text())
    traffic["channels"] = traffic["channels"][1:]
    (tmp_path / "benchmark" / "traffic" / "live.probe.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark" / "limits" / "frame.live.probe.json").write_text(
        (BENCH / "limits" / "frame.live.f32.json").read_text())
    (tmp_path / "benchmark" / "metrics" / "convert_ms.probe.py").write_text(
        "def read(record):\n    return 1e3 * sum(record['spans']['convert']) / len(record['spans']['convert'])\n")
    spec["workloads"].append({"name": "frame.live.probe", "config": "mode14_student", "traffic": "live.probe", "chips": 1,
                              "why": "a probe"})
    spec["per_layer"].append({"name": "convert_ms.probe", "unit": "ms", "better": "lower", "source": "program_span",
                              "layer": "Entry", "moves": "frames_per_s", "workloads": ["frame.live.probe"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "frame.live.f32" in m["workloads"]:
            m["workloads"].append("frame.live.probe")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    r = narrow.run("frame.live.probe", trace=True, root=tmp_path)
    assert r["correct"] and r["metrics"]["convert_ms.probe"]["value"] > 0


def test_mocap_stream_is_a_function_of_the_seed():
    traffic = json.loads((BENCH / "traffic" / "live.f32.json").read_text())
    a, ta = mocap_live.stream(traffic, 2**31 + 3)
    b, tb = mocap_live.stream(traffic, 2**31 + 3)
    c, _ = mocap_live.stream(traffic, 2**31 + 4)
    assert a == b and np.array_equal(ta, tb)
    assert a != c
    assert len(a) == traffic["packet_hz"] * traffic["stream_seconds"]
    assert all(x != y for x, y in zip(a, a[1:]))  # the pose short-circuit never fires


def test_distill_pose_batches_are_a_function_of_seed_and_step():
    m = harness.load_module(BENCH / "configs" / "mode07_body_distill.py")
    cfg = narrow.distill_cfg()
    a, b = m.pose_batch(cfg, 2**33, 5, 8), m.pose_batch(cfg, 2**33, 5, 8)
    assert torch.equal(a, b)
    assert not torch.equal(a, m.pose_batch(cfg, 2**33 + 1, 5, 8))
    assert not torch.equal(a, m.pose_batch(cfg, 2**33, 6, 8))
    assert a.shape == (8, 45) and float(a[:, 37:44].min()) < 0.0 <= float(a[:, :37].min())
    for start, stop, size in m.SPARSE_GROUPS:  # one morph group kept a pose
        nonzero = (a[:, start:stop].reshape(8, -1, size) != 0).any(dim=2).sum(dim=1)
        assert int(nonzero.max()) <= 1


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"tha4_tpu_torch", "tha4_tpu", "jax", "jaxlib", "flax"}, path


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole CPU run of each cell in a fresh process, then the top-level
    names of sys.modules (``tha4_tpu_torch`` is not ``tha4_tpu``)."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness\nfrom benchmark.tests import narrow\n"
            "narrow.run('frame.live.f32', seconds=0.5); narrow.run('body_distill.bf16', seconds=0.5)\n"
            "assert 'tha4_tpu_torch' in sys.modules\nprint(harness.forbidden_modules())\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tha4_tpu_torch_probe", sys)
    assert "tha4_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_run_py_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "frame.live.f32", "--seed", str(2**31 + 9),
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""
