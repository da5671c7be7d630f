"""The benchmark's files against its contract, and every piece found by name."""
from __future__ import annotations

import ast
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from conftest import REPO, make_tiny_root
from trimsbench.run import run_cell
from trimsbench.spec import load_cell

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["trimsbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][1].startswith("trimsbench/")
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("trimsbench/") and (REPO / c["file"]).exists()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_and_readers(cell):
    got = load_cell(cell, REPO)
    e2e = [m.name for m in got.metrics if not m.per_layer]
    layer = [m for m in got.metrics if m.per_layer]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert all(m.moves in e2e for m in layer)
    assert all(callable(m.read) for m in got.metrics)
    assert {"clients", "batch", "prompt", "new_tokens", "order"} <= set(got.traffic)


def test_every_metric_file_is_named_in_benchmark_json():
    files = {p.stem for p in (REPO / "trimsbench" / "metrics").glob("*.py")}
    named = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert files == named


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_reports_every_metric_of_its_cell_on_the_cpu(tiny_root, cell):
    got = load_cell(cell, tiny_root)
    res = run_cell(got, 2 ** 31 + 77, 0.5, False, torch.device("cpu"), 0.0)
    e2e = {m.name for m in got.metrics if not m.per_layer}
    assert set(res["metrics"]) == e2e
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    for m in res["metrics"].values():
        assert m["value"] > 0


def test_a_cell_and_a_metric_are_added_by_adding_files_only(tmp_path):
    root = make_tiny_root(tmp_path)
    (root / "trimsbench" / "traffic" / "tiny_once.json").write_text(json.dumps({
        "clients": 1, "batch": 1, "prompt": 8, "new_tokens": 3, "prompts": 2,
        "tenants": 1, "order": [0], "device_tier_models": None, "device_tier_headroom": 1.0,
        "warmup_requests": 1, "check_per_tenant": 1}))
    (root / "trimsbench" / "metrics" / "first_tokens.py").write_text(
        "def read(run):\n    return float(sum(r.tokens.shape[0] for r in run.done))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dsk7.tiny_once", "config": "deepseek-7b.l2",
                               "traffic": "tiny_once", "chips": 1, "why": "throwaway"})
    bench["end_to_end"].append({"name": "first_tokens", "unit": "tokens", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["dsk7.tiny_once"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("dsk7.tiny_once", root)
    res = run_cell(cell, 5, 0.3, False, torch.device("cpu"), 0.0)
    assert res["correct"] and res["metrics"]["first_tokens"]["value"] >= 1
    assert set(res["metrics"]) == {"first_tokens", "setup_s"}


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(REPO) for p in
                                        (REPO / "trimsbench").rglob("*.py")), ids=str)
def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(REPO / path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "weights.py", "flops.py"])
def test_the_yardstick_imports_nothing_of_the_program(name):
    tops = {n.split(".")[0] for n in _imports(REPO / "trimsbench" / name)}
    assert "repro_torch" not in tops and not tops & FORBIDDEN


def test_nothing_reads_the_jax_benchmarks_folder():
    for p in (REPO / "trimsbench").rglob("*.py"):
        if "tests" in p.parts:
            continue
        assert not re.search(r"['\"/]benchmarks[/'\"]", p.read_text()), p


def test_the_command_fails_where_only_the_benchmark_is_present(tmp_path):
    import subprocess
    import sys
    shutil.copytree(REPO / "trimsbench", tmp_path / "trimsbench")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "trimsbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
