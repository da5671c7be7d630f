"""Shared set-up of the benchmark's CPU tests: a copy of the benchmark in a
temporary root whose configurations and traffic are cut to a size the CPU
runs in seconds, served in float32."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# the tiny copies serve in float32, where the port and the reference agree to
# rounding (test_bench_reference.py): any gap above this is a fault
TINY_LIMIT = 1e-3
TINY_TRAFFIC = {
    "faas_swap": dict(batch=2, prompt=16),
    "faas_warm": dict(batch=2, prompt=16),
    "decode_b32": dict(batch=4, prompt=8, new_tokens=8),
}


def make_tiny_root(dest: Path) -> Path:
    """The benchmark under ``dest`` with tiny traffic and configurations,
    each cut to its architecture's sizes (``arch/<model_type>.py`` ``tiny``)."""
    from trimsbench import spec
    shutil.copytree(REPO / "trimsbench", dest / "trimsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    for cfg in bench["configs"]:
        c = json.loads((REPO / cfg["file"]).read_text())
        c.update(spec.arch(c).tiny(c), torch_dtype="float32",
                 limits={"logit_gap_max": TINY_LIMIT, "logit_gap_mean": TINY_LIMIT})
        (dest / cfg["file"]).write_text(json.dumps(c))
    for name, cut in TINY_TRAFFIC.items():
        path = dest / "trimsbench" / "traffic" / f"{name}.json"
        t = json.loads(path.read_text())
        t.update(cut)
        path.write_text(json.dumps(t))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
