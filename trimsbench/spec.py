"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic file and the reader of each metric.

Everything that belongs to one configuration, one architecture, one
traffic mix or one metric lives in a file of its own, so a cell, a metric or
a configuration of a new architecture is added by adding files and entries,
never by editing one:

- ``BENCHMARK.json``: the cells (``workloads``), configurations and metrics;
- the configuration named by ``configs[].file``: the published sizes as run
  (Hugging Face keys, ``model_type`` among them), ``reduced``, ``assumed``,
  the deployment, the limits of the correctness check;
- ``trimsbench/arch/<model_type>.py``: what the harness needs of the
  architecture (``port_config``, the weights' ``layout`` and any leaf
  ``KINDS`` of its own, the counts ``layer_params_per_token``,
  ``request_flops`` and ``request_kernel_bounds``, the ``FAULTS`` it adds to
  ``faults.py``'s, and ``tiny``, the sizes of its CPU tests);
- ``trimsbench/refs/<model_type>.py``: its plain float32 forward,
  ``final_hidden`` and ``logits``, built from ``reference.py``'s blocks;
- ``trimsbench/traffic/<traffic>.json``: clients, request shape,
  tenants, their order, the device tier, warm-up and the check's sample;
- ``trimsbench/metrics/<metric>.py``: one reader, ``read(run)``, that
  returns the metric's value or ``None`` where it finds nothing to read.
"""
from __future__ import annotations

import functools
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@dataclass
class Metric:
    name: str
    unit: str
    per_layer: bool
    moves: Optional[str]     # the end-to-end metric a per-layer one should move
    read: Callable


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file, as run
    traffic: dict           # the traffic file
    metrics: List[Metric]   # end-to-end ones first, then per-layer ones


def _load(path: Path, what: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"trimsbench_{path.parent.name}_{path.stem}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"{what} has no file at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_reader(root: Path, name: str) -> Callable:
    return _load(root / "trimsbench" / "metrics" / f"{name}.py", f"metric {name!r}").read


@functools.lru_cache(maxsize=None)
def _by_model_type(folder: str, model_type: str) -> ModuleType:
    if not NAME.match(model_type):
        raise ValueError(f"model_type {model_type!r} is not a name")
    return _load(HERE / folder / f"{model_type}.py", f"model_type {model_type!r}")


def arch(c: dict) -> ModuleType:
    """``arch/<model_type>.py`` of the configuration ``c``."""
    return _by_model_type("arch", c["model_type"])


def refs(c: dict) -> ModuleType:
    """``refs/<model_type>.py``: the plain reference of ``c``'s architecture."""
    return _by_model_type("refs", c["model_type"])


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files and
    the readers of every metric it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "trimsbench" / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    metrics = [Metric(m["name"], m["unit"], False, None, _load_reader(root, m["name"]))
               for m in e2e]
    metrics += [Metric(m["name"], m["unit"], True, m["moves"], _load_reader(root, m["name"]))
                for m in layer]
    return Cell(workload, int(w["chips"]), config, traffic, metrics)
