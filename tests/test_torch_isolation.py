"""The PyTorch port stands alone: no JAX, no ml_dtypes, no msgpack (the port
has its own wire codec), nothing of `repro`."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "msgpack", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + sorted((ROOT / "examples_torch").glob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_files_exist():
    files = _port_files()
    assert len(files) > 20
    assert all(f.exists() for f in files)
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"src/repro_torch/core/layerplan.py", "src/repro_torch/serving/prefix_cache.py",
            "src/repro_torch/models/moe.py", "src/repro_torch/models/mamba.py"} <= names
    assert {f"src/repro_torch/core/{m}.py" for m in (
        "wire", "transport", "shm_ipc", "codec", "objectstore", "faas")} <= names
    assert {f"src/repro_torch/core/{m}.py" for m in (
        "directory", "cluster", "placement", "noded", "fleetsim")} <= names
    assert {f"src/repro_torch/{m}.py" for m in (
        "optim/adamw", "optim/schedule", "data/pipeline", "checkpoint/checkpoint",
        "checkpoint/manager", "runtime/fault", "launch/train_step", "launch/train")} <= names
    assert {f"src/repro_torch/{m}.py" for m in (
        "launch/mesh", "launch/sharding", "launch/specs", "launch/op_analysis",
        "launch/dryrun", "models/partitioning", "runtime/compression")} <= names
    assert "src/repro_torch/core/proxyzoo.py" in names
    assert {f"examples_torch/{m}.py" for m in (
        "quickstart", "faas_pipeline", "serve_llm", "train_small")} <= names


def _exported(path: Path):
    """Names a package ``__init__`` re-exports or defines at its top level,
    by the module each comes from (``None`` for a name defined there)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update({a.asname or a.name: node.module for a in node.names})
        elif isinstance(node, ast.Assign):
            names.update({t.id: None for t in node.targets if isinstance(t, ast.Name)})
    return names


REF_SRC, PORT_SRC = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
# modules of the JAX package that the port replaces by design: it has no JAX
# to shim, and it counts a step's operations from the ops it runs
# (launch/op_analysis.py), not from HLO text
REPLACED = {"jax_compat.py": None, "launch/hlo_analysis.py": "launch/op_analysis.py"}


@pytest.mark.parametrize("init", sorted(REF_SRC.rglob("__init__.py")),
                         ids=lambda p: str(p.relative_to(REF_SRC)))
def test_package_exports_match_reference(init):
    """Each package ``__init__`` of the port exports every name its JAX
    counterpart does (read from both files' ASTs, so neither package is
    imported)."""
    rel = init.relative_to(REF_SRC)
    port = _exported(PORT_SRC / rel)
    assert set(_exported(init)) - set(port) == set(), rel


def test_every_module_has_a_counterpart():
    ref = {str(p.relative_to(REF_SRC)) for p in REF_SRC.rglob("*.py")}
    port = {str(p.relative_to(PORT_SRC)) for p in PORT_SRC.rglob("*.py")}
    assert ref - port == set(REPLACED)
    assert {v for v in REPLACED.values() if v} <= port


def test_package_names_import_without_a_build():
    """The names the JAX package's ``__init__``s give are importable from
    the port's, and importing the kernels package builds nothing."""
    code = ("import repro_torch; from repro_torch.kernels import _lib, ops, ref; "
            "from repro_torch.runtime import (make_compressed_grad_fn, "
            "quantized_allreduce, tree_quantized_allreduce); "
            "assert repro_torch.__version__ == '1.0.0', repro_torch.__version__; "
            "assert _lib._lib is None, 'importing the kernels built the library'")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_core_exports_match_reference():
    """Neither ``core`` re-exports ``noded``, the daemon's ``python -m``
    entry point, and neither exports the proxy zoo."""
    ref = _exported(REF_SRC / "core" / "__init__.py")
    port = _exported(PORT_SRC / "core" / "__init__.py")
    assert set(ref) - set(port) == set()
    assert {"Cluster", "ClusterNode", "HashRing", "PlacementPlanner",
            "FleetSim"} <= set(port)
    for exported in (ref, port):
        assert not any(mod.endswith((".noded", ".proxyzoo")) for mod in exported.values())


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_serving_import_leaves_jax_out():
    code = ("import sys, repro_torch.serving.engine, repro_torch.launch.serve, "
            "repro_torch.kernels.ops, repro_torch.core.layerplan, "
            "repro_torch.serving.prefix_cache, repro_torch.models.moe, repro_torch.core, "
            "repro_torch.core.shm_ipc, repro_torch.core.transport, repro_torch.core.faas, "
            "repro_torch.core.objectstore, repro_torch.core.cluster, "
            "repro_torch.core.directory, repro_torch.core.placement, "
            "repro_torch.core.noded, repro_torch.core.fleetsim, repro_torch.core.proxyzoo; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'msgpack', 'repro')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_raise_without_cuda(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.core.mrm import MRM
    from repro_torch.core.store import DiskStore
    from repro_torch.serving import InferenceEngine
    disk = DiskStore(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        MRM(disk, device_capacity=1 << 20)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(disk, None)
    from repro_torch.core.noded import NodeDaemon
    spec = {"name": "n", "disk_root": str(tmp_path / "n"),
            "listen": f"unix:{tmp_path}/n.sock"}
    with pytest.raises(RuntimeError, match="CUDA"):
        NodeDaemon(spec)
    NodeDaemon({**spec, "device": "cpu"}).shutdown()
