"""The port's dry run (``launch/dryrun.py``) against the JAX package's.

- The eight ``CASES`` of ``tests/test_dryrun.py``, with its small meshes
  ((2, 4) and (2, 2, 2) over a fake group of 8), configs and shapes, give
  the same ok and skipped results (one subprocess for all eight).
- ``argument_bytes`` equals the JAX record's ``argument_size_in_bytes``
  exactly for the two single-pod train cases (the JAX package's dry run on
  8 host devices, a subprocess), and the port's dot FLOPs are within the
  stated factor of the JAX record's ``hlo_analysis`` dot FLOPs (see
  ``FLOP_RATIO``).
- At full width and depth, on the production meshes (fake groups of 256
  and 512), ``deepseek-7b train_4k`` and ``jamba-1.5-large-398b
  long_500k`` (multi-pod) finish, and ``param_count`` equals the config's.

The three subprocesses start together and each has its own timeout.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

CASES = [
    ("olmo-1b", "train_4k", "sp"),
    ("qwen3-moe-30b-a3b", "train_4k", "sp"),
    ("mamba2-370m", "decode_32k", "sp"),
    ("jamba-1.5-large-398b", "long_500k", "sp"),
    ("seamless-m4t-large-v2", "prefill_32k", "sp"),
    ("llama-3.2-vision-90b", "decode_32k", "sp"),
    ("olmo-1b", "train_4k", "mp"),        # multi-pod axis shards
    ("deepseek-7b", "long_500k", "sp"),   # inapplicable -> SKIP
]
TRAIN = [c for c in CASES if c[1] == "train_4k" and c[2] == "sp"]

# Port dot FLOPs / JAX dot FLOPs, per train case, and why they differ:
# - olmo (measured 1.31): the port's plain attention computes the masked
#   half of each S x S block too, and DTensor places some products
#   differently from XLA. A factor within [0.5, 2].
# - qwen3-moe ("capacity" dispatch, measured 5.15): the port runs the
#   dispatch whole on every rank (models/moe.py: DTensor has no rule for
#   its scatters), where XLA partitions it over the 8 chips. Within [0.5, 10].
FLOP_RATIO = {"olmo-1b": (0.5, 2.0), "qwen3-moe-30b-a3b": (0.5, 10.0)}

SMALL = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, "src")
    import repro_torch.launch.dryrun as dr
    import repro_torch.launch.mesh as mesh_mod
    from repro_torch.configs import get_config, base
    import repro_torch.configs.registry as reg

    def small_mesh(*, multi_pod=False, device_type=None):
        shape = (2, 2, 2) if multi_pod else (2, 4)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return mesh_mod.make_mesh(shape, axes, "cpu")

    dr.make_production_mesh = small_mesh
    init = dr.init_fake_group
    dr.init_fake_group = lambda n: init(8)
    base.SHAPES_BY_NAME.update({
        "train_4k": base.ShapeCell("train_4k", 128, 8, "train"),
        "prefill_32k": base.ShapeCell("prefill_32k", 256, 4, "prefill"),
        "decode_32k": base.ShapeCell("decode_32k", 256, 8, "decode"),
        "long_500k": base.ShapeCell("long_500k", 1024, 1, "decode")})
    out = []
    for arch, shape, mp in json.loads(sys.argv[1]):
        reg.ARCHS[arch] = get_config(arch).reduced().replace(
            d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
            vocab_size=512, grad_accum=1)
        try:
            rec = dr.run_cell(arch, shape, mp == "mp")
        except Exception as e:
            rec = {"ok": False, "error": repr(e)}
        out.append({"ok": rec.get("ok"), "skipped": rec.get("skipped", False),
                    "argument_bytes": rec.get("per_device", {}).get("argument_bytes"),
                    "peak": rec.get("per_device", {}).get("peak_hbm_bytes", 0),
                    "dot_flops": rec.get("op_analysis", {}).get("dot_flops"),
                    "err": rec.get("error")})
    print(json.dumps(out))
""")

JAX = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import repro.launch.dryrun as dr
    import repro.launch.mesh as mesh_mod
    from repro.configs import get_config, base
    import repro.configs.registry as reg

    def small_mesh(*, multi_pod=False):
        return mesh_mod.make_mesh((2, 4), ("data", "model"))

    dr.make_production_mesh = small_mesh
    base.SHAPES_BY_NAME.update({"train_4k": base.ShapeCell("train_4k", 128, 8, "train")})
    out = []
    for arch, shape, mp in json.loads(sys.argv[1]):
        reg.ARCHS[arch] = get_config(arch).reduced().replace(
            d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
            vocab_size=512, grad_accum=1)
        rec = dr.run_cell(arch, shape, False)
        out.append({"argument_bytes": rec["per_device"]["argument_bytes"],
                    "dot_flops": rec["hlo_analysis"]["dot_flops"]})
    print(json.dumps(out))
""")

FULL = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, "src")
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_cell
    out = []
    for arch, shape, mp in (("deepseek-7b", "train_4k", False),
                            ("jamba-1.5-large-398b", "long_500k", True)):
        rec = run_cell(arch, shape, mp)
        out.append({"ok": rec["ok"], "chips": rec["chips"],
                    "param_count": rec["param_count"],
                    "want": get_config(arch).param_count(),
                    "peak": rec["per_device"]["peak_hbm_bytes"]})
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def records():
    procs = {
        "small": subprocess.Popen([sys.executable, "-c", SMALL, json.dumps(CASES)], cwd=ROOT,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "jax": subprocess.Popen([sys.executable, "-c", JAX, json.dumps(TRAIN)], cwd=ROOT,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "full": subprocess.Popen([sys.executable, "-c", FULL], cwd=ROOT,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
    }
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=400)
            assert p.returncode == 0, (name, stderr[-2000:])
            out[name] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


@pytest.mark.parametrize("i", range(len(CASES)), ids=["-".join(c) for c in CASES])
def test_dryrun_cell_small_mesh(records, i):
    arch, shape, _ = CASES[i]
    r = records["small"][i]
    assert r["ok"], r["err"]
    if arch == "deepseek-7b" and shape == "long_500k":
        assert r["skipped"]
    else:
        assert not r["skipped"]
        assert r["peak"] > 0


@pytest.mark.parametrize("i", range(len(TRAIN)), ids=[c[0] for c in TRAIN])
def test_argument_bytes_and_flops_match_jax(records, i):
    arch = TRAIN[i][0]
    port = records["small"][CASES.index(TRAIN[i])]
    ref = records["jax"][i]
    assert port["argument_bytes"] == ref["argument_bytes"]
    lo, hi = FLOP_RATIO[arch]
    assert lo <= port["dot_flops"] / ref["dot_flops"] <= hi


def test_full_width_cells_on_the_production_meshes(records):
    ds, jb = records["full"]
    assert ds["ok"] and ds["chips"] == 256 and ds["param_count"] == ds["want"]
    assert jb["ok"] and jb["chips"] == 512 and jb["param_count"] == jb["want"]
    assert ds["peak"] > 0 and jb["peak"] > 0
