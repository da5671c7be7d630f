"""What depends on a configuration's architecture is found by its
``model_type`` (``arch/<model_type>.py``, ``refs/<model_type>.py``).

The readings of every dispatcher are pinned to those of ``f2d1853``, the
commit before the architecture files existed, where the same code lived in
``weights.py``, ``serve.py``, ``flops.py``, ``reference.py`` and
``conftest.py``: ``parent_readings.json`` holds what ``readings`` gave there.
A configuration of a third architecture is added to a copy of the benchmark
with new files only and served to ``correct`` true, and each of its faults
fails its limit.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import importlib.util
import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from conftest import REPO, TINY_LIMIT, make_tiny_root
from trimsbench import flops, reference, serve, spec, weights

PINNED = json.loads((Path(__file__).with_name("parent_readings.json")).read_text())
CONFIGS = ["deepseek-7b.l2", "qwen3-moe-30b-a3b.l2"]
TRAFFIC = ["decode_b32", "faas_swap", "faas_warm"]


def _json(path: str) -> dict:
    return json.loads((REPO / path).read_text())


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def readings(tiny_of) -> dict:
    """Layouts, port configurations and counts of the published
    configurations; weight bits and the reference's outputs at the tiny
    sizes ``tiny_of(c)`` gives. One thread, so that every reduction adds
    in one order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _readings(tiny_of)
    finally:
        torch.set_num_threads(threads)


def _readings(tiny_of) -> dict:
    out = {}
    for name in CONFIGS:
        c = _json(f"trimsbench/configs/{name}.json")
        out[f"{name}/layout"] = [[n, list(s), k, repr(float(x))] for n, s, k, x in
                                 weights.layout(c)]
        out[f"{name}/port_config"] = dataclasses.asdict(serve.port_config(c))
        out[f"{name}/counts"] = [weights.n_params(c), weights.nbytes(c),
                                 flops.layer_params_per_token(c)]
        for tn in TRAFFIC:
            t = _json(f"trimsbench/traffic/{tn}.json")
            shape = (c, t["batch"], t["prompt"], t["new_tokens"])
            out[f"{name}/{tn}/request_flops"] = repr(flops.request_flops(*shape))
            out[f"{name}/{tn}/kernel_bounds"] = {
                k: hashlib.sha256(repr(v).encode()).hexdigest()
                for k, v in sorted(flops.request_kernel_bounds(*shape).items())}
        tiny = dict(c, **tiny_of(c))
        out[f"{name}/tiny"] = tiny_of(c)
        for dt in ("bfloat16", "float32"):
            w = weights.draw(dict(tiny, torch_dtype=dt), 1234, "cpu")
            out[f"{name}/draw/{dt}"] = [list(w), _sha(w.values())]
    cases = {"dense": ("deepseek-7b.l2", {}), "moe": ("qwen3-moe-30b-a3b.l2", {}),
             "moe_drops": ("qwen3-moe-30b-a3b.l2",
                           {"assumed": {"capacity_factor": 0.5, "moe_dispatch": "capacity"}})}
    for case, (name, extra) in cases.items():
        c = _json(f"trimsbench/configs/{name}.json")
        c = dict(c, **tiny_of(c), **extra)
        w = {k: v.float() for k, v in weights.draw(c, 77, "cpu").items()}
        g = torch.Generator().manual_seed(5)
        B, S, T = 3, 12, 17
        toks = torch.randint(0, c["vocab_size"], (B, T), generator=g)
        hs = {p: reference.final_hidden(c, w, toks, S, p)
              for p in ("float32", "float8", "bfloat16")}
        h = hs["float32"].reshape(-1, c["hidden_size"])
        served = torch.randint(0, c["vocab_size"], (h.shape[0],), generator=g)
        gaps = reference.gaps(c, w, h, served,
                              {"float8": hs["float8"].reshape(-1, c["hidden_size"])})
        out[f"reference/{case}"] = {
            **{p: _sha([v]) for p, v in hs.items()},
            "logits": _sha([reference.logits(c, w, h)]),
            "logits_float8": _sha([reference.logits(c, w, h, "float8")]),
            "gaps": {k: _sha([v]) for k, v in sorted(gaps.items())},
            "first": [float(x) for x in hs["float32"].reshape(-1)[:4]]}
    return out


@pytest.fixture(scope="module")
def now() -> dict:
    return readings(lambda c: spec.arch(c).tiny(c))


@pytest.mark.parametrize("key", sorted(PINNED))
def test_each_reading_equals_the_parents(now, key):
    assert now[key] == PINNED[key]


def test_no_reading_was_added_or_lost(now):
    assert sorted(now) == sorted(PINNED)


# A third architecture, added with new files only: Qwen3's dense decoder
# (``model_type`` ``qwen3``), llama-style with QK-norm, served by the port's
# DENSE family. Its QK-norm scales are drawn as a leaf kind of its own, and
# it adds a fault of its own: the QK-norm left out.
NEW_ARCH = '''
"""Qwen3's dense decoder: llama-style, with a per-head RMSNorm of the
queries and keys."""
from trimsbench import faults, flops, weights

KINDS = {"head_norm": (None, lambda t, s: t.mul_(s).add_(1.0))}


def port_config(c):
    from repro_torch.configs.base import DENSE
    from trimsbench.serve import decoder_config
    return decoder_config(c, family=DENSE, d_ff=c["intermediate_size"], qk_norm=True)


def layout(c):
    d, lead, hd = c["hidden_size"], (c["num_hidden_layers"],), weights.head_dim(c)
    return (weights.stem(c) + weights.norms(lead, d, "layers/ln1", "layers/ln2")
            + weights.attention(c, lead)
            + [("layers/attn/q_norm", (*lead, hd), "head_norm", weights.NORM_SPREAD),
               ("layers/attn/k_norm", (*lead, hd), "head_norm", weights.NORM_SPREAD)]
            + weights.mlp(lead, d, c["intermediate_size"]))


def layer_params_per_token(c):
    return flops.attention_params(c) + 3 * c["hidden_size"] * c["intermediate_size"]


def request_flops(c, B, S, new):
    L = c["num_hidden_layers"]
    return flops.decoder_flops(c, B, S, new, L * layer_params_per_token(c), L)


def request_kernel_bounds(c, B, S, new):
    return flops.attention_kernel_bounds(c, B, S, new, c["num_hidden_layers"])


def tiny(c):
    return dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
                num_key_value_heads=2, head_dim=16, vocab_size=512)


def _skipped_qk_norm(M):
    orig = M.L.qkv_project

    def qkv_project(cfg, p, x, positions, rope=True):
        p = {k: v for k, v in p.items() if k not in ("q_norm", "k_norm")}
        return orig(cfg, p, x, positions, rope=rope)
    return [(M.L, "qkv_project", qkv_project)]


FAULTS = {"skipped_qk_norm": faults.Fault(_skipped_qk_norm)}
'''
NEW_REF = '''
from trimsbench.reference import attention, layer, mlp, rmsnorm


def final_hidden(c, w, tokens, prompt_len, lin):
    eps = c["rms_norm_eps"]
    x = w["embed"][tokens].float()
    for i in range(c["num_hidden_layers"]):
        x = x + attention(c, layer(w, "layers/attn/", i),
                          rmsnorm(x, w["layers/ln1/scale"][i], eps), lin)
        x = x + mlp(layer(w, "layers/ffn/", i), rmsnorm(x, w["layers/ln2/scale"][i], eps), lin)
    return rmsnorm(x[:, prompt_len - 1:], w["final_norm/scale"], eps)


def logits(c, w, h, lin):
    return lin(h, w["embed"][:c["vocab_size"]].T)
'''
QWEN3_8B = {  # https://huggingface.co/Qwen/Qwen3-8B config.json, 2 of 36 layers, tied
    "name": "qwen3-8b.l2", "model_type": "qwen3", "hidden_size": 4096,
    "intermediate_size": 12288, "num_attention_heads": 32, "num_key_value_heads": 8,
    "head_dim": 128, "num_hidden_layers": 2, "vocab_size": 151936, "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0, "tie_word_embeddings": True, "torch_dtype": "bfloat16",
    "reduced": ["num_hidden_layers", "tie_word_embeddings"]}
NEW_TRAFFIC = {"clients": 1, "batch": 2, "prompt": 8, "new_tokens": 4, "prompts": 3,
               "tenants": 2, "order": [0, 1], "device_tier_models": None,
               "device_tier_headroom": 1.0, "warmup_requests": 2, "check_per_tenant": 2}
DRIVE = '''
import json, sys
from pathlib import Path
import torch
import trimsbench
from trimsbench import faults
from trimsbench.run import run_cell
from trimsbench.spec import load_cell

assert {Path(p).resolve() for p in trimsbench.__path__} == {Path.cwd().resolve() / "trimsbench"}
cell = load_cell("q3.chat", Path.cwd())


def run():
    r = run_cell(cell, 2 ** 31 + 41, 0.3, False, torch.device("cpu"), 0.0)
    return {k: r[k] for k in ("correct", "attempted", "failed", "metrics", "checks")}


out = {"sound": run()}
for name in faults.of_cell(cell.config, cell.traffic):
    saved = [(m, a, getattr(m, a)) for m, a, _ in faults.patches(name, cell.config)]
    for m, a, fn in faults.patches(name, cell.config):
        setattr(m, a, fn)
    try:
        out[name] = run()
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)
print(json.dumps(out))
'''


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def _load_file(path: Path):
    mod_spec = importlib.util.spec_from_file_location("new_arch", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def test_a_new_architecture_is_added_with_new_files_only(tmp_path):
    root = make_tiny_root(tmp_path)
    before = _files(root)
    bench_before = json.loads((root / "BENCHMARK.json").read_text())
    tb = root / "trimsbench"
    (tb / "arch" / "qwen3.py").write_text(NEW_ARCH)
    (tb / "refs" / "qwen3.py").write_text(NEW_REF)
    # cut as conftest cuts the others, by the new file's ``tiny``
    cfg = dict(QWEN3_8B, **_load_file(tb / "arch" / "qwen3.py").tiny(QWEN3_8B),
               torch_dtype="float32", limits={"logit_gap_max": TINY_LIMIT})
    (tb / "configs" / "qwen3-8b.l2.json").write_text(json.dumps(cfg))
    (tb / "traffic" / "chat_tiny.json").write_text(json.dumps(NEW_TRAFFIC))
    bench = json.loads(json.dumps(bench_before))
    bench["configs"].append({"name": "qwen3-8b.l2", "source": "https://huggingface.co/Qwen/Qwen3-8B",
                             "file": "trimsbench/configs/qwen3-8b.l2.json",
                             "reduced": QWEN3_8B["reduced"], "why": "dense with QK-norm"})
    bench["workloads"].append({"name": "q3.chat", "config": "qwen3-8b.l2",
                               "traffic": "chat_tiny", "chips": 1, "why": "throwaway"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{root}:{REPO / 'src'}",
           "PYTHONDONTWRITEBYTECODE": "1", "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(DRIVE)], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])

    sound = res.pop("sound")
    assert sound["correct"] and sound["failed"] == 0 and sound["attempted"] > 0
    assert sound["checks"]["logit_gap_max"]["value"] <= TINY_LIMIT
    assert set(res) == {"altered_token", "half_batch", "skipped_qk_norm", "stale_kv"}
    for name, r in res.items():
        assert not r["correct"], name
        assert r["checks"]["logit_gap_max"]["value"] > 10 * TINY_LIMIT, name

    after = _files(root)
    assert set(after) - set(before) == {
        "trimsbench/arch/qwen3.py", "trimsbench/refs/qwen3.py",
        "trimsbench/configs/qwen3-8b.l2.json", "trimsbench/traffic/chat_tiny.json"}
    assert {k: v for k, v in after.items() if k in before and k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}
    for key, entries in bench_before.items():
        now = json.loads((root / "BENCHMARK.json").read_text())[key]
        assert now[:len(entries)] == entries if isinstance(entries, list) else now == entries


def test_an_unknown_model_type_names_the_missing_file():
    with pytest.raises(FileNotFoundError, match=re.escape(str(Path("arch") / "mamba9.py"))):
        weights.layout({"model_type": "mamba9"})
    with pytest.raises(FileNotFoundError, match=re.escape(str(Path("refs") / "mamba9.py"))):
        reference.logits({"model_type": "mamba9"}, {}, torch.zeros(1, 4))
    with pytest.raises(ValueError):
        spec.arch({"model_type": "../run"})


def _imports(path: Path, top_level_only: bool = False):
    tree = ast.parse(path.read_text())
    for node in (tree.body if top_level_only else ast.walk(tree)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


REFS = sorted((REPO / "trimsbench" / "refs").glob("*.py"))
ARCHS = sorted((REPO / "trimsbench" / "arch").glob("*.py"))


@pytest.mark.parametrize("path", REFS, ids=lambda p: p.name)
def test_a_reference_imports_torch_and_the_shared_blocks_only(path):
    mods = set(_imports(path))
    assert not {m.split(".")[0] for m in mods} & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    assert mods <= {"__future__", "math", "torch", "trimsbench.reference"}, mods


@pytest.mark.parametrize("path", ARCHS, ids=lambda p: p.name)
def test_an_architecture_loads_the_program_only_to_configure_it(path):
    """Layouts, counts and tiny sizes load nothing of the program; only
    ``port_config`` imports it, when called."""
    assert "repro_torch" not in {m.split(".")[0] for m in _imports(path, top_level_only=True)}


def test_every_configuration_has_its_architectures_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    types = {json.loads((REPO / c["file"]).read_text())["model_type"] for c in bench["configs"]}
    assert types == {p.stem for p in ARCHS} == {p.stem for p in REFS}


DISPATCHERS = ["serve.py", "weights.py", "reference.py", "flops.py", "check.py", "faults.py",
               "calibrate.py", "readers.py", "tests/conftest.py"]


@pytest.mark.parametrize("name", DISPATCHERS)
def test_no_dispatcher_names_an_architecture_or_a_configuration(name):
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    named = {p.stem for p in ARCHS} | {c["name"] for c in bench["configs"]}
    tree = ast.parse((REPO / "trimsbench" / name).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert node.value not in named, node.value
        if isinstance(node, ast.Compare):
            assert "model_type" not in ast.unparse(node), ast.unparse(node)
