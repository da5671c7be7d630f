"""Weight bridge and `.trims` store: the JAX package and the PyTorch port
read each other's files byte for byte, and agree on configs."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.core import DiskStore as JaxDiskStore
from repro.models import init_params as jax_init_params
from repro.serving import arch_signature as jax_arch_signature
from repro.serving import params_to_flat as jax_params_to_flat
from repro.serving import publish_model as jax_publish_model
from repro_torch.configs import ARCHS, ModelConfig, get_config
from repro_torch.core.store import DiskStore
from repro_torch.core.mrm import ModelKey
from repro_torch.device import tensor_to_numpy
from repro_torch.models import init_params
from repro_torch.serving import arch_signature, params_to_flat, publish_model, to_torch_tree


def _raw(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_config_and_signature_match(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert jax_arch_signature(jcfg) == arch_signature(tcfg)
    assert jax_arch_signature(jcfg.reduced()) == arch_signature(tcfg.reduced())
    assert tcfg.param_count() == jcfg.param_count()
    assert ModelConfig(**dataclasses.asdict(jcfg)) == tcfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_is_byte_equal(dtype):
    jcfg = jax_get_config("qwen1.5-110b").reduced().replace(
        n_layers=2, param_dtype=dtype, compute_dtype=dtype)
    flat = jax_params_to_flat(jax_init_params(jcfg, jax.random.PRNGKey(3)))
    tree = to_torch_tree(flat, "cpu")
    back = params_to_flat(tree)
    assert sorted(back) == sorted(flat)
    want_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for name, a in flat.items():
        node = tree
        for k in name.split("/"):
            node = node[k]
        assert node.dtype == want_dtype and tuple(node.shape) == a.shape, name
        assert _raw(tensor_to_numpy(node)) == _raw(a), name
        assert _raw(back[name]) == _raw(a), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_file_reads_byte_equal_in_port(tmp_path, dtype):
    jcfg = jax_get_config("deepseek-7b").reduced().replace(
        n_layers=2, param_dtype=dtype, compute_dtype=dtype)
    jdisk = JaxDiskStore(str(tmp_path))
    key = jax_publish_model(jdisk, jcfg, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    want = jdisk.open(key).read_all(verify=True)
    mf = DiskStore(str(tmp_path)).open(ModelKey(*key))
    got = mf.read_all(verify=True)
    assert sorted(got) == sorted(want)
    for n in want:
        assert _raw(got[n]) == _raw(want[n]), n
        assert mf.tensors[n].dtype == dtype
    assert ModelConfig(**mf.meta["config"]) == get_config("deepseek-7b").reduced().replace(
        n_layers=2, param_dtype=dtype, compute_dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_file_reads_byte_equal_in_jax(tmp_path, dtype):
    cfg = get_config("mistral-nemo-12b").reduced().replace(
        n_layers=2, param_dtype=dtype, compute_dtype=dtype)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    disk = DiskStore(str(tmp_path))
    key = publish_model(disk, cfg, params, framework="repro-jax")
    got = JaxDiskStore(str(tmp_path)).open(tuple(key)).read_all(verify=True)
    want = params_to_flat(params)
    assert sorted(got) == sorted(want)
    for n in want:
        assert got[n].dtype.name == dtype, n
        assert _raw(got[n]) == _raw(want[n]), n


def test_meta_template_matches_jax_shapes():
    for arch in ("deepseek-7b", "olmo-1b", "qwen1.5-110b", "mistral-nemo-12b"):
        jcfg = jax_get_config(arch).reduced()
        shapes = jax.eval_shape(lambda k: jax_init_params(jcfg, k), jax.random.PRNGKey(0))
        tmpl = init_params(get_config(arch).reduced(), device="meta")
        jflat = {n: tuple(s.shape) for n, s in _flatten(shapes).items()}
        tflat = {n: tuple(t.shape) for n, t in _flatten(tmpl).items()}
        assert jflat == tflat, arch


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, p) if isinstance(v, dict) else {p: v})
    return out


def test_port_registry_matches():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
