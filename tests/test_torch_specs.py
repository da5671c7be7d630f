"""The dry run's stand-ins (meta tensors) against the JAX package's
``jax.eval_shape`` structs, for every arch x ShapeCell: the same tree
paths, shapes and dtypes for the params, the optimizer state, the batch
and the decode cache; and ``input_specs``' argument and sharding trees of
one structure."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import specs as jspecs
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import specs


def _flat_jax(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in path):
            (tuple(v.shape), np.dtype(v.dtype).name) for path, v in flat}


def _flat(tree, prefix=()):
    out = {}
    items = tree._asdict().items() if hasattr(tree, "_asdict") else tree.items()
    for k, v in items:
        if isinstance(v, dict) or hasattr(v, "_asdict"):
            out.update(_flat(v, prefix + (str(k),)))
        else:
            assert v.device.type == "meta"
            out[prefix + (str(k),)] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_stand_ins_equal_eval_shape(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jp = jspecs.params_struct(jcfg)
    tp = specs.params_struct(cfg)
    assert _flat(tp) == _flat_jax(jp)
    jo = jspecs.opt_struct(jcfg, jp)
    to = specs.opt_struct(cfg, tp)
    assert _flat(to) == _flat_jax({"step": jo.step, "mu": jo.mu, "nu": jo.nu})
    for jcell, cell in zip(JAX_SHAPES, SHAPES):
        assert jcell.name == cell.name
        for labels in (True, False):
            assert _flat(specs.batch_struct(cfg, cell, labels)) == \
                _flat_jax(jspecs.batch_struct(jcfg, jcell, labels)), (cell.name, labels)
        if cell.kind != "train":
            assert _flat(specs.cache_struct(cfg, cell)) == \
                _flat_jax(jspecs.cache_struct(jcfg, jcell)), cell.name


@pytest.mark.parametrize("cell", SHAPES, ids=lambda c: c.name)
def test_input_specs_trees_match(cell):
    """Each argument leaf has a sharding, on a production mesh given as sizes."""
    cfg = get_config("jamba-1.5-large-398b")
    args, in_sh, _ = specs.input_specs(cfg, cell, {"pod": 2, "data": 16, "model": 16})

    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, (tuple, list)):
            return [x for v in t for x in leaves(v)]
        return [t]

    a, s = leaves(args), leaves(in_sh)
    assert len(a) == len(s) and all(isinstance(x, torch.Tensor) for x in a)
    for x, sh in zip(a, s):
        assert len(sh.shard_shape(tuple(x.shape))) == x.ndim
