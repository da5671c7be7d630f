"""The port's sharding rules against the JAX package's: every param,
optimizer, batch and cache spec of every arch at full width, on the two
production meshes and the small meshes of ``tests/test_sharding_rules.py``
(shapes only: meshes as ``{axis: size}``, no process group), the
non-divisible fallbacks to replication among them; and the local shard
shapes of the port's placements against ``NamedSharding.shard_shape``.
Specs are compared exactly (tuples against ``PartitionSpec``s)."""
import jax
import pytest
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import sharding as jshd
from repro.launch.specs import cache_struct as jax_cache_struct
from repro.launch.specs import params_struct as jax_params_struct
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs


class FakeMesh:
    """The reference's duck-typed mesh (axis names and sizes)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"sp": {"data": 16, "model": 16}, "mp": {"pod": 2, "data": 16, "model": 16},
          "small": {"data": 2, "model": 4}, "small_mp": {"pod": 2, "data": 2, "model": 2},
          "model_only": {"model": 8},
          # sizes that most dims do not divide: the fallbacks to replication
          "odd": {"data": 3, "model": 5}, "odd_mp": {"pod": 3, "data": 2, "model": 7}}


def _flat_jax(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(getattr(k, "key", getattr(k, "name", k)) for k in path): v
            for path, v in flat}


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@pytest.fixture(scope="module")
def structs():
    return {arch: (jax_params_struct(jax_get_config(arch)), specs.params_struct(get_config(arch)))
            for arch in sorted(ARCHS)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_param_specs_equal_the_reference(structs, mesh):
    """Param specs (the optimizer's moments take the same) equal JAX's,
    leaf by leaf, for every arch; on the odd meshes leaves fall back to
    replication where a dim does not divide (the production meshes divide
    every param dim of every arch)."""
    sizes = MESHES[mesh]
    n_fallback = 0
    for arch, (jp, tp) in structs.items():
        want = _flat_jax(jshd.make_param_specs(jax_get_config(arch), jp, FakeMesh(sizes)))
        got = _flat(shd.make_param_specs(get_config(arch), tp, sizes))
        assert set(got) == set(want), arch
        for path, spec in want.items():
            assert got[path] == tuple(spec), (arch, path, got[path], spec)
            rule = shd._RULES.get(path[-1])
            if rule and sum(a is not None for a in got[path]) < sum(
                    l is not None for l in rule[1]):
                n_fallback += 1
    if mesh.startswith("odd"):
        assert n_fallback > 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_cache_specs_equal_the_reference(mesh):
    sizes = MESHES[mesh]
    fm = FakeMesh(sizes)
    assert shd.batch_spec(sizes) == tuple(jshd.batch_spec(fm))
    for arch in sorted(ARCHS):
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        for jcell, cell in zip(JAX_SHAPES, SHAPES):
            if cell.kind != "decode":
                continue
            jc = jax_cache_struct(jcfg, jcell)
            want = _flat_jax(jax.tree_util.tree_map_with_path(
                lambda p, l: jshd.cache_spec(p, l, fm, jcell.global_batch), jc))
            got = _flat(shd.make_cache_specs(specs.cache_struct(cfg, cell), sizes,
                                             cell.global_batch))
            assert set(got) == set(want), (arch, cell.name)
            for path, spec in want.items():
                assert got[path] == tuple(spec), (arch, cell.name, path, got[path], spec)


def test_non_divisible_dims_replicate_not_uneven():
    """qwen1.5-110b's 8 KV heads on a 16-wide model axis: the cache takes
    hd instead (as the reference). On a (3, 5) mesh deepseek-7b's wk
    (L, 4096, 4096) divides by neither axis and is replicated whole; every
    local shape divides its dim exactly."""
    cfg = get_config("qwen1.5-110b")
    sp = MESHES["sp"]
    cs = shd.make_cache_specs(specs.cache_struct(cfg, SHAPES[2]), sp, 128)
    assert cs["attn"]["k"] == (None, "data", None, None, "model")
    cfg = get_config("deepseek-7b")
    ps = specs.params_struct(cfg)
    s = shd.make_param_specs(cfg, ps, MESHES["odd"])
    assert s["layers"]["attn"]["wk"] == (None, None, None)
    for path, spec in _flat(s).items():
        shape = tuple(_flat(ps)[path].shape)
        local = shd.local_shape(shape, spec, MESHES["odd"])
        assert all(d % l == 0 for d, l in zip(shape, local) if l), path


@pytest.mark.parametrize("mesh", ["sp", "mp", "small", "small_mp"])
def test_local_shapes_equal_shard_shape(structs, mesh):
    """Every leaf's local shard shape under the port's spec equals JAX's
    ``NamedSharding(AbstractMesh, spec).shard_shape``."""
    sizes = MESHES[mesh]
    am = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    for arch in ("deepseek-7b", "qwen3-moe-30b-a3b", "jamba-1.5-large-398b",
                 "mamba2-370m", "seamless-m4t-large-v2"):
        jp, tp = structs[arch]
        want = _flat_jax(jshd.make_param_specs(jax_get_config(arch), jp, FakeMesh(sizes)))
        leaves = _flat(tp)
        got = _flat(shd.make_param_specs(get_config(arch), tp, sizes))
        for path, spec in want.items():
            shape = tuple(leaves[path].shape)
            assert shd.local_shape(shape, got[path], sizes) == \
                NamedSharding(am, spec).shard_shape(shape), (arch, path)
            assert shd.NamedSharding(sizes, got[path]).shard_shape(shape) == \
                shd.local_shape(shape, got[path], sizes)


def test_placements_of_a_pod_spec():
    """("pod", "data") on one dim: Shard of that dim on both mesh dims
    (pod major, DTensor's mesh order); the 2-D view names it once."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models.partitioning import placements
    mp = MESHES["mp"]
    assert placements((None, ("pod", "data"), "model"), mp) == (Shard(1), Shard(1), Shard(2))
    assert placements(("model", None), mp) == (Replicate(), Replicate(), Shard(0))
    with pytest.raises(ValueError):
        placements(("model", "model"), mp)
