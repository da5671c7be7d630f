"""The port's proxy zoo (``repro_torch.core.proxyzoo``) against the JAX
package's: the paper's Tables 3 and 4, the specs cut from them, the proxy
weights and the ``.trims`` files they make are equal; ``proxy_forward``
(torch, on the weights' device) matches the numpy one within 1e-5 relative
to max |h| in float32, ``np.resize``'s cyclic fill across batch rows
included."""
import dataclasses
import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import proxyzoo as J
from repro.core.store import DiskStore as JaxDiskStore
from repro_torch.core import proxyzoo as P
from repro_torch.core.store import DiskStore

SCALES = (1.0, 0.02, 0.001)
RTOL = 1e-5


def test_tables_are_the_papers():
    assert P.SMALL_MODELS == J.SMALL_MODELS and len(P.SMALL_MODELS) == 37
    assert P.LARGE_MODELS == J.LARGE_MODELS and len(P.LARGE_MODELS) == 8
    assert P.MB == J.MB


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("table", ["small_specs", "large_specs"])
def test_specs_equal_field_by_field(table, scale):
    got, want = getattr(P, table)(scale), getattr(J, table)(scale)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert dataclasses.astuple(g) == dataclasses.astuple(w)
        assert P.proxy_flops(g) == J.proxy_flops(w)


@pytest.mark.parametrize("table", ["small_specs", "large_specs"])
def test_proxy_tensors_byte_equal(table):
    for s, w in zip(getattr(P, table)(0.001), getattr(J, table)(0.001)):
        got, want = P.build_proxy_tensors(s), J.build_proxy_tensors(w)
        assert list(got) == list(want), s.name
        for n in want:
            assert got[n].dtype == want[n].dtype and got[n].shape == want[n].shape
            assert got[n].tobytes() == want[n].tobytes(), (s.name, n)


def _digests(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*.trims"))}


def test_populate_store_writes_the_same_files(tmp_path):
    specs = P.small_specs(0.001) + P.large_specs(0.001)
    keys = P.populate_store(DiskStore(str(tmp_path / "port")), specs)
    jkeys = J.populate_store(JaxDiskStore(str(tmp_path / "jax")),
                             J.small_specs(0.001) + J.large_specs(0.001),
                             framework="repro-torch")
    assert {n: tuple(k) for n, k in keys.items()} == {n: tuple(k) for n, k in jkeys.items()}
    assert all(k.framework == "repro-torch" for k in keys.values())
    got, want = _digests(tmp_path / "port"), _digests(tmp_path / "jax")
    assert len(got) == 45 and got == want
    # a second call finds every model and writes nothing
    P.populate_store(DiskStore(str(tmp_path / "port")), specs)
    assert _digests(tmp_path / "port") == want


def _close(got: torch.Tensor, want: np.ndarray):
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("name", ["AlexNet", "SqueezeNet-v1.0", "VGG19", "AlexNet-S4"])
def test_proxy_forward_matches_jax_on_zoo_models(name, as_tensor, batch):
    spec = {s.name: s for s in P.small_specs(0.001) + P.large_specs(0.001)}[name]
    w = P.build_proxy_tensors(spec)
    x = np.random.default_rng(batch).standard_normal((batch, 64)).astype(np.float32)
    want = J.proxy_forward(w, x)
    arg = {n: torch.from_numpy(a) for n, a in w.items()} if as_tensor else w
    _close(P.proxy_forward(arg, torch.from_numpy(x) if as_tensor else x), want)


# (input width, weight shapes): each change of width goes through np.resize
RESIZE_CASES = {
    "grow": (5, [(7, 9), (9, 4)]),
    "shrink": (12, [(5, 6), (6, 3)]),
    "grow_then_shrink": (4, [(11, 13), (3, 2)]),
    "matched": (6, [(6, 6), (6, 2)]),
}


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("case", list(RESIZE_CASES))
def test_proxy_forward_resize(case, batch):
    width, shapes = RESIZE_CASES[case]
    rng = np.random.default_rng(7)
    w = {f"layer{i:03d}_weight": rng.standard_normal(s).astype(np.float32)
         for i, s in enumerate(shapes)}
    w["layer000_bias"] = np.zeros(shapes[0][1], np.float32)
    x = rng.standard_normal((batch, width)).astype(np.float32)
    _close(P.proxy_forward(w, x), J.proxy_forward(w, x))


@pytest.mark.parametrize("shape,to", [((1, 5), (1, 12)), ((3, 5), (3, 7)), ((3, 7), (3, 2)),
                                      ((3, 4), (3, 4)), ((2, 3, 4), (2, 3, 9))])
def test_resize_is_numpys(shape, to):
    h = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = P._resize(torch.from_numpy(h), to)
    np.testing.assert_array_equal(got.numpy(), np.resize(h, to))


def test_proxy_forward_keeps_the_weights_device():
    w = {"a_weight": torch.ones(4, 3, dtype=torch.float64)}
    out = P.proxy_forward(w, np.ones((2, 4), np.float64))
    assert out.dtype == torch.float32 and out.device == w["a_weight"].device
    np.testing.assert_allclose(out.numpy(), np.tanh(4.0), rtol=1e-6)
