"""The port's layer planner and stream assembler against the JAX package's:
the same ``.trims`` files (written by the JAX ``write_model``) give the same
windows, and streamed bytes rebuild every tensor exactly."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layerplan as jlp
from repro.core.store import TensorMeta as JaxTensorMeta
from repro.core.store import write_model as jax_write_model
from repro_torch.core import layerplan as tlp
from repro_torch.core.store import TensorMeta
from repro_torch.device import is_bf16, tensor_from_numpy


def _layered_tensors(L=4, d=16, moe=False, seed=0):
    rng = np.random.default_rng(seed)

    def f32(*s):
        return rng.standard_normal(s).astype(np.float32)

    t = {
        "embed": f32(64, d),
        "final_norm/scale": f32(d),
        "layers/attn/wq": f32(L, d, d),
        "layers/attn/wo": f32(L, d, d),
        "layers/ffn/w1": f32(L, d, 4 * d),
        "layers/ffn/w2": f32(L, 4 * d, d),
    }
    if moe:
        t["layers/ffn/w_gate"] = f32(L, 8, d)          # router: stays base
        t["layers/ffn/w_up"] = f32(L, 8, d, 2 * d)     # expert banks: 4-D
        t["layers/ffn/w_down"] = f32(L, 8, 2 * d, d)
    return t


def _write(tmp_path, tensors, name="m.trims"):
    path = str(tmp_path / name)
    jax_write_model(path, tensors, meta={"arch": "test"})
    return path


def _windows(plan):
    return [(w.index, w.group, w.layer_index, w.tensor_names, w.ranges) for w in plan]


def _feed_all(path, asm, order, chunk=1000):
    with open(path, "rb") as f:
        blob = f.read()
    frags = [(o, blob[o:o + chunk]) for o in range(0, len(blob), chunk)]
    if order == "shuffled":
        np.random.default_rng(1).shuffle(frags)
    elif order == "reversed":
        frags.reverse()
    for off, data in frags:
        asm.feed(off, data)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_plan_matches_jax(tmp_path, moe):
    path = _write(tmp_path, _layered_tensors(L=3, moe=moe))
    tplan, tmf = tlp.plan_for_file(path)
    jplan, _ = jlp.plan_for_file(path)
    assert _windows(tplan) == _windows(jplan)
    # the union of the windows covers the file exactly, without overlap
    pos = 0
    for off, n in sorted(r for w in tplan for r in w.ranges):
        assert off == pos
        pos += n
    assert pos == os.path.getsize(path)
    groups = [w.group for w in tplan]
    assert groups == (["stem"] + ["layer", "expert"] * 3 if moe else ["stem"] + ["layer"] * 3)
    with open(path, "rb") as f:
        head = f.read(tmf.payload_base)
    tparsed, jparsed = tlp.parse_header(head), jlp.parse_header(head)
    assert tparsed[1:] == jparsed[1:]
    assert {n: dataclasses.astuple(m) for n, m in tparsed[0].items()} == \
        {n: dataclasses.astuple(m) for n, m in jparsed[0].items()}
    assert tlp.parse_header(head[:20]) is None


def test_irregular_depth_falls_back_to_stem_as_jax():
    spec = (("layers/a", "float32", (4, 8), 0, 128, 0),
            ("layers/b", "float32", (3, 8), 128, 96, 0))
    tplan = tlp.build_layer_plan({s[0]: TensorMeta(*s) for s in spec}, 64, 288)
    jplan = jlp.build_layer_plan({s[0]: JaxTensorMeta(*s) for s in spec}, 64, 288)
    assert _windows(tplan) == _windows(jplan)
    assert any("layers/b" in w.tensor_names for w in tplan if w.group == "stem")


@pytest.mark.parametrize("order", ["linear", "reversed", "shuffled"])
def test_feeds_in_any_order_reproduce_tensors(tmp_path, order):
    tensors = _layered_tensors(L=4)
    path = _write(tmp_path, tensors)
    fired = []
    asm = tlp.StreamAssembler(on_window=lambda w: fired.append(w.index))
    _feed_all(path, asm, order)
    assert sorted(fired) == [w.index for w in asm.plan]
    for name, ref in tensors.items():
        assert asm.arrays[name].tobytes() == ref.tobytes() and asm.arrays[name].shape == ref.shape
    n = len(fired)
    _feed_all(path, asm, order)               # a full re-delivery: no double events
    assert len(fired) == n
    assert asm.arrays["embed"].tobytes() == tensors["embed"].tobytes()


def test_bf16_file_streams_into_tagged_bits(tmp_path):
    rng = np.random.default_rng(3)
    tensors = {n: np.asarray(jnp.asarray(a, jnp.bfloat16))
               for n, a in _layered_tensors(L=2, seed=3).items()}
    path = _write(tmp_path, tensors)
    asm = tlp.StreamAssembler()
    _feed_all(path, asm, "shuffled", chunk=int(rng.integers(300, 900)))
    for name, ref in tensors.items():
        got = asm.arrays[name]
        assert is_bf16(got) and got.dtype.itemsize == 2, name
        assert got.view(np.uint16).tobytes() == ref.view(np.uint16).tobytes(), name
        row = got[1] if name.startswith("layers/") else got
        t = tensor_from_numpy(row, "cpu")
        want = torch.from_numpy((ref[1] if name.startswith("layers/") else ref)
                                .astype(np.float32))
        assert t.dtype == torch.bfloat16
        assert torch.equal(t.float(), want), name


def test_components_filter_skips_groups(tmp_path):
    tensors = _layered_tensors(L=3, moe=True)
    path = _write(tmp_path, tensors)
    asm = tlp.StreamAssembler(components=("stem", "layer"))
    _feed_all(path, asm, "shuffled")
    assert "layers/ffn/w_up" not in asm.arrays and "layers/ffn/w_down" not in asm.arrays
    assert "layers/ffn/w_gate" in asm.arrays            # the router stays in the base window
    assert asm.complete_count() == len(asm.plan)        # excluded windows are born complete
    assert asm.arrays["layers/attn/wq"].tobytes() == tensors["layers/attn/wq"].tobytes()


def test_feed_shard_splits_rows_over_their_ranges(tmp_path):
    tensors = _layered_tensors(L=2)
    path = _write(tmp_path, tensors)
    plan, _ = tlp.plan_for_file(path)
    with open(path, "rb") as f:
        blob = f.read()
    asm = tlp.StreamAssembler()
    for w in plan:
        row = {"ranges": [list(r) for r in w.ranges]}
        assert tlp.row_ranges(row) == jlp.row_ranges(row) == list(w.ranges)
        asm.feed_shard(row, b"".join(blob[o:o + n] for o, n in w.ranges))
    assert tlp.row_ranges({"offset": 5, "nbytes": 7}) == [(5, 7)]
    for name, ref in tensors.items():
        assert asm.arrays[name].tobytes() == ref.tobytes(), name
