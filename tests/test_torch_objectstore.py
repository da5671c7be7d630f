"""The port's CLOUD tier against the JAX package's: the codecs, the
content-addressed object store (same blob digests, blob bytes and manifest
for the same file, whole, sharded and layer-sharded, under each codec), the
MRM's cloud opens, streamed cloud opens fed by the shard callbacks, and its
write-back (same tier hits, metrics and window order), and greedy tokens of
a reduced dense model served from the object store, batch and streamed,
against the JAX engine's. Bytes, digests, metrics and tokens are compared
exactly."""
import json
import os

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import MRM as JaxMRM
from repro.core import DiskStore as JaxDiskStore
from repro.core import HardwareModel as JaxHardwareModel
from repro.core import ObjectStore as JaxObjectStore
from repro.core import codec as jax_codec
from repro.core import mrm as jax_mrm_mod
from repro.models import init_params as jax_init_params
from repro.serving import InferenceEngine as JaxInferenceEngine
from repro.serving import publish_model as jax_publish_model
from repro_torch.core import codec, costmodel
from repro_torch.core import mrm as mrm_mod
from repro_torch.core.mrm import MRM, ModelKey
from repro_torch.core.objectstore import ObjectStore
from repro_torch.core.store import DiskStore
from repro_torch.serving import InferenceEngine

MB = 1 << 20
SHARD = 96 << 10


def _layered(L=4, d=32, seed=0):
    rng = np.random.default_rng(seed)

    def f32(*s):   # few distinct values: the compressed codecs have work to do
        return (np.round(rng.standard_normal(s) * 16) / 16).astype(np.float32)

    return {"embed": f32(96, d), "final_norm/scale": f32(d),
            "layers/attn/wq": f32(L, d, d), "layers/attn/wo": f32(L, d, d),
            "layers/ffn/w1": f32(L, d, 4 * d), "layers/ffn/w2": f32(L, 4 * d, d)}


def _blobs(root):
    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "blobs")):
        for fn in files:
            with open(os.path.join(dirpath, fn), "rb") as f:
                out[fn] = f.read()
    return out


@pytest.mark.parametrize("name", sorted(codec.CODECS))
def test_codecs_match_jax(name, tmp_path):
    data = np.random.default_rng(1).bytes(1 << 16) + bytes(1 << 16)
    mine, ref = codec.get_codec(name), jax_codec.get_codec(name)
    assert mine.name == ref.name == name
    packed = mine.compress(data)
    assert packed == ref.compress(data)
    assert mine.decompress(packed) == data
    comp, out = mine.compressor(), []
    for off in range(0, len(data), 10000):
        out.append(comp.compress(data[off:off + 10000]))
    out.append(comp.flush())
    dec = mine.decompressor()
    assert dec.decompress(b"".join(out)) + dec.flush() == data
    path = tmp_path / "sample"
    path.write_bytes(data)
    assert codec.sample_ratio(str(path), mine) == jax_codec.sample_ratio(str(path), ref)


LAYOUTS = {"whole": {}, "sharded": {"shard_bytes": SHARD},
           "layers": {"shard_bytes": SHARD, "shard_plan": "layers"}}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", ["none", "zlib", "lzma"])
def test_store_matches_jax(tmp_path, name, layout):
    """One file into both stores: same digest, manifest and blob bytes; a
    port fetch from the JAX-written store gives the file back."""
    src = DiskStore(str(tmp_path / "src"))
    key = ModelKey("t", "m", "1")
    src.put(key, _layered())
    path = src.path_for(key)
    mine = ObjectStore(str(tmp_path / "port"), codec=name)
    ref = JaxObjectStore(str(tmp_path / "jax"), codec=name)
    kw = LAYOUTS[layout]
    assert mine.put_file(key, path, **kw) == ref.put_file(("t", "m", "1"), path, **kw)
    with open(mine.manifest_path) as f, open(ref.manifest_path) as g:
        assert json.load(f) == json.load(g)
    assert _blobs(mine.root) == _blobs(ref.root)
    assert mine.stats() == ref.stats()
    assert mine.modeled_fetch_s(key) == ref.modeled_fetch_s(("t", "m", "1"))
    # the port reads the JAX-written store
    cross = ObjectStore(str(tmp_path / "jax"))
    dst = DiskStore(str(tmp_path / "dst"))
    seen = []
    cross.fetch(key, dst, on_shard=lambda row, data: seen.append(row["index"]))
    with open(dst.path_for(key), "rb") as f, open(path, "rb") as g:
        assert f.read() == g.read()
    n_shards = len(cross.shard_table(key))
    assert seen == list(range(n_shards))
    if n_shards:
        _, data = mine.fetch_shard(key, 1)
        assert data == ref.fetch_shard(("t", "m", "1"), 1)[1]
    mine.delete(key)
    assert mine.gc_blobs() > 0 and _blobs(mine.root) == {}


# ---------------------------------------------------------------- the MRM

def _hw(jax_side):
    return JaxHardwareModel() if jax_side else costmodel.HardwareModel()


def _new_mrm(jax_side, disk_root, **kw):
    if jax_side:
        return JaxMRM(JaxDiskStore(disk_root), hw=_hw(True), pipelined_staging=False, **kw)
    return MRM(DiskStore(disk_root), hw=_hw(False), pipelined_staging=False, device="cpu",
               **kw)


def _cloud_script(jax_side, tmp, stores):
    """Cloud open, device hit, streamed cloud open, then a write-back MRM
    whose small host tier demotes A to disk. Returns the observations."""
    mod = jax_mrm_mod if jax_side else mrm_mod
    side = "jax" if jax_side else "port"
    Store = JaxObjectStore if jax_side else ObjectStore
    key = lambda n: ("t", n, "1") if jax_side else ModelKey("t", n, "1")  # noqa: E731
    obs = {}
    m1 = _new_mrm(jax_side, f"{tmp}/{side}-d1", objectstore=Store(stores["whole"]),
                  device_capacity=64 * MB, host_capacity=64 * MB)
    hits = []
    for _ in range(2):
        h = m1.open(key("A"))
        hits.append(h.timings.tier_hit)
        m1.close(h)
    obs["batch"] = (hits, {m: m1.stats()[m] for m in ("cloud_downloads", "disk_loads",
                                                        "opens", "h2d_stages")})
    order = []
    mark = mod.LoadFuture._mark_window

    def recording(fut, index):
        if fut.streaming:
            order.append(index)
        mark(fut, index)

    m2 = _new_mrm(jax_side, f"{tmp}/{side}-d2", objectstore=Store(stores["layers"]),
                  device_capacity=64 * MB, host_capacity=64 * MB)
    shards_before_file = []
    fetch = m2.objectstore.fetch

    def watching_fetch(k, dest, report_out=None, on_shard=None):
        def cb(row, data):
            shards_before_file.append(not os.path.exists(dest.path_for(k)))
            on_shard(row, data)
        return fetch(k, dest, report_out=report_out,
                     on_shard=cb if on_shard is not None else None)

    m2.objectstore.fetch = watching_fetch
    mod.LoadFuture._mark_window = recording
    try:
        fut = m2.open_stream(key("A"))
        h = fut.result(timeout=60)
    finally:
        mod.LoadFuture._mark_window = mark
    obs["stream"] = (h.timings.tier_hit, order, len(fut.plan), all(shards_before_file),
                     len(shards_before_file),
                     {m: m2.stats()[m] for m in ("cloud_downloads", "stream_loads",
                                                  "disk_loads")})
    m2.close(h)
    wb = Store(f"{tmp}/{side}-wb")
    sizes = {n: os.path.getsize(stores[n]) for n in "AB"}
    m3 = _new_mrm(jax_side, stores["src_root"], objectstore=wb, writeback_to_cloud=True,
                  device_capacity=64 * MB, host_capacity=max(sizes.values()) + 1)
    for n in "AB":
        m3.close(m3.open(key(n), tier="host"))
    m3.flush_writebacks()
    obs["writeback"] = ({m: m3.stats()[m] for m in ("cloud_writebacks",
                                                     "cloud_writeback_errors")},
                        wb.contains(key("A")), wb.contains(key("B")),
                        wb.stat(key("A"))["digest"] if wb.contains(key("A")) else None)
    m3.shutdown()
    return obs


def test_cloud_tier_matches_jax(tmp_path):
    src = DiskStore(str(tmp_path / "src"))
    paths = {}
    for i, n in enumerate("AB"):
        src.put(ModelKey("t", n, "1"), _layered(L=4 + i, seed=i))
        paths[n] = src.path_for(ModelKey("t", n, "1"))
    stores = {"src_root": str(tmp_path / "src"), **paths}
    for layout in ("whole", "layers"):
        root = str(tmp_path / f"cloud-{layout}")
        st = ObjectStore(root, shard_bytes=SHARD if layout == "layers" else None)
        st.put_file(ModelKey("t", "A", "1"), paths["A"],
                    shard_plan="layers" if layout == "layers" else None)
        stores[layout] = root
    want = _cloud_script(True, str(tmp_path), stores)
    got = _cloud_script(False, str(tmp_path), stores)
    assert got == want
    hits, metrics = got["batch"]
    assert hits == ["cloud", "device"] and metrics["cloud_downloads"] == 1
    tier, order, n_windows, fed_early, n_shards, sm = got["stream"]
    assert tier == "cloud" and order == list(range(n_windows)) and n_windows == 5
    assert fed_early and n_shards >= n_windows and sm["stream_loads"] == 1
    counts, has_a, _, digest = got["writeback"]
    assert counts == {"cloud_writebacks": 1, "cloud_writeback_errors": 0} and has_a
    assert digest == ObjectStore(stores["whole"]).stat(ModelKey("t", "A", "1"))["digest"]


def test_writeback_failures_are_counted_and_shutdown_is_idempotent(tmp_path):
    class BrokenStore:
        def contains(self, key):
            return False

        def put_file(self, key, path, codec=None):
            raise IOError("upload failed")

    disk = DiskStore(str(tmp_path / "d"))
    disk.put(ModelKey("t", "m", "1"), _layered(L=1))
    mrm = MRM(disk, device_capacity=8 * MB, host_capacity=8 * MB, objectstore=BrokenStore(),
              writeback_to_cloud=True, device="cpu")
    mrm.close(mrm.open(ModelKey("t", "m", "1")))
    mrm.host.remove(ModelKey("t", "m", "1"))
    mrm.flush_writebacks()
    assert (mrm.metrics["cloud_writeback_errors"], mrm.metrics["cloud_writebacks"]) == (1, 0)
    mrm.shutdown()
    mrm.shutdown()
    late = MRM(disk, device_capacity=8 * MB, host_capacity=8 * MB, writeback_to_cloud=True,
               device="cpu", cloud_codec="zlib")
    obj = ObjectStore(str(tmp_path / "cloud"))
    late.attach_objectstore(obj)                 # arms the worker when bound late
    late.close(late.open(ModelKey("t", "m", "1")))
    late.host.remove(ModelKey("t", "m", "1"))
    late.shutdown()
    assert late.metrics["cloud_writebacks"] == 1
    assert obj.stat(ModelKey("t", "m", "1"))["codec"] == "zlib"
    assert late.resolvable(ModelKey("t", "m", "1"))


# ---------------------------------------------------------------- tokens

@pytest.fixture(scope="module")
def published(tmp_path_factory):
    root = tmp_path_factory.mktemp("cloud_tokens")
    cfg = jax_get_config("olmo-1b").reduced().replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    disk = JaxDiskStore(str(root / "src"))
    key = jax_publish_model(disk, cfg, jax_init_params(cfg, jax.random.PRNGKey(0)),
                            name="olmo")
    store = ObjectStore(str(root / "cloud"))
    store.put_file(ModelKey(*key), disk.path_for(key), shard_plan="layers",
                   shard_bytes=64 << 10)
    return root, cfg, store.root


def test_cloud_tokens_match_jax(published, tmp_path):
    """The batch engine reads a model's config from its local file, so the
    batch leg opens the model through the MRM first (the CLOUD hit) and then
    serves it from the device; the streamed leg serves the cloud-only key
    directly, its windows fed by the layer shards."""
    root, cfg, cloud = published
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    jdisk = JaxDiskStore(str(tmp_path / "jax"))
    jmrm = JaxMRM(jdisk, device_capacity=1 << 30, objectstore=JaxObjectStore(cloud))
    h = jmrm.open(("repro-jax", "olmo", "1"))
    assert h.timings.tier_hit == "cloud"
    jmrm.close(h)
    want, _ = JaxInferenceEngine(jdisk, jmrm).generate("olmo", toks, max_new_tokens=4)
    key = ModelKey("repro-jax", "olmo", "1")
    for streaming in (False, True):
        disk = DiskStore(str(tmp_path / f"port-{streaming}"))
        mrm = MRM(disk, device_capacity=1 << 30, host_capacity=1 << 30, device="cpu",
                  objectstore=ObjectStore(cloud))
        eng = InferenceEngine(disk, mrm, device="cpu", framework="repro-jax",
                              streaming=streaming)
        if not streaming:
            h = mrm.open(key)
            assert h.timings.tier_hit == "cloud"
            mrm.close(h)
        got, st = eng.generate("olmo", toks, max_new_tokens=4)
        np.testing.assert_array_equal(got, want)
        assert (st.tier_hit, st.streamed) == (("cloud", True) if streaming
                                              else ("device", False))
        assert mrm.stats()["cloud_downloads"] == 1
        again, st2 = eng.generate("olmo", toks, max_new_tokens=4)
        np.testing.assert_array_equal(again, want)
        assert st2.tier_hit in ("device", "host") and not st2.streamed
