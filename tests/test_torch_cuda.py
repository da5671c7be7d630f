"""The port's CUDA kernels against their plain versions, on the card.

Imports torch and the port only (the machine with the card has no JAX):

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py

Each test skips where ``torch.cuda.is_available()`` is false: a CUDA
kernel has no CPU mode. Tolerances: bf16 2e-2 as tests/test_kernels.py;
fp32 1e-4, because the card sums in another order than the plain version.
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import rmsnorm as trms

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _close(got, want, name):
    tol = dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 512, 512, 32, 32, 128), (1, 200, 200, 32, 8, 128),
                                   (2, 130, 70, 8, 1, 64), (2, 64, 64, 2, 2, 8)])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_flash_kernel_matches_plain(cuda_device, shape, name):
    B, S, T, Hq, Hkv, D = shape
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(B, n, h, D, generator=g, device=cuda_device).to(DTYPES[name])
               for n, h in ((S, Hq), (T, Hkv), (T, Hkv)))
    for causal in (True, False):
        before = tflash.launches
        got = tflash.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert tflash.launches == before + 1
        _close(got, tflash.flash_attention_plain(q, k, v, causal=causal), name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 32, 32, 528, 128), (2, 32, 8, 528, 128),
                                  (3, 4, 2, 300, 32), (2, 4, 4, 64, 32)])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_decode_kernel_matches_plain(cuda_device, case, name):
    B, Hq, Hkv, T, D = case
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn(B, Hq, D, generator=g, device=cuda_device).to(DTYPES[name])
    k, v = (torch.randn(B, T, Hkv, D, generator=g, device=cuda_device).to(DTYPES[name])
            for _ in "kv")
    kv_len = torch.randint(0, T + 1, (B,), generator=g, device=cuda_device, dtype=torch.int32)
    before = tdecode.launches
    got = tdecode.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert tdecode.launches == before + 1
    _close(got, tdecode.decode_attention_plain(q, k, v, kv_len), name)


# the plan's edges (kernels/rmsnorm.py::plan_rmsnorm): row counts around
# 132 SMs and widths up to 8192, a D that is not a multiple of the 16-byte
# vector (masked tail) and a row longer than the registers hold (second read)
RMS_EDGES = [(r, d) for r in (1, 2, 131, 133, 1024, 4096) for d in (8, 96, 128, 4096, 5120, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 512, 4096), (2, 1, 4096), (17, 96), (2, 8, 32, 128),
                                   *RMS_EDGES, (7, 100), (2, 40000)])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_rmsnorm_kernel_matches_plain(cuda_device, shape, name):
    """Both eps, the row-strided x[..., -1:, :], scale in the other dtype, a
    base pointer one element off (the scalar branch) and an all-zero row,
    which gives zeros and no NaN."""
    dt = DTYPES[name]
    other = torch.float32 if dt == torch.bfloat16 else torch.bfloat16
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(*shape, generator=g, device=cuda_device).to(dt)
    s = (torch.randn(shape[-1], generator=g, device=cuda_device) + 1).to(dt)
    shifted = torch.randn(x.numel() + 1, generator=g, device=cuda_device).to(dt)[1:].view(shape)
    zero_row = x.clone()       # its own tensor: with one row, x stays random
    zero_row[(0,) * (x.dim() - 1)] = 0
    for eps, xx, ss in ((1e-5, x, s), (1e-6, x, s), (1e-5, x[..., -1:, :], s),
                        (1e-5, x, s.to(other)), (1e-5, shifted, s), (1e-5, zero_row, s)):
        before = trms.launches
        got = trms.rmsnorm(xx, ss, eps)
        torch.cuda.synchronize()
        assert trms.launches == before + 1
        _close(got, trms.rmsnorm_plain(xx, ss, eps), name)
    assert torch.all(got[(0,) * (x.dim() - 1)] == 0)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.randn(1, 8, 2, 256, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        tflash.flash_attention(q[..., :64].half().contiguous(), q[..., :64].half().contiguous(),
                               q[..., :64].half().contiguous())
    kv = torch.randn(2, 16, 2, 32, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        tdecode.decode_attention(torch.randn(2, 4, 32, device=cuda_device), kv, kv,
                                 torch.ones(2, dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError, match="rows"):
        trms.rmsnorm(torch.randn(4, 6, 8, device=cuda_device).transpose(0, 1)[:, ::2],
                     torch.ones(8, device=cuda_device))


# Shapes at the edges of the redesigned attention kernels (as chip_smoke.py
# checks them): the flash kernel's 128-row q tiles, 64-key k tiles and head
# dims zero-filled to 64 or 128; the decode kernel's KV splits.
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 256, 256, 8, 8, 64, True), (2, 64, 64, 4, 2, 8, True),
                                   (1, 300, 300, 8, 2, 128, True),
                                   (2, 300, 100, 4, 4, 128, False),
                                   (2, 100, 300, 8, 2, 64, False)])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_flash_kernel_edges(cuda_device, shape, name):
    B, S, T, Hq, Hkv, D, causal = shape
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(B, n, h, D, generator=g, device=cuda_device).to(DTYPES[name])
               for n, h in ((S, Hq), (T, Hkv), (T, Hkv)))
    got = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _close(got, tflash.flash_attention_plain(q, k, v, causal=causal), name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_flash_with_no_keys_gives_zeros(cuda_device, name):
    q = torch.randn(2, 16, 4, 64, device=cuda_device).to(DTYPES[name])
    kv = torch.empty(2, 0, 4, 64, device=cuda_device, dtype=DTYPES[name])
    got = tflash.flash_attention(q, kv, kv)
    torch.cuda.synchronize()
    assert torch.all(got == 0)
    _close(got, tflash.flash_attention_plain(q, kv, kv), name)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(32, 32), (32, 8), (64, 8)])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_decode_kernel_split_edges(cuda_device, heads, D, name):
    """kv_len 0, 1, on a split boundary, one past it and T in one call, with
    a T that is not a multiple of the split."""
    Hq, Hkv = heads
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    T = 333
    n_split, chunk = tdecode.plan_splits(T, 5, Hkv, n_sm, Hq // Hkv)
    assert n_split > 1 and T % chunk
    lens = (0, 1, chunk, chunk + 1, T)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q = torch.randn(len(lens), Hq, D, generator=g, device=cuda_device).to(DTYPES[name])
    k, v = (torch.randn(len(lens), T, Hkv, D, generator=g, device=cuda_device).to(DTYPES[name])
            for _ in "kv")
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    got = tdecode.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert torch.all(got[0] == 0)
    _close(got, tdecode.decode_attention_plain(q, k, v, kv_len), name)


@pytest.mark.cuda
def test_attention_wrappers_reject_misaligned_layouts(cuda_device):
    x = torch.randn(2, 64, 4, 65, device=cuda_device).to(torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="aligned"):
        tflash.flash_attention(x, x, x)
    # contiguous, but a head dim that is not a multiple of 8: 200-byte head
    # stride in bf16, which TMA cannot step; float32 takes it
    y = torch.randn(1, 64, 2, 100, device=cuda_device)
    with pytest.raises(ValueError, match="stride"):
        tflash.flash_attention(*(y.to(torch.bfloat16),) * 3)
    _close(tflash.flash_attention(y, y, y), tflash.flash_attention_plain(y, y, y), "float32")
    kv = torch.randn(2, 16, 2, 33, device=cuda_device)[..., 1:]
    with pytest.raises(ValueError, match="aligned"):
        tdecode.decode_attention(torch.randn(2, 4, 32, device=cuda_device), kv, kv,
                                 torch.ones(2, dtype=torch.int32, device=cuda_device))


@pytest.mark.cuda
def test_streamed_tokens_equal_batch_tokens_on_the_card(cuda_device, tmp_path):
    """A small bf16 DENSE model served streamed from disk, then batched from
    the host tier and again with a prefix hit: equal tokens, and the streamed
    request ran the kernels (per-layer caches, in inference mode)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.mrm import MRM
    from repro_torch.core.store import DiskStore
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine, publish_model

    cfg = get_config("deepseek-7b").reduced().replace(d_model=256, d_head=64, n_layers=3)
    disk = DiskStore(str(tmp_path))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    publish_model(disk, cfg, init_params(cfg, gen, device=cuda_device), name="m")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    eng = InferenceEngine(disk, MRM(disk, device_capacity=1 << 30, host_capacity=1 << 30),
                          streaming=True, prefix_cache_bytes=64 << 20)
    ops.reset_launches()
    streamed, st = eng.generate("m", toks, max_new_tokens=6)
    assert st.streamed and st.tier_hit == "disk"
    assert (tflash.launches, tdecode.launches) == (3, 3 * 5)
    batched, st2 = eng.generate("m", toks, max_new_tokens=6)
    hit, st3 = eng.generate("m", toks, max_new_tokens=6)
    assert (st2.streamed, st2.tier_hit, st3.tier_hit) == (False, "host", "device")
    assert eng.prefix_kv.hits == 1
    np.testing.assert_array_equal(streamed, batched)
    np.testing.assert_array_equal(hit, batched)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [2, 256])
def test_capacity_moe_is_bitwise_repeatable_on_the_card(cuda_device, T):
    """bf16 capacity MoE at qwen3-moe's expert shape (128 experts, top 8):
    two runs on the same inputs give the same bits (no atomic combine), at
    a decode batch (T = 2: C = 1, assignments dropped) and a prefill one."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as tmoe

    cfg = get_config("qwen3-moe-30b-a3b").replace(d_model=512, d_ff=256)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    p = tmoe.init_moe(cfg, (), g, cuda_device)
    x = torch.randn(T, cfg.d_model, generator=g, device=cuda_device).to(torch.bfloat16)
    out1, aux1 = tmoe.moe_capacity(cfg, p, x)
    out2, aux2 = tmoe.moe_capacity(cfg, p, x)
    torch.cuda.synchronize()
    assert out1.dtype == torch.bfloat16 and torch.isfinite(out1).all()
    assert torch.equal(out1, out2) and torch.equal(aux1, aux2)


@pytest.mark.cuda
def test_moe_streamed_tokens_equal_batch_tokens_on_the_card(cuda_device, tmp_path):
    """A small bf16 MoE model (GQA, QK-norm, 8 experts top 2) served
    streamed from disk (expert windows demanded), then batched from the
    host tier: equal tokens; the streamed request ran the kernels."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.mrm import MRM
    from repro_torch.core.store import DiskStore
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine, publish_model

    cfg = get_config("qwen3-moe-30b-a3b").reduced().replace(d_model=256, d_head=64,
                                                            n_layers=3)
    disk = DiskStore(str(tmp_path))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    publish_model(disk, cfg, init_params(cfg, gen, device=cuda_device), name="m")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    eng = InferenceEngine(disk, MRM(disk, device_capacity=1 << 30, host_capacity=1 << 30),
                          streaming=True)
    ops.reset_launches()
    streamed, st = eng.generate("m", toks, max_new_tokens=6)
    assert st.streamed and st.tier_hit == "disk"
    assert (tflash.launches, tdecode.launches, trms.launches) == (3, 3 * 5, (4 * 3 + 1) * 6)
    batched, st2 = eng.generate("m", toks, max_new_tokens=6)
    assert (st2.streamed, st2.tier_hit) == (False, "host")
    np.testing.assert_array_equal(streamed, batched)


def _publish_small(cuda_device, disk, names=("m",), n_layers=(3,)):
    """Small bf16 DENSE models on ``disk``; returns their config."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import publish_model

    base = get_config("deepseek-7b").reduced().replace(d_model=256, d_head=64)
    cfgs = {}
    for seed, (name, n) in enumerate(zip(names, n_layers)):
        cfgs[name] = base.replace(n_layers=n)
        gen = torch.Generator(device=cuda_device).manual_seed(seed)
        publish_model(disk, cfgs[name], init_params(cfgs[name], gen, device=cuda_device),
                      name=name)
    return cfgs


@pytest.mark.cuda
def test_shm_demotion_bytes_equal_the_device_copy_on_the_card(cuda_device, tmp_path,
                                                              monkeypatch):
    """shm mode on the card: a device eviction copies A from the card
    straight into a new segment; its bits equal the device copy's."""
    import os

    from repro_torch.core import shm_ipc
    from repro_torch.core.mrm import MRM, ModelKey
    from repro_torch.core.store import DiskStore
    from repro_torch.device import tensor_from_numpy

    monkeypatch.setattr(shm_ipc, "SEGMENT_PREFIX", f"trimscuda{os.getpid()}_")
    disk = DiskStore(str(tmp_path))
    _publish_small(cuda_device, disk, "ABC", (4, 2, 2))
    size = {n: disk.open(("repro-torch", n, "1")).total_bytes for n in "ABC"}
    mrm = MRM(disk, device_capacity=size["A"] + size["B"] // 2,
              host_capacity=size["A"] + size["B"] + size["B"] // 2, use_shm=True)
    key = lambda n: ModelKey("repro-torch", n, "1")  # noqa: E731
    try:
        mrm.close(mrm.open(key("A")))
        dev = dict(mrm.device.peek(key("A")).payload)
        mrm.prefetch(key("B"), tier="host").result(timeout=60)
        mrm.prefetch(key("C"), tier="host").result(timeout=60)
        assert mrm.host.peek(key("A")) is None
        mrm.close(mrm.open(key("B")))
        assert mrm.tiers.demotions == 1
        hm = mrm.host.peek(key("A")).payload
        assert len(hm.shm_segments) == 1
        for n, t in dev.items():
            got = tensor_from_numpy(hm.arrays[n], cuda_device)
            assert got.dtype == t.dtype and got.shape == t.shape, n
            assert torch.equal(got.view(torch.int16), t.view(torch.int16)), n
    finally:
        for e in list(mrm.host.entries.values()):
            if e.payload is not None:
                e.payload.release()


CUDA_CLIENT = """
import json, sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
from repro_torch.configs import ModelConfig
from repro_torch.core.shm_ipc import RemoteTrimsClient
from repro_torch.core.store import DiskStore
from repro_torch.device import tensor_from_numpy
from repro_torch.models import model as M
from repro_torch.serving.weights_io import flat_to_params_like

dev = torch.device("cuda")
key = ("repro-torch", "m", "1")
cfg = ModelConfig(**dict(DiskStore({store!r}).open(key).meta["config"]))
c = RemoteTrimsClient({sock!r})
h = c.open(*key)
w = {{n: tensor_from_numpy(a, dev) for n, a in h.arrays.items()}}
params = flat_to_params_like(M.init_params(cfg, device="meta"), w)
toks = torch.as_tensor(np.asarray({toks!r}, dtype=np.int32), dtype=torch.long, device=dev)
S = toks.shape[1]
logits, cache = M.prefill(cfg, params, {{"tokens": toks}}, max_len=S + 6)
tok = logits.argmax(-1)
out = [tok]
for i in range(5):
    logits, cache = M.decode_step(cfg, params, cache, tok, S + i)
    tok = logits.argmax(-1)
    out.append(tok)
print(json.dumps({{"tokens": torch.stack(out, 1).cpu().tolist(),
                  "tier": h.timings["tier_hit"]}}))
c.close(h)
c.disconnect()
"""


@pytest.mark.cuda
def test_subprocess_client_tokens_equal_the_engine_on_the_card(cuda_device, tmp_path,
                                                               monkeypatch):
    """A client process attaches the daemon's shm copy, puts it on the card
    and generates: its tokens equal the daemon's own engine's."""
    import json
    import os
    import subprocess
    import sys
    import tempfile
    from pathlib import Path

    import numpy as np

    from repro_torch.core import shm_ipc
    from repro_torch.core.mrm import MRM
    from repro_torch.core.store import DiskStore
    from repro_torch.serving import InferenceEngine

    monkeypatch.setattr(shm_ipc, "SEGMENT_PREFIX", f"trimscuda{os.getpid()}_")
    disk = DiskStore(str(tmp_path))
    cfg = _publish_small(cuda_device, disk)["m"]
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    mrm = MRM(disk, device_capacity=1 << 30, host_capacity=1 << 30, use_shm=True)
    want, st = InferenceEngine(disk, mrm).generate("m", toks, max_new_tokens=6)
    assert st.tier_hit == "disk"
    sockdir = tempfile.mkdtemp(prefix="tcu-", dir="/tmp")
    srv = shm_ipc.MRMServer(mrm, os.path.join(sockdir, "m.sock"))
    try:
        src = str(Path(__file__).resolve().parents[1] / "src")
        script = CUDA_CLIENT.format(src=src, store=str(tmp_path), sock=srv.sock_path,
                                    toks=toks.tolist())
        r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stderr[-4000:]
        got = json.loads(r.stdout.strip().splitlines()[-1])
        assert got["tier"] == "host"
        np.testing.assert_array_equal(np.asarray(got["tokens"], np.int32), want)
        assert mrm.stats()["disk_loads"] == 1
    finally:
        srv.stop()
        for e in list(mrm.host.entries.values()):
            if e.payload is not None:
                e.payload.release()
        os.rmdir(sockdir)


@pytest.mark.cuda
def test_cloud_hit_tokens_on_the_card(cuda_device, tmp_path):
    """A model only the object store holds: a batch cloud open, then its
    tokens, and a streamed cloud hit fed by the layer shards, both equal
    to the tokens served from the source disk."""
    import numpy as np

    from repro_torch.core.mrm import MRM, ModelKey
    from repro_torch.core.objectstore import ObjectStore
    from repro_torch.core.store import DiskStore
    from repro_torch.serving import InferenceEngine

    src = DiskStore(str(tmp_path / "src"))
    cfg = _publish_small(cuda_device, src)["m"]
    key = ModelKey("repro-torch", "m", "1")
    store = ObjectStore(str(tmp_path / "cloud"))
    store.put_file(key, src.path_for(key), shard_plan="layers", shard_bytes=1 << 20)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want, _ = InferenceEngine(src, MRM(src, device_capacity=1 << 30)).generate(
        "m", toks, max_new_tokens=6)
    for streaming in (False, True):
        disk = DiskStore(str(tmp_path / f"cold{streaming}"))
        mrm = MRM(disk, device_capacity=1 << 30, host_capacity=1 << 30, objectstore=store)
        if not streaming:
            h = mrm.open(key)
            assert h.timings.tier_hit == "cloud"
            mrm.close(h)
        got, st = InferenceEngine(disk, mrm, streaming=streaming).generate(
            "m", toks, max_new_tokens=6)
        assert st.tier_hit == ("cloud" if streaming else "device")
        assert st.streamed == streaming and mrm.stats()["cloud_downloads"] == 1
        np.testing.assert_array_equal(got, want)


# the shapes the SSM, HYBRID, VLM and ENCDEC families give the kernels:
# mamba2-370m's d_model 1024, jamba's and llama-vision's 8192 (prefill and
# decode rows); attention 64 query over 8 KV heads of 128 (jamba, the
# llama-vision self layers) and seamless's 16/16 of 64, over a (2, 512)
# prompt and a (2, 528) cache
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 512, 1024), (2, 1, 1024), (2, 512, 8192), (2, 1, 8192)])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_rmsnorm_at_the_family_shapes(cuda_device, shape, name):
    g = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn(*shape, generator=g, device=cuda_device).to(DTYPES[name])
    s = (torch.randn(shape[-1], generator=g, device=cuda_device) + 1).to(DTYPES[name])
    before = trms.launches
    got = trms.rmsnorm(x, s, 1e-5)
    torch.cuda.synchronize()
    assert trms.launches == before + 1
    _close(got, trms.rmsnorm_plain(x, s, 1e-5), name)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(64, 8, 128), (16, 16, 64)])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_attention_at_the_family_shapes(cuda_device, heads, name):
    Hq, Hkv, D = heads
    g = torch.Generator(device=cuda_device).manual_seed(7)
    dt = DTYPES[name]
    q, k, v = (torch.randn(2, 512, h, D, generator=g, device=cuda_device).to(dt)
               for h in (Hq, Hkv, Hkv))
    before = tflash.launches
    got = tflash.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tflash.launches == before + 1
    _close(got, tflash.flash_attention_plain(q, k, v, causal=True), name)
    qd = torch.randn(2, Hq, D, generator=g, device=cuda_device).to(dt)
    kc, vc = (torch.randn(2, 528, Hkv, D, generator=g, device=cuda_device).to(dt)
              for _ in "kv")
    kv_len = torch.tensor([527, 513], dtype=torch.int32, device=cuda_device)
    before = tdecode.launches
    got = tdecode.decode_attention(qd, kc, vc, kv_len)
    torch.cuda.synchronize()
    assert tdecode.launches == before + 1
    _close(got, tdecode.decode_attention_plain(qd, kc, vc, kv_len), name)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-1.5-large-398b",
                                  "llama-3.2-vision-90b", "seamless-m4t-large-v2"])
def test_family_tokens_on_the_card_equal_the_cpu(cuda_device, arch):
    """A reduced model of each family in float32, at head dim 64 so that
    the attention families run the kernels: greedy tokens on the card equal
    the CPU's plain path, with a random frontend and gates at 0.5."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    cfg = get_config(arch).reduced().replace(d_model=256, d_head=64, param_dtype="float32",
                                             compute_dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if cfg.family == "vlm":
        params["blocks"]["cross"]["gate_attn"].fill_(0.5)
        params["blocks"]["cross"]["gate_mlp"].fill_(0.5)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40), generator=g)}
    if cfg.family in ("vlm", "encdec"):
        batch["frontend"] = torch.randn(2, cfg.n_frontend_tokens or 24, cfg.d_model,
                                        generator=g)
    want = M.greedy_generate(cfg, params, batch, 6, 46)
    on_card = {n: t.to(cuda_device) for n, t in batch.items()}
    ops.reset_launches()
    got = M.greedy_generate(cfg, _to(params, cuda_device), on_card, 6, 46)
    assert torch.equal(got.cpu(), want)
    assert (tflash.launches > 0) == (cfg.family != "ssm")
    assert trms.launches > 0 or cfg.norm_type == "layernorm"


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(2, 64, 4, 2, 64), (1, 200, 8, 8, 128)], ids=["gqa", "mha"])
def test_flash_function_grads_on_the_card(cuda_device, name, shape):
    """FlashAttentionFn on the card (kernel forward, plain VJP backward)
    against autograd through the plain version on the card."""
    from repro_torch.kernels import ops

    b, s, hq, hkv, d = shape
    dt = DTYPES[name]
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda_device).to(dt)
               for h in (hq, hkv, hkv))
    w = torch.randn(b, s, hq, d, generator=g, device=cuda_device).to(dt)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    before = tflash.launches
    got = torch.autograd.grad(ops.flash_attention(*leaves), leaves, w)
    assert tflash.launches == before + 1
    want = torch.autograd.grad(tflash.flash_attention_plain(*plain), plain, w)
    tol = 2e-2 if name == "bfloat16" else 1e-4
    for a, e in zip(got, want):
        assert (a.float() - e.float()).abs().max() <= tol * e.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen3-moe-30b-a3b", "jamba-1.5-large-398b"])
def test_train_step_on_the_card_equals_the_cpu(cuda_device, arch):
    """One float32 train step of a reduced model (remat "nothing", grad
    accumulation 2) on the card against the CPU: loss and grad_norm within
    1e-4 relative, and the kernels ran in the forward and its recompute."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.train_step import make_optimizer, make_train_step
    from repro_torch.models import model as M

    cfg = get_config(arch).reduced().replace(d_model=256, d_head=64, grad_accum=2,
                                             remat_policy="nothing", param_dtype="float32",
                                             compute_dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    metrics = []
    for dev in (cuda_device, torch.device("cpu")):
        init, update = make_optimizer(cfg, 1e-3, 2, 10)
        p = _to(params, dev)
        ops.reset_launches()
        _, _, m = make_train_step(cfg, update)(p, init(p), make_batch(cfg, 0, 4, 48, device=dev))
        metrics.append({k: v.item() for k, v in m.items()})
        if dev.type == "cuda":
            assert tflash.launches > 0 and trms.launches > 0
    for k in ("loss", "grad_norm"):
        assert abs(metrics[0][k] - metrics[1][k]) <= 1e-4 * abs(metrics[1][k]), k


def _mesh_of_one():
    """A (1, 1) mesh over a one-rank NCCL group (a ``FileStore`` in a fresh
    temporary directory); the caller destroys the group."""
    import tempfile
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    tmp = tempfile.mkdtemp(prefix="trims_test_pg_")
    dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                            world_size=1)
    return init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))


@pytest.mark.cuda
def test_mesh_reaches_the_kernels_on_local_shards(cuda_device):
    """A reduced deepseek-7b's prefill, decode steps and a train step,
    through a (1, 1) mesh (DTensors, the kernels on the local shards via
    ``local_map``), launch each kernel as often as without the mesh and
    give the same tokens and loss."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import act_axes, set_mesh
    from repro_torch.launch.train_step import (make_decode_step, make_optimizer,
                                               make_prefill_step, make_train_step)
    from repro_torch.models import model as M
    from repro_torch.models import partitioning as part

    cfg = get_config("deepseek-7b").reduced()
    params = M.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                           device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda_device)
    batch = make_batch(cfg, 0, 4, 64, device=cuda_device)

    def run(p, tok, b):
        counts = []
        ops.reset_launches()
        logits, cache = make_prefill_step(cfg, 72)(p, {"tokens": tok})
        t = logits.argmax(-1)
        out = [t]
        for i in range(7):
            logits, cache = make_decode_step(cfg)(p, cache, t, 64 + i)
            t = logits.argmax(-1)
            out.append(t)
        counts.append([m.launches for m in ops.KERNEL_MODULES])
        init, update = make_optimizer(cfg, 1e-3, 2, 10)
        ops.reset_launches()
        _, _, metrics = make_train_step(cfg, update)(p, init(p), b)   # updates p in place
        counts.append([m.launches for m in ops.KERNEL_MODULES])
        full = lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x  # noqa: E731
        return torch.stack([full(x) for x in out], 1), counts, float(metrics["loss"])

    clone = lambda tree: {k: clone(v) if isinstance(v, dict) else v.clone()  # noqa: E731
                          for k, v in tree.items()}
    want, want_counts, want_loss = run(clone(params), toks, batch)
    mesh = _mesh_of_one()
    try:
        placed = shd.distribute(params, shd.make_param_shardings(cfg, params, mesh))
        bsh = shd.NamedSharding(mesh, shd.batch_spec(mesh))
        tok = shd.place(toks, bsh)
        b = {k: shd.place(v, bsh) for k, v in batch.items()}
        with part.activation_axes(*act_axes(mesh)), set_mesh(mesh):
            got, counts, loss = run(placed, tok, b)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want)
    assert loss == want_loss
    assert counts == want_counts
    assert all(c > 0 for c in counts[0]) and counts[1][0] > 0 and counts[1][2] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_kernels_at_the_example_shapes(cuda_device, name):
    """The shapes ``examples_torch`` gives the kernels: reduced olmo and
    deepseek (4 heads of 16, d_model 64, prompt 32, a cache of 40) and
    train_small's olmo (4 heads of 32, batch 4 x 64)."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    dt = DTYPES[name]

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(dt)

    for B, S, H, D in ((2, 32, 4, 16), (4, 64, 4, 32)):
        q, k, v = rnd(B, S, H, D), rnd(B, S, H, D), rnd(B, S, H, D)
        _close(tflash.flash_attention(q, k, v, causal=True),
               tflash.flash_attention_plain(q, k, v, causal=True), name)
    q, k, v = rnd(2, 4, 16), rnd(2, 40, 4, 16), rnd(2, 40, 4, 16)
    kv_len = torch.tensor([33, 39], dtype=torch.int32, device=cuda_device)
    _close(tdecode.decode_attention(q, k, v, kv_len),
           tdecode.decode_attention_plain(q, k, v, kv_len), name)
    for shape in ((2, 32, 64), (2, 1, 64)):
        x, sc = rnd(*shape), rnd(64) + 1
        _close(trms.rmsnorm(x, sc, 1e-6), trms.rmsnorm_plain(x, sc, 1e-6), name)


@pytest.mark.cuda
def test_proxy_forward_on_the_card_equals_numpy(cuda_device):
    import numpy as np
    from repro_torch.core.proxyzoo import build_proxy_tensors, large_specs, proxy_forward
    spec = {s.name: s for s in large_specs(0.01)}["VGG16-S4"]
    w = build_proxy_tensors(spec)
    x = np.random.default_rng(0).standard_normal((3, 64)).astype(np.float32)
    got = proxy_forward({n: torch.from_numpy(a).to(cuda_device) for n, a in w.items()}, x)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    want = proxy_forward(w, x).numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.cuda
def test_span_joins_the_profiler_trace_by_thread_and_clock(cuda_device):
    """A span's thread id is the one the profiler gives the CUDA runtime
    calls of its thread, and its clock the one it stamps them with: the
    sleep kernel's launch carries the span's thread id and lies inside it,
    and the kernel lies inside it too. Each span leaves 5 ms of host time
    before the launch and after the synchronise, room for the offset
    between the card's timestamps and the host's, which is printed."""
    import threading
    import time

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import trace

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    rec = trace.Recorder()

    def work():
        with rec.span("sleep"):
            time.sleep(0.005)
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
            time.sleep(0.005)

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    rec.enable()
    work()
    th = threading.Thread(target=work)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    rec.disable()
    prof.stop()
    records = rec.drain()
    assert len(records) == 2 and records[0][3] != records[1][3]
    cuda = torch.autograd.DeviceType.CUDA
    evs = list(prof.profiler.kineto_results.events())
    kernels = [e for e in evs if e.device_type() == cuda and "spin_kernel" in e.name()]
    launches = {e.correlation_id(): e for e in evs
                if e.device_type() != cuda and e.name().startswith("cudaLaunchKernel")}
    assert len(kernels) == 2
    for (_, s, e, tid, *_), k in zip(sorted(records, key=lambda r: r[1]),
                                     sorted(kernels, key=lambda k: k.start_ns())):
        call = launches[k.correlation_id()]
        assert call.device_resource_id() == tid
        assert s <= call.start_ns() and call.start_ns() + call.duration_ns() <= e
        k_end = k.start_ns() + k.duration_ns()
        print(f"span thread {tid}: kernel start - launch start "
              f"{(k.start_ns() - call.start_ns()) / 1e6:.3f} ms, span end - kernel end "
              f"{(e - k_end) / 1e6:.3f} ms, kernel {k.duration_ns() / 1e6:.3f} ms")
        assert s <= k.start_ns() and k_end <= e


def _graph_models(cuda_device, disk, arch="deepseek-7b", names=("m",)):
    """Small bf16 models of ``arch`` on ``disk``, each with its own weights
    (DENSE; or capacity MoE with GQA and QK-norm). Returns (cfg, {name:
    params on the card})."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import publish_model

    cfg = get_config(arch).reduced().replace(d_model=256, d_head=64, n_layers=3)
    params = {}
    for seed, name in enumerate(names):
        gen = torch.Generator(device=cuda_device).manual_seed(seed)
        params[name] = init_params(cfg, gen, device=cuda_device)
        publish_model(disk, cfg, params[name], name=name)
    return cfg, params


def _eager_tokens(cfg, params, toks, n):
    import numpy as np

    from repro_torch.models import model as M

    batch = {"tokens": torch.as_tensor(toks, dtype=torch.long, device=params["embed"].device)}
    out = M.greedy_generate(cfg, params, batch, n, toks.shape[1] + n)
    return out.cpu().numpy().astype(np.int32)


def _prompts(cfg, n, B=2, S=40):
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32) for _ in range(n)]


def _counted():
    """Each kernel wrapper's ``launches`` since the last reset."""
    return {m.__name__.rsplit(".", 1)[1]: m.launches for m in (tflash, tdecode, trms)}


# each kernel module's kernels, as the device trace names them
KERNEL_NAMES = {"flash_attention": ("flash_fwd_tc", "flash_fwd_f32"),
                "decode_attention": ("decode_split_kernel",), "rmsnorm": ("rmsnorm_kernel",)}


def _ran(prof):
    """Each kernel module's kernels on a profiler's device trace."""
    cuda = torch.autograd.DeviceType.CUDA
    names = [e.name() for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    return {k: sum(any(p in n for p in pats) for n in names) for k, pats in KERNEL_NAMES.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen3-moe-30b-a3b"])
def test_graph_decode_tokens_and_launches_equal_the_eager_step(cuda_device, tmp_path, arch):
    """DENSE and capacity MoE served through the engine: the first request
    runs one eager step and captures, every later step is replayed; tokens
    equal greedy_generate's eager tokens bit for bit over requests with
    different prompts. The wrappers count only what passes them: the
    prefill, the eager step and the capture's record, once; a replay adds
    nothing."""
    import numpy as np

    from repro_torch.core.mrm import MRM
    from repro_torch.core.store import DiskStore
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving import InferenceEngine

    disk = DiskStore(str(tmp_path))
    cfg, params = _graph_models(cuda_device, disk, arch)
    eng = InferenceEngine(disk, MRM(disk, device_capacity=1 << 30, host_capacity=1 << 30))
    n = 6
    for i, toks in enumerate(_prompts(cfg, 3)):
        ops.reset_launches()
        got, st = eng.generate("m", toks, max_new_tokens=n)
        counted = _counted()
        ops.reset_launches()
        want = _eager_tokens(cfg, params["m"], toks, n)
        eager = _counted()
        ops.reset_launches()
        batch = {"tokens": torch.as_tensor(toks, dtype=torch.long, device=cuda_device)}
        M.prefill(cfg, params["m"], batch, toks.shape[1] + n)
        prefill = _counted()
        step = {k: (eager[k] - prefill[k]) // (n - 1) for k in eager}
        np.testing.assert_array_equal(got, want)
        passed = 2 if i == 0 else 0          # the eager step and the capture
        assert counted == {k: prefill[k] + passed * step[k] for k in step}
        assert step["decode_attention"] == cfg.n_layers
        assert st.graph_steps == (n - 2 if i == 0 else n - 1)
    assert (eng.graph_captures, eng.graph_replays, eng.graph_eager_steps) == (1, 3 * n - 4, 1)
    assert eng.graph_pool_bytes > 0


@pytest.mark.cuda
def test_graph_per_tenant_and_a_new_capture_after_restaging(cuda_device, tmp_path):
    """Two tenants of one architecture with different weights get a graph
    each. A tenant evicted and staged again at new addresses (its old
    tensors are held, so the addresses cannot repeat) is captured again,
    and every request gives the eager tokens."""
    import numpy as np

    from repro_torch.core.mrm import MRM
    from repro_torch.core.store import DiskStore
    from repro_torch.serving import InferenceEngine
    from repro_torch.serving import engine as E

    disk = DiskStore(str(tmp_path))
    cfg, params = _graph_models(cuda_device, disk, names=("a", "b"))
    nbytes = sum(t.numel() * t.element_size() for t in E._leaves(params["a"]))
    eng = InferenceEngine(disk, MRM(disk, device_capacity=int(1.5 * nbytes),
                                    host_capacity=1 << 30))
    toks = _prompts(cfg, 1)[0]
    want = {m: _eager_tokens(cfg, params[m], toks, 5) for m in ("a", "b")}

    def layout(name):
        sm, _ = eng.load_model(name)
        try:
            return E.param_layout(sm.params), sm.params
        finally:
            eng.release(sm)

    got, _ = eng.generate("a", toks, max_new_tokens=5)
    np.testing.assert_array_equal(got, want["a"])
    first, held = layout("a")
    got, st = eng.generate("b", toks, max_new_tokens=5)    # evicts a
    np.testing.assert_array_equal(got, want["b"])
    assert eng.graph_captures == 2 and st.graph_steps == 3
    got, st = eng.generate("a", toks, max_new_tokens=5)    # a staged again
    np.testing.assert_array_equal(got, want["a"])
    again, _ = layout("a")
    assert again != first and st.tier_hit == "host"
    assert eng.graph_captures == 3 and st.graph_steps == 3
    del held


@pytest.mark.cuda
def test_concurrent_workers_share_one_graph_lent_at_a_time(cuda_device, tmp_path):
    """Two workers on one engine serve one model at once: one graph, lent
    to one request at a time (the other steps eagerly), eager tokens for
    every request."""
    import numpy as np

    from repro_torch.core.mrm import MRM
    from repro_torch.core.store import DiskStore
    from repro_torch.serving import InferenceEngine, Request, ServingWorkers

    disk = DiskStore(str(tmp_path))
    cfg, params = _graph_models(cuda_device, disk, "qwen3-moe-30b-a3b")
    eng = InferenceEngine(disk, MRM(disk, device_capacity=1 << 30, host_capacity=1 << 30))
    prompts = _prompts(cfg, 8)
    eng.generate("m", prompts[0], max_new_tokens=8)           # the capture
    workers = ServingWorkers(eng, n_workers=2, lookahead_prefetch=False)
    try:
        reqs = [workers.submit(Request("m", p, max_new=8)) for p in prompts]
        workers.drain(reqs, timeout=300)
    finally:
        workers.stop()
    for r, p in zip(reqs, prompts):
        assert not isinstance(r.result, Exception), r.result
        np.testing.assert_array_equal(r.result, _eager_tokens(cfg, params["m"], p, 8))
    assert eng.graph_captures == 1 and len(eng._graphs) == 1
    assert eng.graph_replays == 6 + sum(r.stats.graph_steps for r in reqs)
    assert eng.graph_replays + eng.graph_eager_steps == 7 * (len(reqs) + 1)
    print(f"graph steps per request {[r.stats.graph_steps for r in reqs]}")


@pytest.mark.cuda
def test_captures_while_other_threads_sync_the_device(cuda_device, tmp_path):
    """Captures with the process's other threads at work: two workers with
    look-ahead prefetch serve two tenants at four prompt lengths (eight keys,
    twice the pool), so keys are captured and evicted and captured again
    while the other worker's request and the MRM's staging thread run, and
    a third thread syncs the device without pause. Every request gives the
    eager tokens and no capture fails."""
    import threading

    import numpy as np

    from repro_torch.core.mrm import MRM
    from repro_torch.core.store import DiskStore
    from repro_torch.device import synchronize
    from repro_torch.serving import InferenceEngine, Request, ServingWorkers

    disk = DiskStore(str(tmp_path))
    cfg, params = _graph_models(cuda_device, disk, names=("a", "b"))
    eng = InferenceEngine(disk, MRM(disk, device_capacity=1 << 30, host_capacity=1 << 30))
    jobs = [(m, _prompts(cfg, 1, S=S)[0]) for S in (40, 48, 56, 64) for m in ("a", "b")] * 2
    stop, syncs, errors = threading.Event(), [0], []

    def syncing():
        try:
            while not stop.is_set():
                synchronize(cuda_device)
                syncs[0] += 1
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    th = threading.Thread(target=syncing)
    th.start()
    workers = ServingWorkers(eng, n_workers=2)
    try:
        reqs = [workers.submit(Request(m, toks, max_new=6)) for m, toks in jobs]
        workers.drain(reqs, timeout=300)
    finally:
        workers.stop()
        stop.set()
        th.join()
    assert not errors, errors
    for r, (m, toks) in zip(reqs, jobs):
        assert not isinstance(r.result, Exception), r.result
        np.testing.assert_array_equal(r.result, _eager_tokens(cfg, params[m], toks, 6))
    assert eng.graph_captures >= 8 and syncs[0] > 0
    print(f"captures {eng.graph_captures}, device syncs {syncs[0]}, "
          f"graph steps {[r.stats.graph_steps for r in reqs]}")


@pytest.mark.cuda
def test_a_failed_capture_fails_its_request(cuda_device, tmp_path, monkeypatch):
    """A capture that raises fails its request and leaves no graph in the
    pool; the next request of the key captures and replays."""
    import numpy as np

    from repro_torch.core.mrm import MRM
    from repro_torch.core.store import DiskStore
    from repro_torch.serving import InferenceEngine
    from repro_torch.serving import engine as E

    def fail(self, cfg, params):
        raise RuntimeError("operation not permitted when stream is capturing")

    disk = DiskStore(str(tmp_path))
    cfg, params = _graph_models(cuda_device, disk)
    eng = InferenceEngine(disk, MRM(disk, device_capacity=1 << 30, host_capacity=1 << 30))
    toks = _prompts(cfg, 1)[0]
    with monkeypatch.context() as mp:
        mp.setattr(E.DecodeGraph, "capture", fail)
        with pytest.raises(RuntimeError, match="capturing"):
            eng.generate("m", toks, max_new_tokens=5)
    assert (eng.graph_captures, len(eng._graphs)) == (0, 0)
    got, st = eng.generate("m", toks, max_new_tokens=5)
    np.testing.assert_array_equal(got, _eager_tokens(cfg, params["m"], toks, 5))
    assert (eng.graph_captures, st.graph_steps) == (1, 3)


@pytest.mark.cuda
def test_replayed_steps_run_the_hand_written_kernels(cuda_device, tmp_path):
    """The card's trace of served MoE requests, the capture's and a
    replayed one, shows the kernels the eager path launches, by name and
    count: a replay runs the captured split-KV decode and RMSNorm kernels,
    none swapped for a library's."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.mrm import MRM
    from repro_torch.core.store import DiskStore
    from repro_torch.kernels import ops
    from repro_torch.serving import InferenceEngine

    disk = DiskStore(str(tmp_path))
    cfg, params = _graph_models(cuda_device, disk, "qwen3-moe-30b-a3b")
    eng = InferenceEngine(disk, MRM(disk, device_capacity=1 << 30, host_capacity=1 << 30))
    for toks, replayed in zip(_prompts(cfg, 2), (4, 5)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            x = torch.zeros(1024, device=cuda_device)
            for _ in range(256):  # a trace can lose the first activity of its window
                x.add_(1)
            torch.cuda.synchronize()
            time.sleep(0.05)
            _, st = eng.generate("m", toks, max_new_tokens=6)
            torch.cuda.synchronize()
            time.sleep(0.01)
        ops.reset_launches()
        _eager_tokens(cfg, params["m"], toks, 6)
        assert st.graph_steps == replayed
        assert _ran(prof) == _counted()
        assert _counted()["decode_attention"] == 3 * 5
