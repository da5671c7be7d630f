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
