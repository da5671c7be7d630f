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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 512, 4096), (2, 1, 4096), (17, 96), (2, 8, 32, 128)])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_rmsnorm_kernel_matches_plain(cuda_device, shape, name):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(*shape, generator=g, device=cuda_device).to(DTYPES[name])
    s = (torch.randn(shape[-1], generator=g, device=cuda_device) + 1).to(DTYPES[name])
    for eps, xx in ((1e-5, x), (1e-6, x), (1e-5, x[..., -1:, :])):   # and a row-strided view
        before = trms.launches
        got = trms.rmsnorm(xx, s, eps)
        torch.cuda.synchronize()
        assert trms.launches == before + 1
        _close(got, trms.rmsnorm_plain(xx, s, eps), name)


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
