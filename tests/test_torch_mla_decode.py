"""The latent decode kernel (``mla_decode_kernel``) against its plain
version, on the card, and latent attention served through the engine's
CUDA-graph decode.

Imports torch and the port only (the machine with the card has no JAX):

    PYTHONPATH=src python -m pytest tests/test_torch_mla_decode.py

Each test skips where ``torch.cuda.is_available()`` is false: a CUDA
kernel has no CPU mode. Tolerance: the kernel rounds the probabilities to
bf16 before their product with the latent rows and writes its output in
bf16, each a relative error of at most 2^-8; the plain version computes in
float32 from the same bf16 inputs. 2e-2 of the largest output covers both
roundings with room, and a wrong row, head or mask moves outputs by O(1).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.mrm import MRM
from repro_torch.core.store import DiskStore
from repro_torch.kernels import mla_decode as tmla
from repro_torch.models import model as M
from repro_torch.serving.engine import InferenceEngine, publish_model

H, R, P = 16, 512, 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(B, T, seed, device, lead=2):
    """q (B, H, R + P) and a latent cache cut from a stacked one (``lead``
    layers, the second taken), as the model reads it."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(B, H, R + P, generator=g, device=device).to(torch.bfloat16)
    c = torch.randn(lead, B, T, 1, R, generator=g, device=device).to(torch.bfloat16)
    pe = torch.randn(lead, B, T, 1, P, generator=g, device=device).to(torch.bfloat16)
    return q, c[1], pe[1]


def _close(got, want):
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs().max()
    assert err <= 2e-2 * want.float().abs().max(), float(err)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["full", "cell_last", "ragged"])
def test_kernel_matches_plain_at_the_cells_shape(cuda_device, kv):
    B, T = 64, 2304
    q, c, pe = _inputs(B, T, 3, cuda_device)
    if kv == "full":
        kv_len = torch.full((B,), T, dtype=torch.int32, device=cuda_device)
    elif kv == "cell_last":
        kv_len = torch.full((B,), T - 1, dtype=torch.int32, device=cuda_device)
    else:
        kv_len = torch.randint(0, T + 1, (B,), dtype=torch.int32, device=cuda_device)
    scale = 192 ** -0.5
    before = tmla.launches
    got = tmla.mla_decode(q, c, pe, kv_len, scale)
    torch.cuda.synchronize()
    assert tmla.launches == before + 1
    _close(got, tmla.mla_decode_plain(q, c, pe, kv_len, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 63, 64, 65, 300, 1153])
def test_kernel_at_the_edges_of_its_tiles_and_splits(cuda_device, T):
    """Lengths 0, 1, a tile's edges and the cache's end, in one batch; B = 2
    gives the most splits (8), B = 40 fewer."""
    for B in (2, 40):
        q, c, pe = _inputs(B, T, T + B, cuda_device)
        lens = [0, 1, 63, 64, 65, T - 1, T, T // 2]
        kv_len = torch.tensor([min(T, lens[i % len(lens)]) for i in range(B)],
                              dtype=torch.int32, device=cuda_device)
        got = tmla.mla_decode(q, c, pe, kv_len, 0.07)
        want = tmla.mla_decode_plain(q, c, pe, kv_len, 0.07)
        _close(got, want)
        assert torch.count_nonzero(got[kv_len == 0]) == 0


@pytest.mark.cuda
def test_kernel_under_cuda_graph_capture(cuda_device):
    """Captured once, replayed with new query, cache rows and lengths: the
    call reads nothing on the host."""
    B, T = 64, 2304
    q, c, pe = _inputs(B, T, 5, cuda_device)
    kv_len = torch.full((B,), 2049, dtype=torch.int32, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tmla.mla_decode(q, c, pe, kv_len, 0.08)                 # first call outside
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = tmla.mla_decode(q, c, pe, kv_len, 0.08)
    torch.cuda.current_stream().wait_stream(side)
    for n, seed in ((2049, 6), (2304, 7), (17, 8)):
        q2, c2, pe2 = _inputs(B, T, seed, cuda_device)
        q.copy_(q2)
        c.copy_(c2)
        pe.copy_(pe2)
        kv_len.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        _close(out, tmla.mla_decode_plain(q, c, pe, kv_len, 0.08))


def _mla_cfg():
    from repro_torch.configs.base import MOE, ModelConfig
    return ModelConfig(name="mla-small", family=MOE, n_layers=3, d_model=256, n_heads=H,
                       n_kv_heads=H, d_ff=64, vocab_size=1024, n_experts=8, top_k=2,
                       n_shared_experts=2, kv_lora_rank=R, qk_nope_head_dim=128,
                       qk_rope_head_dim=P, v_head_dim=128,
                       n_dense_layers=1, dense_d_ff=512, router_scoring="sigmoid",
                       routed_scaling_factor=2.446, rope_theta=5e4)


@pytest.mark.cuda
def test_engine_replays_latent_decode_from_a_graph(cuda_device, tmp_path):
    """A small model with the published MLA widths through ``publish_model``
    -> MRM -> ``InferenceEngine``: every decode step after the capturing
    request's first is a replay, its tokens equal to eager decode steps on
    the same weights, and the cache a request holds is the latent one."""
    cfg = _mla_cfg()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    disk = DiskStore(str(tmp_path))
    publish_model(disk, cfg, params, name="m")
    mrm = MRM(disk, device=cuda_device)
    eng = InferenceEngine(disk, mrm, device=cuda_device)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 40), dtype=np.int32)
    first, st1 = eng.generate("m", tokens, 12)
    second, st2 = eng.generate("m", tokens, 12)
    assert st1.graph_steps == 10 and st2.graph_steps == 11
    assert np.array_equal(first, second)
    p_dev = _to(params, cuda_device)
    want = M.greedy_generate(cfg, p_dev, {"tokens": torch.as_tensor(
        tokens, dtype=torch.long, device=cuda_device)}, 12, 52).cpu().numpy()
    assert np.array_equal(first, want)
    assert st2.cache_bytes == 3 * 4 * 52 * (R + P) * 2
    mrm.shutdown()


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def _flash_close(got, want, dtype):
    """As the card tests of ``flash_attention``: bf16 2e-2, float32 1e-4, of
    each value and absolutely."""
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    assert (err <= tol + tol * want.float().abs()).all(), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 512, 512, True), (1, 200, 200, True),
                                   (1, 300, 300, False), (2, 129, 300, False),
                                   (1, 1, 1, True)])
def test_prefill_kernel_with_keys_wider_than_values(cuda_device, dtype, shape):
    """``flash_fwd`` at latent attention's widths (q, k 192; v 128; 16
    heads), causal and not, at ragged lengths, with v a strided view of the
    expanded latent as ``mla_attention`` passes it; float32 takes the SIMT
    kernel."""
    from repro_torch.kernels import flash_attention as kf
    B, S, T, causal = shape
    g = torch.Generator(device=cuda_device).manual_seed(S + T)
    q = torch.randn(B, S, H, 192, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(B, T, H, 192, generator=g, device=cuda_device).to(dtype)
    kv = torch.randn(B, T, H, 256, generator=g, device=cuda_device).to(dtype)
    v = kv[..., 128:]
    before = kf.launches
    got = kf.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kf.launches == before + 1
    _flash_close(got, kf.flash_attention_plain(q, k, v, causal=causal), dtype)


@pytest.mark.cuda
def test_prefill_kernel_refuses_other_unequal_widths(cuda_device):
    from repro_torch.kernels import flash_attention as kf
    q = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16, device=cuda_device)
    for dk, dv in ((128, 64), (256, 128), (192, 192)):
        with pytest.raises(ValueError, match="head dims"):
            kf.flash_attention(q.new_zeros(1, 8, 2, dk), q.new_zeros(1, 8, 2, dk),
                               q.new_zeros(1, 8, 2, dv))
