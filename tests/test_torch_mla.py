"""Latent attention (MLA), sigmoid routing with a bias and shared experts,
and a leading dense layer: the port's DeepSeek-V3 block on the CPU against
the benchmark's plain float32 reference (``trimsbench/refs/deepseek_v3.py``),
at the tiny sizes of ``trimsbench/arch/deepseek_v3.py``, on seeded random
weights.

Tolerance: 1e-4 of the largest logit, as the parity tests against the JAX
package use. Both sides compute in float32; the port's absorbed decode
multiplies in another order than the reference's expanded keys and values,
which float32 rounding alone separates by ~1e-6 of the largest logit.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import EXTRAS, ModelConfig
from repro_torch.core.mrm import MRM
from repro_torch.core.store import DiskStore
from repro_torch.kernels import mla_decode as tmla
from repro_torch.models import model as M
from repro_torch.models import moe as MoE
from repro_torch.runtime import trace
from repro_torch.serving.engine import InferenceEngine, check_streamable, publish_model
from repro_torch.serving.prefix_cache import prompt_key
from trimsbench import reference, serve, spec, weights
from trimsbench.refs import deepseek_v3 as ref_ds

ROOT = Path(__file__).resolve().parents[1]
MOON = json.loads((ROOT / "trimsbench/configs/moonlight-16b-a3b.l5.json").read_text())
TOL = 1e-4


def _tiny(**kw) -> dict:
    c = dict(MOON, **spec.arch(MOON).tiny(MOON))
    c.update(kw)
    return c


CASES = {
    "moonlight": _tiny(),
    # a capacity so small that the prompt's group and each decode group drop
    "drops": _tiny(assumed=dict(MOON["assumed"], capacity_factor=0.5)),
}


def _model(c, seed=1234):
    cfg = serve.port_config(c).replace(param_dtype="float32", compute_dtype="float32")
    flat = {k: v.float() for k, v in weights.draw(c, seed, "cpu").items()}
    return cfg, flat, weights.as_tree(flat)


def _serve(cfg, params, prompt, new, device_pos=False):
    """Prefill, then ``new - 1`` greedy decode steps through the latent
    cache: (logits (B, new, V), served tokens (B, new), cache)."""
    S = prompt.shape[1]
    logits, cache = M.prefill(cfg, params, {"tokens": prompt}, S + new)
    steps, tok = [logits], logits.argmax(-1)
    served = [tok]
    for i in range(new - 1):
        pos = torch.tensor([S + i]) if device_pos else S + i
        logits, cache = M.decode_step(cfg, params, cache, tok, pos)
        steps.append(logits)
        tok = logits.argmax(-1)
        served.append(tok)
    return torch.stack(steps, 1), torch.stack(served, 1), cache


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_latent_decode_match_the_reference(case):
    c = CASES[case]
    cfg, flat, params = _model(c)
    B, S, new = 3, 12, 9
    prompt = torch.randint(0, c["vocab_size"], (B, S), generator=torch.Generator().manual_seed(5))
    port, served, _ = _serve(cfg, params, prompt, new)
    toks = torch.cat([prompt, served[:, :-1]], dim=1)
    h = reference.final_hidden(c, flat, toks, S)
    ref = reference.logits(c, flat, h)
    scale = ref.abs().max()
    assert (port[..., :c["vocab_size"]] - ref).abs().max() <= TOL * scale
    # the prefill's logits alone, and the positions on the device (a graph's form)
    assert (port[:, 0, :c["vocab_size"]] - ref[:, 0]).abs().max() <= TOL * scale
    again, served2, _ = _serve(cfg, params, prompt, new, device_pos=True)
    assert torch.equal(again, port) and torch.equal(served2, served)


def test_capacity_drops_happen_in_the_drops_case():
    c = CASES["drops"]
    cap = reference.capacity(3 * 12, {"assumed": c["assumed"], "num_experts_per_tok": 2,
                                      "num_experts": c["n_routed_experts"]})
    assert cap < 3 * 12 * 2 / c["n_routed_experts"]


def _moe_inputs(c, T, seed):
    cfg, flat, params = _model(c)
    p = M.layer_params(params["layers"], 0)["ffn"]
    x = torch.randn(T, c["hidden_size"], generator=torch.Generator().manual_seed(seed))
    return cfg, p, x


@pytest.mark.parametrize("case", sorted(CASES))
def test_sigmoid_routing_with_bias_scaling_and_shared_experts_matches(case):
    """One MoE layer over a prompt group (B x S tokens together) and a decode
    group (B tokens): the port's capacity dispatch against the reference's."""
    c = CASES[case]
    cfg, p, _ = _moe_inputs(c, 1, 0)
    ref_p = {k: v for k, v in p.items()}
    for B, S in ((3, 12), (3, 1)):
        x = torch.randn(B, S, c["hidden_size"], generator=torch.Generator().manual_seed(S))
        got, _ = MoE.apply_moe(cfg, p, x)
        want = ref_ds.moe(c, ref_p, x, S, reference.Linear())
        assert (got - want).abs().max() <= TOL * want.abs().max()


def test_router_weights_indices_and_ties():
    """Top k on score + bias, ties to the lower expert index; weights the
    unbiased scores, normalised, times the scaling factor. A zero router
    gives every expert the score 1/2, so the bias alone chooses, and equal
    biases tie."""
    c = _tiny()
    cfg, p, x = _moe_inputs(c, 6, 3)
    E, K = cfg.n_experts, cfg.top_k
    zero = dict(p, router=torch.zeros_like(p["router"]),
                router_bias=torch.tensor([0.0, 0.1, 0.1, 0.0, 0.2, 0.0, 0.1, 0.0]))
    w, i, _ = MoE.router_topk(cfg, zero, x)
    assert torch.equal(i, torch.tensor([[4, 1]] * 6))
    assert torch.allclose(w, torch.full((6, K), cfg.routed_scaling_factor / K))
    w, i, _ = MoE.router_topk(cfg, p, x)
    scores = torch.sigmoid(x @ p["router"])
    order = torch.sort(scores + p["router_bias"], dim=-1, descending=True, stable=True).indices
    assert torch.equal(i, order[:, :K])
    top = scores.gather(-1, i)
    assert torch.allclose(w, top / top.sum(-1, keepdim=True) * 2.446, rtol=1e-6)
    assert torch.allclose(w.sum(-1), torch.full((6,), 2.446), rtol=1e-6)
    # the bias changes the choice (else no fault could show its loss)
    nobias = MoE.router_topk(cfg, dict(p, router_bias=torch.zeros(E)), x)[1]
    assert not torch.equal(nobias, i)
    assert E == 8 and K == 2


def test_softmax_routing_is_unchanged():
    """The softmax branch gives the bits of the formula it had before the
    sigmoid branch (qwen3-moe-30b-a3b.l2 at its tiny size)."""
    c = json.loads((ROOT / "trimsbench/configs/qwen3-moe-30b-a3b.l2.json").read_text())
    c.update(spec.arch(c).tiny(c))
    cfg = serve.port_config(c)
    flat = weights.draw(c, 99, "cpu")
    p = M.layer_params(weights.as_tree(flat)["layers"], 1)["ffn"]
    x = torch.randn(40, c["hidden_size"], generator=torch.Generator().manual_seed(2))
    x = x.to(cfg.cdtype)
    w, i, aux = MoE.router_topk(cfg, p, x)
    probs = torch.softmax((x @ p["router"].to(x.dtype)).float(), dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :cfg.top_k], topi[:, :cfg.top_k]
    topw = topw / topw.sum(-1, keepdim=True)
    frac = torch.nn.functional.one_hot(topi, cfg.n_experts).float().sum(1).mean(0)
    assert torch.equal(w, topw.to(x.dtype)) and torch.equal(i, topi)
    assert torch.equal(aux, cfg.n_experts * (frac * probs.mean(0)).sum())
    assert "router_bias" not in M.init_params(cfg, device="meta")["layers"]["ffn"]


def test_the_leading_dense_layer_runs():
    c = _tiny()
    cfg, flat, params = _model(c)
    dense = params["dense_layers"]
    assert dense["ffn"]["w_gate"].shape == (1, c["hidden_size"], c["intermediate_size"])
    assert "router" not in dense["ffn"] and params["layers"]["ln1"]["scale"].shape[0] == 4
    prompt = torch.randint(0, c["vocab_size"], (2, 10), generator=torch.Generator().manual_seed(1))
    base, _ = M.prefill(cfg, params, {"tokens": prompt}, 12)
    bumped = weights.as_tree({k: v * 1.5 if k.startswith("dense_layers/ffn/") else v
                              for k, v in flat.items()})
    moved, _ = M.prefill(cfg, bumped, {"tokens": prompt}, 12)
    assert not torch.allclose(base, moved)
    # the training forward runs the dense layer first too, and trains it
    p = {k: v.clone().requires_grad_() for k, v in flat.items()}
    loss, _ = M.loss_fn(cfg, weights.as_tree(p), {"tokens": prompt, "labels": prompt})
    loss.backward()
    assert p["dense_layers/ffn/w_up"].grad.abs().sum() > 0
    logits, _ = M.forward(cfg, params, {"tokens": prompt})
    assert (logits[:, -1] - base).abs().max() <= TOL * base.abs().max()


def test_the_cache_is_576_values_a_position_and_layer():
    cfg = serve.port_config(MOON)
    cache = M.init_cache(cfg, 2, 10, device="meta")["attn"]
    assert cache["c_kv"].shape == (5, 2, 10, 1, 512) and cache["k_pe"].shape == (5, 2, 10, 1, 64)
    per = sum(t.shape[-1] for t in cache.values())
    assert per == 576 and per * cfg.cdtype.itemsize == 1152


def _engine(tmp_path, c, **kw):
    cfg, flat, params = _model(c)
    disk = DiskStore(str(tmp_path / "store"))
    publish_model(disk, cfg, params, name="m")
    mrm = MRM(disk, device="cpu", device_capacity=1 << 30)
    return cfg, params, mrm, InferenceEngine(disk, mrm, device="cpu", **kw)


def test_layer_streaming_refuses_latent_attention(tmp_path):
    cfg, _, mrm, eng = _engine(tmp_path, _tiny(), streaming=True)
    tokens = np.zeros((2, 8), dtype=np.int32)
    with pytest.raises(NotImplementedError, match="latent attention"):
        eng.generate("m", tokens, 3)
    with pytest.raises(NotImplementedError):
        check_streamable(cfg.replace(kv_lora_rank=0, qk_nope_head_dim=0, qk_rope_head_dim=0,
                                     v_head_dim=0))
    check_streamable(get_config("qwen3-moe-30b-a3b"))
    mrm.shutdown()


def test_a_prefix_hit_serves_the_latent_cache_and_leaves_it_untouched(tmp_path):
    c = _tiny()
    cfg, params, mrm, eng = _engine(tmp_path, c, prefix_cache_bytes=1 << 26)
    tokens = np.random.default_rng(3).integers(0, c["vocab_size"], (3, 11), dtype=np.int32)
    first, st1 = eng.generate("m", tokens, 6)
    stored = eng.prefix_kv.tier.peek(prompt_key("m", tokens, 17)).payload[1]["attn"]
    assert set(stored) == {"c_kv", "k_pe"}
    snap = {k: v.clone() for k, v in stored.items()}
    second, st2 = eng.generate("m", tokens, 6)
    assert eng.prefix_kv.hits == 1 and np.array_equal(first, second)
    want = M.greedy_generate(cfg, params, {"tokens": torch.as_tensor(tokens, dtype=torch.long)},
                             6, 17).numpy()
    assert np.array_equal(first, want)
    assert all(torch.equal(stored[k], v) for k, v in snap.items())
    assert st1.cache_bytes == st2.cache_bytes == 5 * 3 * 17 * 40 * 4
    mrm.shutdown()


def test_spans_of_latent_attention_and_routing(tmp_path):
    c = _tiny()
    cfg, flat, params = _model(c)
    prompt = torch.randint(0, c["vocab_size"], (2, 7), generator=torch.Generator().manual_seed(4))
    trace.drain()
    assert trace.span("mla.attn", rows=1) is trace.NO_SPAN      # off: no record, no clock
    _serve(cfg, params, prompt, 3)
    assert trace.drain() == []
    trace.enable()
    try:
        _serve(cfg, params, prompt, 3)
        recs = trace.drain()
    finally:
        trace.disable()
    by = {}
    for r in recs:
        by.setdefault(r[0], []).append(r[7])
    assert by["mla.attn"] == [{"rows": 14}] * 5
    assert by["mla.decode"] == [{"kv_len": 8}] * 5 + [{"kv_len": 9}] * 5
    assert by["moe.route"] == [{"scoring": "sigmoid"}] * 4 * 3


def test_cache_bytes_of_a_request_is_the_latent_caches_size(tmp_path):
    c = _tiny()
    cfg, _, mrm, eng = _engine(tmp_path, c)
    tokens = np.zeros((2, 9), dtype=np.int32)
    _, st = eng.generate("m", tokens, 4)
    cache = M.init_cache(cfg, 2, 13, device="meta")
    assert st.cache_bytes == sum(t.numel() * t.element_size() for t in cache["attn"].values())
    assert st.cache_bytes == 5 * 2 * 13 * (32 + 8) * 4
    mrm.shutdown()


def test_the_ports_own_settings_stay_out_of_the_jax_fields():
    """``dataclasses.asdict`` of every registered configuration is the JAX
    package's field set; the settings of ``EXTRAS`` ride in ``to_dict`` where
    set, survive ``replace`` and a published file, and count in equality."""
    for arch in ARCHS:
        cfg = get_config(arch)
        assert cfg.to_dict() == dataclasses.asdict(cfg)
        assert not set(EXTRAS) & {f.name for f in dataclasses.fields(cfg)}
    cfg = serve.port_config(MOON)
    d = cfg.to_dict()
    assert d["kv_lora_rank"] == 512 and d["router_scoring"] == "sigmoid"
    assert ModelConfig(**d) == cfg and cfg.replace(vocab_size=512).kv_lora_rank == 512
    assert cfg != cfg.replace(routed_scaling_factor=1.0)
    with pytest.raises(ValueError):
        cfg.replace(router_scoring="softplus")


def test_parameter_count_matches_the_weights():
    cfg = serve.port_config(MOON)
    n = sum(math.prod(t.shape) for t in _leaves(M.init_params(cfg, device="meta")))
    # the count the JAX package defines adds a layer's two RMSNorm scales twice
    # (its ``norm`` term is a layernorm's scale and bias); the port keeps it
    assert cfg.param_count() == n + 2 * cfg.d_model * cfg.n_layers
    assert round(weights.n_params(MOON) / 1e6, 1) == 2757.9


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


@pytest.mark.parametrize("T", [1, 64, 65, 2304, 4097])
@pytest.mark.parametrize("B", [1, 2, 64, 200])
def test_mla_splits_cover_the_cache_once(T, B):
    n, chunk = tmla.plan_splits(T, B, 132)
    assert 1 <= n <= tmla.MAX_SPLITS and chunk % tmla.TILE == 0
    assert (n - 1) * chunk < T <= n * chunk


def test_the_plain_decode_is_the_expanded_attention():
    """The absorbed form the kernel computes equals attention over each
    head's expanded keys and values (random widths; the plain version sums
    in float32, so 1e-5)."""
    g = torch.Generator().manual_seed(0)
    B, T, H, r, dr, dn, dv = 2, 9, 3, 6, 4, 5, 7
    w_uk = torch.randn(r, H, dn, generator=g, dtype=torch.float64)
    w_uv = torch.randn(r, H, dv, generator=g, dtype=torch.float64)
    c = torch.randn(B, T, 1, r, generator=g, dtype=torch.float64)
    pe = torch.randn(B, T, 1, dr, generator=g, dtype=torch.float64)
    q_nope = torch.randn(B, H, dn, generator=g, dtype=torch.float64)
    q_pe = torch.randn(B, H, dr, generator=g, dtype=torch.float64)
    kv_len = torch.tensor([9, 4])
    q = torch.cat([torch.einsum("bhn,rhn->bhr", q_nope, w_uk), q_pe], -1)
    got = torch.einsum("bhr,rhv->bhv", tmla.mla_decode_plain(q, c, pe, kv_len, 0.3), w_uv)
    k = torch.cat([torch.einsum("btr,rhn->bthn", c[:, :, 0], w_uk),
                   pe.expand(B, T, H, dr)], -1)
    v = torch.einsum("btr,rhv->bthv", c[:, :, 0], w_uv)
    s = torch.einsum("bhd,bthd->bht", torch.cat([q_nope, q_pe], -1), k) * 0.3
    s = s.masked_fill(torch.arange(T)[None, None, :] >= kv_len[:, None, None], float("-inf"))
    want = torch.einsum("bht,bthv->bhv", torch.softmax(s, -1), v)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_the_plain_prefill_takes_keys_wider_than_values(causal):
    """Latent attention's prefill gives ``flash_attention`` 192-wide q and
    k and 128-wide values: its plain version scales by 1/sqrt(192), returns
    the values' width and equals the reference oracle (both sum in float32,
    so 1e-5)."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(0)
    B, S, H, dk, dv = 2, 7, 3, 192, 128
    q, k = (torch.randn(B, S, H, dk, generator=g) for _ in range(2))
    v = torch.randn(B, S, H, dv, generator=g)
    got = kf.flash_attention_plain(q, k, v, causal=causal)
    s = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(dk)
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), float("-inf"))
    want = torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), v)
    assert got.shape == (B, S, H, dv)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    oracle = ref.mha_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal=causal).transpose(1, 2)
    assert torch.allclose(got, oracle, rtol=1e-5, atol=1e-5)


def test_prefill_attention_goes_through_the_flash_entry_point(monkeypatch):
    """``mla_attention`` hands the expanded heads to ``ops.flash_attention``
    (the kernel on the card) once a layer: q and k 192 wide, v 128."""
    from repro_torch.kernels import ops as kops
    cfg, _, params = _model(CASES["moonlight"])
    seen, flash = [], kops.flash_attention

    def recording(q, k, v, **kw):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], kw.get("causal")))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(kops, "flash_attention", recording)
    tokens = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(0))
    M.prefill(cfg, params, {"tokens": tokens}, 8)
    dk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    assert seen == [(dk, dk, cfg.v_head_dim, True)] * cfg.n_layers
