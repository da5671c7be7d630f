"""Model API of the PyTorch port, DENSE family.

Mirrors the JAX package's ``models/model.py``. Parameters are a plain nested
dict of tensors with layers stacked on a leading axis, exactly as the
``.trims`` file stores them; layer ``i`` is read as views
(``params["layers"][...][i]``), never copied. The MRM hands every handle the
same device tensors, which is the sharing this system exists for, so the
model is plain functions over those dicts and not ``nn.Module``s.

Entry points::

  init_params(cfg, generator, device)         -> params ("meta" = shape template)
  init_cache(cfg, batch, max_len, device)     -> decode cache (zeros)
  prefill(cfg, params, batch, max_len)        -> (logits, cache)
  decode_step(cfg, params, cache, token, pos) -> (logits, cache)
  greedy_generate(cfg, params, batch, n_steps, max_len)
  stream_prefill_embed / stream_prefill_layer / stream_logits /
  stream_decode_embed / stream_decode_layer   -> one step of layer streaming

Other families belong to later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import DENSE, ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != DENSE:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family belongs to a later slice of the "
            "PyTorch port (MoE, SSM/hybrid, VLM/enc-dec); this slice serves DENSE")


# ---------------------------------------------------------------------------
# init_params
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    """Random params with the JAX init's shapes and scales. ``device="meta"``
    gives the shape template (the JAX package's ``jax.eval_shape``)."""
    _check_family(cfg)
    lead = (cfg.n_layers,)
    return {
        "embed": L.embed_init((cfg.padded_vocab, cfg.d_model), cfg.pdtype, generator, device),
        "final_norm": L.init_norm(cfg, (), device),
        "layers": {
            "ln1": L.init_norm(cfg, lead, device),
            "attn": L.init_attention(cfg, lead, generator, device),
            "ln2": L.init_norm(cfg, lead, device),
            "ffn": L.init_mlp(cfg, lead, generator, device),
        },
    }


def layer_params(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree, as views."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# stem and head
# ---------------------------------------------------------------------------

def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = x @ params["embed"].to(x.dtype).T
    if cfg.padded_vocab != cfg.vocab_size:  # mask Megatron-style vocab pad
        pad = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens].to(cfg.cdtype)


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, B: int, max_len: int, device="cuda") -> Params:
    """Zero-filled decode cache, ``(L, B, T, Hkv, hd)`` per K and V."""
    _check_family(cfg)
    shape = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"attn": {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
                     "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}}


def _attn_cache_zeros(cfg: ModelConfig, B: int, T: int, device) -> Params:
    """One layer's zero KV cache, ``(B, T, Hkv, hd)`` per K and V."""
    shape = (B, T, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}


def _write_kv(cache_layer: Params, k: torch.Tensor, v: torch.Tensor, start: int) -> Params:
    """KV append, written IN PLACE into the cache (a view of the stacked
    cache, or one layer's own cache on the streaming path). The JAX version
    is out-of-place (dynamic_update_slice on an immutable array); the
    prefix-KV cache therefore stores a copy of each prefill cache and hands
    every hit a fresh clone (``serving/prefix_cache.py``)."""
    S = k.shape[1]
    cache_layer["k"][:, start:start + S] = k.to(cache_layer["k"].dtype)
    cache_layer["v"][:, start:start + S] = v.to(cache_layer["v"].dtype)
    return cache_layer


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill_attn_layer(cfg: ModelConfig, layer: Params, cl: Params,
                       x: torch.Tensor, positions: torch.Tensor
                       ) -> Tuple[torch.Tensor, Params]:
    """One trunk layer of prefill: (x, kv-cache slot) -> (x', primed slot)."""
    h = L.apply_norm(cfg, layer["ln1"], x)
    q, k, v = L.qkv_project(cfg, layer["attn"], h, positions)
    o = L.attention_core(cfg, q, k, v, causal=True)
    x = x + L.attention_out(cfg, layer["attn"], o)
    h = L.apply_norm(cfg, layer["ln2"], x)
    f = L.apply_mlp(layer["ffn"], h)
    return x + f, _write_kv(cl, k, v, 0)


@torch.inference_mode()
def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            max_len: int) -> Tuple[torch.Tensor, Params]:
    """Run the full prompt, return last-position logits + primed cache."""
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_len, tokens.device)
    x = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)[None, :]
    for i in range(cfg.n_layers):
        x, _ = prefill_attn_layer(cfg, layer_params(params["layers"], i),
                                  layer_params(cache["attn"], i), x, positions)
    logits = _logits(cfg, params, x[:, -1:, :])
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _attn_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, cl: Params, pos: int
                 ) -> Tuple[torch.Tensor, Params]:
    """x: (B,1,D); cl: one layer's KV cache. Returns (x, cache)."""
    B = x.shape[0]
    h = L.apply_norm(cfg, p["ln1"], x)
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = L.qkv_project(cfg, p["attn"], h, positions)
    cl = _write_kv(cl, k, v, pos)
    kv_len = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
    o = L.decode_attention_core(cfg, q, cl["k"], cl["v"], kv_len)
    x = x + L.attention_out(cfg, p["attn"], o)
    h = L.apply_norm(cfg, p["ln2"], x)
    return x + L.apply_mlp(p["ffn"], h), cl


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                token: torch.Tensor, pos: int) -> Tuple[torch.Tensor, Params]:
    """One decode step. token: (B,) ints; pos: cache length so far.

    Returns (logits (B, V), cache); the cache is updated in place."""
    _check_family(cfg)
    x = params["embed"][token][:, None, :].to(cfg.cdtype)   # (B,1,D)
    for i in range(cfg.n_layers):
        x, _ = _attn_decode(cfg, layer_params(params["layers"], i), x,
                            layer_params(cache["attn"], i), int(pos))
    logits = _logits(cfg, params, x)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# streaming execution (DESIGN.md §9)
# ---------------------------------------------------------------------------
# Per-layer entry points for the attention family: the serving engine walks
# the trunk layer by layer, starting as soon as the stem + layer 0 windows
# of a streaming load are resident. Each step reuses the function the batch
# path runs (prefill_attn_layer / _attn_decode), so streamed generation
# matches the batch path token for token. Each runs in inference mode: the
# per-layer caches they make are written in place by later calls.

@torch.inference_mode()
def stream_prefill_embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor
                         ) -> torch.Tensor:
    """Stem half of prefill: (B, S) tokens -> residual stream (B, S, D).
    Needs only the stem window (``embed``)."""
    return _embed(cfg, params, tokens)


@torch.inference_mode()
def stream_prefill_layer(cfg: ModelConfig, layer: Params, x: torch.Tensor,
                         positions: torch.Tensor, max_len: int
                         ) -> Tuple[torch.Tensor, Params]:
    """One trunk layer of prefill; allocates and primes this layer's KV
    slot. Returns (x', cache_layer)."""
    cl = _attn_cache_zeros(cfg, x.shape[0], max_len, x.device)
    return prefill_attn_layer(cfg, layer, cl, x, positions)


@torch.inference_mode()
def stream_logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Head half: last-position logits (B, V) from the residual stream.
    Needs only the stem window (``final_norm`` + tied ``embed``)."""
    return _logits(cfg, params, x[:, -1:, :])[:, 0]


@torch.inference_mode()
def stream_decode_embed(cfg: ModelConfig, params: Params, token: torch.Tensor
                        ) -> torch.Tensor:
    """Stem half of a decode step: (B,) token -> (B, 1, D)."""
    return params["embed"][token][:, None, :].to(cfg.cdtype)


@torch.inference_mode()
def stream_decode_layer(cfg: ModelConfig, layer: Params, x: torch.Tensor, cl: Params,
                        pos: int) -> Tuple[torch.Tensor, Params]:
    """One trunk layer of a decode step; ``cl`` is updated in place.
    Returns (x', cache_layer)."""
    return _attn_decode(cfg, layer, x, cl, int(pos))


def greedy_generate(cfg: ModelConfig, params: Params, batch, n_steps: int,
                    max_len: int) -> torch.Tensor:
    """Prefill + n greedy decode steps (reference path for tests)."""
    logits, cache = prefill(cfg, params, batch, max_len)
    S = batch["tokens"].shape[1]
    tok = logits.argmax(-1)
    toks = [tok]
    for i in range(n_steps - 1):
        logits, cache = decode_step(cfg, params, cache, tok, S + i)
        tok = logits.argmax(-1)
        toks.append(tok)
    return torch.stack(toks, dim=1)
