"""Model API of the PyTorch port: every model family of the JAX package.

Mirrors the JAX package's ``models/model.py``. Parameters are a plain nested
dict of tensors with layers stacked on a leading axis, exactly as the
``.trims`` file stores them; layer ``i`` is read as views
(``params["layers"][...][i]``), never copied. The MRM hands every handle the
same device tensors, which is the sharing this system exists for, so the
model is plain functions over those dicts and not ``nn.Module``s.

Entry points::

  init_params(cfg, generator, device)         -> params ("meta" = shape template)
  forward(cfg, params, batch)                 -> (logits, aux)     [training path]
  loss_fn(cfg, params, batch)                 -> (loss, metrics)
  init_cache(cfg, batch, max_len, device, n_ctx) -> decode cache (zeros)
  prefill(cfg, params, batch, max_len)        -> (logits, cache)
  decode_step(cfg, params, cache, token, pos) -> (logits, cache)
  greedy_generate(cfg, params, batch, n_steps, max_len)
  stream_prefill_embed / stream_prefill_layer / stream_logits /
  stream_decode_embed / stream_decode_layer   -> one step of layer streaming

A MoE layer's ``ffn`` holds a ``router`` and expert banks
(``models/moe.py``); the layer functions branch on it, as in the JAX model,
and drop the router's aux loss on the serving path (the training forward
adds it to the loss, as the reference does). The families:

  DENSE, MOE  ``layers``: attention layers, stacked (L, ...); a MOE model
              with ``n_dense_layers`` runs that many layers with a dense
              MLP of ``dense_d_ff`` first, stacked apart under
              ``dense_layers`` (DeepSeek-V3's ``first_k_dense_replace``)
  SSM         ``layers``: Mamba-2 mixers (``models/mamba.py``), no FFN
  HYBRID      ``blocks/sub{i}``: periods of ``attn_every`` sublayers, stacked
              (nP, ...); sublayer ``attn_every - 1`` is attention without
              RoPE, the others Mamba-2 with an FFN; MoE on sublayer i where
              ``i % moe_every == moe_every - 1``
  VLM         ``blocks/self{i}`` and ``blocks/cross``: periods of
              ``cross_attn_every - 1`` attention layers and one gated
              cross-attention layer over ``batch["frontend"]``
  ENCDEC      ``enc_layers`` (bidirectional) over ``batch["frontend"]``,
              ``dec_layers`` with causal self- and cross-attention

The training forward runs the layers in a Python loop (the reference's
``lax.scan``) over per-layer views of the stacked params, each body wrapped
per ``cfg.remat_policy`` (``torch.utils.checkpoint``). It never runs under
``inference_mode``; prefill and decode always do (under a mesh, ``no_grad``:
DTensor views need version counters). Layer streaming serves
DENSE and MoE.

With ``cfg.mla`` every attention layer is latent attention
(``layers.mla_*``): its decode cache holds ``c_kv`` (B, T, 1, r) and
``k_pe`` (B, T, 1, rope) in place of K and V, and a decode step runs the
absorbed form against it.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import DENSE, ENCDEC, HYBRID, MOE, SSM, VLM, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as S
from repro_torch.models import moe as MoE
from repro_torch.models import partitioning as part

Params = Dict[str, Any]
Pos = Union[int, torch.Tensor]     # a decode position: on the host, or (1,) on the device
FAMILIES = (DENSE, MOE, SSM, HYBRID, VLM, ENCDEC)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# init_params
# ---------------------------------------------------------------------------

def _init_attn_layer(cfg: ModelConfig, lead, generator, device, use_moe: bool,
                     d_ff: Optional[int] = None) -> Params:
    return {"ln1": L.init_norm(cfg, lead, device),
            "attn": (L.init_mla(cfg, lead, generator, device) if cfg.mla
                     else L.init_attention(cfg, lead, generator, device)),
            "ln2": L.init_norm(cfg, lead, device),
            "ffn": (MoE.init_moe(cfg, lead, generator, device) if use_moe
                    else L.init_mlp(cfg, lead, generator, device, d_ff))}


def _init_mamba_layer(cfg: ModelConfig, lead, generator, device, with_ffn: bool,
                      use_moe: bool) -> Params:
    p = {"ln1": L.init_norm(cfg, lead, device),
         "mamba": S.init_mamba(cfg, lead, generator, device)}
    if with_ffn:
        p["ln2"] = L.init_norm(cfg, lead, device)
        p["ffn"] = (MoE.init_moe(cfg, lead, generator, device) if use_moe
                    else L.init_mlp(cfg, lead, generator, device))
    return p


def _init_cross_layer(cfg: ModelConfig, lead, generator, device) -> Params:
    """A gated cross-attention layer; the gates are 0 at init (one a period
    once stacked), so the layer starts as the identity."""
    return {"ln1": L.init_norm(cfg, lead, device),
            "xattn": L.init_attention(cfg, lead, generator, device),
            "ln2": L.init_norm(cfg, lead, device),
            "ffn": L.init_mlp(cfg, lead, generator, device),
            "gate_attn": torch.zeros(lead, dtype=cfg.pdtype, device=device),
            "gate_mlp": torch.zeros(lead, dtype=cfg.pdtype, device=device)}


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    """Random params with the JAX init's shapes and scales. ``device="meta"``
    gives the shape template (the JAX package's ``jax.eval_shape``)."""
    _check_family(cfg)
    params: Params = {
        "embed": L.embed_init((cfg.padded_vocab, cfg.d_model), cfg.pdtype, generator, device),
        "final_norm": L.init_norm(cfg, (), device),
    }
    fam = cfg.family
    if fam in (DENSE, MOE):
        if cfg.n_dense_layers:
            params["dense_layers"] = _init_attn_layer(cfg, (cfg.n_dense_layers,), generator,
                                                      device, False, cfg.dense_d_ff)
        params["layers"] = _init_attn_layer(cfg, (cfg.n_moe_stack,), generator, device,
                                            cfg.n_experts > 0)
    elif fam == SSM:
        params["layers"] = _init_mamba_layer(cfg, (cfg.n_layers,), generator, device,
                                             with_ffn=False, use_moe=False)
    elif fam == HYBRID:
        period, moe_every = cfg.attn_every, cfg.moe_every
        lead = (cfg.n_layers // period,)
        blk = {}
        for i in range(period):
            use_moe = cfg.n_experts > 0 and i % moe_every == moe_every - 1
            blk[f"sub{i}"] = (_init_attn_layer(cfg, lead, generator, device, use_moe)
                              if i == period - 1 else
                              _init_mamba_layer(cfg, lead, generator, device, True, use_moe))
        params["blocks"] = blk
    elif fam == VLM:
        period = cfg.cross_attn_every
        lead = (cfg.n_layers // period,)
        blk = {f"self{i}": _init_attn_layer(cfg, lead, generator, device, False)
               for i in range(period - 1)}
        blk["cross"] = _init_cross_layer(cfg, lead, generator, device)
        params["blocks"] = blk
    else:  # ENCDEC
        params["enc_layers"] = _init_attn_layer(cfg, (cfg.n_enc_layers,), generator, device,
                                                False)
        dec = _init_attn_layer(cfg, (cfg.n_dec_layers,), generator, device, False)
        dec["ln_x"] = L.init_norm(cfg, (cfg.n_dec_layers,), device)
        dec["xattn"] = L.init_attention(cfg, (cfg.n_dec_layers,), generator, device)
        params["dec_layers"] = dec
        params["enc_final_norm"] = L.init_norm(cfg, (), device)
    return params


def trunk_layers(cfg: ModelConfig, params: Params) -> List[Params]:
    """The DENSE and MOE families' layers in order, as views: the leading
    dense layers, then ``layers``. Layer ``i`` of the list writes slot ``i``
    of the stacked decode cache."""
    out = [layer_params(params["dense_layers"], i) for i in range(cfg.n_dense_layers)]
    return out + [layer_params(params["layers"], i) for i in range(cfg.n_moe_stack)]


def layer_params(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree, as views (under a mesh, gathered whole
    over the batch axes: ``partitioning.gather_fsdp``)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else part.gather_fsdp(v[i])
            for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# stem and head
# ---------------------------------------------------------------------------

def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = part.shard_logits(x @ part.gather_fsdp(params["embed"]).to(x.dtype).T)
    if cfg.padded_vocab != cfg.vocab_size:  # mask Megatron-style vocab pad
        pad = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return _res(cfg, part.embed_lookup(params["embed"], tokens).to(cfg.cdtype))


def _res(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Residual-stream constraint (batch-sharded: see
    ``partitioning.shard_residual``)."""
    return part.shard_residual(x, allow_seq=cfg.family not in (SSM, HYBRID))


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------

def _attn_cache_zeros(cfg: ModelConfig, B: int, T: int, device, lead=()) -> Params:
    """Zero KV cache, ``(*lead, B, T, Hkv, hd)`` per K and V; with latent
    attention ``c_kv`` ``(*lead, B, T, 1, r)`` and ``k_pe``
    ``(*lead, B, T, 1, rope)``, shared by every head."""
    if cfg.mla:
        return {"c_kv": torch.zeros(*lead, B, T, 1, cfg.kv_lora_rank, dtype=cfg.cdtype,
                                    device=device),
                "k_pe": torch.zeros(*lead, B, T, 1, cfg.qk_rope_head_dim, dtype=cfg.cdtype,
                                    device=device)}
    shape = (*lead, B, T, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}


def _mamba_cache_zeros(cfg: ModelConfig, B: int, device, lead=()) -> Params:
    """Zero Mamba-2 decode state: the float32 SSM state and the last
    ``d_conv - 1`` pre-conv inputs in the activation dtype."""
    ci = cfg.d_inner + 2 * cfg.d_state
    return {"ssm": torch.zeros(*lead, B, cfg.n_ssm_heads, cfg.d_state, cfg.ssm_headdim,
                               dtype=torch.float32, device=device),
            "conv": torch.zeros(*lead, B, cfg.d_conv - 1, ci, dtype=cfg.cdtype,
                                device=device)}


def init_cache(cfg: ModelConfig, B: int, max_len: int, device="cuda",
               n_ctx: Optional[int] = None) -> Params:
    """Zero-filled decode cache, stacked as the params are. ``n_ctx`` is the
    cross-attention context length (VLM: the frontend's, by default the
    config's ``n_frontend_tokens``; ENCDEC: the encoder's, by default
    ``max_len``)."""
    _check_family(cfg)
    fam = cfg.family
    if fam in (DENSE, MOE):
        return {"attn": _attn_cache_zeros(cfg, B, max_len, device, (cfg.n_layers,))}
    if fam == SSM:
        return {"mamba": _mamba_cache_zeros(cfg, B, device, (cfg.n_layers,))}
    if fam == HYBRID:
        nP = cfg.n_layers // cfg.attn_every
        return {"attn": _attn_cache_zeros(cfg, B, max_len, device, (nP,)),
                "mamba": _mamba_cache_zeros(cfg, B, device, (nP, cfg.attn_every - 1))}
    if fam == VLM:
        period = cfg.cross_attn_every
        nP = cfg.n_layers // period
        x = _attn_cache_zeros(cfg, B, n_ctx or cfg.n_frontend_tokens, device, (nP,))
        return {"self": _attn_cache_zeros(cfg, B, max_len, device, (nP, period - 1)),
                "xk": x["k"], "xv": x["v"]}
    x = _attn_cache_zeros(cfg, B, n_ctx if n_ctx is not None else max_len, device,
                          (cfg.n_dec_layers,))
    return {"attn": _attn_cache_zeros(cfg, B, max_len, device, (cfg.n_dec_layers,)),
            "xk": x["k"], "xv": x["v"]}


def _placed_cache(tokens, template: Params) -> Params:
    """Zero caches of ``template``'s shapes (meta tensors) as DTensors on
    the mesh of the DTensor ``tokens``, placed by
    ``launch.sharding.cache_spec``, each rank making only its shards."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import sharding as shd
    mesh = tokens.device_mesh
    dev = tokens.to_local().device
    sh = shd.specs_to_shardings(shd.make_cache_specs(template, mesh, tokens.shape[0]), mesh)

    def zeros(t, s):
        return DTensor.from_local(torch.zeros(s.shard_shape(tuple(t.shape)), dtype=t.dtype,
                                              device=dev),
                                  mesh, s.placements, run_check=False, shape=t.shape,
                                  stride=t.stride())

    return _map_leaves(zeros, template, sh)


def _map_leaves(fn, tree, *rest):
    return {k: _map_leaves(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def _write_kv(cache_layer: Params, k: torch.Tensor, v: torch.Tensor, start: Pos) -> Params:
    """KV append, written IN PLACE into the cache (a view of the stacked
    cache, or one layer's own cache on the streaming path): ``k`` and ``v``
    into the layer's two cache leaves, in their order (K and V, or latent
    attention's ``c_kv`` and ``k_pe``). The JAX version is out-of-place
    (dynamic_update_slice on an immutable array); the prefix-KV cache
    therefore stores a copy of each prefill cache and hands every hit a
    fresh clone (``serving/prefix_cache.py``). A ``start`` on the device, a
    (1,) int64 tensor, takes one row (a decode step's token), written by
    index so that the host never reads it."""
    for dst, new in zip(cache_layer.values(), (k, v)):
        if torch.is_tensor(start):
            dst.index_copy_(1, start, new.to(dst.dtype))
        else:
            dst[:, start:start + new.shape[1]] = new.to(dst.dtype)
    return cache_layer


def _ffn(cfg: ModelConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    """The layer's MLP, or its MoE when it has a router (aux loss dropped)."""
    if "router" in p:
        return MoE.apply_moe(cfg, p, h)[0]
    return L.apply_mlp(p, h)


def _ffn_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x + ffn(ln2(x))``."""
    return x + _ffn(cfg, p["ffn"], L.apply_norm(cfg, p["ln2"], x))


def _self_attn(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor, *,
               causal: bool = True, rope: bool = True):
    """``x + attn(ln1(x))`` over the whole sequence. Returns (x', k, v), or
    with latent attention (x', c_kv, k_pe), what the cache holds."""
    h = L.apply_norm(cfg, p["ln1"], x)
    if cfg.mla:
        q_nope, q_pe, c_kv, k_pe = L.mla_project(cfg, p["attn"], h, positions)
        o = L.mla_attention(cfg, p["attn"], q_nope, q_pe, c_kv, k_pe, causal=causal)
        return x + o @ p["attn"]["wo"].to(o.dtype), c_kv, k_pe
    q, k, v = L.qkv_project(cfg, p["attn"], h, positions, rope=rope)
    o = L.attention_core(cfg, q, k, v, causal=causal)
    return x + L.attention_out(cfg, p["attn"], o), k, v


def _cross_kv(cfg: ModelConfig, p: Params, ctx: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project a context (B, S_ctx, D) to cross-attention K/V with the
    attention params ``p`` (no RoPE)."""
    B, Sc, _ = ctx.shape
    k = part.splittable(ctx @ p["wk"].to(ctx.dtype), cfg.n_kv_heads)
    v = part.splittable(ctx @ p["wv"].to(ctx.dtype), cfg.n_kv_heads)
    k = k.reshape(B, Sc, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, Sc, cfg.n_kv_heads, cfg.head_dim)
    return k, v


def _cross_attend(cfg: ModelConfig, p: Params, h: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Cross-attention of the normed stream ``h`` over context K/V: not
    causal, so the plain path on every device, as in the reference."""
    q = part.splittable(h @ p["wq"].to(h.dtype), cfg.n_heads)
    q = q.reshape(*h.shape[:2], cfg.n_heads, cfg.head_dim)
    return L.attention_out(cfg, p, L.attention_core(cfg, q, k, v, causal=False))


def _apply_cross_layer(cfg: ModelConfig, p: Params, x: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """A VLM cross-attention layer over precomputed context K/V, its two
    residuals gated by ``tanh(gate)``."""
    o = _cross_attend(cfg, p["xattn"], L.apply_norm(cfg, p["ln1"], x), k, v)
    x = x + torch.tanh(p["gate_attn"].to(o.dtype)) * o
    f = L.apply_mlp(p["ffn"], L.apply_norm(cfg, p["ln2"], x))
    return _res(cfg, x + torch.tanh(p["gate_mlp"].to(f.dtype)) * f)


def _mamba_ffn(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """A Mamba-2 layer's FFN block where it has one (HYBRID; SSM has none)."""
    return _ffn_block(cfg, p, x) if "ffn" in p else x


# ---------------------------------------------------------------------------
# remat and the cache-free layers (training path, encoder)
# ---------------------------------------------------------------------------

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat ``"dots"``: keep the outputs of
    products without batch dims (``mm``, ``addmm``: the reference's
    ``dots_with_no_batch_dims_saveable``), recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(cfg: ModelConfig, fn: Callable) -> Callable:
    """``fn`` wrapped per ``cfg.remat_policy``: ``"none"``: as it is;
    ``"nothing"``: ``torch.utils.checkpoint`` (non-reentrant), which saves
    the body's inputs and recomputes its activations in the backward;
    ``"dots"``: the same, keeping the outputs of products without batch
    dims. Where grad is off (prefill under ``inference_mode``) the body runs
    as it is."""
    policy = cfg.remat_policy
    if policy == "none":
        return fn
    kw: Dict[str, Any] = {"use_reentrant": False}
    if policy == "dots":
        try:
            from torch.utils.checkpoint import create_selective_checkpoint_contexts
        except ImportError as e:
            raise NotImplementedError("remat_policy 'dots' needs selective checkpointing "
                                      f"(torch {torch.__version__} has none)") from e
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_saveable)
    elif policy != "nothing":
        raise ValueError(f"remat_policy {policy!r}")

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw)

    return remat


def _unstack(stacked: Params, n: int) -> List[Params]:
    """The ``n`` layers of a stacked tree, as views. ``unbind`` has one
    stack in its backward, where ``layer_params``' selects would each add a
    zero-filled gradient of the whole stacked leaf."""
    layers: List[Params] = [{} for _ in range(n)]
    for k, v in stacked.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for layer, part in zip(layers, parts):
            layer[k] = part
    return layers


def _scan(cfg: ModelConfig, body: Callable, layers: List[Params], x: torch.Tensor,
          aux: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``lax.scan`` over stacked layers: the carry ``(x,
    aux)`` through ``body(layer, x, aux)`` in order, each call wrapped per
    ``cfg.remat_policy``."""
    body = _maybe_remat(cfg, functools.partial(_gathered, body))
    for layer in layers:
        x, aux = body(layer, x, aux)
    return x, aux


def _gathered(body: Callable, layer: Params, x, aux):
    """``body`` on the layer's params gathered over the batch axes inside
    the (rematerialised) body, so that the backward gathers them again."""
    return body(part.gather_fsdp(layer), x, aux)


def _zero_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _ffn_aux(cfg: ModelConfig, p: Params, h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's MLP, or its MoE when it has a router, with the router's
    aux loss (0 for an MLP)."""
    if "router" in p:
        return MoE.apply_moe(cfg, p, h)
    return L.apply_mlp(p, h), _zero_aux(h)


def _apply_attn_layer(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor,
                      *, causal: bool = True, rope: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A cache-free attention layer: (x', router aux)."""
    x, _, _ = _self_attn(cfg, p, x, positions, causal=causal, rope=rope)
    f, aux = _ffn_aux(cfg, p["ffn"], L.apply_norm(cfg, p["ln2"], x))
    return _res(cfg, x + f), aux


def _apply_mamba_layer(cfg: ModelConfig, p: Params, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A cache-free Mamba-2 layer, with its FFN where it has one (HYBRID):
    (x', router aux)."""
    x = x + S.apply_mamba(cfg, p["mamba"], L.apply_norm(cfg, p["ln1"], x))
    if "ffn" not in p:
        return _res(cfg, x), _zero_aux(x)
    f, aux = _ffn_aux(cfg, p["ffn"], L.apply_norm(cfg, p["ln2"], x))
    return _res(cfg, x + f), aux


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill_attn_layer(cfg: ModelConfig, layer: Params, cl: Params,
                       x: torch.Tensor, positions: torch.Tensor, rope: bool = True
                       ) -> Tuple[torch.Tensor, Params]:
    """One trunk layer of prefill: (x, kv-cache slot) -> (x', primed slot).
    HYBRID's attention sublayer runs it with ``rope=False``."""
    x, k, v = _self_attn(cfg, layer, x, positions, rope=rope)
    return _res(cfg, _ffn_block(cfg, layer, x)), _write_kv(cl, k, v, 0)


def prefill_mamba_layer(cfg: ModelConfig, layer: Params, cl: Params, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, Params]:
    """One Mamba-2 layer of prefill; its final SSM state and conv tail are
    written into ``cl`` in place."""
    h = L.apply_norm(cfg, layer["ln1"], x)
    o, (ssm, conv) = S.apply_mamba(cfg, layer["mamba"], h, return_state=True)
    cl["ssm"].copy_(ssm)
    cl["conv"].copy_(conv)
    return _mamba_ffn(cfg, layer, x + o), cl


def _encode(cfg: ModelConfig, params: Params, frontend: torch.Tensor) -> torch.Tensor:
    """The ENCDEC encoder over the frontend's embeddings: bidirectional
    attention layers (RoPE over the frontend's positions), then its norm.
    Prefill and the training forward both run it."""
    x = frontend.to(cfg.cdtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def body(p, x, aux):
        x, a = _apply_attn_layer(cfg, p, x, positions, causal=False)
        return x, aux + a

    x, _ = _scan(cfg, body, _unstack(params["enc_layers"], cfg.n_enc_layers), x,
                 _zero_aux(x))
    return L.apply_norm(cfg, params["enc_final_norm"], x)


def _serving_step(fn: Callable) -> Callable:
    """Run ``fn(cfg, params, ...)`` under ``inference_mode``, or, with
    DTensor params (a mesh), under ``no_grad``: DTensor's views need the
    version counters that inference tensors do not have."""
    @functools.wraps(fn)
    def step(cfg, params, *args, **kwargs):
        dist = part.is_distributed(params.get("embed"))
        with torch.no_grad() if dist else torch.inference_mode():
            return fn(cfg, params, *args, **kwargs)

    return step


@_serving_step
def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            max_len: int) -> Tuple[torch.Tensor, Params]:
    """Run the full prompt, return last-position logits + primed cache.
    VLM and ENCDEC read their context from ``batch["frontend"]``
    (B, S_ctx, D)."""
    _check_family(cfg)
    fam = cfg.family
    tokens = batch["tokens"]
    B, S = tokens.shape
    frontend = batch["frontend"].to(cfg.cdtype) if fam in (VLM, ENCDEC) else None
    dist = part.is_distributed(tokens)
    cache = init_cache(cfg, B, max_len, "meta" if dist else tokens.device,
                       n_ctx=None if frontend is None else frontend.shape[1])
    if dist:
        cache = _placed_cache(tokens, cache)
    x = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)[None, :]
    if fam in (DENSE, MOE):
        for i, layer in enumerate(trunk_layers(cfg, params)):
            x, _ = prefill_attn_layer(cfg, layer, layer_params(cache["attn"], i), x, positions)
    elif fam == SSM:
        for i in range(cfg.n_layers):
            x, _ = prefill_mamba_layer(cfg, layer_params(params["layers"], i),
                                       layer_params(cache["mamba"], i), x)
    elif fam == HYBRID:
        period = cfg.attn_every
        for b in range(cfg.n_layers // period):
            blk = layer_params(params["blocks"], b)
            mcache = layer_params(cache["mamba"], b)
            for i in range(period - 1):      # the mamba caches skip the attention index
                x, _ = prefill_mamba_layer(cfg, blk[f"sub{i}"], layer_params(mcache, i), x)
            x, _ = prefill_attn_layer(cfg, blk[f"sub{period - 1}"],
                                      layer_params(cache["attn"], b), x, positions,
                                      rope=False)
    elif fam == VLM:
        period = cfg.cross_attn_every
        for b in range(cfg.n_layers // period):
            blk = layer_params(params["blocks"], b)
            scache = layer_params(cache["self"], b)
            for i in range(period - 1):
                x, _ = prefill_attn_layer(cfg, blk[f"self{i}"], layer_params(scache, i),
                                          x, positions)
            k, v = _cross_kv(cfg, blk["cross"]["xattn"], frontend)
            cache["xk"][b].copy_(k)
            cache["xv"][b].copy_(v)
            x = _apply_cross_layer(cfg, blk["cross"], x, k, v)
    else:  # ENCDEC
        enc = _encode(cfg, params, frontend)
        for i in range(cfg.n_dec_layers):
            layer = layer_params(params["dec_layers"], i)
            x, k, v = _self_attn(cfg, layer, x, positions)
            _write_kv(layer_params(cache["attn"], i), k, v, 0)
            ck, cv = _cross_kv(cfg, layer["xattn"], enc)
            cache["xk"][i].copy_(ck)
            cache["xv"][i].copy_(cv)
            x = x + _cross_attend(cfg, layer["xattn"], L.apply_norm(cfg, layer["ln_x"], x),
                                  ck, cv)
            x = _ffn_block(cfg, layer, x)
    logits = _logits(cfg, params, x[:, -1:, :])
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _self_attn_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, cl: Params, pos: Pos,
                      rope: bool = True) -> torch.Tensor:
    """``x + attn(ln1(x))`` for one token; its K/V (latent attention: its
    ``c_kv`` and ``k_pe``) appended to ``cl`` in place."""
    B = x.shape[0]
    h = L.apply_norm(cfg, p["ln1"], x)
    if torch.is_tensor(pos):       # on the device: the same int32 values, no host read
        positions = pos.to(torch.int32).view(1, 1)
        kv_len = (positions[0] + 1).expand(B).contiguous()
    else:
        positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
        kv_len = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
    if cfg.mla:
        q_nope, q_pe, c_kv, k_pe = L.mla_project(cfg, p["attn"], h, positions)
        cl = _write_kv(cl, c_kv, k_pe, pos)
        o = L.mla_decode_attention(cfg, p["attn"], q_nope, q_pe, cl["c_kv"], cl["k_pe"],
                                   kv_len, None if torch.is_tensor(pos) else pos + 1)
        return x + o @ p["attn"]["wo"].to(o.dtype)
    q, k, v = L.qkv_project(cfg, p["attn"], h, positions, rope=rope)
    cl = _write_kv(cl, k, v, pos)
    o = L.decode_attention_core(cfg, q, cl["k"], cl["v"], kv_len)
    return x + L.attention_out(cfg, p["attn"], o)


def _attn_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, cl: Params, pos: Pos,
                 rope: bool = True) -> Tuple[torch.Tensor, Params]:
    """x: (B,1,D); cl: one layer's KV cache. Returns (x, cache)."""
    return _ffn_block(cfg, p, _self_attn_decode(cfg, p, x, cl, pos, rope)), cl


def _mamba_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, cl: Params
                  ) -> Tuple[torch.Tensor, Params]:
    """x: (B,1,D); cl: one layer's SSM and conv state, updated in place."""
    h = L.apply_norm(cfg, p["ln1"], x)
    o, ssm, conv = S.mamba_decode_step(cfg, p["mamba"], h, cl["ssm"], cl["conv"])
    cl["ssm"].copy_(ssm)
    cl["conv"].copy_(conv)
    return _mamba_ffn(cfg, p, x + o), cl


@_serving_step
def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                token: torch.Tensor, pos: Pos) -> Tuple[torch.Tensor, Params]:
    """One decode step. token: (B,) ints; pos: cache length so far, a
    Python int or a 0-d or (1,) int tensor on the token's device. The
    tensor form reads nothing on the host, so that the step can be captured
    in a CUDA graph and replayed at every position; it gives the same
    logits and cache bits as the int.

    Returns (logits (B, V), cache); the cache is updated in place."""
    _check_family(cfg)
    fam = cfg.family
    pos = pos.reshape(1).long() if torch.is_tensor(pos) else int(pos)
    x = part.shard_btd(part.embed_lookup(params["embed"], token)[:, None, :]
                       .to(cfg.cdtype))                                    # (B,1,D)
    if fam in (DENSE, MOE):
        for i, layer in enumerate(trunk_layers(cfg, params)):
            x, _ = _attn_decode(cfg, layer, x, layer_params(cache["attn"], i), pos)
    elif fam == SSM:
        for i in range(cfg.n_layers):
            x, _ = _mamba_decode(cfg, layer_params(params["layers"], i), x,
                                 layer_params(cache["mamba"], i))
    elif fam == HYBRID:
        period = cfg.attn_every
        for b in range(cfg.n_layers // period):
            blk = layer_params(params["blocks"], b)
            mcache = layer_params(cache["mamba"], b)
            for i in range(period - 1):
                x, _ = _mamba_decode(cfg, blk[f"sub{i}"], x, layer_params(mcache, i))
            x, _ = _attn_decode(cfg, blk[f"sub{period - 1}"], x,
                                layer_params(cache["attn"], b), pos, rope=False)
    elif fam == VLM:
        period = cfg.cross_attn_every
        for b in range(cfg.n_layers // period):
            blk = layer_params(params["blocks"], b)
            scache = layer_params(cache["self"], b)
            for i in range(period - 1):
                x, _ = _attn_decode(cfg, blk[f"self{i}"], x, layer_params(scache, i), pos)
            x = _apply_cross_layer(cfg, blk["cross"], x, cache["xk"][b], cache["xv"][b])
    else:  # ENCDEC
        for i in range(cfg.n_dec_layers):
            layer = layer_params(params["dec_layers"], i)
            x = _self_attn_decode(cfg, layer, x, layer_params(cache["attn"], i), pos)
            x = x + _cross_attend(cfg, layer["xattn"], L.apply_norm(cfg, layer["ln_x"], x),
                                  cache["xk"][i], cache["xv"][i])
            x = _ffn_block(cfg, layer, x)
    logits = _logits(cfg, params, x)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# streaming execution (DESIGN.md §9)
# ---------------------------------------------------------------------------
# Per-layer entry points for the DENSE and MoE families: the serving engine walks
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
    return part.shard_btd(part.embed_lookup(params["embed"], token)[:, None, :].to(cfg.cdtype))


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


# ---------------------------------------------------------------------------
# forward and loss (training)
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logits (B, S, V) of every position and the summed router aux loss.
    VLM and ENCDEC read their context from ``batch["frontend"]``."""
    _check_family(cfg)
    fam = cfg.family
    if fam == ENCDEC:
        return _forward_encdec(cfg, params, batch)
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    aux = _zero_aux(x)

    if fam in (DENSE, MOE, SSM):
        def body(p, x, aux):
            x, a = (_apply_mamba_layer(cfg, p, x) if fam == SSM
                    else _apply_attn_layer(cfg, p, x, positions))
            return x, aux + a

        layers = _unstack(params["layers"], cfg.n_moe_stack)
        if cfg.n_dense_layers:
            layers = _unstack(params["dense_layers"], cfg.n_dense_layers) + layers
        x, aux = _scan(cfg, body, layers, x, aux)
    elif fam == HYBRID:
        period = cfg.attn_every
        # nested remat, as the reference: the period body keeps only its
        # carry, and each sublayer is checkpointed too
        attn_fn = _maybe_remat(cfg, lambda p, x: _apply_attn_layer(cfg, p, x, positions,
                                                                   rope=False))
        mamba_fn = _maybe_remat(cfg, lambda p, x: _apply_mamba_layer(cfg, p, x))

        def body(blk, x, aux):
            for i in range(period):
                x, a = (attn_fn if i == period - 1 else mamba_fn)(blk[f"sub{i}"], x)
                aux = aux + a
            return x, aux

        x, aux = _scan(cfg, body, _unstack(params["blocks"], cfg.n_layers // period), x, aux)
    else:  # VLM
        frontend = batch["frontend"].to(cfg.cdtype)
        period = cfg.cross_attn_every
        self_fn = _maybe_remat(cfg, lambda p, x: _apply_attn_layer(cfg, p, x, positions))
        cross_fn = _maybe_remat(cfg, lambda p, x: _apply_cross_layer(
            cfg, p, x, *_cross_kv(cfg, p["xattn"], frontend)))

        def body(blk, x, aux):
            for i in range(period - 1):
                x, a = self_fn(blk[f"self{i}"], x)
                aux = aux + a
            return cross_fn(blk["cross"], x), aux

        x, aux = _scan(cfg, body, _unstack(params["blocks"], cfg.n_layers // period), x, aux)
    return _logits(cfg, params, x), aux


def _forward_encdec(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    enc = _encode(cfg, params, batch["frontend"])
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]

    def body(p, x, aux):
        x, _, _ = _self_attn(cfg, p, x, positions)
        ck, cv = _cross_kv(cfg, p["xattn"], enc)
        x = x + _cross_attend(cfg, p["xattn"], L.apply_norm(cfg, p["ln_x"], x), ck, cv)
        return _res(cfg, _ffn_block(cfg, p, x)), aux

    x, aux = _scan(cfg, body, _unstack(params["dec_layers"], cfg.n_dec_layers), x,
                   _zero_aux(x))
    return _logits(cfg, params, x), aux


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position NLL in float32, as the reference: the max shift held
    constant, and the label's logit picked by comparison with a vocab index
    (no gather). Under a mesh, vocab-parallel
    (``partitioning.vocab_parallel_nll``)."""
    if part.is_distributed(logits):
        return part.vocab_parallel_nll(logits, labels)
    logits_f = logits.float()
    shifted = logits_f - logits_f.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(shifted).sum(-1))
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    label_logit = torch.where(vocab == labels[..., None], shifted, 0.0).sum(-1)
    return lse - label_logit


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {"loss", "aux_loss", "perplexity"}): the mean next-token NLL
    plus ``router_aux_coef`` times the router aux loss."""
    logits, aux = forward(cfg, params, batch)
    loss = softmax_cross_entropy(logits, batch["labels"]).mean()
    total = loss + cfg.router_aux_coef * aux
    return total, {"loss": loss, "aux_loss": aux,
                   "perplexity": torch.exp(torch.clamp(loss, max=20.0))}
