"""Model/architecture configuration (PyTorch port).

Same fields, defaults and derived properties as the JAX package's
``ModelConfig``, so ``ModelConfig(**meta["config"])`` accepts the config a
published ``.trims`` file carries from either package. ``pdtype``/``cdtype``
return torch dtypes; ``use_pallas`` is kept for meta compatibility and is
ignored (the port picks its kernels by the tensor's device).

The port's own settings, which the JAX package has no counterpart of
(latent attention, leading dense layers of the MOE family, sigmoid
routing: ``EXTRAS``), are ``InitVar``s that ``__post_init__`` keeps as
attributes. ``dataclasses.asdict`` and ``fields`` leave them out, so a
configuration that keeps them at their defaults is the JAX package's field
for field; :meth:`ModelConfig.to_dict` adds those set otherwise, and
equality compares it. ``replace`` carries them over.
"""
from __future__ import annotations

import dataclasses
from dataclasses import InitVar, dataclass, field
from typing import Optional, Tuple

import torch

# Model family tags --------------------------------------------------------
DENSE = "dense"
MOE = "moe"
HYBRID = "hybrid"   # interleaved mamba + attention (Jamba)
SSM = "ssm"         # pure Mamba-2
ENCDEC = "encdec"   # encoder-decoder (seamless; audio frontend stubbed)
VLM = "vlm"         # decoder + interleaved cross-attention (vision stubbed)

# the port's settings beyond the JAX package's fields, with their defaults
EXTRAS = {
    "kv_lora_rank": 0,              # latent attention (MLA) where > 0: the cached latent width;
                                    # its RoPE takes interleaved pairs (DeepSeek-V3)
    "qk_nope_head_dim": 0,          # MLA: a head's query/key width without RoPE
    "qk_rope_head_dim": 0,          # MLA: its width with RoPE (one key part shared by all heads)
    "v_head_dim": 0,                # MLA: a head's value width
    "n_dense_layers": 0,            # MOE: leading layers with a dense MLP of ``dense_d_ff``
    "dense_d_ff": 0,
    "router_scoring": "softmax",    # "softmax" | "sigmoid" (top-k on score + ``router_bias``)
    "routed_scaling_factor": 1.0,   # sigmoid: the normalised top-k weights are scaled by it
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # attention ------------------------------------------------------------
    d_head: Optional[int] = None          # explicit head dim (qwen3/nemo); default d_model//n_heads
    qkv_bias: bool = False                # qwen1.5
    qk_norm: bool = False                 # qwen3
    rope_theta: float = 1e4
    max_seq_len: int = 131072
    # norm -------------------------------------------------------------------
    norm_type: str = "rmsnorm"            # "rmsnorm" | "layernorm" | "nonparametric_ln" (olmo)
    norm_eps: float = 1e-5
    # MoE --------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_every: int = 1                    # apply MoE every Nth layer (jamba: 2)
    capacity_factor: float = 1.25
    moe_impl: str = "capacity"            # "capacity" | "ragged"
    router_aux_coef: float = 0.01
    # hybrid / SSM -----------------------------------------------------------
    attn_every: int = 0                   # jamba: 1 attention layer per `attn_every` layers (8)
    d_state: int = 0                      # mamba2 SSM state dim
    d_conv: int = 4
    expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    # enc-dec ------------------------------------------------------------------
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # vlm ----------------------------------------------------------------------
    cross_attn_every: int = 0             # llama-3.2-vision: 1 cross-attn per 5 layers
    n_frontend_tokens: int = 0            # stub image/audio embedding length
    tie_embeddings: bool = True
    # numerics / execution ------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat_policy: str = "nothing"         # "none" | "nothing" | "dots"
    scan_layers: bool = True
    grad_accum: int = 1                   # microbatches per train step
    use_pallas: bool = False              # pallas kernels on TPU; jnp chunked path elsewhere
    attn_chunk: int = 2048                # query-chunk for online-softmax jnp attention
    logits_chunk: int = 0                 # 0 = unchunked vocab projection
    opt_moment_dtype: str = "float32"     # "bfloat16" shaves optimizer HBM for >100B models
    source: str = ""                      # provenance [source; verified-tier]
    # the port's own (``EXTRAS``) ------------------------------------------------
    kv_lora_rank: InitVar[int] = 0
    qk_nope_head_dim: InitVar[int] = 0
    qk_rope_head_dim: InitVar[int] = 0
    v_head_dim: InitVar[int] = 0
    n_dense_layers: InitVar[int] = 0
    dense_d_ff: InitVar[int] = 0
    router_scoring: InitVar[str] = "softmax"
    routed_scaling_factor: InitVar[float] = 1.0

    def __post_init__(self, *extras):
        for name, value in zip(EXTRAS, extras):
            object.__setattr__(self, name, value)
        if self.router_scoring not in ("softmax", "sigmoid"):
            raise ValueError(f"router_scoring {self.router_scoring!r}")
        if self.kv_lora_rank and not (self.qk_nope_head_dim and self.qk_rope_head_dim
                                      and self.v_head_dim):
            raise ValueError("latent attention needs qk_nope_head_dim, qk_rope_head_dim "
                             "and v_head_dim")
        if self.n_dense_layers and (self.family != MOE or not self.dense_d_ff
                                    or self.n_dense_layers >= self.n_layers):
            raise ValueError("leading dense layers are the MOE family's, need dense_d_ff "
                             "and leave at least one MoE layer")

    def to_dict(self) -> dict:
        """``dataclasses.asdict`` and every setting of ``EXTRAS`` that is not
        its default: what a published file's meta carries, and what the
        engine's signature hashes."""
        out = dataclasses.asdict(self)
        out.update({k: getattr(self, k) for k, d in EXTRAS.items() if getattr(self, k) != d})
        return out

    def __eq__(self, other):
        return isinstance(other, ModelConfig) and self.to_dict() == other.to_dict()

    # derived ----------------------------------------------------------------
    @property
    def mla(self) -> bool:
        """Latent attention: a cache of ``kv_lora_rank + qk_rope_head_dim``
        values a position, shared by every head."""
        return self.kv_lora_rank > 0

    @property
    def n_moe_stack(self) -> int:
        """Layers stacked under ``layers`` (the MOE family's leading dense
        layers are stacked apart, under ``dense_layers``)."""
        return self.n_layers - self.n_dense_layers

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a 256 multiple (Megatron-style padding) so the
        logits' vocab dim always divides the TP degree; the pad region is
        masked to -inf in the loss/argmax."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests (one real step)."""
        kw = dict(
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads // max(1, self.n_heads // 4))),
            d_head=16,
            d_ff=128,
            vocab_size=256,
            max_seq_len=512,
            attn_chunk=32,
            remat_policy="none",
        )
        if self.n_experts:
            kw.update(n_experts=min(8, self.n_experts), top_k=min(2, self.top_k))
        if self.family in (HYBRID,):
            kw.update(n_layers=self.attn_every or 8, d_state=16, ssm_headdim=16,
                      ssm_chunk=16, expand=2)
        if self.family == SSM:
            kw.update(n_layers=2, d_state=16, ssm_headdim=16, ssm_chunk=16,
                      n_heads=1, n_kv_heads=1)
        if self.family == ENCDEC:
            kw.update(n_enc_layers=2, n_dec_layers=2, n_layers=4)
        if self.family == VLM:
            kw.update(n_layers=self.cross_attn_every or 5, n_frontend_tokens=16)
        return self.replace(**kw)

    def param_count(self) -> int:
        """Analytic parameter count (matches init; used for 6ND and sizing)."""
        d, hd = self.d_model, self.head_dim
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.mla:
            H, r, rope = self.n_heads, self.kv_lora_rank, self.qk_rope_head_dim
            attn = (d * H * (self.qk_nope_head_dim + rope) + d * (r + rope) + r
                    + r * H * (self.qk_nope_head_dim + self.v_head_dim)
                    + H * self.v_head_dim * d)
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        ffn_dense = 3 * d * self.d_ff  # SwiGLU: gate, up, down
        moe = 0
        if self.n_experts:
            moe = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            if self.router_scoring == "sigmoid":
                moe += self.n_experts                 # router_bias
            if self.n_shared_experts:
                moe += self.n_shared_experts * 3 * d * self.d_ff
        norm = 2 * d if self.norm_type == "rmsnorm" else (0 if self.norm_type == "nonparametric_ln" else 4 * d)
        ssm = 0
        if self.d_state:
            di, ns, nh = self.d_inner, self.d_state, self.n_ssm_heads
            ssm = (d * (2 * di + 2 * ns + nh)      # in_proj [z,x,B,C,dt]
                   + self.d_conv * (di + 2 * ns)   # conv over x,B,C
                   + nh * 3                        # A_log, D, dt_bias
                   + di * d + di)                  # out_proj + norm

        def layer_cost(kind: str, use_moe: bool) -> int:
            if kind == "attn":
                c = attn + norm
            else:
                c = ssm + norm // 2 if self.norm_type != "nonparametric_ln" else ssm
            c += (moe if use_moe else ffn_dense) + norm
            return c

        total = self.vocab_size * d  # embedding (tied)
        if not self.tie_embeddings:
            total += self.vocab_size * d
        total += d  # final norm
        if self.family in (DENSE,):
            total += self.n_layers * layer_cost("attn", False)
        elif self.family == MOE:
            total += self.n_moe_stack * layer_cost("attn", True)
            total += self.n_dense_layers * (layer_cost("attn", True) - moe
                                            + 3 * d * self.dense_d_ff)
        elif self.family == SSM:
            # mamba2 block has no separate FFN
            total += self.n_layers * (ssm + d)
        elif self.family == HYBRID:
            period = self.attn_every
            n_periods = self.n_layers // period
            for i in range(period):
                kind = "attn" if i == period - 1 else "ssm"
                use_moe = self.n_experts > 0 and (i % self.moe_every == self.moe_every - 1)
                total += n_periods * layer_cost(kind, use_moe)
        elif self.family == ENCDEC:
            total += self.n_enc_layers * layer_cost("attn", False)
            total += self.n_dec_layers * (layer_cost("attn", False) + attn + norm)  # + cross-attn
        elif self.family == VLM:
            period = self.cross_attn_every
            n_periods = self.n_layers // period
            total += n_periods * ((period - 1) * layer_cost("attn", False)
                                  + layer_cost("attn", False) + attn + norm)  # cross layer = self+cross
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        expert_params = self.n_experts * 3 * self.d_model * self.d_ff
        active_expert = (self.top_k + self.n_shared_experts) * 3 * self.d_model * self.d_ff
        n_moe_layers = self._n_moe_layers()
        return full - n_moe_layers * (expert_params - active_expert)

    def _n_moe_layers(self) -> int:
        if not self.n_experts:
            return 0
        if self.family == MOE:
            return self.n_moe_stack
        if self.family == HYBRID:
            period = self.attn_every
            per_period = sum(1 for i in range(period)
                             if i % self.moe_every == self.moe_every - 1)
            return (self.n_layers // period) * per_period
        return self.n_layers

    def weight_bytes(self) -> int:
        return self.param_count() * self.pdtype.itemsize


@dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell from the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> bool:
    """long_500k only for sub-quadratic archs (SSM/hybrid); see DESIGN.md."""
    if shape.name == "long_500k":
        return cfg.family in (SSM, HYBRID)
    return True
