"""Operations and bytes that the work of a request needs, from its shapes.

Each input byte is counted read once and each output byte written once,
whatever a kernel rereads; causal attention is half of the full product;
the output head only for the rows whose logits are computed (the prompt's
last position and every decode step). MoE layers count the ``top_k``
routed experts a token uses, not all the experts the program reads.
The card's peaks are in ``peaks.json``. What a request of a configuration
needs is counted by its architecture's file (``arch/<model_type>.py``) from
the pieces below.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

from trimsbench import spec
from trimsbench.weights import head_dim

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
BF16 = 2


def layer_params_per_token(c: dict) -> int:
    """Weights one token multiplies in one layer (routed experts: top_k),
    from the architecture's file."""
    return spec.arch(c).layer_params_per_token(c)


def request_flops(c: dict, B: int, S: int, new: int) -> float:
    """Useful operations of one request: prefill of S tokens, then new - 1
    decode steps, at batch B; from the architecture's file."""
    return spec.arch(c).request_flops(c, B, S, new)


def request_kernel_bounds(c: dict, B: int, S: int, new: int) -> Dict[str, List[float]]:
    """Calls of each kernel in one request with their least times:
    ``{kernel: [bound_s, ...]}``, in launch order; from the architecture's
    file."""
    return spec.arch(c).request_kernel_bounds(c, B, S, new)


def attention_params(c: dict) -> int:
    """Weights of one attention layer's four products."""
    d = c["hidden_size"]
    hd = head_dim(c)
    qd, kvd = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd
    return d * qd + 2 * d * kvd + qd * d


def _attn_flops(c: dict, B: int, q_rows: int, kv_len: int, causal: bool) -> float:
    """QK^T and PV of one layer for ``q_rows`` queries against ``kv_len`` keys."""
    full = 4.0 * B * c["num_attention_heads"] * q_rows * kv_len * head_dim(c)
    return full / 2 if causal else full


def decoder_flops(c: dict, B: int, S: int, new: int, params_per_token: int,
                  attn_layers: int) -> float:
    """Operations of a request to a decoder whose layers multiply
    ``params_per_token`` weights a token in all and of which
    ``attn_layers`` attend: prefill of S tokens, then new - 1 decode steps,
    at batch B, the tied head at the prompt's last position and each step."""
    d, V = c["hidden_size"], c["vocab_size"]
    per_tok = 2.0 * params_per_token
    head = 2.0 * B * d * V
    total = per_tok * B * S + attn_layers * _attn_flops(c, B, S, S, True) + head
    for i in range(new - 1):
        total += per_tok * B + attn_layers * _attn_flops(c, B, 1, S + i + 1, False) + head
    return total


def flash_call(c: dict, B: int, S: int) -> Tuple[float, float]:
    """(operations, bytes) of one causal prefill attention call: q, k, v
    read and o written once, bf16."""
    hd = head_dim(c)
    H, G = c["num_attention_heads"], c["num_key_value_heads"]
    nbytes = BF16 * B * S * hd * (2 * H + 2 * G)
    return _attn_flops(c, B, S, S, True), float(nbytes)


def decode_call(c: dict, B: int, kv_len: int) -> Tuple[float, float]:
    """(operations, bytes) of one decode attention call: q read, the
    ``kv_len`` valid rows of K and V read, o written, bf16."""
    hd = head_dim(c)
    H, G = c["num_attention_heads"], c["num_key_value_heads"]
    nbytes = BF16 * B * hd * (2 * H + 2 * G * kv_len)
    return _attn_flops(c, B, 1, kv_len, False), float(nbytes)


def bound_s(ops: float, nbytes: float) -> float:
    """Least time the card could take: compute or bytes, whichever is more."""
    return max(ops / PEAKS["bf16_flops_per_s"], nbytes / PEAKS["hbm_bytes_per_s"])


def attention_kernel_bounds(c: dict, B: int, S: int, new: int,
                            attn_layers: int) -> Dict[str, List[float]]:
    """Least times of the attention kernels' calls in one request to a
    decoder with ``attn_layers`` attention layers: one ``flash_fwd`` a layer
    in prefill, one ``decode_split_kernel`` a layer in each decode step."""
    flash = [bound_s(*flash_call(c, B, S))] * attn_layers
    decode: List[float] = []
    for i in range(new - 1):
        decode += [bound_s(*decode_call(c, B, S + i + 1))] * attn_layers
    return {"flash_fwd": flash, "decode_split_kernel": decode}
