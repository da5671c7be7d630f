"""Prefix-KV sharing: TrIMS's insight applied to the THIRD cold-start term.

The paper shares model weights because they are constant across requests.
In LLM serving there is a second class of constant data: the prefill KV
cache of a shared prompt prefix (system prompts, few-shot preambles). This
module extends the MRM pattern to it — a byte-capacity LRU tier of prefill
results keyed by (model, prompt-hash).

Copies, not shares: the port's decode step writes its cache IN PLACE
(``models/model.py``: the K/V append, and the SSM and conv states of the
Mamba-2 layers), where the JAX package's returns fresh buffers and can hand
one stored cache to every decode. So :meth:`insert` stores its own clone of
the prefill cache, and every :meth:`lookup` hit hands back a fresh clone of
that, every leaf of the tree: K/V, SSM and conv states, and the cross K/V
of the VLM and ENCDEC families. The stored tensors are never the ones a
decode writes into, and concurrent decodes from one prefix stay isolated.
A hit costs one device copy of the cache instead of a prefill. Logits are
only read (argmax) and are shared.
"""
from __future__ import annotations

import hashlib
from typing import Any, Optional, Tuple

import numpy as np

from repro_torch.core.cache import CapacityError, Tier, TierCache


def prompt_key(model: str, tokens: np.ndarray, max_len: int) -> str:
    h = hashlib.sha1(np.ascontiguousarray(tokens).tobytes()).hexdigest()[:24]
    return f"{model}@{tokens.shape[0]}x{tokens.shape[1]}@{max_len}@{h}"


def _leaves(tree):
    """Tensors of a nested dict (a decode cache tree)."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _cache_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


class PrefixKVStore:
    """Device-tier cache of (prefill logits, KV cache) keyed by prompt."""

    def __init__(self, capacity_bytes: int = 2 << 30, policy: str = "lru"):
        self.tier = TierCache(Tier.DEVICE, capacity_bytes, policy)
        self.hits = 0
        self.misses = 0
        self.prefills_skipped_s = 0.0  # accumulated compute seconds saved

    def lookup(self, key: str) -> Optional[Tuple[Any, Any]]:
        """``(logits, cache)`` for ``key``, the cache a clone the caller may
        write into; None on a miss."""
        e = self.tier.get(key)
        if e is None:
            self.misses += 1
            return None
        self.hits += 1
        logits, cache = e.payload
        return logits, _clone(cache)

    def insert(self, key: str, logits, cache, prefill_s: float = 0.0):
        """Keep a clone of ``cache``: the caller goes on decoding into its
        own."""
        if self.tier.peek(key) is not None:
            return
        nbytes = _cache_bytes(cache)
        try:
            self.tier.make_room(nbytes)
            e = self.tier.insert(key, nbytes, payload=(logits, _clone(cache)))
            e.payload_prefill_s = prefill_s  # type: ignore[attr-defined]
        except CapacityError:
            pass  # larger than the tier: serve uncached

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                **self.tier.stats()}
