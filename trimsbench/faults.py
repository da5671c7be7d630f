"""Faults of the timed path, planted in the port at run time.

The CPU tests plant each in a run of a tiny copy of a cell and see
``correct`` come out false; ``calibrate.py --fault`` plants one in a run of
a cell at its own size on the card, to read how far its served tokens lie
from the reference. Each fault replaces one function of
``repro_torch.models.model``; the engine looks the function up when it
builds a request's executable, so a fault is planted before set-up.

- ``stale_kv``: decode steps return the KV cache unchanged (the new
  position's keys and values never written). A cell whose requests serve
  one token each makes no decode step, so it cannot have this fault.
- ``half_batch``: the prefill leaves out half of the batch and serves the
  other half's tokens and cache in its place.
- ``altered_token``: the first row's token is altered where it is produced,
  by the prefill and by every decode step.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch


def _alter(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    logits = logits.clone()
    logits[0, (logits[0].argmax() + 1) % vocab] = 1e30
    return logits


def _stale_kv(M) -> Dict[str, Callable]:
    orig = M._write_kv

    def write(cl, k, v, start):
        return cl if k.shape[1] == 1 else orig(cl, k, v, start)
    return {"_write_kv": write}


def _half_batch(M) -> Dict[str, Callable]:
    orig = M.prefill

    def prefill(cfg, params, batch, max_len):
        toks = batch["tokens"]
        logits, cache = orig(cfg, params, {"tokens": toks[: toks.shape[0] // 2]}, max_len)
        cache = {k: {kk: torch.cat([vv, vv], dim=1) for kk, vv in v.items()}
                 for k, v in cache.items()}
        return torch.cat([logits, logits]), cache
    return {"prefill": prefill}


def _altered_token(M) -> Dict[str, Callable]:
    prefill_orig, decode_orig = M.prefill, M.decode_step

    def prefill(cfg, params, batch, max_len):
        logits, cache = prefill_orig(cfg, params, batch, max_len)
        return _alter(logits, cfg.vocab_size), cache

    def decode(cfg, params, cache, token, pos):
        logits, cache = decode_orig(cfg, params, cache, token, pos)
        return _alter(logits, cfg.vocab_size), cache
    return {"prefill": prefill, "decode_step": decode}


FAULTS = {"stale_kv": _stale_kv, "half_batch": _half_batch,
          "altered_token": _altered_token}


def of_traffic(t: dict) -> List[str]:
    """The faults a cell with traffic ``t`` can have."""
    return sorted(f for f in FAULTS if f != "stale_kv" or t["new_tokens"] > 1)


def patches(name: str) -> List[Tuple[object, str, Callable]]:
    """``(module, attribute, replacement)`` for each function the fault
    ``name`` replaces."""
    from repro_torch.models import model as M
    return [(M, attr, fn) for attr, fn in FAULTS[name](M).items()]


def plant(name: str) -> None:
    """Plant the fault ``name`` for the rest of the process."""
    for mod, attr, fn in patches(name):
        setattr(mod, attr, fn)
