"""Faults of the timed path, planted in the port at run time.

The CPU tests plant each in a run of a tiny copy of a cell and see
``correct`` come out false; ``calibrate.py --fault`` plants one in a run of
a cell at its own size on the card, to read how far its served tokens lie
from the reference. Each fault replaces functions of the port (of
``repro_torch.models.model`` or a module it calls through); the engine
looks them up when it builds a request's executable, so a fault is planted
before set-up. The faults every cell can have are below; an architecture's
file (``arch/<model_type>.py``) adds those of its own layers under
``FAULTS``.

- ``stale_kv``: decode steps return the KV cache unchanged (the new
  position's keys and values never written). A cell whose requests serve
  one token each makes no decode step, so it cannot have this fault.
- ``half_batch``: the prefill leaves out half of the batch and serves the
  other half's tokens and cache in its place.
- ``altered_token``: the first row's token is altered where it is produced,
  by the prefill and by every decode step (replayed from a CUDA graph too).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch

from trimsbench import spec

Patch = Tuple[object, str, Callable]


@dataclass(frozen=True)
class Fault:
    """``patches(M)``: ``(module, attribute, replacement)`` for each
    function the fault replaces, given ``repro_torch.models.model`` as
    ``M``; ``decodes``: the fault lives in decode steps only."""
    patches: Callable[[object], List[Patch]]
    decodes: bool = False


def _alter(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """The first row's logit after its best set highest, without reading
    the index on the host, so that a CUDA graph can capture it."""
    logits = logits.clone()
    row = logits[0]
    hit = torch.arange(row.shape[-1], device=row.device) == (row.argmax() + 1) % vocab
    logits[0] = row.masked_fill(hit, 1e30)
    return logits


def _stale_kv(M) -> List[Patch]:
    orig = M._write_kv

    def write(cl, k, v, start):
        return cl if k.shape[1] == 1 else orig(cl, k, v, start)
    return [(M, "_write_kv", write)]


def _half_batch(M) -> List[Patch]:
    orig = M.prefill

    def prefill(cfg, params, batch, max_len):
        toks = batch["tokens"]
        logits, cache = orig(cfg, params, {"tokens": toks[: toks.shape[0] // 2]}, max_len)
        cache = {k: {kk: torch.cat([vv, vv], dim=1) for kk, vv in v.items()}
                 for k, v in cache.items()}
        return torch.cat([logits, logits]), cache
    return [(M, "prefill", prefill)]


def _altered_token(M) -> List[Patch]:
    prefill_orig, decode_orig = M.prefill, M.decode_step

    def prefill(cfg, params, batch, max_len):
        logits, cache = prefill_orig(cfg, params, batch, max_len)
        return _alter(logits, cfg.vocab_size), cache

    def decode(cfg, params, cache, token, pos):
        logits, cache = decode_orig(cfg, params, cache, token, pos)
        return _alter(logits, cfg.vocab_size), cache
    return [(M, "prefill", prefill), (M, "decode_step", decode)]


FAULTS = {"stale_kv": Fault(_stale_kv, decodes=True), "half_batch": Fault(_half_batch),
          "altered_token": Fault(_altered_token)}


def of_config(c: dict) -> Dict[str, Fault]:
    """Every fault of a configuration: the shared ones and its architecture's."""
    return {**FAULTS, **getattr(spec.arch(c), "FAULTS", {})}


def of_cell(c: dict, t: dict) -> List[str]:
    """The faults a cell of configuration ``c`` and traffic ``t`` can have."""
    return sorted(n for n, f in of_config(c).items() if not f.decodes or t["new_tokens"] > 1)


def patches(name: str, c: dict) -> List[Patch]:
    """``(module, attribute, replacement)`` for each function the fault
    ``name`` of configuration ``c`` replaces."""
    from repro_torch.models import model as M
    return of_config(c)[name].patches(M)


def plant(name: str, c: dict) -> None:
    """Plant the fault ``name`` for the rest of the process."""
    for mod, attr, fn in patches(name, c):
        setattr(mod, attr, fn)
