"""Decide ``correct``: the served tokens against the plain reference.

After the window has closed and the program's state is freed, a sample of
the finished requests, drawn from the seed, is run through the float32
reference (``reference.py``) over its prompt and the tokens the program
served. For every served token the gap by which the reference's logit of
that token lies below the reference's best is read. The configuration's
``limits`` name the statistics of these gaps that are compared and their
limits: ``logit_gap_max``, the widest gap over the sample, or
``logit_gap_mean``, their mean (PERF.md gives the readings each limit was
set from, and why a configuration compares the one it does). The sample holds,
for each tenant, a request whose model the MRM staged from the host tier
where there is one, so that a tenant served another tenant's bytes fails.
A request that failed or never returned fails the run.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from trimsbench import reference, weights
from trimsbench.serve import Record


def sample(records: Sequence[Record], per_tenant: int, seed: int) -> List[Record]:
    """Up to ``per_tenant`` finished requests of each tenant: a host-tier
    hit first where the tenant has one, the rest drawn at random."""
    rng = np.random.default_rng((seed + 1) % 2 ** 63)
    done = [r for r in records if r.error is None]
    out: List[Record] = []
    for tenant in sorted({r.tenant for r in done}):
        mine = [r for r in done if r.tenant == tenant]
        host = [r for r in mine if r.stats.tier_hit == "host"]
        picked = [host[rng.integers(len(host))]] if host else []
        rest = [r for r in mine if r not in picked]
        idx = rng.permutation(len(rest))[:max(0, per_tenant - len(picked))]
        out += picked + [rest[i] for i in idx]
    return sorted(out, key=lambda r: r.n)


def served_gaps(c: dict, seed: int, reqs: Sequence[Record], pool, device,
                others: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """Gaps of every served token of ``reqs`` (``"program"``) and, for each
    precision of ``others`` (``"float8"``: the control), of the tokens the
    reference computed in it puts first at the same positions."""
    S = pool[0].shape[1]
    out: Dict[str, list] = {}
    for tenant in sorted({r.tenant for r in reqs}):
        w = weights.draw(c, weights.tenant_seed(seed, tenant), device)
        with torch.inference_mode():
            for r in (r for r in reqs if r.tenant == tenant):
                served = torch.as_tensor(r.tokens, dtype=torch.long, device=device)
                prompt = torch.as_tensor(pool[r.prompt], dtype=torch.long, device=device)
                toks = torch.cat([prompt, served[:, :-1]], dim=1)
                d = c["hidden_size"]
                h = reference.final_hidden(c, w, toks, S).reshape(-1, d)
                hs = {p: reference.final_hidden(c, w, toks, S, p).reshape(-1, d)
                      for p in others}
                for k, g in reference.gaps(c, w, h, served.reshape(-1), hs).items():
                    out.setdefault(k, []).append(g.cpu())
        del w
    return {k: torch.cat(v) for k, v in out.items()}


STATISTICS = {"logit_gap_max": torch.max, "logit_gap_mean": torch.mean}


def run_check(c: dict, t: dict, seed: int, records: Sequence[Record], pool,
              device) -> Dict[str, dict]:
    """The numbers compared, each ``{"value": v, "limit": l}``; the run is
    correct when no value exceeds its limit."""
    out = {"failed_requests": {"value": sum(r.error is not None for r in records),
                               "limit": 0}}
    reqs = sample(records, t["check_per_tenant"], seed)
    g = served_gaps(c, seed, reqs, pool, device)["program"] if reqs else None
    for name, limit in c["limits"].items():
        value = float("inf") if g is None else float(STATISTICS[name](g))
        out[name] = {"value": value, "limit": limit}
    return out
