"""The plain reference against the port on the CPU at a small size, in
float32: the port's prefill and decode through its cache give the logits
of the reference's single pass over the prompt and the served tokens, MoE
capacity drops included."""
from __future__ import annotations

import json

import pytest
import torch

from conftest import REPO
from repro_torch.models import model as M
from trimsbench import reference, serve, spec, weights


def _tiny(name, **kw):
    c = json.loads((REPO / f"trimsbench/configs/{name}.json").read_text())
    c.update(spec.arch(c).tiny(c), **kw)
    return c


CASES = {
    "dense": _tiny("deepseek-7b.l2"),
    # a small capacity factor so that the prompt's group and every decode
    # group drop assignments
    "moe_drops": _tiny("qwen3-moe-30b-a3b.l2",
                       assumed={"capacity_factor": 0.5, "moe_dispatch": "capacity"}),
    "moe": _tiny("qwen3-moe-30b-a3b.l2"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_logits_equal_the_ports_prefill_and_decode(case):
    c = CASES[case]
    cfg = serve.port_config(c).replace(param_dtype="float32", compute_dtype="float32")
    flat = {k: v.float() for k, v in weights.draw(c, 1234, "cpu").items()}
    params = weights.as_tree(flat)
    B, S, new = 3, 12, 6
    prompt = torch.randint(0, c["vocab_size"], (B, S), generator=torch.Generator().manual_seed(5))
    logits, cache = M.prefill(cfg, params, {"tokens": prompt}, S + new)
    steps = [logits[:, :c["vocab_size"]]]
    tok = logits.argmax(-1)
    served = [tok]
    for i in range(new - 1):
        logits, cache = M.decode_step(cfg, params, cache, tok, S + i)
        steps.append(logits[:, :c["vocab_size"]])
        tok = logits.argmax(-1)
        served.append(tok)
    port = torch.stack(steps, dim=1)                                   # (B, new, V)
    toks = torch.cat([prompt, torch.stack(served, 1)[:, :-1]], dim=1)
    h = reference.final_hidden(c, flat, toks, S)
    ref = reference.logits(c, flat, h)
    scale = ref.abs().max()
    assert (port - ref).abs().max() <= 1e-5 * scale
    g = reference.gaps(c, flat, h.reshape(-1, c["hidden_size"]),
                       torch.stack(served, 1).reshape(-1))["program"]
    assert g.max() <= 1e-5 * scale


def test_capacity_drops_happen_in_the_small_moe_case():
    c = CASES["moe_drops"]
    assert reference.capacity(3 * 12, c) < 3 * 12 * 2 / 8
    assert reference.capacity(3, c) == 1


def test_the_control_rounds_to_float8():
    x = torch.randn(4, 64)
    q = reference._fp8(x, -1)
    assert not torch.equal(q, x)
    rel = ((q - x).abs() / x.abs().amax(-1, keepdim=True)).max()
    assert 1e-4 < rel < 2 ** -4
