#!/usr/bin/env python3
"""Drive the PyTorch port of TrIMS on one NVIDIA card, end to end.

    python3 chip_smoke.py [--out results.json]

Run from the root of a checkout. Phases, each of which raises on failure
(the script then exits non-zero and prints no result):

1. Device: the card's name and power limit; build (or load) the CUDA kernel
   library from ``src/repro_torch/csrc``.
2. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the serving path's shapes (bf16 and fp32; model A's and
   model Q's, phase 6), at GQA shapes,
   ragged lengths, the edges of the attention kernels' tiles and KV splits
   and of RMSNorm's launch plan; then CUDA-event timings of the kernel, its
   plain version and one PyTorch library call as a yardstick (the port
   never calls it), with the inputs warm in L2 and cold (rotated over more
   than twice the L2's 50 MB), and the time per call issued from Python.
3. Serve (the main path): a full-width deepseek-7b (4 and 2 layers, random
   weights from a seed, bf16) is published three times into a store and
   served through the MRM and the inference engine with device and host
   capacities that force eviction and D2H demotion, then by two concurrent
   workers that must share one device copy. Kernel launch counts are set to
   0 before this phase and read after it.
4. End to end: model A's prefill logits on the card (kernels, bf16) against
   the port's plain path on the CPU (float32 weights upcast from the same
   file).
5. Stream and prefix: a fresh MRM and an engine with layer streaming and a
   prefix-KV cache serve model A three times over the same store: streamed
   from disk (windows ready in execution order), then from the host tier
   through the batch path (a prefix miss), then from the device tier with a
   prefix hit that must leave the stored K/V unchanged. Every request's
   tokens must equal phase 3's for A exactly, and every request's kernel
   launches (counts set to 0 just before it) what its path implies.
6. MoE: model Q, a full-width qwen3-moe-30b-a3b (GQA 32/4, QK-norm, 128
   experts top 8; 2 layers, random weights from a seed, bf16, capacity
   dispatch), in a store of its own: a batch engine serves it from disk and
   from the device, then a fresh MRM with a streaming, prefix-caching engine
   serves it streamed from disk (stem, then each layer's base and expert
   windows ready in that order; layer 1's experts demanded before layer
   0's prefill returns), from the host tier, and from the device with a
   prefix hit. All five requests' tokens must be equal, and each request's
   launches (counts set to 0 just before it) what its path implies. Then
   Q's prefill logits on the card in float32 against the CPU plain path in
   float32, with the bf16 logits' difference and the router's agreement
   printed. Printed as ``{"moe": {...}}``.
7. CLOUD tier, cross-process sharing and FaaS, over phase 3's store and
   model A (each request's launches counted from 0 and held to its path):
   (a) A published into an object store (layer shards, codec ``none``); a
   fresh MRM over an empty disk serves it as a batch cloud hit (one
   download), a second streams it (windows ready 0..4, every shard fed
   before the file is complete), and an MRM whose host tier holds A or B
   but not both writes A back into an empty store with the same digest;
   (b) an shm-mode MRM daemon on a unix socket serves A once (a disk hit
   into shared memory), two client processes (this script with
   ``--ipc-client``) open A, put it on the card and generate, a third is
   killed while it holds A and must be released within 5 s, and a device
   eviction demotes A into a segment holding the device copy's bytes;
   (c) a FaaS platform runs a function entitled to A in two tenants'
   containers (the second a device hit on the same storage), refuses an
   unentitled one, drops the references at teardown, and a router prefers
   it over a cold platform. Every request's tokens equal phase 3's.
   Printed as ``{"ipc": ...}``, ``{"cloud": ...}`` and ``{"faas": ...}``.

The last lines are the summaries of phases 5, 6 and 7, the first port's
attention kernel times (constants, labelled ``first_port_ms``), the kernel
table as JSON (``launches``: phase 3's counts; ``q_launches``: phase 6's;
``q_*``: times at Q's shapes), the card's name and
power limit as ``nvidia-smi`` prints them, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data sheet (dense): HBM3 bytes/s and the bf16 tensor-core peak
HBM_BW = 3.35e12
PEAK_BF16 = 989e12
L2_BYTES = 50 * 2 ** 20

# Kernel times of the first, simple CUDA kernels that the attention kernels
# replaced: this script's warm CUDA-graph timing of them on an NVIDIA H100
# 80GB HBM3 at 700.00 W, in an earlier tree. Not measured by this run, so
# they are printed on a line of their own, labelled, outside the kernel table.
FIRST_PORT_MS = {"flash_attention": 0.5458000183105469, "decode_attention": 0.15609920024871826}

B, PROMPT, NEW = 2, 512, 16          # one request: batch 2, 512-token prompt, 16 new tokens
GiB = 2 ** 30


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions, and timings
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps: int = 20, trials: int = 21) -> float:
    """Device time of one call, in ms: after a warm-up, ``reps`` calls
    captured into one CUDA graph, the graph replayed ``trials`` times
    between CUDA events, the median replay divided by ``reps``. With one
    function the inputs stay in L2 across calls; ``fn`` may be a list of
    functions over different input copies, which the calls then rotate
    through (``reps`` is rounded up to a multiple of its length)."""
    fns = fn if isinstance(fn, (list, tuple)) else [fn]
    reps = -(-reps // len(fns)) * len(fns)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the default stream, as capture needs
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return statistics.median(times)


def call_ms(torch, fn, reps: int = 50, trials: int = 9) -> float:
    """Time per call issued back to back from Python, in ms: CUDA events
    around ``reps`` calls, the median of ``trials`` such loops (the host's
    clock is shared and noisy). It is the larger of the host's cost to issue
    a call and the device's to run it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return statistics.median(times)


def cold_copies(torch, make, nbytes: int):
    """Enough copies of the inputs that ``make`` builds (``nbytes`` each)
    that rotating over them passes twice the L2 cache: every call then
    finds its inputs in HBM, as the serving path's decode steps do."""
    return [make() for _ in range(max(2, -(-2 * L2_BYTES // nbytes)))]


def bound(nbytes: float, ops: float):
    """Least time for the work, in ms: bytes over HBM rate vs bf16 operations
    over the tensor-core peak, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BW, ops / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_close(torch, name, got, want, dtype, case) -> float:
    """bf16: 2e-2 as tests/test_kernels.py; fp32: 1e-4 (the card sums in
    another order than the plain version)."""
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = err > tol + tol * w.abs()
    if not torch.isfinite(g).all() or bad.any():
        raise AssertionError(f"{name} {case} {dtype}: max abs err {err.max().item():.3g} "
                             f"over rtol=atol={tol}")
    return err.max().item()


def kernel_phase(torch, F):
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import rmsnorm as kr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    errs = {"flash_attention": [], "decode_attention": [], "rmsnorm": []}
    q_errs = {"flash_attention": [], "decode_attention": [], "rmsnorm": []}   # model Q's shapes
    for dtype in (torch.bfloat16, torch.float32):
        # flash: slice prefill (MHA), GQA (mistral-nemo heads; Q's group 8), ragged S/T
        for (b, s, t, hq, hkv, d, causal) in ((B, PROMPT, PROMPT, 32, 32, 128, True),
                                              (B, PROMPT, PROMPT, 32, 8, 128, True),
                                              (B, PROMPT, PROMPT, 32, 4, 128, True),
                                              (1, 200, 200, 32, 8, 128, True),
                                              (2, 130, 70, 32, 8, 128, False)):
            q, k, v = rnd(b, s, hq, d, dtype=dtype), rnd(b, t, hkv, d, dtype=dtype), \
                rnd(b, t, hkv, d, dtype=dtype)
            e = check_close(torch, "flash", kf.flash_attention(q, k, v, causal=causal),
                            kf.flash_attention_plain(q, k, v, causal=causal), dtype,
                            (b, s, t, hq, hkv, d, causal))
            if (s, hkv, dtype) == (PROMPT, 32, torch.bfloat16):
                errs["flash_attention"].append(e)
            if (s, hkv, dtype) == (PROMPT, 4, torch.bfloat16):
                q_errs["flash_attention"].append(e)
        # decode: slice cache (2, 528, 32, 128), GQA (Q's group 8), ragged T,
        # kv_len 0 -> zeros
        T = PROMPT + NEW
        for (b, t, hq, hkv, d, lens) in ((B, T, 32, 32, 128, (T - 1, PROMPT + 1)),
                                         (B, T, 32, 8, 128, (T, 1)),
                                         (B, T, 32, 4, 128, (T - 1, PROMPT + 1)),
                                         (3, 300, 32, 8, 128, (0, 299, 300))):
            q = rnd(b, hq, d, dtype=dtype)
            kc, vc = rnd(b, t, hkv, d, dtype=dtype), rnd(b, t, hkv, d, dtype=dtype)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            e = check_close(torch, "decode", kd.decode_attention(q, kc, vc, kv_len),
                            kd.decode_attention_plain(q, kc, vc, kv_len), dtype,
                            (b, t, hq, hkv, d, lens))
            if (hkv, dtype) == (32, torch.bfloat16):
                errs["decode_attention"].append(e)
            if (hkv, dtype) == (4, torch.bfloat16):
                q_errs["decode_attention"].append(e)
        edge_cases(torch, kd, kf, rnd, dtype, dev)
        # rmsnorm: prefill and decode rows of d_model (A's 4096, Q's 2048),
        # Q's QK-norm rows over 32 query and 4 KV heads, a ragged shape
        for shape, eps in (((B, PROMPT, 4096), 1e-5), ((B, 1, 4096), 1e-5),
                           ((B, 7, 32, 128), 1e-6), ((17, 96), 1e-5),
                           ((B, PROMPT, 2048), 1e-5), ((B, 1, 2048), 1e-5),
                           ((B, PROMPT, 32, 128), 1e-6), ((B, PROMPT, 4, 128), 1e-6),
                           ((B, 1, 32, 128), 1e-6), ((B, 1, 4, 128), 1e-6)):
            x, sc = rnd(*shape, dtype=dtype), rnd(shape[-1], dtype=dtype) + 1
            e = check_close(torch, "rmsnorm", kr.rmsnorm(x, sc, eps),
                            kr.rmsnorm_plain(x, sc, eps), dtype, (shape, eps))
            if dtype == torch.bfloat16 and shape[-1] == 4096:
                errs["rmsnorm"].append(e)
            if dtype == torch.bfloat16 and shape[-1] in (2048, 128) and shape[0] == B:
                q_errs["rmsnorm"].append(e)
        # the final norm reads the last position, x[:, -1:], a row-strided view
        x, sc = rnd(B, PROMPT, 4096, dtype=dtype)[:, -1:], rnd(4096, dtype=dtype) + 1
        check_close(torch, "rmsnorm", kr.rmsnorm(x, sc), kr.rmsnorm_plain(x, sc), dtype,
                    "x[:, -1:]")
        rmsnorm_edges(torch, kr, rnd, dtype)
    torch.cuda.synchronize()

    # timings at the serving path's shapes, bf16
    bf = torch.bfloat16
    out = {}
    q, k, v = (rnd(B, PROMPT, 32, 128, dtype=bf) for _ in range(3))
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    n_pairs = B * 32 * PROMPT * (PROMPT + 1) / 2          # causal (q, k) pairs
    out["flash_attention"] = dict(
        ms=time_ms(torch, lambda: kf.flash_attention(q, k, v, causal=True)),
        call_ms=call_ms(torch, lambda: kf.flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(torch, lambda: kf.flash_attention_plain(q, k, v, causal=True)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        shape=[B, PROMPT, 32, 128])
    out["flash_attention"]["bound_ms"], out["flash_attention"]["bound_by"] = bound(
        4 * q.numel() * 2, 4 * 128 * n_pairs)
    sets = cold_copies(torch, lambda: [rnd(B, PROMPT, 32, 128, dtype=bf) for _ in range(3)],
                       4 * q.numel() * 2)
    out["flash_attention"].update(
        cold_ms=time_ms(torch, [lambda a=a: kf.flash_attention(*a, causal=True) for a in sets]),
        cold_library_ms=time_ms(torch, [lambda a=a: F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in a), is_causal=True) for a in sets]),
        cold_copies=len(sets))
    del sets
    # a larger batch (8 prompts of 512): 1024 q tiles, about 8 per SM
    q8, k8, v8 = (rnd(8, PROMPT, 32, 128, dtype=bf) for _ in range(3))
    out["flash_attention"].update(
        batch8_ms=time_ms(torch, lambda: kf.flash_attention(q8, k8, v8, causal=True)),
        batch8_library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in (q8, k8, v8)), is_causal=True)),
        batch8_bound_ms=bound(4 * q8.numel() * 2, 4 * 128 * n_pairs * 4)[0])
    del q8, k8, v8

    T = PROMPT + NEW
    L = T - 1                                              # last decode step's kv_len
    qd = rnd(B, 32, 128, dtype=bf)
    kc, vc = rnd(B, T, 32, 128, dtype=bf), rnd(B, T, 32, 128, dtype=bf)
    kv_len = torch.full((B,), L, dtype=torch.int32, device=dev)
    mask = (torch.arange(T, device=dev)[None, :] < kv_len[:, None])[:, None, None, :]
    out["decode_attention"] = dict(
        ms=time_ms(torch, lambda: kd.decode_attention(qd, kc, vc, kv_len)),
        call_ms=call_ms(torch, lambda: kd.decode_attention(qd, kc, vc, kv_len)),
        plain_ms=time_ms(torch, lambda: kd.decode_attention_plain(qd, kc, vc, kv_len)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2), attn_mask=mask)),
        shape=[B, T, 32, 128], kv_len=L)
    out["decode_attention"]["bound_ms"], out["decode_attention"]["bound_by"] = bound(
        2 * qd.numel() * 2 + 2 * B * L * 32 * 128 * 2 + B * 4,
        4 * B * 32 * L * 128)
    sets = cold_copies(torch, lambda: (rnd(B, 32, 128, dtype=bf), rnd(B, T, 32, 128, dtype=bf),
                                       rnd(B, T, 32, 128, dtype=bf)), 2 * kc.numel() * 2)
    out["decode_attention"].update(
        cold_ms=time_ms(torch, [lambda a=a: kd.decode_attention(*a, kv_len) for a in sets]),
        cold_library_ms=time_ms(torch, [lambda a=a: F.scaled_dot_product_attention(
            a[0][:, :, None], a[1].transpose(1, 2), a[2].transpose(1, 2), attn_mask=mask)
            for a in sets]),
        cold_copies=len(sets),
        n_split=kd.plan_splits(T, B, 32, torch.cuda.get_device_properties(0).multi_processor_count)[0])
    del sets

    # rmsnorm at the prefill rows (2, 512, 4096) and the decode rows (2, 1, 4096)
    out["rmsnorm"] = {"shape": [B, PROMPT, 4096]}
    for pre, rows in (("", PROMPT), ("decode_rows_", 1)):
        r = rmsnorm_times(torch, F, kr, rnd, (B, rows, 4096), 1e-5)
        out["rmsnorm"].update({pre + x: y for x, y in r.items()})
    q_timings(torch, F, kf, kd, kr, rnd, out)
    for name, e in errs.items():
        out[name]["max_abs_err"] = max(e)
        out[name]["q_max_abs_err"] = max(q_errs[name])
    return out


def rmsnorm_times(torch, F, kr, rnd, shape, eps):
    """RMSNorm's times at one shape, bf16: kernel warm, cold (``(x, scale)``
    rotated over copies that pass twice the L2) and per call; its plain
    version; ``F.rms_norm`` warm, cold and per call; and the bound."""
    bf, d = torch.bfloat16, shape[-1]
    x, sc = rnd(*shape, dtype=bf), rnd(d, dtype=bf) + 1
    sets = cold_copies(torch, lambda: (rnd(*shape, dtype=bf), rnd(d, dtype=bf) + 1),
                       (x.numel() + d) * 2)
    r = {"ms": time_ms(torch, lambda: kr.rmsnorm(x, sc, eps)),
         "cold_ms": time_ms(torch, [lambda a=a: kr.rmsnorm(*a, eps) for a in sets]),
         "call_ms": call_ms(torch, lambda: kr.rmsnorm(x, sc, eps)),
         "plain_ms": time_ms(torch, lambda: kr.rmsnorm_plain(x, sc, eps)),
         "library_ms": time_ms(torch, lambda: F.rms_norm(x, (d,), weight=sc, eps=eps)),
         "cold_library_ms": time_ms(torch, [lambda a=a: F.rms_norm(
             a[0], (d,), weight=a[1], eps=eps) for a in sets]),
         "library_call_ms": call_ms(torch, lambda: F.rms_norm(x, (d,), weight=sc, eps=eps)),
         "cold_copies": len(sets)}
    r["bound_ms"], r["bound_by"] = bound(2 * x.numel() * 2 + d * 2, 4 * x.numel())
    return r


def q_timings(torch, F, kf, kd, kr, rnd, out):
    """Each kernel at model Q's shapes (qwen3-moe-30b-a3b: 32 query heads
    over 4 KV heads of 128, d_model 2048, QK-norm), bf16, as ``q_*`` keys
    of its row: flash over (2, 512) with group 8, decode over a (2, 528)
    cache at kv_len 527, RMSNorm over d_model rows and QK-norm rows, at
    prefill and decode. The library calls are SDPA with ``enable_gqa`` and
    ``F.rms_norm``."""
    bf, dev = torch.bfloat16, torch.device("cuda")
    q, k, v = rnd(B, PROMPT, 32, 128, dtype=bf), rnd(B, PROMPT, 4, 128, dtype=bf), \
        rnd(B, PROMPT, 4, 128, dtype=bf)
    nbytes = (2 * q.numel() + 2 * k.numel()) * 2
    sets = cold_copies(torch, lambda: (rnd(B, PROMPT, 32, 128, dtype=bf),
                                       rnd(B, PROMPT, 4, 128, dtype=bf),
                                       rnd(B, PROMPT, 4, 128, dtype=bf)), nbytes)

    def sdpa(a):
        return F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in a),
                                              is_causal=True, enable_gqa=True)

    r = {"ms": time_ms(torch, lambda: kf.flash_attention(q, k, v, causal=True)),
         "cold_ms": time_ms(torch, [lambda a=a: kf.flash_attention(*a, causal=True)
                                    for a in sets]),
         "call_ms": call_ms(torch, lambda: kf.flash_attention(q, k, v, causal=True)),
         "plain_ms": time_ms(torch, lambda: kf.flash_attention_plain(q, k, v, causal=True)),
         "library_ms": time_ms(torch, lambda: sdpa((q, k, v))),
         "cold_library_ms": time_ms(torch, [lambda a=a: sdpa(a) for a in sets]),
         "cold_copies": len(sets), "shape": [B, PROMPT, 32, 4, 128]}
    r["bound_ms"], r["bound_by"] = bound(nbytes, 4 * 128 * B * 32 * PROMPT * (PROMPT + 1) / 2)
    out["flash_attention"].update({"q_" + x: y for x, y in r.items()})
    del sets

    T = PROMPT + NEW
    L = T - 1
    kv_len = torch.full((B,), L, dtype=torch.int32, device=dev)
    mask = (torch.arange(T, device=dev)[None, :] < kv_len[:, None])[:, None, None, :]
    qd, kc, vc = rnd(B, 32, 128, dtype=bf), rnd(B, T, 4, 128, dtype=bf), \
        rnd(B, T, 4, 128, dtype=bf)
    sets = cold_copies(torch, lambda: (rnd(B, 32, 128, dtype=bf), rnd(B, T, 4, 128, dtype=bf),
                                       rnd(B, T, 4, 128, dtype=bf)), 2 * kc.numel() * 2)

    def sdpa_decode(a):
        return F.scaled_dot_product_attention(a[0][:, :, None], a[1].transpose(1, 2),
                                              a[2].transpose(1, 2), attn_mask=mask,
                                              enable_gqa=True)

    r = {"ms": time_ms(torch, lambda: kd.decode_attention(qd, kc, vc, kv_len)),
         "cold_ms": time_ms(torch, [lambda a=a: kd.decode_attention(*a, kv_len)
                                    for a in sets]),
         "call_ms": call_ms(torch, lambda: kd.decode_attention(qd, kc, vc, kv_len)),
         "plain_ms": time_ms(torch, lambda: kd.decode_attention_plain(qd, kc, vc, kv_len)),
         "library_ms": time_ms(torch, lambda: sdpa_decode((qd, kc, vc))),
         "cold_library_ms": time_ms(torch, [lambda a=a: sdpa_decode(a) for a in sets]),
         "cold_copies": len(sets), "shape": [B, T, 32, 4, 128], "kv_len": L,
         "n_split": kd.plan_splits(T, B, 4, torch.cuda.get_device_properties(0)
                                   .multi_processor_count, 8)[0]}
    r["bound_ms"], r["bound_by"] = bound(2 * qd.numel() * 2 + 2 * B * L * 4 * 128 * 2 + B * 4,
                                         4 * B * 32 * L * 128)
    out["decode_attention"].update({"q_" + x: y for x, y in r.items()})
    del sets

    for pre, shape, eps in (("q_", (B, PROMPT, 2048), 1e-5),
                            ("q_decode_rows_", (B, 1, 2048), 1e-5),
                            ("q_head_rows_", (B, PROMPT, 32, 128), 1e-6),
                            ("q_head_decode_rows_", (B, 1, 32, 128), 1e-6)):
        r = rmsnorm_times(torch, F, kr, rnd, shape, eps)
        out["rmsnorm"].update({pre + x: y for x, y in r.items()})
        out["rmsnorm"][pre + "shape"] = list(shape)


def rmsnorm_edges(torch, kr, rnd, dtype):
    """RMSNorm at the edges of its launch plan: row counts around the SM
    count and widths up to 8192 (1 to 8 vectors a thread, 32 to 1024
    threads a row), a D that is not a multiple of the 16-byte vector and a
    row longer than the registers hold; in each, scale in the other dtype,
    a base pointer one element off (the scalar branch), the row-strided
    x[..., -1:, :] and an all-zero row, which must give zeros."""
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    shapes = [(r, d) for r in (1, 2, 131, 133, 1024, 4096)
              for d in (8, 96, 128, 4096, 5120, 8192)] + [(7, 100), (2, 40000)]
    for rows, d in shapes:
        x, sc = rnd(rows, d, dtype=dtype), rnd(d, dtype=dtype) + 1
        zero_row = x.clone()   # its own tensor: with one row, x stays random
        zero_row[0] = 0
        shifted = rnd(rows * d + 1, dtype=dtype)[1:].view(rows, d)
        for case, xx, ss in (("", x, sc), ("scale " + str(other), x, sc.to(other)),
                             ("offset by one", shifted, sc), ("x[-1:]", x[-1:], sc),
                             ("zero row", zero_row, sc)):
            got = kr.rmsnorm(xx, ss)
            check_close(torch, "rmsnorm", got, kr.rmsnorm_plain(xx, ss), dtype,
                        (rows, d, case))
        if (got[0] != 0).any():
            raise AssertionError(f"rmsnorm {(rows, d)} {dtype}: a zero row did not give zeros")


def edge_cases(torch, kd, kf, rnd, dtype, dev):
    """Shapes at the edges of the attention kernels' designs: the flash
    kernel's 128-row q tiles, 64-key k tiles, head dims zero-filled to 64
    or 128 and no keys at all; the decode kernel's KV splits, with kv_len 0, 1, on a split
    boundary, one past it and T in one call, a T that is not a multiple of
    the split, and groups 1, 4 and 8."""
    for (b, s, t, hq, hkv, d, causal) in ((2, 256, 256, 8, 8, 64, True),
                                          (2, 64, 64, 4, 2, 8, True),
                                          (1, 300, 300, 8, 2, 128, True),
                                          (2, 300, 100, 4, 4, 128, False),
                                          (2, 100, 300, 8, 2, 64, False)):
        q, k, v = rnd(b, s, hq, d, dtype=dtype), rnd(b, t, hkv, d, dtype=dtype), \
            rnd(b, t, hkv, d, dtype=dtype)
        check_close(torch, "flash", kf.flash_attention(q, k, v, causal=causal),
                    kf.flash_attention_plain(q, k, v, causal=causal), dtype,
                    (b, s, t, hq, hkv, d, causal))
    q, kv = rnd(2, 16, 4, 64, dtype=dtype), rnd(2, 0, 4, 64, dtype=dtype)   # no keys: zeros
    if not bool((kf.flash_attention(q, kv, kv) == 0).all()):
        raise AssertionError(f"flash with T = 0 {dtype}: output is not 0")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for (hq, hkv) in ((32, 32), (32, 8), (64, 8)):
        for d in (32, 64, 128):
            t = next(t for t in (333, 301, 500)
                     if t % kd.plan_splits(t, 5, hkv, n_sm, hq // hkv)[1])
            n_split, chunk = kd.plan_splits(t, 5, hkv, n_sm, hq // hkv)
            if n_split < 2:
                raise AssertionError(f"decode: one split at T={t}, Hkv={hkv}")
            lens = (0, 1, chunk, chunk + 1, t)
            q = rnd(len(lens), hq, d, dtype=dtype)
            kc, vc = (rnd(len(lens), t, hkv, d, dtype=dtype) for _ in "kv")
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            got = kd.decode_attention(q, kc, vc, kv_len)
            check_close(torch, "decode", got, kd.decode_attention_plain(q, kc, vc, kv_len),
                        dtype, (t, hq, hkv, d, lens, n_split))
            if (got[0] != 0).any():
                raise AssertionError("decode: kv_len 0 did not give zeros")


# ---------------------------------------------------------------------------
# phase 3: the serving path
# ---------------------------------------------------------------------------

def prompt(vocab: int):
    import numpy as np
    return np.random.default_rng(0).integers(0, vocab, (B, PROMPT)).astype("int32")


def publish(torch, disk, cfg, name, seed, device):
    from repro_torch.models import init_params
    from repro_torch.serving import publish_model
    gen = torch.Generator(device=device).manual_seed(seed)
    publish_model(disk, cfg, init_params(cfg, gen, device=device), name=name)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return disk.open(("repro-torch", name, "1")).total_bytes


def counts(ops) -> dict:
    """Each kernel's launches since the last ``ops.reset_launches()``."""
    return {m.__name__.rsplit(".", 1)[1]: m.launches for m in ops.KERNEL_MODULES}


def path_launches(cfg, prefill: bool = True) -> dict:
    """Launches one request of batch 2 implies: flash once per layer,
    decode once per layer and decode step, rmsnorm twice per layer (four
    with QK-norm: the query and key head norms) plus the final norm for
    every position that gives a token; a prefix hit runs no prefill."""
    steps = NEW if prefill else NEW - 1
    norms = 4 if cfg.qk_norm else 2
    return {"flash_attention": cfg.n_layers if prefill else 0,
            "decode_attention": cfg.n_layers * (NEW - 1),
            "rmsnorm": (norms * cfg.n_layers + 1) * steps}


def serve_phase(torch, store_dir: Path, base, device, caps):
    """``base`` is the full-width config; ``caps`` the (device, host) tier
    capacities in bytes."""
    from repro_torch.core.costmodel import get_hardware
    from repro_torch.core.mrm import MRM, ModelKey
    from repro_torch.core.store import DiskStore
    from repro_torch.kernels import ops
    from repro_torch.serving import InferenceEngine, Request, ServingWorkers

    cfgs = {"A": base.replace(n_layers=4), "B": base.replace(n_layers=2),
            "C": base.replace(n_layers=2)}
    disk = DiskStore(str(store_dir))
    t0 = time.perf_counter()
    sizes = {n: publish(torch, disk, c, n, seed, device)
             for seed, (n, c) in enumerate(cfgs.items())}
    log(f"published {json.dumps(sizes)} bytes in {time.perf_counter() - t0:.1f} s")

    hw = get_hardware()
    log(f"measured h2d {hw.h2d_bw / 1e9:.2f} GB/s, d2h {hw.d2h_bw / 1e9:.2f} GB/s, "
        f"disk {hw.disk_bw / 1e9:.2f} GB/s")
    mrm = MRM(disk, device_capacity=caps[0], host_capacity=caps[1], hw=hw, device=device)
    engine = InferenceEngine(disk, mrm, device=device)
    toks = prompt(base.vocab_size)
    key = lambda n: ModelKey("repro-torch", n, "1")  # noqa: E731

    ops.reset_launches()
    t_main = time.perf_counter()
    results, stats = {}, []

    def gen(name):
        out, st = engine.generate(name, toks, NEW)
        results.setdefault(name, []).append(out)
        stats.append(st)
        log(json.dumps({"request": len(stats), **dataclasses.asdict(st)}))

    gen("A")                                            # disk
    gen("A")                                            # device
    mrm.prefetch(key("B"), tier="host").result()        # host: A, B
    mrm.prefetch(key("C"), tier="host").result()        # host: B, C; A stays on the device
    gen("B")                                            # host; A demoted D2H, C displaced
    gen("A")                                            # host, saved by the demotion

    hits = [s.tier_hit for s in stats]
    st = mrm.stats()
    if hits != ["disk", "device", "host", "host"]:
        raise AssertionError(f"tier hits {hits}")
    if mrm.tiers.demotions < 1 or st["demotion_saved_reloads"] < 1:
        raise AssertionError(f"demotions {mrm.tiers.demotions}, "
                             f"saved reloads {st['demotion_saved_reloads']}")
    a = results["A"]
    if not all((x == a[0]).all() for x in a):
        raise AssertionError("the three requests for A gave different tokens")

    # concurrent workers on the device-resident A: one shared device copy
    disk_loads = st["disk_loads"]
    device_ptrs = {n: t.data_ptr() for n, t in mrm.device.peek(key("A")).payload.items()}
    seen = []
    load = engine.load_model

    def recording_load(name, version="1"):
        sm, s = load(name, version)
        seen.append({n: t.data_ptr() for n, t in sm.loaded.weights.items()})
        return sm, s

    engine.load_model = recording_load
    workers = ServingWorkers(engine, n_workers=2)
    reqs = [workers.submit(Request("A", toks, max_new=NEW)) for _ in range(4)]
    workers.drain(reqs, timeout=600)
    workers.stop()
    engine.load_model = load
    for r in reqs:
        if isinstance(r.result, BaseException) or r.result is None:
            raise RuntimeError(f"worker request failed: {r.result!r}")
        if not (r.result == a[0]).all():
            raise AssertionError("a worker's tokens differ from the first request's")
        stats.append(r.stats)
        log(json.dumps({"request": len(stats), **dataclasses.asdict(r.stats)}))
    main_s = time.perf_counter() - t_main
    launches = counts(ops)

    if mrm.stats()["disk_loads"] != disk_loads:
        raise AssertionError("the workers reloaded A from disk")
    if len(seen) != 4 or any(s != device_ptrs for s in seen):
        raise AssertionError("handles of A do not share one device copy")
    for out in (x for v in results.values() for x in v):
        if out.shape != (B, NEW) or out.min() < 0 or out.max() >= base.vocab_size:
            raise AssertionError(f"bad tokens {out.shape} {out.min()}..{out.max()}")

    per_request = [path_launches(cfgs[s.model]) for s in stats]
    want = {k: sum(p[k] for p in per_request) for k in per_request[0]}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, path implies {want}")
    log(f"main path: {len(stats)} requests in {main_s:.2f} s; launches {json.dumps(launches)}")
    summary = {"tier_hits": hits, "demotions": mrm.tiers.demotions,
               "demotion_saved_reloads": st["demotion_saved_reloads"],
               "disk_loads": disk_loads, "main_path_s": main_s, "sizes": sizes,
               "h2d_bw": hw.h2d_bw, "d2h_bw": hw.d2h_bw,
               "requests": [dataclasses.asdict(s) for s in stats]}
    return engine, launches, summary, a[0]


# ---------------------------------------------------------------------------
# phase 4: end to end against the plain path
# ---------------------------------------------------------------------------

def end_to_end_phase(torch, engine):
    """A's prefill logits on the card (kernels, bf16) against the plain path
    on the CPU (float32 weights upcast from the same published file), on the
    first 128 tokens of the prompt.

    Tolerance: bf16 keeps 8 mantissa bits (a step of 2^-8 = 0.4% of a value);
    through 4 layers of 4096-wide products and a 4096-wide logit product the
    rounding grows to a few percent of the logits' scale, so the card's
    logits must lie within 5% of max |logit| of the float32 ones."""
    from repro_torch.models import model as M
    from repro_torch.serving import to_torch_tree

    sm, _ = engine.load_model("A")
    try:
        cfg = sm.cfg
        toks = torch.from_numpy(prompt(cfg.vocab_size)[:, :128]).long()
        logits, _ = M.prefill(cfg, sm.params, {"tokens": toks.to(engine.device)}, 128)
        got = logits.float().cpu()
    finally:
        engine.release(sm)
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    flat = engine.disk.open(sm.key).read_all()
    params = to_torch_tree(flat, "cpu", template=M.init_params(cfg32, device="meta"))
    params = _map(params, lambda t: t.float())
    t0 = time.perf_counter()
    want, _ = M.prefill(cfg32, params, {"tokens": toks}, 128)
    cpu_s = time.perf_counter() - t0
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if not torch.isfinite(got).all() or got.shape != want.shape or err > 0.05 * scale:
        raise AssertionError(f"end to end: max abs err {err:.4g} vs 5% of {scale:.4g}")
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"end to end: logits {tuple(got.shape)}, max abs err {err:.4g} "
        f"(max |logit| {scale:.4g}), argmax agreement {agree:.2f}, CPU pass {cpu_s:.1f} s")
    return {"max_abs_err": err, "max_abs_logit": scale, "argmax_agreement": agree}


# ---------------------------------------------------------------------------
# phase 5: the layer-streaming path and the prefix-KV cache
# ---------------------------------------------------------------------------

def stream_phase(torch, store_dir: Path, device, caps, want_tokens, batch_disk_hit):
    """Model A through a fresh MRM and a streaming, prefix-caching engine
    over the store of phase 3. ``want_tokens`` are phase 3's tokens for A,
    ``batch_disk_hit`` its disk-hit request's stats."""
    import numpy as np
    from repro_torch.core import mrm as mrm_mod
    from repro_torch.core.costmodel import get_hardware
    from repro_torch.core.store import DiskStore
    from repro_torch.device import synchronize, tensor_from_numpy
    from repro_torch.kernels import ops
    from repro_torch.serving import InferenceEngine
    from repro_torch.serving import engine as engine_mod

    disk = DiskStore(str(store_dir))
    mrm = mrm_mod.MRM(disk, device_capacity=caps[0], host_capacity=caps[1],
                      hw=get_hardware(), device=device)
    engine = InferenceEngine(disk, mrm, device=device, streaming=True,
                             prefix_cache_bytes=256 * 2 ** 20)
    key = mrm_mod.ModelKey("repro-torch", "A", "1")
    cfg = engine._config_for(key)
    n_layers, toks = cfg.n_layers, prompt(cfg.vocab_size)
    stats, launches = [], []

    def gen():
        ops.reset_launches()
        out, st = engine.generate("A", toks, NEW)
        launches.append(counts(ops))
        stats.append(st)
        log(json.dumps({"stream_request": len(stats), **dataclasses.asdict(st)}))
        if not np.array_equal(out, want_tokens):
            raise AssertionError(f"request {len(stats)} of phase 5 ({st.tier_hit}, "
                                 f"streamed {st.streamed}): tokens differ from phase 3's")
        return st

    # 1. streamed from disk; record when the plan was set (its arrays
    # allocated), the order and the time at which windows became ready, the
    # stream's future, and the engine's host-to-device copies of the windows
    # (pageable, synchronous: seconds and bytes)
    order, ready, planned, futs, puts = [], [], [], set(), []
    mark, put = mrm_mod.LoadFuture._mark_window, engine_mod.tensor_from_numpy
    set_plan = mrm_mod.LoadFuture._set_plan

    def recording_set_plan(fut, plan, arrays, meta=None):
        if fut.streaming:
            planned.append(time.perf_counter())
        set_plan(fut, plan, arrays, meta)

    def recording_mark(fut, index):
        if fut.streaming:
            order.append(index)
            ready.append(time.perf_counter())
            futs.add(fut)
        mark(fut, index)

    def timed_put(arr, dev):
        t0 = time.perf_counter()
        t = put(arr, dev)
        puts.append((time.perf_counter() - t0, arr.nbytes))
        return t

    mrm_mod.LoadFuture._mark_window = recording_mark
    mrm_mod.LoadFuture._set_plan = recording_set_plan
    engine_mod.tensor_from_numpy = timed_put
    t_req = time.perf_counter()
    try:
        st1 = gen()
    finally:
        mrm_mod.LoadFuture._mark_window = mark
        mrm_mod.LoadFuture._set_plan = set_plan
        engine_mod.tensor_from_numpy = put
    (stream_fut,) = futs
    n_windows = 1 + n_layers                      # the stem, then one per layer
    if (st1.tier_hit, st1.streamed) != ("disk", True):
        raise AssertionError(f"first request: tier {st1.tier_hit}, streamed {st1.streamed}")
    if mrm.stats()["stream_loads"] != 1:
        raise AssertionError(f"stream_loads {mrm.stats()['stream_loads']}")
    if order != list(range(n_windows)):
        raise AssertionError(f"windows became ready in the order {order}")

    # pageable H2D of one layer's rows, from the host tier's arrays
    arrays = mrm.host.peek(key).payload.arrays
    rows = [a[0] for n, a in arrays.items() if n.startswith("layers/")]
    layer_bytes = sum(r.nbytes for r in rows)
    h2d = []
    for _ in range(3):
        t0 = time.perf_counter()
        copies = [tensor_from_numpy(r, device) for r in rows]
        synchronize(device)
        h2d.append(time.perf_counter() - t0)
        del copies

    # 2. host hit: the batch path, a prefix miss
    st2 = gen()
    if (st2.tier_hit, st2.streamed) != ("host", False):
        raise AssertionError(f"second request: tier {st2.tier_hit}, streamed {st2.streamed}")
    pkv = engine.prefix_kv
    if (pkv.misses, pkv.hits) != (1, 0):
        raise AssertionError(f"prefix store after request 2: {pkv.stats()}")
    (stored,) = [e.payload[1] for e in pkv.tier.entries.values()]
    before = {kv: stored["attn"][kv].clone() for kv in ("k", "v")}

    # 3. device hit and prefix hit: decodes into a clone of the stored K/V
    st3 = gen()
    if (st3.tier_hit, st3.streamed) != ("device", False):
        raise AssertionError(f"third request: tier {st3.tier_hit}, streamed {st3.streamed}")
    if (pkv.misses, pkv.hits) != (1, 1):
        raise AssertionError(f"prefix store after request 3: {pkv.stats()}")
    for kv, t in before.items():
        if not torch.equal(stored["attn"][kv], t):
            raise AssertionError(f"the prefix hit's decodes wrote into the stored {kv}")

    want = [path_launches(cfg), path_launches(cfg), path_launches(cfg, prefill=False)]
    if launches != want:
        raise AssertionError(f"phase 5 kernel launches {launches}, paths imply {want}")

    def times(st):
        return {k: getattr(st, k) for k in ("ttft_s", "model_load_s", "compile_s",
                                            "compute_s", "total_s", "tier_hit")}

    log(f"stream and prefix: windows {order}, launches {json.dumps(launches)}")
    return {"streamed": {**times(st1), "windows": n_windows,
                         "plan_ready_s": planned[0] - t_req,
                         "window_ready_s": [t - t_req for t in ready],
                         "disk_read_s": stream_fut.timings.disk_read_s,
                         "scatter_s": stream_fut.timings.deserialize_s,
                         "h2d_s": sum(c[0] for c in puts),
                         "h2d_bytes": sum(c[1] for c in puts)},
            "batch_disk_hit": times(batch_disk_hit),
            "host_hit_ttft_s": st2.ttft_s, "prefix_hit_ttft_s": st3.ttft_s,
            "layer_h2d": {"bytes": layer_bytes, "s": sorted(h2d)},
            "launches": launches}


# ---------------------------------------------------------------------------
# phase 6: MoE, batch and layer-streamed
# ---------------------------------------------------------------------------

def moe_phase(torch, store_dir: Path, cfg, device, caps):
    """Model Q (``cfg``) in a store of its own: a batch engine serves it
    from disk and then from the device; a fresh MRM and an engine with
    streaming and a prefix store serve it streamed from disk (windows ready
    in execution order, layer 1's expert window demanded before layer 0's
    prefill returns), from the host tier and from the device with a prefix
    hit that must leave the stored K/V unchanged. Every request's tokens
    must equal the first's exactly, and its kernel launches (counts set to
    0 just before it) what its path implies. Returns (summary, tokens)."""
    import numpy as np
    from repro_torch.core import mrm as mrm_mod
    from repro_torch.core.costmodel import get_hardware
    from repro_torch.core.layerplan import plan_for_file
    from repro_torch.core.store import DiskStore
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving import InferenceEngine

    disk = DiskStore(str(store_dir))
    t0 = time.perf_counter()
    size = publish(torch, disk, cfg, "Q", 3, device)
    log(f"published Q: {size} bytes in {time.perf_counter() - t0:.1f} s")
    hw = get_hardware()
    toks = prompt(cfg.vocab_size)
    stats, launches, tokens = [], [], []

    def gen(engine):
        ops.reset_launches()
        out, st = engine.generate("Q", toks, NEW)
        launches.append(counts(ops))
        stats.append(st)
        tokens.append(out)
        log(json.dumps({"moe_request": len(stats), **dataclasses.asdict(st)}))
        if out.shape != (B, NEW) or out.min() < 0 or out.max() >= cfg.vocab_size:
            raise AssertionError(f"Q: bad tokens {out.shape} {out.min()}..{out.max()}")
        if not np.array_equal(out, tokens[0]):
            raise AssertionError(f"Q request {len(stats)} ({st.tier_hit}, streamed "
                                 f"{st.streamed}): tokens differ from the first request's")
        return st

    # 1. batch: a disk hit, then a device hit
    engine = InferenceEngine(disk, mrm_mod.MRM(disk, device_capacity=caps[0],
                                               host_capacity=caps[1], hw=hw, device=device),
                             device=device)
    gen(engine)
    gen(engine)
    batch_engine = engine

    # 2. streamed from disk through a fresh MRM, recording the windows as
    # they become ready, the engine's demands, and when each layer's
    # prefill returns
    mrm = mrm_mod.MRM(disk, device_capacity=caps[0], host_capacity=caps[1], hw=hw,
                      device=device)
    engine = InferenceEngine(disk, mrm, device=device, streaming=True,
                             prefix_cache_bytes=256 * 2 ** 20)
    order, ready, demands, layer_done = [], [], [], []
    mark, demand = mrm_mod.LoadFuture._mark_window, mrm_mod.LoadFuture.demand
    prefill_layer = M.stream_prefill_layer

    def recording_mark(fut, index):
        if fut.streaming:
            order.append(index)
            ready.append(time.perf_counter() - t_req)
        mark(fut, index)

    def recording_demand(fut, index):
        accepted = demand(fut, index)
        demands.append({"window": index, "s": time.perf_counter() - t_req,
                        "accepted": accepted, "layers_done": len(layer_done)})
        return accepted

    def recording_prefill_layer(*a, **kw):
        r = prefill_layer(*a, **kw)
        layer_done.append(time.perf_counter() - t_req)
        return r

    mrm_mod.LoadFuture._mark_window = recording_mark
    mrm_mod.LoadFuture.demand = recording_demand
    M.stream_prefill_layer = recording_prefill_layer
    t_req = time.perf_counter()
    try:
        st = gen(engine)
    finally:
        mrm_mod.LoadFuture._mark_window = mark
        mrm_mod.LoadFuture.demand = demand
        M.stream_prefill_layer = prefill_layer
    if (st.tier_hit, st.streamed) != ("disk", True):
        raise AssertionError(f"Q streamed request: tier {st.tier_hit}, streamed {st.streamed}")
    plan = [(w.group, w.layer_index) for w in plan_for_file(
        disk.open(("repro-torch", "Q", "1")).path)[0]]
    want_plan = [("stem", -1)] + [(g, i) for i in range(cfg.n_layers)
                                  for g in ("layer", "expert")]
    if plan != want_plan or order != list(range(len(plan))):
        raise AssertionError(f"Q windows {plan} became ready in the order {order}")
    ahead = [d for d in demands if d["window"] == 4]
    if not ahead or ahead[0]["layers_done"] != 0 or ahead[0]["s"] >= layer_done[0]:
        raise AssertionError(f"layer 1's expert window (4) was not demanded before layer "
                             f"0's prefill returned: demands {demands}, layers {layer_done}")

    # 3. host hit (batch path, a prefix miss), then a device and prefix hit
    st = gen(engine)
    if (st.tier_hit, st.streamed) != ("host", False):
        raise AssertionError(f"Q host request: tier {st.tier_hit}, streamed {st.streamed}")
    pkv = engine.prefix_kv
    (stored,) = [e.payload[1] for e in pkv.tier.entries.values()]
    before = {kv: stored["attn"][kv].clone() for kv in ("k", "v")}
    st = gen(engine)
    if (st.tier_hit, st.streamed, pkv.misses, pkv.hits) != ("device", False, 1, 1):
        raise AssertionError(f"Q prefix request: tier {st.tier_hit}, prefix {pkv.stats()}")
    for kv, t in before.items():
        if not torch.equal(stored["attn"][kv], t):
            raise AssertionError(f"Q's prefix hit wrote into the stored {kv}")

    want = [path_launches(cfg)] * 4 + [path_launches(cfg, prefill=False)]
    if launches != want:
        raise AssertionError(f"phase 6 kernel launches {launches}, paths imply {want}")
    del engine, mrm
    log(f"MoE: windows {order}, demands {json.dumps(demands)}, launches {json.dumps(launches)}")
    return batch_engine, {"size": size, "requests": [dataclasses.asdict(s) for s in stats],
                          "tokens_sha1": hashlib.sha1(tokens[0].tobytes()).hexdigest(),
                          "windows": {"plan": plan, "order": order, "ready_s": ready},
                          "demands": demands, "layer_prefill_done_s": layer_done,
                          "launches": launches}


def moe_end_to_end(torch, engine, device):
    """Q's prefill logits (the full prompt) three ways: on the card in
    float32 (weights upcast on the card, the kernels' float32 routes), on
    the card in bf16 (the served weights), and on the CPU in float32 (the
    port's plain path), recording each layer's router choices.

    Tolerance, float32 card against float32 CPU: 1% of max |logit|. The two
    sum in other orders (~1e-5 of the logits' scale); where that flips a
    near-tie of the router for an earlier token, the last position sees the
    change only through one of 512 attention rows (~1e-3 of the scale). A
    flip at the last position itself would exceed it. The bf16 card
    logits' difference from the float32 CPU ones and the router agreement
    (the share of the reference's (token, k) choices that the other run
    also chose for that token, over both layers) are printed, not asserted:
    in bf16 routing flips on ties."""
    from repro_torch.models import model as M
    from repro_torch.models import moe as MoE
    from repro_torch.serving import to_torch_tree

    routes = []
    router_topk = MoE.router_topk

    def recording(cfg, p, x2d):
        r = router_topk(cfg, p, x2d)
        routes.append(r[1].cpu())
        return r

    def run(cfg, params, dev):
        routes.clear()
        toks = torch.from_numpy(prompt(cfg.vocab_size)).long().to(dev)
        t0 = time.perf_counter()
        logits, _ = M.prefill(cfg, params, {"tokens": toks}, PROMPT)
        logits = logits[:, :cfg.vocab_size].float().cpu()      # not the masked pad
        return logits, list(routes), time.perf_counter() - t0

    def agreement(ref, other):
        return sum((a[:, :, None] == b[:, None, :]).any(-1).float().mean().item()
                   for a, b in zip(ref, other)) / len(ref)

    sm, _ = engine.load_model("Q")
    cfg = sm.cfg
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    flat = engine.disk.open(sm.key).read_all()
    tpl = M.init_params(cfg32, device="meta")
    MoE.router_topk = recording
    try:
        got_bf16, routes_bf16, _ = run(cfg, sm.params, engine.device)
        engine.release(sm)
        params = _map(to_torch_tree(flat, device, template=tpl), lambda t: t.float())
        got, routes_card, _ = run(cfg32, params, device)
        del params
        torch.cuda.empty_cache()
        params = _map(to_torch_tree(flat, "cpu", template=tpl), lambda t: t.float())
        want, routes_cpu, cpu_s = run(cfg32, params, "cpu")
    finally:
        MoE.router_topk = router_topk
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or got.shape != want.shape or err > 0.01 * scale:
        raise AssertionError(f"Q end to end, float32: max abs err {err:.4g} "
                             f"vs 1% of {scale:.4g}")
    r = {"max_abs_err_f32": err, "max_abs_logit": scale,
         "argmax_agreement_f32": (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
         "router_agreement_f32": agreement(routes_cpu, routes_card),
         "max_abs_err_bf16": (got_bf16 - want).abs().max().item(),
         "argmax_agreement_bf16": (got_bf16.argmax(-1) == want.argmax(-1)).float().mean().item(),
         "router_agreement_bf16": agreement(routes_cpu, routes_bf16),
         "router_calls": len(routes_cpu), "cpu_pass_s": cpu_s}
    log(f"Q end to end: {json.dumps(r)}")
    return r


# ---------------------------------------------------------------------------
# phase 7: the CLOUD tier, cross-process sharing and the FaaS platform
# ---------------------------------------------------------------------------

KEY_A = ("repro-torch", "A", "1")
CLIENT_TIMEOUT_S = 180


def greedy(torch, cfg, weights, toks, device):
    """Prefill plus NEW - 1 greedy decode steps on ``weights`` (a flat name
    -> tensor or host array map) through the model functions the engine
    calls. Returns the (B, NEW) int32 tokens."""
    import numpy as np
    from repro_torch.device import tensor_from_numpy
    from repro_torch.models import model as M
    from repro_torch.serving.weights_io import flat_to_params_like

    params = flat_to_params_like(
        M.init_params(cfg, device="meta"), weights,
        convert=lambda v: v if torch.is_tensor(v) else tensor_from_numpy(v, device))
    S = toks.shape[1]
    batch = {"tokens": torch.as_tensor(np.asarray(toks), dtype=torch.long, device=device)}
    logits, cache = M.prefill(cfg, params, batch, max_len=S + NEW)
    tok = logits.argmax(-1)
    out = [tok]
    for i in range(NEW - 1):
        logits, cache = M.decode_step(cfg, params, cache, tok, S + i)
        tok = logits.argmax(-1)
        out.append(tok)
    return torch.stack(out, dim=1).cpu().numpy().astype("int32")


def tokens_sha1(tokens) -> str:
    import numpy as np
    return hashlib.sha1(np.ascontiguousarray(tokens, dtype=np.int32).tobytes()).hexdigest()


def model_config(store_dir: Path, key=KEY_A):
    """The config a published file carries in its header."""
    from repro_torch.configs import ModelConfig
    from repro_torch.core.store import DiskStore
    return ModelConfig(**dict(DiskStore(str(store_dir)).open(key).meta["config"]))


def ipc_client(sock: str, store_dir: Path, hold: bool, device: str = "cuda") -> int:
    """A client process of phase 7 (``--ipc-client``): open A through the
    daemon's socket, put the attached host arrays on the card, generate,
    print one JSON line. With ``hold`` it prints once A is open and then
    waits to be killed."""
    sys.path.insert(0, str(SRC))
    import torch
    from repro_torch.core.shm_ipc import RemoteTrimsClient
    from repro_torch.device import resolve_device, synchronize, tensor_from_numpy
    from repro_torch.kernels import ops

    device = resolve_device(device)
    cfg = model_config(store_dir)
    toks = prompt(cfg.vocab_size)
    client = RemoteTrimsClient(sock)
    t0 = time.perf_counter()
    h = client.open(*KEY_A)
    open_s = time.perf_counter() - t0
    if hold:
        log(json.dumps({"held": h.handle_id}))
        time.sleep(CLIENT_TIMEOUT_S)
        return 1
    t0 = time.perf_counter()
    weights = {n: tensor_from_numpy(a, device) for n, a in h.arrays.items()}
    synchronize(device)
    h2d_s = time.perf_counter() - t0
    ops.reset_launches()
    t0 = time.perf_counter()
    out = greedy(torch, cfg, weights, toks, device)
    compute_s = time.perf_counter() - t0
    launches = counts(ops)
    client.close(h)
    client.disconnect()
    log(json.dumps({"tokens_sha1": tokens_sha1(out), "tier_hit": h.timings["tier_hit"],
                    "open_s": open_s, "attach_s": h.attach_s, "h2d_s": h2d_s,
                    "h2d_bytes": sum(t.numel() * t.element_size() for t in weights.values()),
                    "compute_s": compute_s, "launches": launches,
                    "daemon_timings": h.timings}))
    return 0


def _client_cmd(sock: str, store_dir: Path, device, hold: bool = False):
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--ipc-client", sock,
           "--store", str(store_dir), "--device", str(device)]
    return cmd + (["--hold"] if hold else [])


def _bits(torch, t):
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


def cloud_phase(torch, store_dir: Path, build: Path, device, caps, want_tokens):
    """(a) A from an object store: a batch cloud hit, a streamed cloud hit
    whose windows the shard callbacks feed before the file lands, and the
    write-back of A by an MRM whose host tier holds A or B but not both."""
    import numpy as np
    from repro_torch.core import mrm as mrm_mod
    from repro_torch.core.costmodel import get_hardware
    from repro_torch.core.objectstore import ObjectStore
    from repro_torch.core.store import DiskStore
    from repro_torch.kernels import ops
    from repro_torch.serving import InferenceEngine

    cfg = model_config(store_dir)
    toks, hw, src = prompt(cfg.vocab_size), get_hardware(), DiskStore(str(store_dir))
    key = mrm_mod.ModelKey(*KEY_A)
    want = path_launches(cfg)
    store = ObjectStore(str(build / "cloud"))
    t0 = time.perf_counter()
    # layer-planned shards (one or more per window): the streaming open's
    # wire leg; codec "none": random bf16 weights do not compress
    digest = store.put_file(key, src.path_for(key), codec="none", shard_plan="layers",
                            shard_bytes=256 * 2 ** 20)
    put_s = time.perf_counter() - t0
    n_shards = len(store.shard_table(key))
    log(f"published A into the object store: {n_shards} shards in {put_s:.1f} s")

    def serve(engine, label):
        ops.reset_launches()
        out, st = engine.generate("A", toks, NEW)
        launches = counts(ops)
        log(json.dumps({"cloud_request": label, **dataclasses.asdict(st)}))
        if not np.array_equal(out, want_tokens):
            raise AssertionError(f"phase 7 {label}: tokens differ from phase 3's")
        if launches != want:
            raise AssertionError(f"phase 7 {label}: launches {launches}, path implies {want}")
        return st, launches

    # 1. batch: a fresh MRM over an empty disk; the engine reads a model's
    # config from its local file, so a cloud-only key's config comes from
    # the publisher (here the source file's header)
    disk = DiskStore(str(build / "cloud_disk1"))
    mrm = mrm_mod.MRM(disk, device_capacity=caps[0], host_capacity=caps[1], hw=hw,
                      device=device, objectstore=store)
    engine = InferenceEngine(disk, mrm, device=device)
    engine._cfg_cache[("A", "1")] = cfg
    st1, l1 = serve(engine, "batch")
    if st1.tier_hit != "cloud" or mrm.stats()["cloud_downloads"] != 1:
        raise AssertionError(f"batch cloud open: tier {st1.tier_hit}, "
                             f"downloads {mrm.stats()['cloud_downloads']}")
    del engine, mrm
    torch.cuda.empty_cache()

    # 2. streamed: windows fed by the shard callbacks of the fetch
    disk = DiskStore(str(build / "cloud_disk2"))
    mrm = mrm_mod.MRM(disk, device_capacity=caps[0], host_capacity=caps[1], hw=hw,
                      device=device, objectstore=store)
    engine = InferenceEngine(disk, mrm, device=device, streaming=True)
    order, ready, shards = [], [], []
    mark, fetch = mrm_mod.LoadFuture._mark_window, store.fetch

    def recording_mark(fut, index):
        if fut.streaming:
            order.append(index)
            ready.append(time.perf_counter())
        mark(fut, index)

    def watching_fetch(k, dest, report_out=None, on_shard=None):
        def fed(row, data):
            shards.append((time.perf_counter(), os.path.exists(dest.path_for(k))))
            on_shard(row, data)
        return fetch(k, dest, report_out=report_out,
                     on_shard=fed if on_shard is not None else None)

    mrm_mod.LoadFuture._mark_window = recording_mark
    store.fetch = watching_fetch
    t_req = time.perf_counter()
    try:
        st2, l2 = serve(engine, "streamed")
    finally:
        mrm_mod.LoadFuture._mark_window = mark
        del store.fetch
    n_windows = 1 + cfg.n_layers
    if (st2.tier_hit, st2.streamed) != ("cloud", True):
        raise AssertionError(f"streamed cloud open: tier {st2.tier_hit}, streamed {st2.streamed}")
    if order != list(range(n_windows)):
        raise AssertionError(f"streamed cloud open: windows ready in the order {order}")
    if len(shards) != n_shards or any(landed for _, landed in shards):
        raise AssertionError(f"streamed cloud open: {len(shards)} of {n_shards} shards fed, "
                             f"file complete before {sum(x for _, x in shards)} of them")
    del engine, mrm
    torch.cuda.empty_cache()

    # 3. write-back: serving B pushes A out of the host tier, and the worker
    # publishes A into a second, empty object store
    sizes = {n: src.open(("repro-torch", n, "1")).total_bytes for n in "AB"}
    wb = ObjectStore(str(build / "cloud_wb"))
    puts, put_file = [], wb.put_file

    def timed_put(*a, **kw):
        t0 = time.perf_counter()
        r = put_file(*a, **kw)
        puts.append(time.perf_counter() - t0)
        return r

    wb.put_file = timed_put
    mrm = mrm_mod.MRM(src, device_capacity=8 * GiB, host_capacity=sizes["A"] + sizes["B"] // 2,
                      hw=hw, device=device, objectstore=wb, writeback_to_cloud=True)
    engine = InferenceEngine(src, mrm, device=device)
    st3, _ = serve(engine, "writeback A")
    ops.reset_launches()
    engine.generate("B", toks, NEW)
    l4 = counts(ops)
    if l4 != path_launches(engine._config_for(mrm_mod.ModelKey("repro-torch", "B", "1"))):
        raise AssertionError(f"phase 7 writeback B: launches {l4}")
    t0 = time.perf_counter()
    mrm.flush_writebacks()
    flush_s = time.perf_counter() - t0
    wst = mrm.stats()
    mrm.shutdown()
    if wst["cloud_writebacks"] < 1 or wst["cloud_writeback_errors"] != 0:
        raise AssertionError(f"write-back: {wst['cloud_writebacks']} done, "
                             f"{wst['cloud_writeback_errors']} failed")
    if not wb.contains(key) or wb.stat(key)["digest"] != digest:
        raise AssertionError("write-back: the second store's digest for A differs")
    del engine, mrm
    torch.cuda.empty_cache()
    log(f"cloud: batch {st1.ttft_s:.3f} s, streamed {st2.ttft_s:.3f} s to the first token; "
        f"write-back {puts}")
    return {"put_s": put_s, "shards": n_shards, "digest": digest,
            "batch": {**dataclasses.asdict(st1), "launches": l1},
            "streamed": {**dataclasses.asdict(st2),
                         "windows": order, "window_ready_s": [t - t_req for t in ready],
                         "shard_fed_s": [t - t_req for t, _ in shards], "launches": l2},
            "writeback": {"cloud_writebacks": wst["cloud_writebacks"],
                          "cloud_writeback_errors": wst["cloud_writeback_errors"],
                          "put_s": puts, "flush_wait_s": flush_s,
                          "host_capacity": sizes["A"] + sizes["B"] // 2}}


def ipc_phase(torch, store_dir: Path, device, caps, want_tokens):
    """(b) A shm-mode MRM daemon on a unix socket: its own engine serves A
    (a disk hit into shared memory), two client processes open A, put it on
    the card and generate, a third is killed while it holds A, and a device
    eviction demotes A into a segment."""
    import select
    import signal
    import tempfile

    import numpy as np
    from repro_torch.core import mrm as mrm_mod
    from repro_torch.core.costmodel import get_hardware
    from repro_torch.core.shm_ipc import MRMServer
    from repro_torch.core.store import DiskStore
    from repro_torch.device import tensor_from_numpy
    from repro_torch.kernels import ops
    from repro_torch.serving import InferenceEngine

    free = shutil.disk_usage("/dev/shm").free
    size_a = DiskStore(str(store_dir)).open(KEY_A).total_bytes
    if free < 2 * size_a:
        raise RuntimeError(f"/dev/shm has {free} bytes free; phase 7 needs {2 * size_a} "
                           f"(A twice: its host copy and its demoted copy)")
    key = mrm_mod.ModelKey(*KEY_A)
    cfg = model_config(store_dir)
    disk = DiskStore(str(store_dir))
    mrm = mrm_mod.MRM(disk, device_capacity=caps[0], host_capacity=caps[1],
                      hw=get_hardware(), device=device, use_shm=True)
    sockdir = tempfile.mkdtemp(prefix="trims-", dir="/tmp")
    server = MRMServer(mrm, os.path.join(sockdir, "mrm.sock"))
    procs = []
    try:
        engine = InferenceEngine(disk, mrm, device=device)
        ops.reset_launches()
        out, st = engine.generate("A", prompt(cfg.vocab_size), NEW)
        daemon_launches = counts(ops)
        if st.tier_hit != "disk" or not np.array_equal(out, want_tokens):
            raise AssertionError(f"daemon request: tier {st.tier_hit}, tokens equal "
                                 f"{np.array_equal(out, want_tokens)}")
        if daemon_launches != path_launches(cfg):
            raise AssertionError(f"daemon request: launches {daemon_launches}")
        (seg,) = mrm.host.peek(key).payload.shm_segments
        clients = []
        for i in range(2):
            t0 = time.perf_counter()
            r = subprocess.run(_client_cmd(server.sock_path, store_dir, device), capture_output=True,
                               text=True, timeout=CLIENT_TIMEOUT_S)
            wall = time.perf_counter() - t0
            if r.returncode != 0:
                raise RuntimeError(f"client {i} exited {r.returncode}:\n{r.stderr[-4000:]}")
            res = json.loads(r.stdout.strip().splitlines()[-1])
            res["process_s"] = wall
            clients.append(res)
            log(json.dumps({"ipc_client": i, **res}))
            if not os.path.exists(f"/dev/shm/{seg.name}"):
                raise AssertionError(f"client {i}'s exit unlinked the daemon's segment")
        want_sha = tokens_sha1(want_tokens)
        for i, c in enumerate(clients):
            if c["tokens_sha1"] != want_sha:
                raise AssertionError(f"client {i}: tokens differ from phase 3's")
            if c["launches"] != path_launches(cfg):
                raise AssertionError(f"client {i}: launches {c['launches']}")
        if clients[1]["tier_hit"] != "host":
            raise AssertionError(f"second client: tier {clients[1]['tier_hit']}")
        disk_loads = mrm.stats()["disk_loads"]
        if disk_loads != 1:
            raise AssertionError(f"daemon disk_loads {disk_loads}")
        if mrm.host.peek(key).refcount != 0:
            raise AssertionError(f"A's host refcount {mrm.host.peek(key).refcount} after close")

        # a client killed while it holds A
        proc = subprocess.Popen(_client_cmd(server.sock_path, store_dir, device, hold=True),
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append(proc)
        ready, _, _ = select.select([proc.stdout], [], [], CLIENT_TIMEOUT_S)
        line = proc.stdout.readline() if ready else ""
        if not line or mrm.host.peek(key).refcount != 1:
            raise RuntimeError(f"holding client: {line!r}, refcount "
                               f"{mrm.host.peek(key).refcount}:\n"
                               f"{proc.stderr.read() if proc.poll() is not None else ''}")
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        while mrm.host.peek(key).refcount and time.perf_counter() - t0 < 5:
            time.sleep(0.01)
        release_s = time.perf_counter() - t0
        if mrm.host.peek(key).refcount != 0:
            raise AssertionError("the daemon kept the killed client's reference")

        # device eviction in shm mode: B and C push A out of the host tier,
        # then B on the device evicts A, which is demoted into a segment
        dev = dict(mrm.device.peek(key).payload)
        mrm.prefetch(mrm_mod.ModelKey("repro-torch", "B", "1"), tier="host").result()
        mrm.prefetch(mrm_mod.ModelKey("repro-torch", "C", "1"), tier="host").result()
        if mrm.host.peek(key) is not None:
            raise AssertionError("A still on the host tier before the eviction")
        demote, timed = mrm._demote_device_payload, []

        def timed_demote(victim):
            t0 = time.perf_counter()
            r = demote(victim)
            timed.append(time.perf_counter() - t0)
            return r

        mrm.tiers.demote_fn = timed_demote
        mrm.close(mrm.open(mrm_mod.ModelKey("repro-torch", "B", "1")))
        mrm.tiers.demote_fn = demote
        entry = mrm.host.peek(key)
        if entry is None or len(entry.payload.shm_segments) != 1 or len(timed) != 1:
            raise AssertionError("A was not demoted into a segment")
        for n, t in dev.items():
            got = tensor_from_numpy(entry.payload.arrays[n], device)
            if not torch.equal(_bits(torch, got), _bits(torch, t)):
                raise AssertionError(f"demoted {n} differs from the device copy")
        del dev, engine
        summary = {"daemon": {"tier_hit": st.tier_hit, "ttft_s": st.ttft_s,
                              "model_load_s": st.model_load_s, "launches": daemon_launches},
                   "clients": clients, "disk_loads": disk_loads,
                   "killed_release_s": release_s, "demotion_s": timed[0],
                   "demoted_bytes": entry.nbytes, "segment_bytes": size_a}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
            p.stdout.close()
            p.stderr.close()
        server.stop()
        for e in list(mrm.host.entries.values()):
            if e.payload is not None:
                e.payload.release()
        shutil.rmtree(sockdir, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"ipc: clients {[c['tier_hit'] for c in clients]}, "
        f"attach {[round(c['attach_s'], 4) for c in clients]} s")
    return summary


def faas_phase(torch, store_dir: Path, device, caps, want_tokens):
    """(c) A FaaS platform over a card MRM: containers of two tenants run a
    function entitled to A, an unentitled one is refused, teardown drops
    the references, and a router prefers the warm platform over a cold one."""
    import numpy as np
    from repro_torch.core import mrm as mrm_mod
    from repro_torch.core.costmodel import get_hardware
    from repro_torch.core.faas import FaaSPlatform, IsolationError, Router
    from repro_torch.core.store import DiskStore
    from repro_torch.core.tenant import RequestContext
    from repro_torch.kernels import ops

    key = mrm_mod.ModelKey(*KEY_A)
    cfg = model_config(store_dir)
    toks = prompt(cfg.vocab_size)

    def platform(name):
        mrm = mrm_mod.MRM(DiskStore(str(store_dir)), device_capacity=caps[0],
                          host_capacity=caps[1], hw=get_hardware(), device=device)
        return FaaSPlatform(mrm, name=name)

    seen = []

    def fn(ctx, payload):
        m = ctx.load_model(*KEY_A[:2])
        ops.reset_launches()
        out = greedy(torch, cfg, m.weights, payload, device)
        seen.append({"tier_hit": m.timings.tier_hit, "launches": counts(ops),
                     "embed_ptr": m.weights["embed"].data_ptr()})
        return out

    warm = platform("warm")
    for tenant in ("t1", "t2"):
        warm.deploy(f"gen-{tenant}", fn, allowed_models=[KEY_A[:2]], prewarm=False)
    times = []
    for tenant in ("t1", "t2"):
        t0 = time.perf_counter()
        out = warm.invoke(f"gen-{tenant}", toks, ctx=RequestContext(tenant=tenant))
        times.append(time.perf_counter() - t0)
        if not np.array_equal(out, want_tokens):
            raise AssertionError(f"FaaS {tenant}: tokens differ from phase 3's")
    if [s["tier_hit"] for s in seen] != ["disk", "device"] or \
            seen[0]["embed_ptr"] != seen[1]["embed_ptr"]:
        raise AssertionError(f"FaaS: {seen}")
    if any(s["launches"] != path_launches(cfg) for s in seen):
        raise AssertionError(f"FaaS launches {[s['launches'] for s in seen]}")
    warm.deploy("sneaky", fn, allowed_models=[("repro-torch", "B")], prewarm=False)
    try:
        warm.invoke("sneaky", toks)
        raise AssertionError("an unentitled container loaded A")
    except IsolationError:
        pass
    refs = warm.mrm.refcount(key)
    for tenant in ("t1", "t2"):
        warm.undeploy(f"gen-{tenant}")
    if (refs, warm.mrm.refcount(key)) != (2, 0):
        raise AssertionError(f"refcount {refs} before teardown, "
                             f"{warm.mrm.refcount(key)} after")
    cold = platform("cold")
    for node in (cold, warm):
        node.deploy("gen", fn, allowed_models=[KEY_A[:2]], prewarm=False)
    router = Router([cold, warm])
    if router.route("gen", [KEY_A]) is not warm:
        raise AssertionError("the router did not prefer the warm platform")
    out = router.invoke("gen", toks, needed_models=[KEY_A])
    if not np.array_equal(out, want_tokens) or router.dispatches != {"cold": 0, "warm": 1}:
        raise AssertionError(f"routed invoke: dispatches {router.dispatches}")
    for node in (cold, warm):
        node.undeploy("gen")
    del cold, warm
    torch.cuda.empty_cache()
    log(f"faas: tiers {[s['tier_hit'] for s in seen]}, invoke {times} s")
    return {"invocations": [{**s, "invoke_s": t} for s, t in zip(seen, times)],
            "routed": seen[2], "dispatches": router.dispatches,
            "refcount_before_teardown": refs}


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------

SOURCES = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:86"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:74"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:24"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write every result here as JSON")
    ap.add_argument("--ipc-client", metavar="SOCKET", default=None,
                    help="run as one of phase 7's client processes against this socket")
    ap.add_argument("--store", default=None, help="(client) the daemon's model store")
    ap.add_argument("--hold", action="store_true",
                    help="(client) open A, report, and wait to be killed")
    ap.add_argument("--device", default="cuda", help="(client) the daemon's device")
    args = ap.parse_args()
    if args.ipc_client:
        return ipc_client(args.ipc_client, Path(args.store), args.hold, args.device)
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1

    # 1. device
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _lib
    device = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = smi()
    log(f"device: {kind} ({card}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    _lib.load()
    log(f"kernel library ready in {_lib.build_seconds:.1f} s ({_lib.build_dir()})")

    # 2. kernels
    t0 = time.perf_counter()
    kern = kernel_phase(torch, F)
    log(f"kernels agree with their plain versions ({time.perf_counter() - t0:.1f} s)")

    # 3. serve, 4. end to end
    store_dir = ROOT / "build" / "smoke_store"
    cloud_dir = ROOT / "build" / "smoke_cloud"
    for d in (store_dir, cloud_dir):
        shutil.rmtree(d, ignore_errors=True)
    try:
        # full width: d_model 4096, 32 heads of 128, d_ff 11008, vocab 102400
        caps = (3 * GiB, int(4.5 * GiB))
        engine, launches, summary, tokens_a = serve_phase(
            torch, store_dir, get_config("deepseek-7b"), device, caps)
        e2e = end_to_end_phase(torch, engine)
        # 5. stream and prefix
        batch_disk_hit = next(s for s in engine.stats if s.model == "A")
        del engine
        stream = stream_phase(torch, store_dir, device, caps, tokens_a, batch_disk_hit)

        # 6. MoE: qwen3-moe-30b-a3b at full width (d_model 2048, 32 query and 4
        # KV heads of 128, QK-norm, 128 experts top 8 of d_ff 768, vocab
        # 151936), cut to 2 layers, in a store of its own
        moe_dir = ROOT / "build" / "smoke_store_moe"
        shutil.rmtree(moe_dir, ignore_errors=True)
        try:
            torch.cuda.empty_cache()
            moe_engine, moe = moe_phase(torch, moe_dir, get_config("qwen3-moe-30b-a3b").replace(
                n_layers=2), device, (8 * GiB, 8 * GiB))
            moe["end_to_end"] = moe_end_to_end(torch, moe_engine, device)
            del moe_engine
        finally:
            shutil.rmtree(moe_dir, ignore_errors=True)

        # 7. the CLOUD tier, cross-process sharing and FaaS, over phase 3's store
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cloud = cloud_phase(torch, store_dir, cloud_dir, device, caps, tokens_a)
        ipc = ipc_phase(torch, store_dir, device, caps, tokens_a)
        faas = faas_phase(torch, store_dir, device, caps, tokens_a)
        log(f"phase 7 passed in {time.perf_counter() - t0:.1f} s")
    finally:
        for d in (store_dir, cloud_dir):
            shutil.rmtree(d, ignore_errors=True)
    q_launches = {k: sum(x[k] for x in moe["launches"]) for k in moe["launches"][0]}

    table = []
    for name, (source, replaces) in SOURCES.items():
        k = kern[name]
        table.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "launches": launches[name], "q_launches": q_launches[name],
                      "max_abs_err": k["max_abs_err"],
                      "ms": k["ms"], "kernel_ms": k["ms"], "plain_ms": k["plain_ms"],
                      "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                      "library_ms": k["library_ms"],
                      **{x: y for x, y in k.items() if x not in (
                          "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                          "max_abs_err")}})
    if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.") for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "kernels": table, "serve": summary, "end_to_end": e2e,
             "stream": stream, "moe": moe, "cloud": cloud, "ipc": ipc, "faas": faas,
             "build_seconds": _lib.build_seconds, "first_port_ms": FIRST_PORT_MS}, indent=1))
    print(json.dumps({"stream": stream}))
    print(json.dumps({"moe": moe}))
    print(json.dumps({"ipc": ipc}))
    print(json.dumps({"cloud": cloud}))
    print(json.dumps({"faas": faas}))
    print(json.dumps({"first_port_ms": FIRST_PORT_MS}))
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
