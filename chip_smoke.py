#!/usr/bin/env python3
"""Drive the PyTorch port of TrIMS on one NVIDIA card, end to end.

    python3 chip_smoke.py [--out results.json]

Run from the root of a checkout. Phases, each of which raises on failure
(the script then exits non-zero and prints no result):

1. Device: the card's name and power limit; build (or load) the CUDA kernel
   library from ``src/repro_torch/csrc``.
2. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the serving path's shapes (bf16 and fp32; model A's and
   model Q's, phase 6, and those of phase 9's families), at GQA shapes,
   ragged lengths, the edges of the attention kernels' tiles and KV splits
   and of RMSNorm's launch plan; then CUDA-event timings of the kernel, its
   plain version and one PyTorch library call as a yardstick (the port
   never calls it), with the inputs warm in L2 and cold (rotated over more
   than twice the L2's 50 MB), and the time per call issued from Python.
   At phase 10's training shapes (flash q, k, v (4, 512, 32, 128), RMSNorm
   rows (4, 512, 4096), bf16 and float32) the ``autograd.Function``s'
   gradients against autograd through the plain versions, the kernels'
   forward times, and the plain flash backward beside SDPA's backward.
3. Serve (the main path): a full-width deepseek-7b (4 and 2 layers, random
   weights from a seed, bf16) is published three times into a store and
   served through the MRM and the inference engine with device and host
   capacities that force eviction and D2H demotion, then by two concurrent
   workers that must share one device copy. Its kernel launches are read
   from a device trace of the phase (``launched``), as are those of every
   later phase that serves through the engine: the engine replays a DENSE or
   MoE model's decode steps from a CUDA graph, whose kernels pass no
   wrapper's counter.
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
8. The cluster layer, over phase 3's store and phase 7's object store, model
   A at full width (each request's launches counted from 0 and held to its
   path, its tokens equal to phase 3's): four in-process nodes (MRMs on the
   card) share the object store and a sharded directory. (a) Node a holds
   A warm in its host tier and b, a peer-only node with an empty disk,
   pulls it by peer fetch (no download, the same SHA-256 as a's file);
   (b) A's shards are scattered over a and b (b's whole copy dropped) and a
   streaming engine on c serves A by a gather (windows ready 0..4, every
   shard fed before the file is complete); (c) a placement planner on a
   virtual clock sees a periodic arrival trace of A on d and its
   preposition, applied with ``tier="device"``, pulls A onto d's card (a
   peer fetch, then the device copy), so d's next request is a device hit
   that loads in under 10 ms; (d) two daemon processes
   (``repro_torch.core.noded``): na serves the directory over phase 3's
   store, nb joins it with an empty disk and a client socket, pulls A from
   na over the data-plane socket onto its card, serves a client process
   (``--ipc-client``) A as a host hit, and both stop on SIGTERM with exit
   code 0, nb withdrawn from na's directory first and no segment left.
   Printed as ``{"cluster": ...}``: the measured wall times beside the cost
   model's modeled ``peer_s``/``gather_s``.
9. The SSM, HYBRID, VLM and ENCDEC families, in a store of their own
   (``build/smoke_store_fam``, removed at the end), random weights from a
   seed, each request's launches counted from 0 and held to its path:
   M = mamba2-370m at full width and depth (48 layers, bf16) served by a
   batch engine from disk and device, then by a fresh MRM with a streaming,
   prefix-caching engine (a disk hit on the batch path with no stream
   opened; a host hit after J's preposition took M's place on the card;
   a device hit; the last two prefix hits that leave the stored SSM and
   conv states equal to their clones), all five requests' tokens equal;
   V = llama-3.2-vision-90b at full width, one period (4 self layers, 1
   gated cross layer, its 1601-token frontend), E = seamless-m4t-large-v2
   at full width and depth, and J = jamba-1.5-large-398b ``reduced()`` in
   float32, each from disk and device with equal tokens (J's equal to the
   CPU plain path's); float32
   prefill logits of M, V (gates 0.5, a random frontend) and E on the card
   within 1% of max |logit| of the CPU plain path's; and two of jamba's
   sublayers at full width (Mamba-2 and attention without RoPE, each with a
   dense FFN), a prefill and 4 decode steps, within 1% of the CPU's.
   Printed as ``{"families": ...}``.
10. Training, on model A (deepseek-7b at full width, 4 layers; bf16
   params, float32 moments, remat "nothing", grad_accum 2): (a) one
   float32 microbatch (1 x 512 tokens) through the card's kernels, its loss
   and every parameter's gradient against the CPU's plain path, every
   gradient nonzero; (b) a ``Trainer`` of batch 8 x 512 for 6 steps through
   a failure injected at step 3 under ``run_with_restarts`` (the two forced
   checkpoints of the 12.3 GB state in ``build/smoke_train_ckpt``, removed
   at the end), then the same 6 steps uninterrupted: the resumed steps'
   losses within 2e-2 of the uninterrupted run's (the embedding gather's
   backward adds with atomics on the card), each step's launches counted
   from 0 and held to the path (flash 16, RMSNorm 34); (c) the trained
   params published and served twice through a fresh MRM and engine (disk,
   then device hit, one disk load), tokens equal to greedy generation on
   them in this process; (d) one float32 train step of each family's
   ``reduced()`` config on the card against the CPU. Printed as
   ``{"train": ...}``: the step time split into forward, backward and
   optimizer (CUDA events), tokens/s, peak memory, checkpoint seconds and
   bytes, the launches a step.
11. Distribution, on a one-rank NCCL group (a ``FileStore`` in a temporary
   directory, no TCP port) and a (1, 1) mesh: (a) A trained as (b)'s
   uninterrupted run through ``Trainer(mesh=...)`` (DTensor params and
   moments, the kernels on local shards), losses against phase 10's and
   launches a step flash 16, RMSNorm 34; (b) ``launch.dryrun.run_cell`` of
   that step in a subprocess (a fake group of one): params and moments
   bytes equal to the card's, the predicted peak beside
   ``max_memory_allocated``, dot FLOPs over the step time; (c) A's prefill
   and 16 greedy decode steps through ``make_prefill_step`` /
   ``make_decode_step`` on the mesh, tokens and launches equal to phase
   3's; (d) Q's MoE layer at full width, ``moe_impl="ep"`` against the
   grouped path (bf16 and float32, gradients, a bit-equal rerun); (e) the
   int8 all-reduce over a pod axis of one on A's gradients. Printed as
   ``{"mesh": ...}``.
12. The paper's own workload and the examples: (a) the proxy zoo of
   Tables 3 and 4 at its published sizes (all 37 Table 3 models and
   AlexNet-S4 and VGG16-S4, 16.0 GiB, drawn from a seed into
   ``build/smoke_store_zoo``, removed at the end). Each model, with its file
   dropped from the page cache before every read meant to hit the disk, is
   cold-loaded onto the card (the no-TrIMS baseline), opened through TrIMS
   twice (a disk hit, then a device hit on the same storage: equal
   ``data_ptr``s, no new allocation), run through ``proxy_forward`` at
   (1, 64) (CUDA events; VGG19's and VGG16-S4's outputs against the numpy
   formula on the CPU) and freed (refcount 0). An 8 GiB device tier:
   Table 4's models evict Table 3's (the resident set as LRU predicts), and
   evicted models reopen as host hits. faas_pipeline's scenario over this
   store at scale 1.0: two tenants, one disk load of AlexNet, a scene
   container entitled to ResNet50 only. (b) ``examples_torch``'s four
   scripts with their defaults on the card, each one's launches counted
   from 0 and held to its paths (serve_llm with olmo-1b and deepseek-7b:
   16 requests of batch 2, prompt 32, 8 new tokens; train_small through
   its injected failure, its loss falling), each kernel first held to its
   plain version at the examples' shapes. Printed as ``{"zoo": ...}`` and
   ``{"examples": ...}``.

The last lines are the summaries of phases 5 to 12, the first
port's attention kernel times (constants, labelled ``first_port_ms``), the
kernel table as JSON (``launches``: phase 3's counts; ``q_launches``: phase
6's; ``m_``/``v_``/``e_``/``j_launches``: phase 9's for each model;
``train_launches``: phase 10's a training step; ``examples_launches``:
phase 12's, all examples together; ``q_*``: times at Q's
shapes; ``family_shapes``: times at phase 9's shapes; ``train_shapes``
and ``train_bwd``: times at phase 10's), the
card's name and power limit as ``nvidia-smi`` prints them, and
``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import argparse
import contextlib
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

# H100 SXM data sheet (dense): HBM3 bytes/s, the bf16 tensor-core peak and
# the float32 peak outside the tensor cores
HBM_BW = 3.35e12
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
L2_BYTES = 50 * 2 ** 20

# Kernel times of the first, simple CUDA kernels that the attention kernels
# replaced: this script's warm CUDA-graph timing of them on an NVIDIA H100
# 80GB HBM3 at 700.00 W, in an earlier tree. Not measured by this run, so
# they are printed on a line of their own, labelled, outside the kernel table.
FIRST_PORT_MS = {"flash_attention": 0.5458000183105469, "decode_attention": 0.15609920024871826}

B, PROMPT, NEW = 2, 512, 16          # one request: batch 2, 512-token prompt, 16 new tokens
GiB = 2 ** 30
# the shapes phase 9's families give the kernels: attention (Hq, Hkv, D) of
# jamba and the llama-vision self layers, and of the seamless decoder, over
# a (B, PROMPT) prompt and a (B, PROMPT + NEW) cache; RMSNorm rows of
# mamba2-370m's d_model and of jamba's and llama-vision's
FAMILY_HEADS = ((64, 8, 128), (16, 16, 64))
FAMILY_RMSNORM = ((B, PROMPT, 1024), (B, 1, 1024), (B, PROMPT, 8192), (B, 1, 8192))


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


def bound(nbytes: float, ops: float, peak: float = PEAK_BF16):
    """Least time for the work, in ms: bytes over HBM rate vs operations
    over ``peak`` (bf16 tensor cores by default), and which of the two
    bounds it."""
    t_bytes, t_ops = nbytes / HBM_BW, ops / peak
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
    fam_errs = {"flash_attention": [], "decode_attention": [], "rmsnorm": []}  # phase 9's
    for dtype in (torch.bfloat16, torch.float32):
        # flash: slice prefill (MHA), GQA (mistral-nemo heads; Q's group 8), ragged S/T
        for (b, s, t, hq, hkv, d, causal) in ((B, PROMPT, PROMPT, 32, 32, 128, True),
                                              (B, PROMPT, PROMPT, 32, 8, 128, True),
                                              (B, PROMPT, PROMPT, 32, 4, 128, True),
                                              (1, 200, 200, 32, 8, 128, True),
                                              (2, 130, 70, 32, 8, 128, False),
                                              *((B, PROMPT, PROMPT, *h, True)
                                                for h in FAMILY_HEADS)):
            q, k, v = rnd(b, s, hq, d, dtype=dtype), rnd(b, t, hkv, d, dtype=dtype), \
                rnd(b, t, hkv, d, dtype=dtype)
            e = check_close(torch, "flash", kf.flash_attention(q, k, v, causal=causal),
                            kf.flash_attention_plain(q, k, v, causal=causal), dtype,
                            (b, s, t, hq, hkv, d, causal))
            if (s, hkv, dtype) == (PROMPT, 32, torch.bfloat16):
                errs["flash_attention"].append(e)
            if (s, hkv, dtype) == (PROMPT, 4, torch.bfloat16):
                q_errs["flash_attention"].append(e)
            if (hq, hkv, d) in FAMILY_HEADS and dtype == torch.bfloat16:
                fam_errs["flash_attention"].append(e)
        # decode: slice cache (2, 528, 32, 128), GQA (Q's group 8), ragged T,
        # kv_len 0 -> zeros
        T = PROMPT + NEW
        for (b, t, hq, hkv, d, lens) in ((B, T, 32, 32, 128, (T - 1, PROMPT + 1)),
                                         (B, T, 32, 8, 128, (T, 1)),
                                         (B, T, 32, 4, 128, (T - 1, PROMPT + 1)),
                                         (3, 300, 32, 8, 128, (0, 299, 300)),
                                         *((B, T, *h, (T - 1, PROMPT + 1))
                                           for h in FAMILY_HEADS)):
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
            if (hq, hkv, d) in FAMILY_HEADS and dtype == torch.bfloat16:
                fam_errs["decode_attention"].append(e)
        edge_cases(torch, kd, kf, rnd, dtype, dev)
        # rmsnorm: prefill and decode rows of d_model (A's 4096, Q's 2048),
        # Q's QK-norm rows over 32 query and 4 KV heads, a ragged shape
        for shape, eps in (((B, PROMPT, 4096), 1e-5), ((B, 1, 4096), 1e-5),
                           ((B, 7, 32, 128), 1e-6), ((17, 96), 1e-5),
                           ((B, PROMPT, 2048), 1e-5), ((B, 1, 2048), 1e-5),
                           ((B, PROMPT, 32, 128), 1e-6), ((B, PROMPT, 4, 128), 1e-6),
                           ((B, 1, 32, 128), 1e-6), ((B, 1, 4, 128), 1e-6),
                           *((shape, 1e-5) for shape in FAMILY_RMSNORM)):
            x, sc = rnd(*shape, dtype=dtype), rnd(shape[-1], dtype=dtype) + 1
            e = check_close(torch, "rmsnorm", kr.rmsnorm(x, sc, eps),
                            kr.rmsnorm_plain(x, sc, eps), dtype, (shape, eps))
            if dtype == torch.bfloat16 and shape[-1] == 4096:
                errs["rmsnorm"].append(e)
            if dtype == torch.bfloat16 and shape[-1] in (2048, 128) and shape[0] == B:
                q_errs["rmsnorm"].append(e)
            if dtype == torch.bfloat16 and shape in FAMILY_RMSNORM:
                fam_errs["rmsnorm"].append(e)
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
    family_timings(torch, F, kf, kd, kr, rnd, out)
    train_shapes(torch, F, kf, kr, rnd, out)
    mla_kernels(torch, F, kf, rnd, out)
    for name, e in errs.items():
        out[name]["max_abs_err"] = max(e)
        out[name]["q_max_abs_err"] = max(q_errs[name])
        out[name]["family_max_abs_err"] = max(fam_errs[name])
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


def flash_times(torch, F, kf, rnd, hq, hkv, d, b=B, dtype=None):
    """Flash attention's times over a (b, PROMPT) prompt with ``hq`` query
    and ``hkv`` KV heads of ``d``, causal, bf16 unless ``dtype`` says
    otherwise: kernel warm, cold and per call, its plain version, SDPA
    (``enable_gqa``) warm and cold, the bound (float32 against the float32
    peak outside the tensor cores: the kernel's SIMT path)."""
    dt = dtype or torch.bfloat16

    def make():
        return rnd(b, PROMPT, hq, d, dtype=dt), rnd(b, PROMPT, hkv, d, dtype=dt), \
            rnd(b, PROMPT, hkv, d, dtype=dt)

    q, k, v = make()
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    sets = cold_copies(torch, make, nbytes)

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
         "cold_copies": len(sets), "shape": [b, PROMPT, hq, hkv, d], "dtype": str(dt)}
    r["bound_ms"], r["bound_by"] = bound(nbytes, 4 * d * b * hq * PROMPT * (PROMPT + 1) / 2,
                                         PEAK_BF16 if dt == torch.bfloat16 else PEAK_FP32)
    return r


def decode_times(torch, F, kd, rnd, hq, hkv, d):
    """Decode attention's times against a (B, PROMPT + NEW) cache at the last
    step's kv_len, bf16, as :func:`flash_times` (SDPA with a length mask
    and ``enable_gqa``), and the kernel's KV split count."""
    bf, dev = torch.bfloat16, torch.device("cuda")
    T = PROMPT + NEW
    L = T - 1
    kv_len = torch.full((B,), L, dtype=torch.int32, device=dev)
    mask = (torch.arange(T, device=dev)[None, :] < kv_len[:, None])[:, None, None, :]

    def make():
        return rnd(B, hq, d, dtype=bf), rnd(B, T, hkv, d, dtype=bf), rnd(B, T, hkv, d, dtype=bf)

    qd, kc, vc = make()
    sets = cold_copies(torch, make, 2 * kc.numel() * 2)

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
         "cold_copies": len(sets), "shape": [B, T, hq, hkv, d], "kv_len": L,
         "n_split": kd.plan_splits(T, B, hkv, torch.cuda.get_device_properties(0)
                                   .multi_processor_count, hq // hkv)[0]}
    r["bound_ms"], r["bound_by"] = bound(2 * qd.numel() * 2 + 2 * B * L * hkv * d * 2 + B * 4,
                                         4 * B * hq * L * d)
    return r


def q_timings(torch, F, kf, kd, kr, rnd, out):
    """Each kernel at model Q's shapes (qwen3-moe-30b-a3b: 32 query heads
    over 4 KV heads of 128, d_model 2048, QK-norm), bf16, as ``q_*`` keys
    of its row: flash over (2, 512) with group 8, decode over a (2, 528)
    cache at kv_len 527, RMSNorm over d_model rows and QK-norm rows, at
    prefill and decode. The library calls are SDPA with ``enable_gqa`` and
    ``F.rms_norm``."""
    for name, r in (("flash_attention", flash_times(torch, F, kf, rnd, 32, 4, 128)),
                    ("decode_attention", decode_times(torch, F, kd, rnd, 32, 4, 128))):
        out[name].update({"q_" + x: y for x, y in r.items()})
    for pre, shape, eps in (("q_", (B, PROMPT, 2048), 1e-5),
                            ("q_decode_rows_", (B, 1, 2048), 1e-5),
                            ("q_head_rows_", (B, PROMPT, 32, 128), 1e-6),
                            ("q_head_decode_rows_", (B, 1, 32, 128), 1e-6)):
        r = rmsnorm_times(torch, F, kr, rnd, shape, eps)
        out["rmsnorm"].update({pre + x: y for x, y in r.items()})
        out["rmsnorm"][pre + "shape"] = list(shape)


def family_timings(torch, F, kf, kd, kr, rnd, out):
    """Each kernel at the shapes phase 9's families give it (FAMILY_HEADS,
    FAMILY_RMSNORM), bf16, as a ``family_shapes`` list in its row, each
    entry with its ``shape`` and the keys of :func:`flash_times`,
    :func:`decode_times` or :func:`rmsnorm_times`."""
    out["flash_attention"]["family_shapes"] = [flash_times(torch, F, kf, rnd, *h)
                                               for h in FAMILY_HEADS]
    out["decode_attention"]["family_shapes"] = [decode_times(torch, F, kd, rnd, *h)
                                                for h in FAMILY_HEADS]
    out["rmsnorm"]["family_shapes"] = [
        {**rmsnorm_times(torch, F, kr, rnd, shape, 1e-5), "shape": list(shape)}
        for shape in FAMILY_RMSNORM]


# latent attention at moon.decode_b64's shapes: 16 heads, a latent of 512
# and a RoPE part of 64, keys of 128 + 64 and values of 128; a batch of 64
# over a cache of 2048 + 256 positions, read at its first, middle and last
# decode step
MLA_H, MLA_R, MLA_P, MLA_DK, MLA_DV = 16, 512, 64, 192, 128
MLA_B, MLA_T, MLA_KV = 64, 2304, (2049, 2176, 2304)
MLA_PREFILL = (4, 2048)   # flash timings: 4 of the cell's 64 prompts of 2048


def mla_kernels(torch, F, kf, rnd, out):
    """The kernels of latent attention against their plain versions, and
    their times, as the rows ``out["mla_decode"]`` and
    ``out["flash_attention"]["mla_prefill"]``.

    ``mla_decode`` at the cell's shape (q (64, 16, 576), a (64, 2304) latent
    cache) at each ``MLA_KV`` and at ragged lengths, bf16 (its only type):
    kernel warm, cold and per call, its plain version, and the same heads
    without absorption (each head's keys and values expanded in memory)
    through SDPA as the yardstick. ``flash_attention`` with 192-wide q and k
    and 128-wide values (a strided view, as ``mla_attention`` passes them),
    causal, against its plain version in bf16 and float32 at ragged lengths;
    its times over ``MLA_PREFILL``, the library call SDPA with the values
    padded to 192, the port's prefill before the kernel took these widths."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels import mla_decode as km
    bf, dev = torch.bfloat16, torch.device("cuda")
    scale = MLA_DK ** -0.5
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    errs = []
    for dtype in (bf, torch.float32):
        for (b, s, t) in ((2, 512, 512), (1, 200, 200), (1, 300, 129), (1, 1, 1)):
            q, k = rnd(b, s, MLA_H, MLA_DK, dtype=dtype), rnd(b, t, MLA_H, MLA_DK, dtype=dtype)
            v = rnd(b, t, MLA_H, 2 * MLA_DV, dtype=dtype)[..., MLA_DV:]
            errs.append(check_close(torch, "flash_attention", kf.flash_attention(q, k, v),
                                    kf.flash_attention_plain(q, k, v), dtype,
                                    ("mla", b, s, t)))

    def make_prefill():
        b, s = MLA_PREFILL
        return (rnd(b, s, MLA_H, MLA_DK, dtype=bf), rnd(b, s, MLA_H, MLA_DK, dtype=bf),
                rnd(b, s, MLA_H, 2 * MLA_DV, dtype=bf)[..., MLA_DV:])

    def sdpa_padded(a):
        q, k, v = (x.transpose(1, 2) for x in a)
        v = F.pad(v, (0, MLA_DK - MLA_DV))
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)[..., :MLA_DV]

    b, s = MLA_PREFILL
    qkv = make_prefill()
    nbytes = b * s * MLA_H * (2 * MLA_DK + 2 * MLA_DV) * 2
    sets = cold_copies(torch, make_prefill, nbytes)
    r = {"ms": time_ms(torch, lambda: kf.flash_attention(*qkv)),
         "cold_ms": time_ms(torch, [lambda a=a: kf.flash_attention(*a) for a in sets]),
         "call_ms": call_ms(torch, lambda: kf.flash_attention(*qkv)),
         "plain_ms": time_ms(torch, lambda: kf.flash_attention_plain(*qkv), reps=2, trials=3),
         "library_ms": time_ms(torch, lambda: sdpa_padded(qkv)),
         "cold_library_ms": time_ms(torch, [lambda a=a: sdpa_padded(a) for a in sets]),
         "cold_copies": len(sets), "shape": [b, s, MLA_H, MLA_DK, MLA_DV],
         "max_abs_err": max(errs)}
    r["bound_ms"], r["bound_by"] = bound(nbytes,
                                         2 * (MLA_DK + MLA_DV) * b * MLA_H * s * (s + 1) / 2)
    out["flash_attention"]["mla_prefill"] = r
    del qkv, sets

    def make_latent():
        return (rnd(MLA_B, MLA_T, 1, MLA_R, dtype=bf), rnd(MLA_B, MLA_T, 1, MLA_P, dtype=bf))

    q = rnd(MLA_B, MLA_H, MLA_R + MLA_P, dtype=bf)
    c, pe = make_latent()
    ragged = torch.randint(0, MLA_T + 1, (MLA_B,), dtype=torch.int32, device=dev)
    errs = [check_close(torch, "mla_decode", km.mla_decode(q, c, pe, ragged, scale),
                        km.mla_decode_plain(q, c, pe, ragged, scale), bf, "ragged")]
    sets = cold_copies(torch, make_latent, (c.numel() + pe.numel()) * 2)
    rows = []
    for kv in MLA_KV:
        kv_len = torch.full((MLA_B,), kv, dtype=torch.int32, device=dev)
        errs.append(check_close(torch, "mla_decode", km.mla_decode(q, c, pe, kv_len, scale),
                                km.mla_decode_plain(q, c, pe, kv_len, scale), bf, kv))
        kq = rnd(MLA_B, MLA_H, 1, MLA_DK, dtype=bf)
        kk = rnd(MLA_B, MLA_H, kv, MLA_DK, dtype=bf)
        vv = rnd(MLA_B, MLA_H, kv, MLA_DV, dtype=bf)
        nb = 2 * (q.numel() + MLA_B * kv * (MLA_R + MLA_P) + MLA_B * MLA_H * MLA_R)
        row = {"kv_len": kv,
               "ms": time_ms(torch, lambda: km.mla_decode(q, c, pe, kv_len, scale)),
               "cold_ms": time_ms(torch, [lambda a=a: km.mla_decode(q, *a, kv_len, scale)
                                          for a in sets]),
               "call_ms": call_ms(torch, lambda: km.mla_decode(q, c, pe, kv_len, scale)),
               "plain_ms": time_ms(torch, lambda: km.mla_decode_plain(q, c, pe, kv_len, scale),
                                   reps=2, trials=3),
               "library_call_ms": call_ms(torch, lambda: F.scaled_dot_product_attention(
                   kq, kk, vv, scale=scale))}
        row["bound_ms"], row["bound_by"] = bound(
            nb, 2.0 * MLA_B * MLA_H * kv * (2 * MLA_R + MLA_P))
        rows.append(row)
        del kk, vv
    out["mla_decode"] = {"shape": [MLA_B, MLA_H, MLA_T, MLA_R, MLA_P], "rows": rows,
                         "cold_copies": len(sets), "max_abs_err": max(errs),
                         "n_split": km.plan_splits(MLA_T, MLA_B, n_sm)[0]}
    log_path = sorted(_lib.build_dir().glob("*.log"))
    if log_path:
        text = log_path[-1].read_text()
        i = text.find("== mla_decode.cu")
        out["mla_decode"]["ptxas"] = [ln for ln in text[i:].splitlines()[:40] if i >= 0 and (
            "registers" in ln or "spill" in ln)]


TRAIN_B = 4            # phase 10's microbatch: batch 8 in 2 accumulation steps
TRAIN_QKV = (TRAIN_B, PROMPT, 32, 128)
TRAIN_ROWS = (TRAIN_B, PROMPT, 4096)


def grad_err(torch, name, got, want, dtype, case) -> float:
    """Largest |difference| of two gradients over the reference's largest
    |value|; bf16 within 2e-2, float32 within 1e-4 (the two sum in other
    orders; in bf16 the Function's backward rounds ``p`` to bf16 before
    ``PV``, as the reference's oracle, where the plain version does not)."""
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    g, w = got.float(), want.float()
    rel = ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
    if not torch.isfinite(g).all() or rel > tol:
        raise AssertionError(f"{name} {case} {dtype}: gradient error {rel:.3g} of max over {tol}")
    return rel


def train_shapes(torch, F, kf, kr, rnd, out):
    """The two ``autograd.Function``s at model A's training shapes (phase
    10's microbatch): flash q, k, v (4, 512, 32, 128) and RMSNorm rows (4,
    512, 4096) with their scale, bf16 and float32. Each Function's output
    and gradients on the card against ``torch.autograd`` through the plain
    version on the card; the kernels' forward times at these shapes as
    ``train_shapes`` of their rows (:func:`flash_times`,
    :func:`rmsnorm_times`); and the plain flash backward (the Function's,
    the VJP of ``ref.mha_reference``) beside SDPA's backward, per call from
    Python (``train_bwd``), a yardstick: the port never calls SDPA. Also
    what the Function costs the serving path per call (RMSNorm at A's
    decode rows, through the Function and through the wrapper)."""
    from repro_torch.kernels import ops

    errs = {"flash_attention": [], "rmsnorm": []}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (rnd(*TRAIN_QKV, dtype=dtype) for _ in "qkv")
        g = rnd(*TRAIN_QKV, dtype=dtype)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = ops.flash_attention(*leaves)
        dgot = torch.autograd.grad(got, leaves, g)
        plain = [t.clone().requires_grad_() for t in (q, k, v)]
        want = kf.flash_attention_plain(*plain)
        dwant = torch.autograd.grad(want, plain, g)
        check_close(torch, "flash Function", got, want, dtype, TRAIN_QKV)
        errs["flash_attention"] += [grad_err(torch, f"flash d{n}", a, b, dtype, TRAIN_QKV)
                                    for n, a, b in zip("qkv", dgot, dwant)]
        x, sc = rnd(*TRAIN_ROWS, dtype=dtype), rnd(TRAIN_ROWS[-1], dtype=dtype) + 1
        g = rnd(*TRAIN_ROWS, dtype=dtype)
        leaves = [x.clone().requires_grad_(), sc.clone().requires_grad_()]
        got = ops.rmsnorm(*leaves)
        dgot = torch.autograd.grad(got, leaves, g)
        plain = [x.clone().requires_grad_(), sc.clone().requires_grad_()]
        want = kr.rmsnorm_plain(*plain)
        dwant = torch.autograd.grad(want, plain, g)
        check_close(torch, "rmsnorm Function", got, want, dtype, TRAIN_ROWS)
        errs["rmsnorm"] += [grad_err(torch, f"rmsnorm d{n}", a, b, dtype, TRAIN_ROWS)
                            for n, a, b in zip(("x", "scale"), dgot, dwant)]
    del q, k, v, x, sc, g, leaves, plain, got, want, dgot, dwant
    out["flash_attention"]["train_shapes"] = [
        flash_times(torch, F, kf, rnd, 32, 32, 128, b=TRAIN_B, dtype=dt)
        for dt in (torch.bfloat16, torch.float32)]
    out["rmsnorm"]["train_shapes"] = [
        {**rmsnorm_times(torch, F, kr, rnd, TRAIN_ROWS, 1e-5), "shape": list(TRAIN_ROWS)}]

    bf = torch.bfloat16
    q, k, v = (rnd(*TRAIN_QKV, dtype=bf).requires_grad_() for _ in "qkv")
    g = rnd(*TRAIN_QKV, dtype=bf)
    o = ops.flash_attention(q, k, v)
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    gt = g.transpose(1, 2)
    # the least the backward (q, k, v, dO) -> (dq, dk, dv) could take: each
    # input read and each output written once (7 tensors), and six
    # products over the causal triangle (QK^T and PV again, dO V^T, P^T dO,
    # dS K, dS^T Q)
    Bt, St, Ht, Dt = TRAIN_QKV
    tri = Bt * Ht * St * (St + 1) // 2
    bwd_bound = bound(7 * q.numel() * 2, 6 * 2 * tri * Dt)
    out["flash_attention"]["train_bwd"] = {
        "shape": list(TRAIN_QKV), "dtype": str(bf),
        "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
        "plain_bwd_call_ms": call_ms(torch, lambda: torch.autograd.grad(
            o, (q, k, v), g, retain_graph=True), reps=10, trials=5),
        "library_bwd_call_ms": call_ms(torch, lambda: torch.autograd.grad(
            ot, (qt, kt, vt), gt, retain_graph=True), reps=10, trials=5)}
    # the serving path's cost of the Function: RMSNorm at A's decode rows
    # under inference_mode, per call from Python, through the Function and
    # through the kernel module's wrapper, in turns (wrapper, Function,
    # Function, wrapper)
    x, sc = rnd(B, 1, 4096, dtype=bf), rnd(4096, dtype=bf) + 1
    with torch.inference_mode():
        turns = [call_ms(torch, lambda f=f: f(x, sc)) for f in (kr.rmsnorm, ops.rmsnorm,
                                                                 ops.rmsnorm, kr.rmsnorm)]
    out["rmsnorm"]["decode_rows_call_ms_wrapper_function"] = turns
    for name, e in errs.items():
        out[name]["train_grad_max_rel_err"] = max(e)
    log(f"training shapes: {json.dumps(out['flash_attention']['train_bwd'])}, RMSNorm call "
        f"ms (wrapper, Function, Function, wrapper) {turns}")


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


# each kernel module's kernels, as a device trace names them
KERNEL_NAMES = {"flash_attention": ("flash_fwd_tc", "flash_fwd_f32"),
                "decode_attention": ("decode_split_kernel",),
                "rmsnorm": ("rmsnorm_kernel",)}
# and with latent attention's decode kernel (phase 6's model L)
MLA_KERNEL_NAMES = {**KERNEL_NAMES, "mla_decode": ("mla_decode_kernel",)}


@contextlib.contextmanager
def launched(torch, kernels=KERNEL_NAMES):
    """Each kernel's launches inside the block, read from a device trace of
    it: the engine replays a DENSE or MoE model's decode steps from a CUDA
    graph, whose kernels run without passing the wrappers that ``counts``
    reads. Yields a dict of ``kernels``' counts, filled when the block
    ends. A trace on the H100
    has lost the first device activity of its window (the first ~40
    kernels and copies of a request that began 10 ms in), so the block
    starts after 256 throwaway kernels, a sync and 50 ms."""
    from torch.profiler import ProfilerActivity, profile
    got = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        x = torch.zeros(1024, device="cuda")
        for _ in range(256):
            x.add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        yield got
        torch.cuda.synchronize()
        time.sleep(0.01)
    cuda = torch.autograd.DeviceType.CUDA
    names = [e.name() for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    got.update({k: sum(any(p in n for p in pats) for n in names)
                for k, pats in kernels.items()})


def path_launches(cfg, prefill: bool = True, new: int = NEW) -> dict:
    """Launches one request of ``new`` new tokens implies: flash once per
    causal self-attention layer, decode once per such layer and decode step
    (``new - 1``), and rmsnorm once per RMSNorm of a pass (two a layer or
    sublayer, one for a Mamba-2 layer without an FFN, two more with QK-norm:
    the query and key head norms; none in a layernorm model) plus the final
    norm, for every pass that gives a token; a prefix hit runs no prefill.
    Latent attention (``cfg.mla``) runs flash in prefill as well, the latent
    decode kernel where the others run decode, and one more RMSNorm a
    layer, the latent's."""
    steps = new if prefill else new - 1
    if getattr(cfg, "mla", False):
        return {"flash_attention": cfg.n_layers if prefill else 0, "decode_attention": 0,
                "rmsnorm": (3 * cfg.n_layers + 1) * steps,
                "mla_decode": cfg.n_layers * (new - 1)}
    fam = cfg.family
    if fam == "ssm":
        n_attn = 0
    elif fam == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
    elif fam == "vlm":
        n_attn = cfg.n_layers // cfg.cross_attn_every * (cfg.cross_attn_every - 1)
    elif fam == "encdec":
        n_attn = cfg.n_dec_layers
    else:
        n_attn = cfg.n_layers
    norms = 0
    if cfg.norm_type == "rmsnorm":
        norms = (cfg.n_layers if fam == "ssm" else 2 * cfg.n_layers) + 1 \
            + (2 * n_attn if cfg.qk_norm else 0)
    return {"flash_attention": n_attn if prefill else 0,
            "decode_attention": n_attn * (new - 1),
            "rmsnorm": norms * steps}


def serve_phase(torch, store_dir: Path, base, device, caps):
    """``base`` is the full-width config; ``caps`` the (device, host) tier
    capacities in bytes."""
    from repro_torch.core.costmodel import get_hardware
    from repro_torch.core.mrm import MRM, ModelKey
    from repro_torch.core.store import DiskStore
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

    t_main = time.perf_counter()
    results, stats = {}, []

    def gen(name):
        out, st = engine.generate(name, toks, NEW)
        results.setdefault(name, []).append(out)
        stats.append(st)
        log(json.dumps({"request": len(stats), **dataclasses.asdict(st)}))

    with launched(torch) as launches:
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
        with launched(torch) as n:
            out, st = engine.generate("A", toks, NEW)
        launches.append(n)
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
        with launched(torch) as n:
            out, st = engine.generate("Q", toks, NEW)
        launches.append(n)
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


def moon_config():
    """Model L: Moonlight-16B-A3B (the DeepSeek-V3 block; HF
    moonshotai/Moonlight-16B-A3B config.json) at full width, cut to 3 of
    its 27 layers: the leading dense one and two MoE layers. As the
    benchmark runs it (``trimsbench/arch/deepseek_v3.py``): the head tied,
    capacity dispatch at 1.25."""
    from repro_torch.configs.base import MOE, ModelConfig
    return ModelConfig(
        name="moonlight-16b-a3b", family=MOE, n_layers=3, d_model=2048, n_heads=16,
        n_kv_heads=16, vocab_size=163840, rope_theta=50000.0, norm_eps=1e-5,
        capacity_factor=1.25, moe_impl="capacity", tie_embeddings=True,
        param_dtype="bfloat16", compute_dtype="bfloat16", d_ff=1408, n_experts=64, top_k=6,
        n_shared_experts=2, kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, n_dense_layers=1, dense_d_ff=11264, router_scoring="sigmoid",
        routed_scaling_factor=2.446)


def moon_phase(torch, store_dir: Path, device, caps):
    """Model L (``moon_config``) in a store of its own, through
    ``publish_model``, the MRM and a batch engine: a disk hit, then a
    device hit. Both requests' tokens must be equal; each request's
    launches, read from a device trace (``launched`` with the latent decode
    kernel), what its path implies (``path_launches``: flash once a layer
    in prefill, ``mla_decode_kernel`` once a layer in every later step,
    though the device hit replays every step from a CUDA graph), and the
    cache it held the latent one (576 bf16 values a position and layer)."""
    import numpy as np
    from repro_torch.core import mrm as mrm_mod
    from repro_torch.core.costmodel import get_hardware
    from repro_torch.core.store import DiskStore
    from repro_torch.serving import InferenceEngine

    cfg = moon_config()
    disk = DiskStore(str(store_dir))
    t0 = time.perf_counter()
    size = publish(torch, disk, cfg, "L", 4, device)
    log(f"published L: {size} bytes in {time.perf_counter() - t0:.1f} s")
    engine = InferenceEngine(disk, mrm_mod.MRM(disk, device_capacity=caps[0],
                                               host_capacity=caps[1], hw=get_hardware(),
                                               device=device), device=device)
    toks = prompt(cfg.vocab_size)
    want = path_launches(cfg)
    cache_bytes = cfg.n_layers * B * (PROMPT + NEW) * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2
    out = {"model": cfg.name, "n_layers": cfg.n_layers, "bytes": size, "want": want,
           "launches": [], "requests": []}
    tokens = []
    for tier in ("disk", "device"):
        with launched(torch, MLA_KERNEL_NAMES) as n:
            got, st = engine.generate("L", toks, NEW)
        log(json.dumps({"moon_request": len(tokens) + 1, "launches": n,
                        **dataclasses.asdict(st)}))
        out["launches"].append(n)
        out["requests"].append(dataclasses.asdict(st))
        if st.tier_hit != tier:
            raise AssertionError(f"L: a {st.tier_hit} hit where a {tier} hit was due")
        if got.shape != (B, NEW) or got.min() < 0 or got.max() >= cfg.vocab_size:
            raise AssertionError(f"L: bad tokens {got.shape} {got.min()}..{got.max()}")
        if tokens and not np.array_equal(got, tokens[0]):
            raise AssertionError("L: the device hit's tokens differ from the disk hit's")
        if n != want:
            raise AssertionError(f"L {tier} hit: launches {n}, the path implies {want}")
        if st.cache_bytes != cache_bytes:
            raise AssertionError(f"L: the request held {st.cache_bytes} B of cache, the "
                                 f"latent cache is {cache_bytes} B")
        tokens.append(got)
    if out["requests"][1]["graph_steps"] != NEW - 1:
        raise AssertionError(f"L: the device hit replayed {out['requests'][1]['graph_steps']} "
                             f"of {NEW - 1} decode steps")
    out["tokens_sha1"] = tokens_sha1(tokens[0])
    return out


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
        with launched(torch) as launches:
            out, st = engine.generate("A", toks, NEW)
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
    with launched(torch) as l4:
        engine.generate("B", toks, NEW)
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
        with launched(torch) as daemon_launches:
            out, st = engine.generate("A", prompt(cfg.vocab_size), NEW)
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


# ---------------------------------------------------------------------------
# phase 8: the cluster layer (peer fetch, sharded gather, placement, daemons)
# ---------------------------------------------------------------------------

def _timed(fn, out: list):
    """``fn`` that appends each call's wall seconds to ``out``."""
    def run(*a, **kw):
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        out.append(time.perf_counter() - t0)
        return r
    return run


def file_sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(64 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def cluster_phase(torch, store_dir: Path, build: Path, device, caps, want_tokens):
    """(a) Peer fetch, (b) a streamed sharded gather and (c) a planner's
    preposition among four in-process nodes that share phase 7's object
    store and a sharded directory; then (d) two daemon processes."""
    import numpy as np
    from repro_torch.core import mrm as mrm_mod
    from repro_torch.core.cluster import Cluster
    from repro_torch.core.costmodel import get_hardware
    from repro_torch.core.objectstore import ObjectStore
    from repro_torch.core.placement import PlacementPlanner, PlannerConfig
    from repro_torch.core.store import DiskStore
    from repro_torch.serving import InferenceEngine

    cfg = model_config(store_dir)
    toks, hw, want = prompt(cfg.vocab_size), get_hardware(), path_launches(cfg)
    key = mrm_mod.ModelKey(*KEY_A)
    store = ObjectStore(str(build / "cloud"))          # phase 7's: A in layer shards
    digest = file_sha256(DiskStore(str(store_dir)).path_for(key))
    if store.stat(key)["digest"] != digest:
        raise AssertionError("phase 7's object store holds another A")
    cluster = Cluster(objectstore=store, directory="sharded")

    def node(name, disk_root, gather=True):
        mrm = mrm_mod.MRM(DiskStore(str(disk_root)), device_capacity=caps[0],
                          host_capacity=caps[1], hw=hw, device=device)
        return cluster.add_node(name, mrm, gather=gather)

    def serve(n, label, streaming=False):
        engine = InferenceEngine(n.mrm.disk, n.mrm, device=device, streaming=streaming)
        engine._cfg_cache[("A", "1")] = cfg     # a cold node has no local file to read it from
        with launched(torch) as launches:
            out, st = engine.generate("A", toks, NEW)
        log(json.dumps({"cluster_request": label, **dataclasses.asdict(st)}))
        if not np.array_equal(out, want_tokens):
            raise AssertionError(f"phase 8 {label}: tokens differ from phase 3's")
        if launches != want:
            raise AssertionError(f"phase 8 {label}: launches {launches}, path implies {want}")
        return {**dataclasses.asdict(st), "launches": launches}

    # b and d are peer-only: with A in layer shards in the object store, a
    # gather over a and the cloud would be modeled at least as cheap as the
    # single peer link, and these two requests are to take the peer leg
    a, b = node("a", store_dir), node("b", build / "cluster_b", gather=False)
    c, d = node("c", build / "cluster_c"), node("d", build / "cluster_d", gather=False)
    out = {"hw": {k: getattr(hw, k) for k in ("peer_bw", "peer_rtt", "disk_bw",
                                               "ingest_bw", "h2d_bw")}}

    # (a) peer fetch: a holds A warm in its host tier, b pulls it over the
    # modeled peer link (in this process: a file copy)
    a.mrm.prefetch(key, tier="host").result()
    pulls = []
    b._pull_from_peer = _timed(b._pull_from_peer, pulls)
    st = serve(b, "peer")
    if st["tier_hit"] != "peer" or b.mrm.metrics["peer_fetches"] != 1 or len(pulls) != 1:
        raise AssertionError(f"peer fetch: tier {st['tier_hit']}, "
                             f"peer_fetches {b.mrm.metrics['peer_fetches']}")
    if b.mrm.metrics["cloud_downloads"] != 0:
        raise AssertionError("peer fetch: b downloaded from the object store")
    if file_sha256(b.mrm.disk.path_for(key)) != digest:
        raise AssertionError("peer fetch: b's copy of A differs from a's")
    out["peer"] = {**st, "pull_wall_s": pulls[0],
                   "modeled_peer_s": b.mrm.metrics["modeled_fetch_s"],
                   "node_b": b.stats(), "node_a": a.stats()}
    log(f"peer: pull {pulls[0]:.3f} s wall (modeled {b.mrm.metrics['modeled_fetch_s']:.3f} s), "
        f"ttft {st['ttft_s']:.3f} s")

    # (b) sharded gather, streamed: A's shards scattered over a and b; b's
    # whole copy and a's host copy go, so both sources serve from disk
    if not (b.mrm.drop_model(key, from_disk=True)["disk"] and a.mrm.drop_model(key)["host"]):
        raise AssertionError("A's copies on b and in a's host tier were not dropped")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    placed = cluster.scatter(key, ["a", "b"])
    scatter_s = time.perf_counter() - t0
    plans, order, ready, fed = [], [], [], []
    plan_sources, gather_run = c.plan_shard_sources, c._gather_run
    dst = c.mrm.disk.path_for(key)

    def recording_plan(k, st_):
        p = plan_sources(k, st_)
        plans.append(p)
        return p

    def watching_gather(k, st_, timings, on_shard=None, ctx=None):
        def cb(row, data):
            fed.append((time.perf_counter(), os.path.exists(dst), row["index"]))
            on_shard(row, data)
        return gather_run(k, st_, timings, cb if on_shard is not None else None, ctx=ctx)

    mark = mrm_mod.LoadFuture._mark_window

    def recording_mark(fut, index):
        if fut.streaming:
            order.append(index)
            ready.append(time.perf_counter())
        mark(fut, index)

    c.plan_shard_sources, c._gather_run = recording_plan, watching_gather
    mrm_mod.LoadFuture._mark_window = recording_mark
    t_req = time.perf_counter()
    try:
        st = serve(c, "gather", streaming=True)
    finally:
        mrm_mod.LoadFuture._mark_window = mark
        del c.plan_shard_sources, c._gather_run
    n_shards, n_windows = len(store.shard_table(key)), 1 + cfg.n_layers
    if (st["tier_hit"], st["streamed"]) != ("gather", True):
        raise AssertionError(f"gather: tier {st['tier_hit']}, streamed {st['streamed']}")
    if order != list(range(n_windows)):
        raise AssertionError(f"gather: windows ready in the order {order}")
    if len(fed) != n_shards or any(landed for _, landed, _ in fed):
        raise AssertionError(f"gather: {len(fed)} of {n_shards} shards fed, the file "
                             f"complete before {sum(x for _, x, _ in fed)} of them")
    if c.mrm.metrics["gather_fetches"] != 1:
        raise AssertionError(f"gather: gather_fetches {c.mrm.metrics['gather_fetches']}")
    rows, modeled_gather_s, _ = plans[-1]
    out["gather"] = {**st, "scatter_s": scatter_s, "placed": placed,
                     "sources": [[r["index"], r["source"], r["node"]] for r in rows],
                     "modeled_gather_s": c.mrm.metrics["modeled_fetch_s"],
                     "planned_gather_s": modeled_gather_s,
                     "windows": order, "window_ready_s": [t - t_req for t in ready],
                     "shard_fed_s": [[i, t - t_req] for t, _, i in fed], "node_c": c.stats()}
    log(f"gather: sources {[r['node'] or r['source'] for r in rows]}, "
        f"ttft {st['ttft_s']:.3f} s, windows at {[round(t - t_req, 3) for t in ready]} s")

    # (c) placement: a periodic arrival trace of A on d, on a virtual clock;
    # the planner's preposition, applied with tier="device", pulls A onto d's
    # card ahead of the burst
    planner = PlacementPlanner(cfg=PlannerConfig(bin_s=1.0, min_bursts=3, min_arrivals=4,
                                                 lead_s=1.0))
    for i in range(6):
        planner.observe(key, node="d", now=0.25 + 5.0 * i)
    futs, prefetch = [], d.mrm.prefetch

    def recording_prefetch(*a_, **kw):
        futs.append(prefetch(*a_, **kw))
        return futs[-1]

    d.mrm.prefetch = recording_prefetch
    t0 = time.perf_counter()
    applied = planner.apply(cluster, now=29.5, tier="device")
    if [(x.kind, x.nodes) for x in applied] != [("preposition", ("d",))] or len(futs) != 1:
        raise AssertionError(f"planner: applied {applied}")
    futs[0].result()
    prefetch_s = time.perf_counter() - t0
    del d.mrm.prefetch
    if futs[0].timings.tier_hit != "peer" or d.mrm.device.peek(key) is None:
        raise AssertionError(f"preposition: tier {futs[0].timings.tier_hit}, on the device "
                             f"{d.mrm.device.peek(key) is not None}")
    st = serve(d, "prepositioned")
    if st["tier_hit"] != "device" or st["model_load_s"] >= 0.010:
        raise AssertionError(f"after the preposition: tier {st['tier_hit']}, "
                             f"load {st['model_load_s']:.4f} s")
    x = applied[0]
    out["planner"] = {"action": {"kind": x.kind, "nodes": list(x.nodes), "at_s": x.at_s,
                                 "reason": x.reason},
                      "prefetch_s": prefetch_s, "prefetch_tier_hit": futs[0].timings.tier_hit,
                      "request": st, "stats": planner.stats()}
    log(f"planner: {x.kind} -> {x.nodes}, prefetch {prefetch_s:.3f} s "
        f"({futs[0].timings.tier_hit}), then load {st['model_load_s'] * 1e3:.2f} ms")
    out["directory"] = cluster.directory.stats()
    for n in cluster.nodes.values():
        n.mrm.shutdown()
    del cluster, a, b, c, d, futs
    torch.cuda.empty_cache()

    # (d) daemon processes
    out["daemons"] = daemon_phase(store_dir, build, device, caps, want_tokens, digest, cfg)
    return out


def daemon_phase(store_dir: Path, build: Path, device, caps, want_tokens, digest, cfg):
    """Two port daemons: na serves the sharded directory over phase 3's
    store, nb joins it with an empty disk and a client socket. nb pulls A
    from na over the data-plane socket onto its card, a client process
    opens A through nb as a host hit and generates, and both daemons stop
    cleanly on SIGTERM."""
    import glob
    import signal
    import tempfile

    from repro_torch.core.noded import spawn_node
    from repro_torch.core.transport import SocketTransport

    sockdir = tempfile.mkdtemp(prefix="trims-", dir="/tmp")
    shm_before = set(glob.glob("/dev/shm/trims_*"))
    nb_root = build / "cluster_nb"
    nb_root.mkdir(parents=True, exist_ok=True)
    procs, errs, out = {}, [], {}

    def spawn(name, **spec):
        errs.append(open(build / f"{name}.err", "w"))
        t0 = time.perf_counter()
        procs[name], info = spawn_node(
            {"name": name, "listen": f"unix:{sockdir}/{name}.sock", "device": str(device),
             "device_capacity": caps[0], "host_capacity": caps[1], "call_timeout_s": 300,
             **spec}, stderr=errs[-1], ready_timeout_s=180)
        out[name] = {**info, "ready_s": time.perf_counter() - t0}
        return info["address"]

    def stop(name):
        t0 = time.perf_counter()
        procs[name].send_signal(signal.SIGTERM)
        rc = procs[name].wait(timeout=60)
        out["shutdown_s"][name] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"daemon {name} exited {rc} on SIGTERM")

    try:
        ta = SocketTransport(spawn("na", disk_root=str(store_dir), directory={
            "serve": True, "policy": "sharded", "n_shards": 8}), timeout_s=300)
        tb = SocketTransport(spawn("nb", disk_root=str(nb_root),
                                   client_sock=f"{sockdir}/nb-client.sock",
                                   directory={"connect": out["na"]["address"]}), timeout_s=600)
        t0 = time.perf_counter()
        r = tb.call({"op": "open", "key": list(KEY_A), "tier": "device", "timeout": 600})
        pull_s = time.perf_counter() - t0
        if r["timings"]["tier_hit"] != "peer" or r["disk_digest"] != digest:
            raise AssertionError(f"daemon pull: tier {r['timings']['tier_hit']}, digest "
                                 f"{'equal' if r['disk_digest'] == digest else 'differs'}")
        stats = {n: t.call({"op": "node_stats"}) for n, t in (("na", ta), ("nb", tb))}
        tb.close()
        if stats["nb"]["node"]["peer_fetches"] != 1 or stats["na"]["node"]["peer_serves"] != 1:
            raise AssertionError(f"daemon pull: {stats['nb']['node']}, {stats['na']['node']}")
        out["pull"] = {"wall_s": pull_s, "timings": r["timings"], "nbytes": r["nbytes"],
                       "nb": stats["nb"]["node"], "na": stats["na"]["node"],
                       "calibration": stats["nb"]["calibration"]}
        log(f"daemons: nb pulled A from na in {pull_s:.3f} s "
            f"(wire {r['timings']['wire_s']:.3f} s)")
        res = subprocess.run(_client_cmd(out["nb"]["client_sock"], store_dir, device),
                             capture_output=True, text=True, timeout=CLIENT_TIMEOUT_S)
        if res.returncode != 0:
            raise RuntimeError(f"nb's client exited {res.returncode}:\n{res.stderr[-4000:]}")
        client = out["client"] = json.loads(res.stdout.strip().splitlines()[-1])
        if client["tokens_sha1"] != tokens_sha1(want_tokens) or client["tier_hit"] != "host":
            raise AssertionError(f"nb's client: tier {client['tier_hit']}, tokens "
                                 f"{client['tokens_sha1']}")
        if client["launches"] != path_launches(cfg):
            raise AssertionError(f"nb's client: launches {client['launches']}")

        def members():
            return ([n for n, _ in ta.call({"op": "dir.holders", "key": list(KEY_A)})["holders"]],
                    [n for n, _ in ta.call({"op": "dir.nodes"})["nodes"]])

        if any("nb" not in x for x in members()):
            raise AssertionError(f"na's directory does not list nb: {members()}")
        out["shutdown_s"] = {}
        stop("nb")
        if any("nb" in x for x in members()):
            raise AssertionError(f"nb is still in na's directory: {members()}")
        ta.close()
        stop("na")
        leaked = set(glob.glob("/dev/shm/trims_*")) - shm_before
        if leaked:
            raise AssertionError(f"the daemons left segments behind: {sorted(leaked)}")
        log(f"daemons: client open {client['open_s']:.3f} s, attach {client['attach_s']:.3f} s, "
            f"h2d {client['h2d_s']:.3f} s; shutdown {out['shutdown_s']}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for f in errs:
            f.close()
        shutil.rmtree(sockdir, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 9: the SSM, HYBRID, VLM and ENCDEC families
# ---------------------------------------------------------------------------

E2E_PROMPT, E2E_CTX = 64, 128      # phase 9's CPU passes: prompt, ENCDEC source frames


def families_phase(torch, store_dir: Path, device):
    """Models M (mamba2-370m, full width and depth), V (llama-3.2-vision-90b
    at full width, one period of 4 self and 1 gated cross layer), E
    (seamless-m4t-large-v2, full width and depth) and J (jamba-1.5-large-398b
    ``reduced()``, one period, float32) in a store of their own, served by
    the engine with each request's launches counted from 0 and held to its
    path. M: a batch engine's disk and device hits, then a fresh MRM with a
    streaming, prefix-caching engine: a disk hit that takes the batch path
    (no stream opened), a host hit after J's preposition took M's place on
    the card, and a device hit, both prefix hits that leave the stored SSM
    and conv states unchanged; all five requests' tokens equal. J, V and E: disk and device
    hits with equal tokens, J's equal to the CPU plain path's in float32.
    Then float32 prefill logits of M, V and E on the card against the CPU
    plain path, and jamba's sublayers at full width (:func:`jamba_sublayers`).
    Returns (summary, launches by model)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import mrm as mrm_mod
    from repro_torch.core.cache import Tier
    from repro_torch.core.costmodel import get_hardware
    from repro_torch.core.store import DiskStore
    from repro_torch.kernels import ops
    from repro_torch.serving import InferenceEngine

    cfgs = {"M": get_config("mamba2-370m"),
            "V": get_config("llama-3.2-vision-90b").replace(n_layers=5),
            "E": get_config("seamless-m4t-large-v2"),
            "J": get_config("jamba-1.5-large-398b").reduced().replace(
                param_dtype="float32", compute_dtype="float32")}
    disk = DiskStore(str(store_dir))
    t0 = time.perf_counter()
    sizes = {n: publish(torch, disk, c, n, 10 + i, device) for i, (n, c) in enumerate(cfgs.items())}
    log(f"published {json.dumps(sizes)} bytes in {time.perf_counter() - t0:.1f} s")
    hw = get_hardware()
    key = lambda n: mrm_mod.ModelKey("repro-torch", n, "1")  # noqa: E731
    requests = {n: [] for n in cfgs}
    tokens = {n: [] for n in cfgs}

    def gen(engine, name, label, tier, prefill=True):
        cfg = cfgs[name]
        ops.reset_launches()
        out, st = engine.generate(name, prompt(cfg.vocab_size), NEW)
        launches = counts(ops)
        r = {"label": label, **dataclasses.asdict(st), "launches": launches,
             "tokens_sha1": tokens_sha1(out)}
        requests[name].append(r)
        log(json.dumps({"family_request": name, **r}))
        if out.shape != (B, NEW) or out.min() < 0 or out.max() >= cfg.vocab_size:
            raise AssertionError(f"{name} {label}: bad tokens {out.shape} {out.min()}..{out.max()}")
        if tokens[name] and not np.array_equal(out, tokens[name][0]):
            raise AssertionError(f"{name} {label}: tokens differ from the first request's")
        tokens[name].append(out)
        if (st.tier_hit, st.streamed) != (tier, False):
            raise AssertionError(f"{name} {label}: tier {st.tier_hit}, streamed {st.streamed}")
        want = path_launches(cfg, prefill)
        if launches != want:
            raise AssertionError(f"{name} {label}: launches {launches}, path implies {want}")

    batch = InferenceEngine(disk, mrm_mod.MRM(disk, device_capacity=24 * GiB,
                                              host_capacity=24 * GiB, hw=hw, device=device),
                            device=device)
    # (a) M: batch disk and device hits, then a fresh MRM and a streaming,
    # prefix-caching engine whose device tier holds M or J but not both
    gen(batch, "M", "batch disk", "disk")
    gen(batch, "M", "batch device", "device")
    both = sorted((sizes["M"], sizes["J"]))
    mrm = mrm_mod.MRM(disk, device_capacity=both[1] + both[0] // 2,
                      host_capacity=4 * GiB, hw=hw, device=device)
    eng = InferenceEngine(disk, mrm, device=device, streaming=True,
                          prefix_cache_bytes=256 * 2 ** 20)
    gen(eng, "M", "streaming engine, disk", "disk")
    if mrm.stats()["stream_opens"] != 0:
        raise AssertionError(f"M opened a stream: {mrm.stats()['stream_opens']}")
    mrm.prefetch(key("J"), tier="device").result()
    if mrm.resident(key("M"), Tier.DEVICE) or not mrm.resident(key("M"), Tier.HOST):
        raise AssertionError("J's preposition did not leave M in the host tier only")
    pkv = eng.prefix_kv
    (stored,) = [e.payload[1] for e in pkv.tier.entries.values()]
    before = {n: stored["mamba"][n].clone() for n in ("ssm", "conv")}
    gen(eng, "M", "streaming engine, host, prefix hit", "host", prefill=False)
    gen(eng, "M", "streaming engine, device, prefix hit", "device", prefill=False)
    if (pkv.misses, pkv.hits) != (1, 2):
        raise AssertionError(f"M's prefix store: {pkv.stats()}")
    for n, t in before.items():
        if not torch.equal(stored["mamba"][n], t):
            raise AssertionError(f"M's prefix hits wrote into the stored {n} state")
    m_stream_opens = mrm.stats()["stream_opens"]
    del eng, mrm, stored, before

    # (b)-(d) J, V and E through the batch engine
    for name in ("J", "V", "E"):
        gen(batch, name, "batch disk", "disk")
        gen(batch, name, "batch device", "device")
    cpu_j = greedy(torch, cfgs["J"], disk.open(key("J")).read_all(),
                   prompt(cfgs["J"].vocab_size), "cpu")
    if not np.array_equal(cpu_j, tokens["J"][0]):
        raise AssertionError("J's tokens on the card differ from the CPU plain path's")
    del batch
    torch.cuda.empty_cache()

    out = {"sizes": sizes, "m_stream_opens": m_stream_opens,
           "requests": requests, "j_cpu_tokens_equal": True, "end_to_end": {}}
    for name, S, ctx in (("M", PROMPT, None), ("V", E2E_PROMPT, None), ("E", E2E_PROMPT, E2E_CTX)):
        out["end_to_end"][name] = family_end_to_end(torch, disk, name, cfgs[name], device, S, ctx)
    out["jamba_sublayers"] = jamba_sublayers(torch, device)
    launches = {n: {k: sum(r["launches"][k] for r in rs) for k in rs[0]["launches"]}
                for n, rs in requests.items()}
    log(f"families: launches {json.dumps(launches)}")
    return out, launches


def family_end_to_end(torch, disk, name, cfg, device, S, ctx=None):
    """``name``'s prefill logits over the first ``S`` prompt tokens in
    float32 (weights upcast from the published bf16 file), on the card
    against the CPU plain path. The VLM's gates are set to 0.5 and the
    VLM and ENCDEC models get a random frontend (``cfg.n_frontend_tokens``
    or ``ctx`` frames), so that the cross path counts. Tolerance: 1% of
    max |logit|, as phase 6 holds Q; the two devices sum in other orders."""
    from repro_torch.models import model as M
    from repro_torch.serving import to_torch_tree

    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    flat = disk.open(("repro-torch", name, "1")).read_all()
    batch = {"tokens": torch.from_numpy(prompt(cfg.vocab_size)[:, :S]).long()}
    if cfg.family in ("vlm", "encdec"):
        g = torch.Generator().manual_seed(17)
        batch["frontend"] = torch.randn(B, cfg.n_frontend_tokens or ctx, cfg.d_model,
                                        generator=g)

    def run(dev):
        params = _map(to_torch_tree(flat, dev, template=M.init_params(cfg32, device="meta")),
                      lambda t: t.float())
        if cfg.family == "vlm":
            for gate in ("gate_attn", "gate_mlp"):
                params["blocks"]["cross"][gate].fill_(0.5)
        t0 = time.perf_counter()
        logits, _ = M.prefill(cfg32, params, {n: t.to(dev) for n, t in batch.items()}, S)
        logits = logits[:, :cfg.vocab_size].float().cpu()      # not the masked pad
        return logits, time.perf_counter() - t0

    got, card_s = run(device)
    torch.cuda.empty_cache()
    want, cpu_s = run("cpu")
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or got.shape != want.shape or err > 0.01 * scale:
        raise AssertionError(f"{name} end to end, float32: max abs err {err:.4g} "
                             f"vs 1% of {scale:.4g}")
    r = {"prompt": S, "frontend": list(batch["frontend"].shape) if "frontend" in batch else None,
         "max_abs_err_f32": err, "max_abs_logit": scale,
         "argmax_agreement_f32": (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
         "card_pass_s": card_s, "cpu_pass_s": cpu_s}
    log(f"{name} end to end: {json.dumps(r)}")
    return r


def jamba_sublayers(torch, device):
    """Jamba's sublayers at full width (d_model 8192; d_inner 16384, 256 SSM
    heads of 64, d_state 128; 64 query over 8 KV heads of 128, no RoPE) in
    float32: sublayer 0 (Mamba-2 and its dense FFN) and sublayer 7 (attention
    without RoPE, its 16-expert MoE replaced by a dense FFN of the same
    d_ff: the MoE holds 9.7 B parameters, and phase 6 runs full-width MoE),
    weights random on the card. A (B, PROMPT) prefill and 4 decode steps,
    each sublayer's contribution ``x' - x`` on the card against the CPU
    plain path within 1% of its max; the final SSM state likewise."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    cfg = get_config("jamba-1.5-large-398b").replace(
        n_layers=8, n_experts=0, param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator(device=device).manual_seed(23)
    subs = (M._init_mamba_layer(cfg, (), gen, device, with_ffn=True, use_moe=False),
            M._init_attn_layer(cfg, (), gen, device, use_moe=False))
    g = torch.Generator().manual_seed(29)
    xs = [torch.randn(B, PROMPT, cfg.d_model, generator=g)] + \
        [torch.randn(B, 1, cfg.d_model, generator=g) for _ in range(4)]

    def run(dev):
        """[(mamba delta, attention delta) per pass], final SSM state, seconds."""
        pm, pa = (_map(sub, lambda t: t.to(dev)) for sub in subs)
        cache = M.init_cache(cfg, B, PROMPT + 4, dev)
        ml = M.layer_params(M.layer_params(cache["mamba"], 0), 0)
        al = M.layer_params(cache["attn"], 0)
        positions = torch.arange(PROMPT, device=dev)[None, :]
        deltas = []
        t0 = time.perf_counter()
        with torch.inference_mode():
            for step, x in enumerate(xs):
                x = x.to(dev)
                if step == 0:
                    y, _ = M.prefill_mamba_layer(cfg, pm, ml, x)
                    z, _ = M.prefill_attn_layer(cfg, pa, al, x, positions, rope=False)
                else:
                    y, _ = M._mamba_decode(cfg, pm, x, ml)
                    z, _ = M._attn_decode(cfg, pa, x, al, PROMPT + step - 1, rope=False)
                deltas.append(((y - x).cpu(), (z - x).cpu()))
        return deltas, ml["ssm"].cpu(), time.perf_counter() - t0

    ops.reset_launches()
    got, got_ssm, card_s = run(device)
    launches = counts(ops)
    torch.cuda.empty_cache()
    want, want_ssm, cpu_s = run("cpu")
    checks = [(f"{part} pass {step}", a, b) for step, (ga, wa) in enumerate(zip(got, want))
              for part, a, b in zip(("mamba", "attention"), ga, wa)]
    checks.append(("final ssm state", got_ssm, want_ssm))
    errs = []
    for label, a, b in checks:
        scale, err = b.abs().max().item(), (a - b).abs().max().item()
        errs.append({"what": label, "max_abs_err": err, "max_abs": scale})
        if not torch.isfinite(a).all() or err > 0.01 * scale:
            raise AssertionError(f"jamba sublayers, {label}: max abs err {err:.4g} "
                                 f"vs 1% of {scale:.4g}")
    want_launches = {"flash_attention": 1, "decode_attention": 4, "rmsnorm": 4 * 5}
    if launches != want_launches:
        raise AssertionError(f"jamba sublayers: launches {launches}, path implies "
                             f"{want_launches}")
    r = {"worst": max(errs, key=lambda e: e["max_abs_err"] / max(e["max_abs"], 1e-30)),
         "launches": launches, "card_s": card_s, "cpu_s": cpu_s}
    log(f"jamba sublayers at full width: {json.dumps(r)}")
    return r


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# phase 10: training
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_FAIL_AT = 6, 3
TRAIN_BATCH = 2 * TRAIN_B               # 8 sequences of PROMPT tokens a step
RESUME_TOL = 2e-2                       # |loss difference|, resumed vs uninterrupted
FAMILY_TRAIN = (("deepseek-7b", {}), ("qwen3-moe-30b-a3b", {"moe_impl": "capacity"}),
                ("qwen3-moe-30b-a3b", {"moe_impl": "ragged"}), ("mamba2-370m", {}),
                ("jamba-1.5-large-398b", {}), ("llama-3.2-vision-90b", {}),
                ("seamless-m4t-large-v2", {}))


def train_launches(cfg) -> dict:
    """Launches one training step of A implies: each microbatch runs flash
    once per layer and RMSNorm twice per layer (ln1, ln2) in the forward,
    the same again when remat ``"nothing"`` recomputes each layer in the
    backward, plus the final norm once; the backward itself launches no
    kernel (the plain VJPs); decode attention never runs. A layernorm model
    launches no RMSNorm."""
    again = 2 if cfg.remat_policy == "nothing" else 1
    accum = max(1, cfg.grad_accum)
    norms = (2 * cfg.n_layers * again + 1) * accum if cfg.norm_type == "rmsnorm" else 0
    return {"flash_attention": cfg.n_layers * again * accum, "decode_attention": 0,
            "rmsnorm": norms}


class StepMarks:
    """The train step's ``mark`` hook: a CUDA event at each mark, and the
    kernel launches of each step (counts set to 0 at its start)."""

    def __init__(self, torch, ops):
        self.torch, self.ops = torch, ops
        self.steps, self.launches = [], []

    def __call__(self, label):
        if label == "start":
            self.ops.reset_launches()
            self.steps.append([])
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.steps[-1].append((label, ev))
        if label == "optimizer":
            self.launches.append(counts(self.ops))

    def split_ms(self, i) -> dict:
        """Step ``i``'s device time by part: forward (from the step's start
        or the last backward), backward, optimizer."""
        self.torch.cuda.synchronize()
        out = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
        marks = self.steps[i]
        for (_, a), (label, b) in zip(marks, marks[1:]):
            out[label] += a.elapsed_time(b)
        return out


def train_phase(torch, build: Path, device):
    """Phase 10 on model A (deepseek-7b at full width, 4 layers, bf16
    params, float32 moments, remat "nothing", grad_accum 2): (a) the
    float32 gradient check against the CPU, (b) a Trainer run through an
    injected failure against an uninterrupted one, (c) the trained model
    served through the MRM, (d) one float32 step of each family's reduced
    config against the CPU. Returns (summary, launches of one step, the
    uninterrupted run's final parameters on the host)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import Trainer, TrainerConfig
    from repro_torch.runtime import FailureInjector

    cfg = get_config("deepseek-7b").replace(n_layers=4)
    n = cfg.param_count()
    state_bytes = n * (cfg.pdtype.itemsize + 2 * getattr(torch, cfg.opt_moment_dtype).itemsize)
    out = {"model": {"arch": cfg.name, "n_layers": cfg.n_layers, "params": n,
                     "state_bytes": state_bytes, "remat_policy": cfg.remat_policy,
                     "grad_accum": cfg.grad_accum, "param_dtype": cfg.param_dtype,
                     "opt_moment_dtype": cfg.opt_moment_dtype,
                     "batch": [TRAIN_BATCH, PROMPT], "steps": TRAIN_STEPS}}
    t0 = time.perf_counter()
    out["grad_check"] = train_grad_check(torch, cfg, device)
    out["grad_check"]["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # (b) through a failure at step 3 (only the two forced saves write), then
    # the same steps with no failure and no checkpoint
    free = shutil.disk_usage(build).free
    if free < 2.5 * state_bytes:
        raise RuntimeError(f"{build} has {free} bytes free; phase 10 needs 2.5 x {state_bytes}")
    ckpt = build / "smoke_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(batch_size=TRAIN_BATCH, seq_len=PROMPT, steps=TRAIN_STEPS, warmup=2,
              ckpt_every=TRAIN_STEPS + 1, log_every=1)
    t0 = time.perf_counter()
    try:
        marks = StepMarks(torch, ops)
        tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(ckpt), **kw),
                     injector=FailureInjector(fail_at_steps=[TRAIN_FAIL_AT]), device=device,
                     mark=marks)
        # wall seconds of the host snapshot (a synchronous copy from the
        # card), of the background write, and of a restore to the card
        io = {"snapshot_s": [], "write_s": [], "restore_s": [], "init_s": []}
        save, snap = tr.ckpt.save, _timed(tr.ckpt.save, io["snapshot_s"])
        tr.ckpt.save = lambda step, state, meta=None, force=False: (
            snap if force or tr.ckpt.should_save(step) else save)(step, state, meta, force)
        tr.ckpt._write = _timed(tr.ckpt._write, io["write_s"])
        restore = tr.restore_or_init

        def restore_synced():
            r = restore()
            torch.cuda.synchronize()
            return r

        tr.restore_or_init = lambda: _timed(restore_synced, io[
            "restore_s" if any(ckpt.glob("LATEST")) else "init_s"])()
        torch.cuda.reset_peak_memory_stats()
        params = tr.run_with_restarts(max_restarts=1)["params"]
        peak_resumed = torch.cuda.max_memory_allocated()
        ckpt_bytes = {f.parent.name: f.stat().st_size for f in ckpt.glob("step_*/state.trims")}
        saved = sorted(tr.ckpt.saved_steps)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    resumed_s = time.perf_counter() - t0
    resumed = {h["step"]: h for h in tr.history}
    if tr.restarts != 1 or saved != [TRAIN_FAIL_AT, TRAIN_STEPS] or len(io["restore_s"]) != 1 \
            or sorted(resumed) != list(range(TRAIN_STEPS)):
        raise AssertionError(f"restarts {tr.restarts}, saves {saved}, restores "
                             f"{len(io['restore_s'])}, steps {sorted(resumed)}")
    del tr
    torch.cuda.empty_cache()

    straight_marks = StepMarks(torch, ops)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr2 = Trainer(cfg, TrainerConfig(**kw), device=device, mark=straight_marks)
    final = tr2.run()["params"]
    straight_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    straight = {h["step"]: h for h in tr2.history}
    straight_params = {k: t.detach().cpu() for k, t in _leaves(final)}   # phase 11's reference
    del tr2, final
    torch.cuda.empty_cache()

    losses = {"resumed": [resumed[i]["loss"] for i in range(TRAIN_STEPS)],
              "straight": [straight[i]["loss"] for i in range(TRAIN_STEPS)]}
    diff = [abs(a - b) for a, b in zip(losses["resumed"], losses["straight"])]
    if not np.isfinite(losses["resumed"] + losses["straight"]).all():
        raise AssertionError(f"training losses not finite: {losses}")
    if max(diff[TRAIN_FAIL_AT:]) > RESUME_TOL:
        raise AssertionError(f"resumed steps' losses differ from the uninterrupted run's by "
                             f"{max(diff[TRAIN_FAIL_AT:]):.4g} > {RESUME_TOL}: {losses}")
    want = train_launches(cfg)
    for label, m in (("resumed", marks), ("straight", straight_marks)):
        if len(m.launches) != TRAIN_STEPS or any(c != want for c in m.launches):
            raise AssertionError(f"{label} run: launches a step {m.launches}, path implies {want}")
    splits = [straight_marks.split_ms(i) for i in range(1, TRAIN_STEPS)]   # step 0 warms up
    step_s = [straight[i]["step_s"] for i in range(1, TRAIN_STEPS)]
    tokens = TRAIN_BATCH * PROMPT
    out["trainer"] = {
        "losses": losses, "max_loss_diff_resumed_steps": max(diff[TRAIN_FAIL_AT:]),
        "max_loss_diff_first_steps": max(diff[:TRAIN_FAIL_AT]), "resume_tol": RESUME_TOL,
        "grad_norm": [straight[i]["grad_norm"] for i in range(TRAIN_STEPS)],
        "lr": [straight[i]["lr"] for i in range(TRAIN_STEPS)],
        "step_split_ms": {k: statistics.median(s[k] for s in splits) for k in splits[0]},
        "step_split_ms_each": splits, "step_s": step_s,
        "tokens_per_s": tokens / statistics.median(step_s),
        "max_memory_allocated": peak, "max_memory_allocated_with_checkpoints": peak_resumed,
        "checkpoint": {**io, "bytes": ckpt_bytes, "saved_steps": saved},
        "launches_per_step": want, "resumed_run_s": resumed_s, "straight_run_s": straight_s}
    log(f"trainer: {json.dumps(out['trainer'])}")

    t0 = time.perf_counter()
    out["serve"] = serve_trained(torch, cfg, params, build, device)
    out["serve"]["seconds"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["families"] = family_train_steps(torch, device)
    out["families_seconds"] = time.perf_counter() - t0
    return out, want, straight_params


def train_grad_check(torch, cfg, device):
    """(a) One microbatch of A (batch 1, PROMPT tokens) in float32 through
    the card's kernels (the flash SIMT kernel, RMSNorm in float32), its
    loss and every parameter's gradient against the same computation on the
    CPU's plain path (remat "none" there: the same arithmetic, without the
    recompute). Tolerances: the loss within 1e-5 relative; each leaf's
    gradient within 1e-3 of that leaf's largest |grad| (float32 on two
    devices summing in other orders). Every leaf's gradient must be
    nonzero, and the kernels must have run as the path implies."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.train_step import value_and_grad
    from repro_torch.models import model as M

    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator(device=device).manual_seed(31)
    params = M.init_params(cfg32, gen, device=device)
    batch = make_batch(cfg32, 0, 1, PROMPT, device=device)
    ops.reset_launches()
    t0 = time.perf_counter()
    total, metrics, grads = value_and_grad(cfg32, params, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = counts(ops)
    want_launches = {**train_launches(cfg32.replace(grad_accum=1)), "decode_attention": 0}
    if launches != want_launches:
        raise AssertionError(f"gradient check: launches {launches}, path implies {want_launches}")
    got = {n: g.cpu() for n, g in _leaves(grads)}
    del grads
    cpu_params = _map(params, lambda t: t.cpu())
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ctotal, cmetrics, cgrads = value_and_grad(cfg32.replace(remat_policy="none"), cpu_params,
                                              {k: v.cpu() for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    if not (torch.isfinite(total) and abs(total.item() - ctotal.item()) <= 1e-5 * abs(ctotal.item())):
        raise AssertionError(f"gradient check: loss {total.item()} on the card, "
                             f"{ctotal.item()} on the CPU")
    worst = {"leaf": None, "rel": 0.0}
    for name, want in _leaves(cgrads):
        g = got[name]
        scale = want.abs().max().item()
        if g.abs().max().item() == 0 or scale == 0:
            raise AssertionError(f"gradient check: {name} has a zero gradient")
        rel = (g - want).abs().max().item() / scale
        if not torch.isfinite(g).all() or rel > 1e-3:
            raise AssertionError(f"gradient check: {name} differs by {rel:.3g} of its max")
        if rel > worst["rel"]:
            worst = {"leaf": name, "rel": rel, "max_abs_grad": scale}
    r = {"loss_card": total.item(), "loss_cpu": ctotal.item(), "leaves": len(got),
         "worst": worst, "launches": launches, "card_s": card_s, "cpu_s": cpu_s}
    log(f"gradient check: {json.dumps(r)}")
    return r


def serve_trained(torch, cfg, params, build: Path, device):
    """(c) The trained params published into a store and served twice
    through a fresh MRM and engine: a disk hit, then a device hit with one
    disk load; each request's launches counted from 0 and held to its path;
    the tokens equal greedy generation on the trained params in this process."""
    import numpy as np
    from repro_torch.core.costmodel import get_hardware
    from repro_torch.core.mrm import MRM
    from repro_torch.core.store import DiskStore
    from repro_torch.models import model as M
    from repro_torch.serving import InferenceEngine, publish_model

    store = build / "smoke_store_train"
    shutil.rmtree(store, ignore_errors=True)
    try:
        disk = DiskStore(str(store))
        publish_model(disk, cfg, params, name="T")
        toks = prompt(cfg.vocab_size)
        want = M.greedy_generate(cfg, params, {"tokens": torch.as_tensor(
            toks, dtype=torch.long, device=device)}, NEW, PROMPT + NEW).cpu().numpy()
        mrm = MRM(disk, device_capacity=8 * GiB, host_capacity=8 * GiB, hw=get_hardware(),
                  device=device)
        engine = InferenceEngine(disk, mrm, device=device)
        requests = []
        for _ in range(2):
            with launched(torch) as launches:
                got, st = engine.generate("T", toks, NEW)
            requests.append({**dataclasses.asdict(st), "launches": launches,
                             "tokens_sha1": tokens_sha1(got)})
            if not np.array_equal(got, want):
                raise AssertionError("trained model: served tokens differ from greedy "
                                     "generation on the trained params")
            if launches != path_launches(cfg):
                raise AssertionError(f"trained model: launches {launches}, path implies "
                                     f"{path_launches(cfg)}")
        hits = [r["tier_hit"] for r in requests]
        if hits != ["disk", "device"] or mrm.stats()["disk_loads"] != 1:
            raise AssertionError(f"trained model: tier hits {hits}, disk loads "
                                 f"{mrm.stats()['disk_loads']}")
        del engine, mrm
    finally:
        shutil.rmtree(store, ignore_errors=True)
    r = {"requests": requests, "disk_loads": 1}
    log(f"trained model served: {json.dumps(r)}")
    return r


def family_train_steps(torch, device):
    """(d) One float32 train step of each family's ``reduced()`` config
    (DENSE, MoE capacity and ragged, SSM, HYBRID, VLM, ENCDEC; batch the
    larger of 4 and the config's grad_accum, 32 tokens) from the same
    params and batch on the card and on the CPU: loss and grad_norm within
    1e-4 relative (float32, other sum orders, the card's kernels)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.train_step import make_optimizer, make_train_step
    from repro_torch.models import model as M

    out = []
    for arch, over in FAMILY_TRAIN:
        cfg = get_config(arch).reduced().replace(param_dtype="float32",
                                                 compute_dtype="float32", **over)
        bs = max(4, cfg.grad_accum)
        params = M.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
        metrics = {}
        for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
            init, update = make_optimizer(cfg, 1e-3, 2, 10)
            p = _map(params, lambda t: t.to(dev, copy=True))
            _, _, m = make_train_step(cfg, update)(p, init(p), make_batch(cfg, 0, bs, 32,
                                                                          device=dev))
            metrics[where] = {k: v.item() for k, v in m.items()}
        r = {"arch": arch, **over, "family": cfg.family, "batch": bs, **metrics}
        for k in ("loss", "grad_norm"):
            a, b = metrics["card"][k], metrics["cpu"][k]
            if not np.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
                raise AssertionError(f"{arch} {over} train step: {k} {a} on the card, {b} "
                                     f"on the CPU")
        out.append(r)
    log(f"family train steps: {json.dumps(out)}")
    return out


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


# ---------------------------------------------------------------------------
# phase 11: distribution (a device mesh of one card)
# ---------------------------------------------------------------------------

EP_B, EP_S = 2, 512                      # Q's MoE layer: (2, 512) tokens at full width
EP_TOL_BF16 = 1e-2                       # |ep - grouped| <= this x max |grouped| (bf16)
EP_TOL_F32 = 1e-5                        # the same in float32
MESH_TOL = 1e-5                          # |mesh - phase 10| / |phase 10|, each step's loss
                                         # and grad norm (the H100's readings are 0)
MESH_PARAM_TOL = 1e-3                    # per leaf: |mesh - phase 10| <= this x |phase 10 - init|


def mesh_phase(torch, device, train, trained, tokens_a):
    """Phase 11: the distribution layer on a one-rank NCCL group (a
    ``FileStore`` in a temporary directory, no TCP port): (a) A trained as
    phase 10's uninterrupted run through ``Trainer(mesh=...)`` on a (1, 1)
    mesh; (b) the dry run of that step (a subprocess: its fake group never
    shares a process with a real one) against the card's bytes and time;
    (c) A's prefill and 16 greedy decode steps through the mesh step
    factories; (d) Q's MoE layer with ``moe_impl="ep"`` on the mesh against
    the grouped path; (e) the int8 gradient all-reduce over a pod axis of
    one. ``trained``: phase 10's final parameters (host). Returns its
    summary."""
    import tempfile
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config

    tmp = tempfile.mkdtemp(prefix="trims_smoke_pg_")
    dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                            world_size=1)
    out = {}
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        cfg = get_config("deepseek-7b").replace(n_layers=4)
        t0 = time.perf_counter()
        out["train"], state_bytes, peak = mesh_train(torch, cfg, device, mesh, train, trained)
        out["train"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["dryrun"] = mesh_dryrun(cfg, state_bytes, peak, out["train"])
        out["dryrun"]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["serve"], params = mesh_serve(torch, cfg, device, mesh, tokens_a)
        out["serve"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["compression"] = mesh_compression(torch, cfg, device, params)
        out["compression"]["seconds"] = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["ep"] = mesh_ep(torch, device, mesh)
        out["ep"]["seconds"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"mesh: {json.dumps(out)}")
    return out


def mesh_train(torch, cfg, device, mesh, train, trained):
    """(a) Phase 10's uninterrupted run (same data, shapes, steps) with
    ``Trainer(mesh=mesh)``: params and moments DTensors on the (1, 1) mesh,
    AdamW on their local shards. Each step's loss and grad norm within
    ``MESH_TOL`` of phase 10's (the largest differences are printed, and
    whether they are 0); the final parameters against phase 10's
    (``trained``), leaf by leaf, within ``MESH_PARAM_TOL`` of how far that
    leaf moved from the seed-0 draw both runs start from, and the
    parameters must have moved; launches a step equal to phase 10's."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch.train import Trainer, TrainerConfig
    from torch.distributed.tensor import DTensor

    marks = StepMarks(torch, ops)
    kw = dict(batch_size=TRAIN_BATCH, seq_len=PROMPT, steps=TRAIN_STEPS, warmup=2,
              ckpt_every=TRAIN_STEPS + 1, log_every=1)
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, TrainerConfig(**kw), device=device, mark=marks, mesh=mesh)
    res = tr.run()
    peak = torch.cuda.max_memory_allocated()
    leaves = [t for _, t in _leaves(res["params"])] + \
        [t for _, t in _leaves(res["opt"].mu)] + [t for _, t in _leaves(res["opt"].nu)]
    if not all(isinstance(t, DTensor) for t in leaves):
        raise AssertionError("the mesh Trainer's state is not DTensors")
    state_bytes = sum(t.to_local().numel() * t.to_local().element_size() for t in leaves)
    hist = {h["step"]: h for h in tr.history}
    moved = param_agreement(torch, cfg, device, res["params"], trained)
    del tr, res, leaves
    torch.cuda.empty_cache()
    losses = [hist[i]["loss"] for i in range(TRAIN_STEPS)]
    norms = [hist[i]["grad_norm"] for i in range(TRAIN_STEPS)]
    ref = train["trainer"]["losses"]["straight"]
    ref_norms = train["trainer"]["grad_norm"]
    diff = [abs(a - b) for a, b in zip(losses, ref)]
    rel = [d / abs(b) for d, b in zip(diff, ref)]
    ndiff = [abs(a - b) / abs(b) for a, b in zip(norms, ref_norms)]
    if max(rel + ndiff) > MESH_TOL or not np.isfinite(losses + norms).all():
        raise AssertionError(f"mesh losses {losses} vs phase 10's {ref}; grad norms {norms} "
                             f"vs {ref_norms}")
    want = train_launches(cfg)
    if len(marks.launches) != TRAIN_STEPS or any(c != want for c in marks.launches):
        raise AssertionError(f"mesh run: launches a step {marks.launches}, path implies {want}")
    splits = [marks.split_ms(i) for i in range(1, TRAIN_STEPS)]
    step_s = [hist[i]["step_s"] for i in range(1, TRAIN_STEPS)]
    tokens = TRAIN_BATCH * PROMPT
    r = {"losses": losses, "phase10_losses": ref, "max_loss_diff": max(diff),
         "loss_diff_is_zero": max(diff) == 0.0, "step0_loss_equal": losses[0] == ref[0],
         "grad_norms": norms, "phase10_grad_norms": ref_norms,
         "max_loss_rel_diff": max(rel), "max_grad_norm_rel_diff": max(ndiff),
         "grad_norm_diff_is_zero": max(ndiff) == 0.0,
         "tol": MESH_TOL, "params": moved,
         "launches_per_step": want,
         "step_split_ms": {k: statistics.median(s[k] for s in splits) for k in splits[0]},
         "phase10_step_split_ms": train["trainer"]["step_split_ms"],
         "step_s": step_s, "tokens_per_s": tokens / statistics.median(step_s),
         "phase10_tokens_per_s": train["trainer"]["tokens_per_s"],
         "state_bytes": state_bytes, "max_memory_allocated": peak}
    return r, state_bytes, peak


def param_agreement(torch, cfg, device, got, trained) -> dict:
    """Each leaf of the mesh run's final parameters ``got`` against phase
    10's (``trained``, host): |got - trained| <= MESH_PARAM_TOL x
    |trained - init| (L2 norms, float32; init the seed-0 draw both runs
    start from), so a leaf whose update was dropped or misapplied fails,
    and a leaf that did not move must be bit-equal. The parameters must
    have moved: the sum of |trained - init|^2 over the leaves is above 0."""
    from repro_torch.models import init_params

    gen = torch.Generator(device=device).manual_seed(0)
    init = dict(_leaves(init_params(cfg, gen, device=device)))
    worst, moved_sq, n_moved, equal = 0.0, 0.0, 0, True
    for k, t in _leaves(got):
        g = t.full_tensor() if hasattr(t, "full_tensor") else t
        w = trained[k].to(device)
        d = (g.float() - w.float()).norm().item()
        m = (w.float() - init[k].float()).norm().item()
        if d > MESH_PARAM_TOL * m:
            raise AssertionError(f"mesh param {k}: |mesh - phase 10| {d} > {MESH_PARAM_TOL} x "
                                 f"|phase 10 - init| {m}")
        worst = max(worst, d / m if m else 0.0)
        moved_sq, n_moved = moved_sq + m * m, n_moved + (m > 0)
        equal = equal and torch.equal(g, w)
    del init
    if moved_sq <= 0:
        raise AssertionError("the parameters did not move in training")
    return {"leaves": len(trained), "leaves_moved": n_moved, "moved_l2": moved_sq ** 0.5,
            "max_diff_over_moved": worst, "bit_equal": equal, "tol": MESH_PARAM_TOL}


def mesh_dryrun(cfg, state_bytes, peak, trained):
    """(b) ``launch.dryrun.run_cell`` for A's train step on a (1, 1) mesh
    with phase 10's batch, in a subprocess: the predicted bytes of params
    and moments equal to the bytes the card holds for them; the predicted
    peak beside ``max_memory_allocated``; dot FLOPs a step over the
    measured step time as a share of the bf16 peak."""
    code = ("import json, sys; sys.path.insert(0, 'src');"
            "from repro_torch.configs import ShapeCell;"
            "from repro_torch.launch.dryrun import run_cell;"
            f"r = run_cell('deepseek-7b', 'train_4k', False, {{'n_layers': {cfg.n_layers}}}, "
            f"cell=ShapeCell('phase10', {PROMPT}, {TRAIN_BATCH}, 'train'), mesh_shape=(1, 1));"
            "print(json.dumps(r))")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=env)
    if p.returncode != 0:
        raise RuntimeError(f"dry run failed: {p.stderr[-2000:]}")
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    pd = rec["per_device"]
    if pd["state_bytes"] != state_bytes:
        raise AssertionError(f"dry run: params + moments {pd['state_bytes']} bytes predicted, "
                             f"{state_bytes} held on the card")
    step = statistics.median(trained["step_s"])
    flops = rec["op_analysis"]["dot_flops"]
    r = {"state_bytes_predicted": pd["state_bytes"], "state_bytes_card": state_bytes,
         "argument_bytes": pd["argument_bytes"], "peak_predicted": pd["peak_hbm_bytes"],
         "peak_method": pd["peak_method"], "max_memory_allocated": peak,
         "dot_flops_per_step": flops, "step_s": step,
         "dot_tflops_per_s": flops / step / 1e12,
         "share_of_bf16_peak": flops / step / PEAK_BF16,
         "op_analysis": rec["op_analysis"], "run_s": rec["run_s"]}
    log(f"dry run vs card: {json.dumps(r)}")
    return r


def mesh_serve(torch, cfg, device, mesh, tokens_a):
    """(c) A (phase 3's weights: seed 0) placed on the mesh by the rules;
    its prefill and 15 more greedy decode steps through ``make_prefill_step``
    and ``make_decode_step`` under the mesh: tokens equal to phase 3's,
    launches equal to one request of phase 3."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import act_axes, set_mesh
    from repro_torch.launch.train_step import make_decode_step, make_prefill_step
    from repro_torch.models import init_params
    from repro_torch.models import partitioning as part

    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device=device)
    placed = shd.distribute(params, shd.make_param_shardings(cfg, params, mesh))
    toks = torch.as_tensor(prompt(cfg.vocab_size), dtype=torch.long, device=device)
    tok_dt = shd.place(toks, shd.NamedSharding(mesh, shd.batch_leaf_spec(toks, mesh)))
    prefill, decode = make_prefill_step(cfg, PROMPT + NEW), make_decode_step(cfg)
    ops.reset_launches()
    t0 = time.perf_counter()
    with part.activation_axes(*act_axes(mesh)), set_mesh(mesh):
        logits, cache = prefill(placed, {"tokens": tok_dt})
        tok = logits.argmax(-1)
        out = [tok]
        for i in range(NEW - 1):
            logits, cache = decode(placed, cache, tok, PROMPT + i)
            tok = logits.argmax(-1)
            out.append(tok)
    got = torch.stack([t.full_tensor() for t in out], dim=1).cpu().numpy()
    seconds = time.perf_counter() - t0
    launches = counts(ops)
    del cache, logits, placed
    if not np.array_equal(got, tokens_a):
        raise AssertionError("mesh prefill/decode: tokens differ from phase 3's")
    if launches != path_launches(cfg):
        raise AssertionError(f"mesh prefill/decode: launches {launches}, path implies "
                             f"{path_launches(cfg)}")
    return {"launches": launches, "tokens_sha1": tokens_sha1(got), "generate_s": seconds}, params


def mesh_ep(torch, device, mesh):
    """(d) Q's MoE layer at full width (128 experts top 8, d_model 2048,
    (2, 512) tokens): ``moe_impl="ep"`` on the mesh against the grouped
    path, outputs and gradients (of the output's sum, for x and every
    weight) within EP_TOL_BF16 x max |grouped| in bf16 and EP_TOL_F32 x
    max in float32; "ep" run twice gives bit-equal outputs."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import act_axes, set_mesh
    from repro_torch.models import moe as MoE
    from repro_torch.models import partitioning as part

    out = {}
    for dt, tol in (("bfloat16", EP_TOL_BF16), ("float32", EP_TOL_F32)):
        cfg = get_config("qwen3-moe-30b-a3b").replace(param_dtype=dt, compute_dtype=dt)
        gen = torch.Generator(device=device).manual_seed(5)
        p = MoE.init_moe(cfg, (), gen, device)
        x = torch.randn(EP_B, EP_S, cfg.d_model, generator=gen, device=device).to(cfg.cdtype)

        def grads(cfg, p, x):
            leaf = {k: v.detach().requires_grad_() for k, v in p.items()}
            xl = x.detach().requires_grad_()
            o, aux = MoE.apply_moe(cfg, leaf, xl)
            g = torch.autograd.grad(o.float().sum() + aux, [xl, *leaf.values()])
            full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731
            return full(o).detach(), [full(t) for t in g]

        want, gw = grads(cfg.replace(moe_impl="grouped"), p, x)
        sh = shd.make_param_shardings(cfg, {"ffn": p}, mesh)["ffn"]
        pd = {k: shd.place(v, sh[k]) for k, v in p.items()}
        xd = shd.place(x, shd.NamedSharding(mesh, shd.batch_leaf_spec(x, mesh)))
        with part.activation_axes(*act_axes(mesh)), set_mesh(mesh):
            got, gg = grads(cfg.replace(moe_impl="ep"), pd, xd)
            again, _ = grads(cfg.replace(moe_impl="ep"), pd, xd)
        scale = want.abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        gerr = [((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)
                 ).item() for a, b in zip(gg, gw)]
        if err > tol * scale or max(gerr) > tol or not torch.equal(got, again):
            raise AssertionError(f"ep {dt}: output err {err} (max |out| {scale}), grad rel "
                                 f"errs {gerr}, rerun equal {torch.equal(got, again)}")
        out[dt] = {"max_abs_err": err, "max_abs_out": scale, "grad_rel_err": max(gerr),
                   "tol": tol, "rerun_bit_equal": True}
    return out


def mesh_compression(torch, cfg, device, params):
    """(e) ``make_compressed_grad_fn`` over a pod axis of one on a (1, 1, 1)
    mesh, on A's gradients (phase 10's first microbatch, 4 x 512): every
    leaf within scale/2 of the exact gradient that went in (plus half an
    ulp of the result's dtype, the final cast), the tensor handed to
    ``all_gather_into_tensor`` int8; the quantise, gather and sum times."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import model as M
    from repro_torch.runtime import compression as C

    mesh3 = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    wire, pairs = [], []
    gather = dist.all_gather_into_tensor
    quant = C.quantized_allreduce

    times = {"quantise": 0.0, "gather": 0.0, "sum": 0.0}
    clock = {}

    def now():
        torch.cuda.synchronize()
        return time.perf_counter()

    # a leaf's quantise time runs from its call to the gather, its sum time
    # from the gather's end to the call's
    def recording_gather(out, inp, *a, **k):
        wire.append(inp.dtype)
        clock["gather"] = now()
        times["quantise"] += clock["gather"] - clock["call"]
        r = gather(out, inp, *a, **k)
        clock["gathered"] = now()
        times["gather"] += clock["gathered"] - clock["gather"]
        return r

    def recording_quant(x, group):
        clock["call"] = now()
        y = quant(x, group)
        times["sum"] += now() - clock["gathered"]
        pairs.append((x, y))
        return y

    batch = make_batch(cfg, 0, TRAIN_B, PROMPT, device=device)
    fn = C.make_compressed_grad_fn(lambda p, b: M.loss_fn(cfg, p, b)[0], mesh3, "pod")
    dist.all_gather_into_tensor, C.quantized_allreduce = recording_gather, recording_quant
    try:
        fn(params, batch)
    finally:
        dist.all_gather_into_tensor, C.quantized_allreduce = gather, quant
    worst = 0.0
    for x, y in pairs:
        xf = x.float()
        scale = max(xf.abs().max().item() / 127.0, 1e-20)
        ulp = torch.finfo(y.dtype).eps * y.float().abs()
        excess = ((y.float() - xf).abs() - (scale / 2 + ulp / 2)).max().item()
        worst = max(worst, ((y.float() - xf).abs().max().item()) / scale)
        if excess > 0:
            raise AssertionError(f"int8 all-reduce: error exceeds scale/2 by {excess}")
    if not wire or any(d != torch.int8 for d in wire):
        raise AssertionError(f"all_gather_into_tensor got {wire}")
    n_leaves = len(pairs)
    del pairs
    return {"leaves": n_leaves, "wire_dtype": "int8", "max_err_over_scale": worst,
            "times_s": times}


# ---------------------------------------------------------------------------
# phase 12: the paper's proxy zoo (Tables 3 and 4) and the four examples
# ---------------------------------------------------------------------------

ZOO_DEVICE_CAP = 8 * GiB       # VGG16-S4 (6.26 GiB) then leaves room for nothing else
ZOO_HOST_CAP = 20 * GiB        # holds every model (16.0 GiB): evicted ones stay warm there
# |card - CPU| / max |h| of proxy_forward in float32 (TF32 off), and |card -
# float64| / max |h|. Both sides round in float32 and sum each dot of up to
# 14.5k products in their own order, through VGG16-S4's 8 layers; on an H100
# their errors against float64 were 5.1e-5 (card) and 2.7e-5 (CPU), so the
# two differ by at most their sum, 7.8e-5 (5.9e-5 measured)
ZOO_FWD_TOL = 1e-4
ZOO_CHECKED = ("VGG19", "VGG16-S4")   # proxy_forward held against the CPU
ZOO_REOPEN = 2                 # evicted Table 3 models reopened (host hits)


def zoo_specs(scale: float = 1.0):
    """Table 3 at ``scale`` and Table 4's largest of each family."""
    from repro_torch.core.proxyzoo import large_specs, small_specs
    large = {s.name: s for s in large_specs(scale)}
    return small_specs(scale) + [large["AlexNet-S4"], large["VGG16-S4"]]


def drop_page_cache(path) -> None:
    """Write ``path``'s dirty pages back and drop its pages from the page
    cache, so that the next read of it comes from the disk."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def proxy_forward_numpy(arrays, x, dtype="float32"):
    """The JAX package's numpy ``proxy_forward``, on the CPU, in ``dtype``
    (the reference's float32, or float64 to measure float32's error)."""
    import numpy as np
    h = np.asarray(x, dtype)
    for name in sorted(arrays):
        if not name.endswith("_weight"):
            continue
        w = np.asarray(arrays[name], dtype)
        if h.shape[-1] != w.shape[0]:
            h = np.resize(h, (*h.shape[:-1], w.shape[0]))
        h = np.tanh(h @ w)
    return h


def raw_read_s(path) -> float:
    """Seconds to read ``path`` into one 64 MiB buffer, and nothing else."""
    mv = memoryview(bytearray(64 << 20))
    t0 = time.perf_counter()
    with open(path, "rb", buffering=0) as f:
        while f.readinto(mv):
            pass
    return time.perf_counter() - t0


def event_ms(torch, fn, reps: int = 5) -> float:
    """Median device time of ``fn`` between CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def lru_resident(order, sizes, cap):
    """The models an LRU tier of ``cap`` bytes holds after opening ``order``
    (each closed before the next), oldest first."""
    resident = []
    for name in order:
        if name in resident:
            resident.remove(name)
        else:
            while sum(sizes[n] for n in resident) + sizes[name] > cap:
                resident.pop(0)
        resident.append(name)
    return resident


def zoo_phase(torch, store_dir: Path, device):
    """(a) The paper's zoo at its published sizes: every model cold-loaded
    (the no-TrIMS baseline), then opened twice through TrIMS (a disk hit,
    then a device hit on the same storage), run on the card, and freed;
    Table 4's models evict Table 3's from the device tier, and the evicted
    come back as host hits. Then faas_pipeline's scenario over the same
    store at scale 1.0."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core import MRM, TrimsClient, cold_load, free_model, load_model
    from repro_torch.core.proxyzoo import populate_store, proxy_forward
    from repro_torch.core.store import DiskStore

    specs = zoo_specs()
    disk = DiskStore(str(store_dir))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:   # numpy and writes drop the GIL
        keys = {}
        for r in ex.map(lambda s: populate_store(disk, [s]),
                        sorted(specs, key=lambda s: -s.mwmf_bytes)):
            keys.update(r)
    gen_s = time.perf_counter() - t0
    paths = {n: disk.path_for(k) for n, k in keys.items()}
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(drop_page_cache, paths.values()))
    write_s = time.perf_counter() - t0
    sizes = {n: disk.open(k).total_bytes for n, k in keys.items()}
    total = sum(sizes.values())
    log(f"zoo: {len(keys)} models, {total / GiB:.2f} GiB drawn and written in {write_s:.1f} s "
        f"({gen_s:.1f} s before the flush)")

    mrm = MRM(disk, device_capacity=ZOO_DEVICE_CAP, host_capacity=ZOO_HOST_CAP, device=device)
    client = TrimsClient(mrm)
    x = np.random.default_rng(0).standard_normal((1, 64)).astype(np.float32)
    rows, errs, read_s = [], {}, 0.0
    for spec in specs:
        name, key = spec.name, keys[spec.name]
        drop_page_cache(paths[name])
        m = cold_load(disk, key, device=device)
        cold = m.timings
        read_s += cold.disk_read_s + cold.deserialize_s
        del m
        drop_page_cache(paths[name])
        a0 = torch.cuda.memory_allocated()
        m1 = load_model("repro-torch", name, trims=client)
        a1 = torch.cuda.memory_allocated()
        m2 = load_model("repro-torch", name, trims=client)
        a2 = torch.cuda.memory_allocated()
        hits = [m1.timings.tier_hit, m2.timings.tier_hit]
        if hits != ["disk", "device"]:
            raise AssertionError(f"zoo {name}: tier hits {hits}")
        if any(t.device.type != device.type for t in m1.weights.values()):
            raise AssertionError(f"zoo {name}: a weight is not on {device}")
        if any(m2.weights[n].data_ptr() != t.data_ptr() for n, t in m1.weights.items()) \
                or a2 != a1:
            raise AssertionError(f"zoo {name}: the second open allocated "
                                 f"{a2 - a1} bytes or other storage")
        out = proxy_forward(m1.weights, x)
        if out.device.type != device.type or out.dtype != torch.float32 or out.shape[0] != 1 \
                or not torch.isfinite(out).all():
            raise AssertionError(f"zoo {name}: output {out.dtype} {tuple(out.shape)} "
                                 f"on {out.device}")
        fwd_ms = event_ms(torch, lambda: proxy_forward(m1.weights, x))
        if name in ZOO_CHECKED:
            arrays = disk.open(key).read_all()
            got, want = out.cpu().numpy(), proxy_forward_numpy(arrays, x)
            exact = proxy_forward_numpy(arrays, x, "float64")
            del arrays
            rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())  # noqa: E731
            errs[name] = {"card_vs_cpu": rel(got, want), "card_vs_f64": rel(got, exact),
                          "cpu_vs_f64": rel(want, exact)}
            if not max(errs[name]["card_vs_cpu"], errs[name]["card_vs_f64"]) <= ZOO_FWD_TOL:
                raise AssertionError(f"zoo {name}: proxy_forward {errs[name]} of max |h| "
                                     f"from the CPU's, over {ZOO_FWD_TOL}")
        free_model(m2, client)
        free_model(m1, client)
        if mrm.refcount(key) != 0:
            raise AssertionError(f"zoo {name}: refcount {mrm.refcount(key)} after the frees")
        fwd_s = fwd_ms / 1e3
        rows.append({"model": name, "mwmf_bytes": spec.mwmf_bytes, "file_bytes": sizes[name],
                     "cold_disk_read_s": cold.disk_read_s,
                     "cold_deserialize_s": cold.deserialize_s,
                     "cold_h2d_measured_s": cold.h2d_measured_s, "cold_total_s": cold.total_s,
                     "trims": [{"tier": t.timings.tier_hit, "total_s": t.timings.total_s}
                               for t in (m1, m2)],
                     "forward_ms": fwd_ms, "alloc_bytes": a1 - a0,
                     "cold_over_warm": (cold.total_s + fwd_s) / (m2.timings.total_s + fwd_s)})
        del m1, m2, out
    order = [s.name for s in specs]
    predicted = lru_resident(order, sizes, ZOO_DEVICE_CAP)
    resident = [n for n in order if mrm.device.peek(keys[n]) is not None]
    if sorted(resident) != sorted(predicted):
        raise AssertionError(f"device tier holds {resident}, LRU predicts {predicted}")
    evicted = [n for n in order[:37] if n not in predicted]
    reopen = []
    for name in evicted[:ZOO_REOPEN]:
        m = load_model("repro-torch", name, trims=client)
        reopen.append({"model": name, "tier": m.timings.tier_hit, "total_s": m.timings.total_s})
        if m.timings.tier_hit != "host":
            raise AssertionError(f"zoo {name}: evicted, reopened as a {m.timings.tier_hit} hit")
        free_model(m, client)
    st = mrm.stats()
    for name, key in keys.items():
        for tier in (mrm.device, mrm.host):
            e = tier.peek(key)
            if e is not None and e.refcount != 0:
                raise AssertionError(f"zoo {name}: {tier.tier.name} refcount {e.refcount}")
    # did dropping the page cache take: VGG16-S4 read raw, dropped, then warm
    path = paths["VGG16-S4"]
    drop_page_cache(path)
    dropped_read = raw_read_s(path) / (sizes["VGG16-S4"] / 1e9)
    warm_read = raw_read_s(path) / (sizes["VGG16-S4"] / 1e9)
    cold_read = read_s / (total / 1e9)
    fs = subprocess.run(["stat", "-f", "-c", "%T", str(store_dir)], capture_output=True,
                        text=True, timeout=60).stdout.strip()
    out = {"models": rows, "reopened": reopen, "device_resident": resident,
           "evicted_from_device": mrm.device.evictions, "demotions": mrm.tiers.demotions,
           "disk_loads": st["disk_loads"], "opens": st["opens"], "forward_err": errs,
           "forward_tol": ZOO_FWD_TOL, "total_bytes": total, "draw_s": gen_s,
           "write_s": write_s, "write_s_per_gb": write_s / (total / 1e9),
           "cold_load_read_s_per_gb": cold_read, "raw_read_dropped_s_per_gb": dropped_read,
           "raw_read_warm_s_per_gb": warm_read, "page_cache_dropped": dropped_read > 1.5 * warm_read,
           "filesystem": fs}
    del mrm, client
    torch.cuda.empty_cache()
    log(f"zoo: {len(rows)} models served cold and through TrIMS; reopened {reopen}; "
        f"cold_load read {cold_read:.3f} s/GB; {path} read raw {dropped_read:.3f} s/GB "
        f"dropped, {warm_read:.3f} warm ({fs})")
    out["faas"] = zoo_faas(torch, disk, device)
    return out


class spying:
    """Record each call of ``owner.attr`` (its arguments, result and
    seconds) while in the ``with`` block."""

    def __init__(self, owner, attr):
        self.owner, self.attr, self.calls = owner, attr, []

    def __enter__(self):
        orig = self.orig = getattr(self.owner, self.attr)

        def wrapper(*a, **k):
            t0 = time.perf_counter()
            r = orig(*a, **k)
            self.calls.append((a, r, time.perf_counter() - t0))
            return r

        setattr(self.owner, self.attr, wrapper)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.orig)


def example(name: str):
    """``examples_torch/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def zoo_faas(torch, disk, device):
    """faas_pipeline's scenario over the zoo's store (scale 1.0): two
    tenants share AlexNet (one disk load), the scene container may load
    ResNet50 only; per-invocation seconds and tier hits."""
    from repro_torch.core import ModelKey, faas
    with spying(faas.FaaSPlatform, "invoke") as invokes, \
            spying(faas.Container, "load_model") as loads:
        r = example("faas_pipeline").run(device=str(device), disk=disk)
    plat = r["platform"]
    alex = ModelKey("repro-torch", "AlexNet", "1")
    tiers = [(a[0].fn_name, a[2], m.timings.tier_hit, m.nbytes) for a, m, _ in loads]
    ptrs = [{n: t.data_ptr() for n, t in m.weights.items()}
            for (c, fw, nm, *_), m, _ in loads if nm == "AlexNet"]
    if r["stats"]["disk_loads"] != 3 or sum(1 for t in tiers if t[1] == "AlexNet") != 2 \
            or [t[2] for t in tiers if t[1] == "AlexNet"] != ["disk", "device"] \
            or len(ptrs) != 2 or ptrs[0] != ptrs[1]:
        raise AssertionError(f"FaaS: disk loads {r['stats']['disk_loads']}, loads {tiers}")
    if tiers[0][3] != disk.open(alex).total_bytes:
        raise AssertionError(f"FaaS: AlexNet of {tiers[0][3]} bytes")
    try:
        plat.containers["scene"].load_model("repro-torch", "AlexNet")
        raise AssertionError("FaaS: the scene container loaded AlexNet")
    except faas.IsolationError:
        pass
    for c in plat.containers.values():
        c.teardown()
    if r["mrm"].refcount(alex) != 0:
        raise AssertionError("FaaS: AlexNet referenced after teardown")
    out = {"output": r["output"], "disk_loads": r["stats"]["disk_loads"],
           "opens": r["stats"]["opens"], "alexnet_refcount": r["alexnet_refcount"],
           "alexnet_bytes": tiers[0][3],
           "invocations": [{"function": a[1], "s": dt} for a, _, dt in invokes],
           "loads": [{"function": f, "model": n, "tier": t, "s": dt}
                     for (f, n, t, _), (_, _, dt) in zip(tiers, loads)]}
    del r, plat
    torch.cuda.empty_cache()
    return out


def example_kernel_checks(torch):
    """Each kernel at the shapes the examples give it, against its plain
    version (``check_close``): reduced olmo and deepseek (4 heads of 16,
    d_model 64; prompt 32, a cache of 40) and train_small's olmo (4 heads
    of 32, batch 4 x 64)."""
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import rmsnorm as kr
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    errs = {"flash_attention": 0.0, "decode_attention": 0.0, "rmsnorm": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for (b, s, h, d) in ((2, 32, 4, 16), (4, 64, 4, 32)):
            q, k, v = (rnd(b, s, h, d, dtype=dtype) for _ in range(3))
            e = check_close(torch, "flash", kf.flash_attention(q, k, v, causal=True),
                            kf.flash_attention_plain(q, k, v, causal=True), dtype, (b, s, h, d))
            errs["flash_attention"] = max(errs["flash_attention"], e)
        q = rnd(2, 4, 16, dtype=dtype)
        kc, vc = rnd(2, 40, 4, 16, dtype=dtype), rnd(2, 40, 4, 16, dtype=dtype)
        for lens in ((33, 33), (36, 39)):
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            e = check_close(torch, "decode", kd.decode_attention(q, kc, vc, kv_len),
                            kd.decode_attention_plain(q, kc, vc, kv_len), dtype, lens)
            errs["decode_attention"] = max(errs["decode_attention"], e)
        for shape in ((2, 32, 64), (2, 1, 64)):
            x, sc = rnd(*shape, dtype=dtype), rnd(64, dtype=dtype) + 1
            e = check_close(torch, "rmsnorm", kr.rmsnorm(x, sc, 1e-6),
                            kr.rmsnorm_plain(x, sc, 1e-6), dtype, shape)
            errs["rmsnorm"] = max(errs["rmsnorm"], e)
    return errs


def examples_phase(torch, work: Path, device):
    """(b) The four examples on the card, each with its defaults (stores
    and checkpoints under ``work``), launches counted from 0 for each and
    held to its paths: quickstart and faas_pipeline none; serve_llm 16
    requests (4 cold, 4 through TrIMS, 8 on the worker pool) of batch 2,
    prompt 32, 8 new tokens; train_small's steps and one request."""
    from repro_torch.configs import get_config
    from repro_torch.core import DiskStore
    from repro_torch.kernels import ops

    errs = example_kernel_checks(torch)
    none = {"flash_attention": 0, "decode_attention": 0, "rmsnorm": 0}
    runs, launches, want = {}, {}, {}

    ops.reset_launches()
    r = example("quickstart").run(device=str(device), disk=DiskStore(str(work / "quickstart")))
    launches["quickstart"], want["quickstart"] = counts(ops), none
    runs["quickstart"] = {"tiers": [m.timings.tier_hit for m in r["trims"]], "stats": r["stats"],
                          "cold_s": r["cold"].timings.total_s,
                          "trims_s": [m.timings.total_s for m in r["trims"]]}
    if runs["quickstart"]["tiers"] != ["disk", "device"]:
        raise AssertionError(f"quickstart: tier hits {runs['quickstart']['tiers']}")
    for m in r["trims"]:
        r["client"].close(m.handle)
    del r

    ops.reset_launches()
    r = example("faas_pipeline").run(device=str(device), disk=DiskStore(str(work / "faas")))
    launches["faas_pipeline"], want["faas_pipeline"] = counts(ops), none
    runs["faas_pipeline"] = {"output": r["output"], "disk_loads": r["stats"]["disk_loads"],
                             "alexnet_refcount": r["alexnet_refcount"]}
    if (r["stats"]["disk_loads"], r["alexnet_refcount"]) != (3, 2):
        raise AssertionError(f"faas_pipeline: {runs['faas_pipeline']}")
    for c in r["platform"].containers.values():
        c.teardown()
    del r

    for arch in ("olmo-1b", "deepseek-7b"):
        tag = f"serve_llm {arch}"
        with launched(torch) as launches[tag]:
            r = example("serve_llm").run(arch=arch, device=str(device),
                                         disk=DiskStore(str(work / "serve")))
        n = sum(len(v) for v in r["served"].values()) + len(r["concurrent"])
        one = path_launches(get_config(arch).reduced(), new=8)
        want[tag] = {k: n * v for k, v in one.items()}
        tiers = {k: [st.tier_hit for _, st in v] for k, v in r["served"].items()}
        runs[tag] = {"tiers": tiers, "requests": n, "concurrent_ok": r["concurrent_ok"],
                     "disk_loads": r["disk_loads"],
                     "tokens": r["served"]["TrIMS"][0][0][0][:8].tolist()}
        first = r["served"]["baseline(cold)"][0][0]
        if tiers["TrIMS"] != ["disk"] + ["device"] * 3 or r["concurrent_ok"] != 8 \
                or r["disk_loads"] != 1 or not all(
                    (out == first).all() for v in r["served"].values() for out, _ in v) \
                or not all((q.result == first).all() for q in r["concurrent"]):
            raise AssertionError(f"{tag}: {runs[tag]}")
        del r

    with launched(torch) as launches["train_small"]:
        r = example("train_small").run(device=str(device), root=str(work / "train"))
    steps = len(r["history"])
    step, serve = train_launches(r["cfg"]), path_launches(r["cfg"], new=8)
    want["train_small"] = {k: steps * step[k] + serve[k] for k in step}
    runs["train_small"] = {"restarts": r["restarts"], "steps": steps, "first_loss": r["losses"][0],
                           "last_loss": r["losses"][-1], "tier": r["stats"].tier_hit,
                           "tokens": r["tokens"][0].tolist()}
    if r["restarts"] != 1 or steps != 60 or not r["losses"][-1] < r["losses"][0]:
        raise AssertionError(f"train_small: {runs['train_small']}")
    del r
    torch.cuda.empty_cache()

    if launches != want:
        raise AssertionError(f"examples' launches {launches}, paths imply {want}")
    return {"runs": runs, "launches": launches, "kernel_max_abs_err": errs}


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
        t0 = time.perf_counter()
        engine, launches, summary, tokens_a = serve_phase(
            torch, store_dir, get_config("deepseek-7b"), device, caps)
        log(f"phase 3 passed in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        e2e = end_to_end_phase(torch, engine)
        log(f"phase 4 passed in {time.perf_counter() - t0:.1f} s")
        # 5. stream and prefix
        batch_disk_hit = next(s for s in engine.stats if s.model == "A")
        del engine
        t0 = time.perf_counter()
        stream = stream_phase(torch, store_dir, device, caps, tokens_a, batch_disk_hit)
        log(f"phase 5 passed in {time.perf_counter() - t0:.1f} s")

        # 6. MoE: qwen3-moe-30b-a3b at full width (d_model 2048, 32 query and 4
        # KV heads of 128, QK-norm, 128 experts top 8 of d_ff 768, vocab
        # 151936), cut to 2 layers, in a store of its own
        moe_dir = ROOT / "build" / "smoke_store_moe"
        shutil.rmtree(moe_dir, ignore_errors=True)
        try:
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            moe_engine, moe = moe_phase(torch, moe_dir, get_config("qwen3-moe-30b-a3b").replace(
                n_layers=2), device, (8 * GiB, 8 * GiB))
            moe["end_to_end"] = moe_end_to_end(torch, moe_engine, device)
            del moe_engine
            log(f"phase 6 passed in {time.perf_counter() - t0:.1f} s")
        finally:
            shutil.rmtree(moe_dir, ignore_errors=True)

        # 6b. latent attention: model L, Moonlight-16B-A3B at full width, 3 layers
        moon_dir = ROOT / "build" / "smoke_store_moon"
        shutil.rmtree(moon_dir, ignore_errors=True)
        try:
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            moon = moon_phase(torch, moon_dir, device, (8 * GiB, 8 * GiB))
            log(f"phase 6b passed in {time.perf_counter() - t0:.1f} s")
        finally:
            shutil.rmtree(moon_dir, ignore_errors=True)

        # 7. the CLOUD tier, cross-process sharing and FaaS, over phase 3's store
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cloud = cloud_phase(torch, store_dir, cloud_dir, device, caps, tokens_a)
        ipc = ipc_phase(torch, store_dir, device, caps, tokens_a)
        faas = faas_phase(torch, store_dir, device, caps, tokens_a)
        log(f"phase 7 passed in {time.perf_counter() - t0:.1f} s")

        # 8. the cluster layer, over phase 3's store and phase 7's object store
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cluster = cluster_phase(torch, store_dir, cloud_dir, device, caps, tokens_a)
        cluster["phase_s"] = time.perf_counter() - t0
        log(f"phase 8 passed in {cluster['phase_s']:.1f} s")
    finally:
        for d in (store_dir, cloud_dir):
            shutil.rmtree(d, ignore_errors=True)

    # 9. the SSM, HYBRID, VLM and ENCDEC families, in a store of their own
    fam_dir = ROOT / "build" / "smoke_store_fam"
    shutil.rmtree(fam_dir, ignore_errors=True)
    try:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        families, fam_launches = families_phase(torch, fam_dir, device)
        families["phase_s"] = time.perf_counter() - t0
        log(f"phase 9 passed in {families['phase_s']:.1f} s")
    finally:
        shutil.rmtree(fam_dir, ignore_errors=True)

    # 10. training
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train, step_launches, trained = train_phase(torch, ROOT / "build", device)
    train["phase_s"] = time.perf_counter() - t0
    log(f"phase 10 passed in {train['phase_s']:.1f} s")
    q_launches = {k: sum(x[k] for x in moe["launches"]) for k in moe["launches"][0]}

    # 11. distribution: a device mesh of one card
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh = mesh_phase(torch, device, train, trained, tokens_a)
    del trained
    mesh["phase_s"] = time.perf_counter() - t0
    log(f"phase 11 passed in {mesh['phase_s']:.1f} s")

    # 12. the paper's proxy zoo at its published sizes, and the four examples
    zoo_dir, ex_dir = ROOT / "build" / "smoke_store_zoo", ROOT / "build" / "smoke_examples"
    for d in (zoo_dir, ex_dir):
        shutil.rmtree(d, ignore_errors=True)
    try:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        zoo = zoo_phase(torch, zoo_dir, device)
        zoo["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        examples = examples_phase(torch, ex_dir, device)
        examples["phase_s"] = time.perf_counter() - t0
        log(f"phase 12 passed in {zoo['phase_s'] + examples['phase_s']:.1f} s "
            f"(zoo {zoo['phase_s']:.1f} s)")
    finally:
        for d in (zoo_dir, ex_dir):
            shutil.rmtree(d, ignore_errors=True)

    table = []
    for name, (source, replaces) in SOURCES.items():
        k = kern[name]
        table.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "launches": launches[name], "q_launches": q_launches[name],
                      "train_launches": step_launches[name],
                      "examples_launches": sum(x[name] for x in examples["launches"].values()),
                      **{m.lower() + "_launches": fam_launches[m][name] for m in fam_launches},
                      "max_abs_err": k["max_abs_err"],
                      "ms": k["ms"], "kernel_ms": k["ms"], "plain_ms": k["plain_ms"],
                      "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                      "library_ms": k["library_ms"],
                      **{x: y for x, y in k.items() if x not in (
                          "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                          "max_abs_err")}})
    table.append({"name": "mla_decode", "route": "cuda",
                  "source": "src/repro_torch/csrc/mla_decode.cu", "replaces": None, "moon_launches": moon["launches"][1]["mla_decode"],
                  **kern["mla_decode"]})
    if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.") for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "kernels": table, "serve": summary, "end_to_end": e2e,
             "stream": stream, "moe": moe, "moon": moon, "cloud": cloud, "ipc": ipc, "faas": faas,
             "cluster": cluster, "families": families, "train": train, "mesh": mesh,
             "zoo": zoo, "examples": examples,
             "build_seconds": _lib.build_seconds, "first_port_ms": FIRST_PORT_MS}, indent=1))
    print(json.dumps({"stream": stream}))
    print(json.dumps({"moe": moe}))
    print(json.dumps({"moon": moon}))
    print(json.dumps({"ipc": ipc}))
    print(json.dumps({"cloud": cloud}))
    print(json.dumps({"faas": faas}))
    print(json.dumps({"cluster": cluster}))
    print(json.dumps({"families": families}))
    print(json.dumps({"train": train}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"zoo": zoo}))
    print(json.dumps({"examples": examples}))
    print(json.dumps({"first_port_ms": FIRST_PORT_MS}))
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
