#!/usr/bin/env python3
"""Drive the PyTorch port of TrIMS on one NVIDIA card, end to end.

    python3 chip_smoke.py [--out results.json]

Run from the root of a checkout. Phases, each of which raises on failure
(the script then exits non-zero and prints no result):

1. Device: the card's name and power limit; build (or load) the CUDA kernel
   library from ``src/repro_torch/csrc``.
2. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the serving path's shapes (bf16 and fp32), at GQA shapes,
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

The last lines are the first port's attention kernel times (constants,
labelled ``first_port_ms``), the kernel table as JSON, the card's name and
power limit as ``nvidia-smi`` prints them, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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
    for dtype in (torch.bfloat16, torch.float32):
        # flash: slice prefill (MHA), GQA (mistral-nemo heads), ragged S/T
        for (b, s, t, hq, hkv, d, causal) in ((B, PROMPT, PROMPT, 32, 32, 128, True),
                                              (B, PROMPT, PROMPT, 32, 8, 128, True),
                                              (1, 200, 200, 32, 8, 128, True),
                                              (2, 130, 70, 32, 8, 128, False)):
            q, k, v = rnd(b, s, hq, d, dtype=dtype), rnd(b, t, hkv, d, dtype=dtype), \
                rnd(b, t, hkv, d, dtype=dtype)
            e = check_close(torch, "flash", kf.flash_attention(q, k, v, causal=causal),
                            kf.flash_attention_plain(q, k, v, causal=causal), dtype,
                            (b, s, t, hq, hkv, d, causal))
            if (s, hkv, dtype) == (PROMPT, 32, torch.bfloat16):
                errs["flash_attention"].append(e)
        # decode: slice cache (2, 528, 32, 128), GQA, ragged T, kv_len 0 -> zeros
        T = PROMPT + NEW
        for (b, t, hq, hkv, d, lens) in ((B, T, 32, 32, 128, (T - 1, PROMPT + 1)),
                                         (B, T, 32, 8, 128, (T, 1)),
                                         (3, 300, 32, 8, 128, (0, 299, 300))):
            q = rnd(b, hq, d, dtype=dtype)
            kc, vc = rnd(b, t, hkv, d, dtype=dtype), rnd(b, t, hkv, d, dtype=dtype)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            e = check_close(torch, "decode", kd.decode_attention(q, kc, vc, kv_len),
                            kd.decode_attention_plain(q, kc, vc, kv_len), dtype,
                            (b, t, hq, hkv, d, lens))
            if (hkv, dtype) == (32, torch.bfloat16):
                errs["decode_attention"].append(e)
        edge_cases(torch, kd, kf, rnd, dtype, dev)
        # rmsnorm: prefill and decode rows of d_model, head-norm rows, a ragged shape
        for shape, eps in (((B, PROMPT, 4096), 1e-5), ((B, 1, 4096), 1e-5),
                           ((B, 7, 32, 128), 1e-6), ((17, 96), 1e-5)):
            x, sc = rnd(*shape, dtype=dtype), rnd(shape[-1], dtype=dtype) + 1
            e = check_close(torch, "rmsnorm", kr.rmsnorm(x, sc, eps),
                            kr.rmsnorm_plain(x, sc, eps), dtype, (shape, eps))
            if shape[-1] == 4096 and dtype == torch.bfloat16:
                errs["rmsnorm"].append(e)
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

    # rmsnorm at the prefill rows (2, 512, 4096) and the decode rows (2, 1, 4096);
    # "cold" rotates (x, scale) over copies that pass twice the L2
    out["rmsnorm"] = {"shape": [B, PROMPT, 4096]}
    for pre, rows in (("", PROMPT), ("decode_rows_", 1)):
        x, sc = rnd(B, rows, 4096, dtype=bf), rnd(4096, dtype=bf) + 1
        sets = cold_copies(torch, lambda: (rnd(B, rows, 4096, dtype=bf),
                                           rnd(4096, dtype=bf) + 1), (x.numel() + 4096) * 2)
        out["rmsnorm"].update({
            pre + "ms": time_ms(torch, lambda: kr.rmsnorm(x, sc, 1e-5)),
            pre + "cold_ms": time_ms(torch, [lambda a=a: kr.rmsnorm(*a, 1e-5) for a in sets]),
            pre + "call_ms": call_ms(torch, lambda: kr.rmsnorm(x, sc, 1e-5)),
            pre + "plain_ms": time_ms(torch, lambda: kr.rmsnorm_plain(x, sc, 1e-5)),
            pre + "library_ms": time_ms(torch, lambda: F.rms_norm(x, (4096,), weight=sc,
                                                                  eps=1e-5)),
            pre + "cold_library_ms": time_ms(torch, [lambda a=a: F.rms_norm(
                a[0], (4096,), weight=a[1], eps=1e-5) for a in sets]),
            pre + "library_call_ms": call_ms(torch, lambda: F.rms_norm(x, (4096,), weight=sc,
                                                                       eps=1e-5)),
            pre + "cold_copies": len(sets)})
        out["rmsnorm"][pre + "bound_ms"], out["rmsnorm"][pre + "bound_by"] = bound(
            2 * x.numel() * 2 + 4096 * 2, 4 * x.numel())
        del sets
    for name, e in errs.items():
        out[name]["max_abs_err"] = max(e)
    return out


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


def path_launches(n_layers: int, prefill: bool = True) -> dict:
    """Launches one request of batch 2 implies: flash once per layer,
    decode once per layer and decode step, rmsnorm twice per layer plus the
    final norm for every position that gives a token; a prefix hit runs no
    prefill."""
    steps = NEW if prefill else NEW - 1
    return {"flash_attention": n_layers if prefill else 0,
            "decode_attention": n_layers * (NEW - 1),
            "rmsnorm": (2 * n_layers + 1) * steps}


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
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in ops.KERNEL_MODULES}

    if mrm.stats()["disk_loads"] != disk_loads:
        raise AssertionError("the workers reloaded A from disk")
    if len(seen) != 4 or any(s != device_ptrs for s in seen):
        raise AssertionError("handles of A do not share one device copy")
    for out in (x for v in results.values() for x in v):
        if out.shape != (B, NEW) or out.min() < 0 or out.max() >= base.vocab_size:
            raise AssertionError(f"bad tokens {out.shape} {out.min()}..{out.max()}")

    per_request = [path_launches(cfgs[s.model].n_layers) for s in stats]
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
        launches.append({m.__name__.rsplit(".", 1)[1]: m.launches
                         for m in ops.KERNEL_MODULES})
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

    want = [path_launches(n_layers), path_launches(n_layers),
            path_launches(n_layers, prefill=False)]
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
    args = ap.parse_args()
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
    shutil.rmtree(store_dir, ignore_errors=True)
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
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)

    table = []
    for name, (source, replaces) in SOURCES.items():
        k = kern[name]
        table.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "launches": launches[name], "max_abs_err": k["max_abs_err"],
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
             "stream": stream,
             "build_seconds": _lib.build_seconds, "first_port_ms": FIRST_PORT_MS}, indent=1))
    print(json.dumps({"stream": stream}))
    print(json.dumps({"first_port_ms": FIRST_PORT_MS}))
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
