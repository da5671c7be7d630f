#!/usr/bin/env python3
"""Drive the PyTorch port of TrIMS on one NVIDIA card, end to end.

    python3 chip_smoke.py [--out results.json]

Run from the root of a checkout. Phases, each of which raises on failure
(the script then exits non-zero and prints no result):

1. Device: the card's name and power limit; build (or load) the CUDA kernel
   library from ``src/repro_torch/csrc``.
2. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the serving path's shapes (bf16 and fp32), at a GQA shape
   and at ragged lengths; then CUDA-event timings of the kernel, its plain
   version and one PyTorch library call as a yardstick (the port never
   calls it).
3. Serve (the main path): a full-width deepseek-7b (4 and 2 layers, random
   weights from a seed, bf16) is published three times into a store and
   served through the MRM and the inference engine with device and host
   capacities that force eviction and D2H demotion, then by two concurrent
   workers that must share one device copy. Kernel launch counts are set to
   0 before this phase and read after it.
4. End to end: model A's prefill logits on the card (kernels, bf16) against
   the port's plain path on the CPU (float32 weights upcast from the same
   file).

The last lines are the kernel table as JSON, the card's name and power
limit as ``nvidia-smi`` prints them, and ``{"ok": true, "device": ...}``.
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
    between CUDA events, the median replay divided by ``reps``. The inputs
    stay in L2 across calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the default stream, as capture needs
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
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


def call_ms(torch, fn, reps: int = 50) -> float:
    """Time per call issued back to back from Python, in ms (CUDA events
    around the loop): the larger of the host's cost to issue a call and the
    device's to run it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


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

    x, sc = rnd(B, PROMPT, 4096, dtype=bf), rnd(4096, dtype=bf) + 1
    xd = rnd(B, 1, 4096, dtype=bf)
    out["rmsnorm"] = dict(
        ms=time_ms(torch, lambda: kr.rmsnorm(x, sc, 1e-5)),
        call_ms=call_ms(torch, lambda: kr.rmsnorm(x, sc, 1e-5)),
        plain_ms=time_ms(torch, lambda: kr.rmsnorm_plain(x, sc, 1e-5)),
        library_ms=time_ms(torch, lambda: F.rms_norm(x, (4096,), weight=sc, eps=1e-5)),
        shape=[B, PROMPT, 4096],
        decode_rows_ms=time_ms(torch, lambda: kr.rmsnorm(xd, sc, 1e-5)),
        decode_rows_call_ms=call_ms(torch, lambda: kr.rmsnorm(xd, sc, 1e-5)),
        decode_rows_library_ms=time_ms(torch, lambda: F.rms_norm(xd, (4096,), weight=sc,
                                                                 eps=1e-5)))
    out["rmsnorm"]["bound_ms"], out["rmsnorm"]["bound_by"] = bound(
        2 * x.numel() * 2 + 4096 * 2, 4 * x.numel())
    out["rmsnorm"]["decode_rows_bound_ms"] = bound(2 * xd.numel() * 2 + 4096 * 2,
                                                   4 * xd.numel())[0]
    for name, e in errs.items():
        out[name]["max_abs_err"] = max(e)
    return out


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

    # launches the path implies: per request flash n_layers, decode
    # n_layers x (NEW - 1), rmsnorm (2 n_layers + 1) x NEW
    layers = [cfgs[s.model].n_layers for s in stats]
    want = {"flash_attention": sum(layers),
            "decode_attention": sum(n * (NEW - 1) for n in layers),
            "rmsnorm": sum((2 * n + 1) * NEW for n in layers)}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, path implies {want}")
    log(f"main path: {len(stats)} requests in {main_s:.2f} s; launches {json.dumps(launches)}")
    summary = {"tier_hits": hits, "demotions": mrm.tiers.demotions,
               "demotion_saved_reloads": st["demotion_saved_reloads"],
               "disk_loads": disk_loads, "main_path_s": main_s, "sizes": sizes,
               "h2d_bw": hw.h2d_bw, "d2h_bw": hw.d2h_bw,
               "requests": [dataclasses.asdict(s) for s in stats]}
    return engine, launches, summary


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
        engine, launches, summary = serve_phase(
            torch, store_dir, get_config("deepseek-7b"), device, (3 * GiB, int(4.5 * GiB)))
        e2e = end_to_end_phase(torch, engine)
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
             "build_seconds": _lib.build_seconds}, indent=1))
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
