#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits nonzero):

1. build   — compile the CUDA kernels from ``src/repro_torch/csrc`` (one
             ``nvcc`` per source, started together) and print the seconds.
2. kernels — hold each kernel against its plain PyTorch version on the card
             (f32 at 2e-5, bf16 at 2e-2), at the serving shapes and at
             D 20, ragged ``kv_start``, filler rows and a window; the paged
             decode kernel at the paged serving shape (scrambled table,
             trash tail) and BITWISE against the contiguous decode kernel
             on the same logical keys (gathered, left-padded with
             ``kv_start``, block sizes 16 and 48, D 20, a window); the
             prefill kernel with ``kv_len`` at a chunk shape.  The SSD scan
             kernel (f32 at 2e-4, bf16 at 2e-2) at the zamba2-2.7b serving
             shape with ``start``, at S 200, 1 and 64 (chunk 128), G 2
             over 4 heads, a given ``h0`` and the zamba2-smoke shape, and
             BITWISE: one row's y and final state after left pads of 0, 31
             and 415 with ``start``.  Kernels 1 and 2 at the shared
             attention's (32, 32, 80).  The WKV kernel against its plain
             chunked version and the plain scan (f32 at 5e-4, bf16 at
             2e-2) at the
             rwkv6-1.6b serving shape with ``start``, at S 200, 1 and 64,
             with a given ``s0`` and at the rwkv6-smoke shape, and BITWISE
             against itself: one row's y and final state after left pads of
             0, 31 and 415 with ``start``.  Kernel 2 row by row: each
             request's row of the wave's decode call, launched alone at its
             solo capacity, BITWISE equal to its row of the B 8 call (bf16,
             smollm and the shared attention's shapes).  Time each kernel,
             its plain version and one PyTorch library call where there is
             one (``scaled_dot_product_attention``, timed only, never used
             by the port; none computes the SSD or the WKV scan), each
             host-paced (CUDA events around 20 calls back to back) and the
             kernel and the library call also device-only (the summed
             device time of the profiled calls' kernels).
   rows    — whether a row's bf16 bits depend on how many rows share the
             call: each product of the three models (``torch.matmul`` and
             the port's ``linear`` with its 256-row floor), ``rms_norm``
             and the SSD and WKV decode readouts; the port's forms must
             hold every row, the library's are reported.
3. serve   — ``smollm-360m`` at full width in bf16 with random weights from
             ``torch.Generator().manual_seed(0)``: a wave of 8 ragged
             requests and a wave of 3 with filler rows, through
             ``pack_prompts`` and ``make_generate_fn``.  Every kernel's
             launch count must move by exactly the expected amount.
5. paged   — paged KV serving of ``smollm-360m`` at full width in bf16
             through ``engine_paged_prefill`` / ``engine_paged_decode``:
             8 slots, block size 16, table width 64, 512 blocks, a prefill
             budget of 256 tokens, 8 decode steps per call, 12 requests
             (the wave's 8, repeats of two, two sharing a 160-token head),
             the last 4 admitted into freed slots.  The launch counts must
             be exact (prefill kernel 32 per chunk forward, paged decode
             kernel 32 per step, contiguous decode, SSD and WKV kernels 0).
4. check   — in f32: prefill logits with the kernels against the plain
             path (1e-3), greedy tokens of each request served alone equal
             to those served packed, and the 12 requests served paged equal
             to each served alone.  Phase 5 runs before phase 4 (it needs
             the bf16 weights).
6. hybrid  — ``zamba2-2.7b`` (54 Mamba2 layers, d_model 2560, a shared
             attention block every 6 layers) at full width in bf16 with
             random weights from a CUDA ``torch.Generator`` seeded 0: the
             two waves of phase 3.  Launch counts must be exact (SSD kernel
             54 per prefill, prefill kernel 9 per prefill, decode kernel 9
             per decode step, paged decode and WKV kernels 0).  Then phase
             4's f32 checks for the hybrid: prefill logits with the kernels
             against the plain path (1e-3) and every request solo ==
             packed.
7. rwkv    — ``rwkv6-1.6b`` (24 layers, d_model 2048, 32 WKV heads of 64)
             at full width in bf16 with random weights from a CUDA
             ``torch.Generator`` seeded 0: the two waves of phase 3.
             Launch counts must be exact (WKV kernel 24 per prefill and 0
             per decode step, kernels 1-4 0).  Then in f32: prefill logits
             with the WKV kernel against the plain path (1e-3) and every
             request solo == packed.

In every wave phase (3, 6, 7) each request served alone gives its packed
greedy tokens in bf16, as a batch of 1 and, for phases 6 and 7, pinned to
the wave's 8 rows; in phase 5 each request served paged gives its solo
tokens in bf16.  All of these are asserted.

It prints the card's name and power limit, then one JSON line of kernel
numbers, then as its last line ``{"ok": true, "device": {...}}``.  Without a
CUDA card it exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                   # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,           # dense tensor cores
              "float32": 67e12}             # CUDA cores, no TF32
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py's SSD
WKV_TOL = {"float32": 5e-4, "bfloat16": 2e-2}   # tests/test_kernels.py's WKV
MAX_NEW = 32
WAVE_LENGTHS = (1, 64, 97, 160, 233, 311, 420, 512)
# paged serving (phase 5): slots, block size, table width, pool blocks,
# prefill token budget per call, decode steps per call
PAGED = dict(slots=8, block_size=16, table_width=64, blocks=512, budget=256,
             k=8)


def _time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _device_ms(fn, iters=20, warmup=3):
    """Mean device-only time of ``fn`` over ``iters`` calls: the summed
    self device time of the CUDA rows (kernels, copies, fills) of one
    ``torch.profiler`` run of the calls.  The host's time between launches
    is left out, so a call whose device work is shorter than its host cost
    is not timed at its host pace, as ``_time_ms`` times it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [r for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA]
    if not rows:
        raise AssertionError("the profiler saw no device time")
    return sum(r.self_device_time_total for r in rows) / 1e3 / iters


def _times(kernel, plain, library=None, *, plain_iters=20, plain_warmup=3):
    """Kernel, plain version and library call timed both ways: host-paced
    (``ms``, ``plain_ms``, ``library_ms``; CUDA events around back-to-back
    calls) and device-only (``device_ms``, ``library_device_ms``)."""
    r = {"ms": _time_ms(kernel), "device_ms": _device_ms(kernel),
         "plain_ms": _time_ms(plain, iters=plain_iters,
                              warmup=plain_warmup),
         "library_ms": None, "library_device_ms": None}
    if library is not None:
        r["library_ms"] = _time_ms(library)
        r["library_device_ms"] = _device_ms(library)
    return r


def _print_times(name, r, t_bytes, t_ops):
    """One phase-2 line of times: each call host-paced and device-only."""
    lib = ("none" if r["library_ms"] is None else
           f"{r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f} "
           "ms)")
    print(f"[kernels] {name}: kernel {r['ms']:.4f} ms (device "
          f"{r['device_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, library "
          f"{lib}, bound {r['bound_ms']:.5f} ms ({r['bound_by']}; bytes "
          f"{t_bytes:.5f} ms, operations {t_ops:.5f} ms)")


def _wall_ms(fn):
    """Host time of one call that ends in a device sync."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def _profile(label, fn, wall_ms):
    """Device busy time of one call (kernel rows of a profile), its share
    of ``wall_ms`` (the unprofiled host time of the same call), and the
    top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [r for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA]
    busy = sum(r.self_device_time_total for r in rows) / 1e3
    top = sorted(rows, key=lambda r: -r.self_device_time_total)[:5]
    print(f"[profile] {label}: device busy {busy:.3f} ms of {wall_ms:.3f} ms"
          f" wall (idle {1 - busy / wall_ms:.1%}); top kernels: " + "; ".join(
              f"{r.key[:48]} {r.self_device_time_total / 1e3:.3f} ms "
              f"x{r.count}" for r in top))
    return {"device_busy_ms": busy, "wall_ms": wall_ms,
            "idle_share": 1 - busy / wall_ms}


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def _bound(nbytes, flops, dtype_name):
    """(bound ms, what bounds it, bytes ms, operations ms)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", t_bytes, t_ops)


def _randn(gen, shape, dtype, device):
    import torch
    return torch.randn(shape, generator=gen, device=device).to(dtype)


# ------------------------------------------------------------ phase 1 ----

def phase_build():
    from repro_torch.kernels import _build
    t = time.perf_counter()
    logs = _build.build(verbose=True)
    secs = time.perf_counter() - t
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name} {entry}: {line.strip()}")
    print(f"[build] {sorted(logs) or 'already built'} in {secs:.1f} s")
    return secs


# ------------------------------------------------------------ phase 2 ----

def _prefill_case(gen, device, dtype, b, s, hq, hkv, d, kv_start, *,
                  window=0, q_offset=0, skv=None):
    import torch
    from repro_torch.kernels.flash_attention import (attention_xla,
                                                     flash_attention_bshd)
    skv = skv or s
    q = _randn(gen, (b, s, hq, d), dtype, device)
    k = _randn(gen, (b, skv, hkv, d), dtype, device)
    v = _randn(gen, (b, skv, hkv, d), dtype, device)
    ks = torch.tensor(kv_start, dtype=torch.int32, device=device)
    out = flash_attention_bshd(q, k, v, ks, window=window, q_offset=q_offset)
    plain = attention_xla(q, k, v, kv_start=ks, window=window,
                          q_offset=q_offset)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError("flash attention: non-finite output")
    err = _max_err(out, plain)
    tol = TOL[str(dtype).split(".")[-1]]
    if not torch.allclose(out.float(), plain.float(), rtol=tol, atol=tol):
        raise AssertionError(
            f"flash attention vs plain: max err {err:.3g} > {tol} at "
            f"b{b} s{s} hq{hq} hkv{hkv} d{d} {dtype} window {window} "
            f"q_offset {q_offset}")
    return (q, k, v, ks), err


def _decode_case(gen, device, dtype, b, skv, hq, hkv, d, kv_start, kv_len,
                 *, window=0):
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                      flash_decode_bshd)
    q = _randn(gen, (b, hq, d), dtype, device)
    k = _randn(gen, (b, skv, hkv, d), dtype, device)
    v = _randn(gen, (b, skv, hkv, d), dtype, device)
    ks = torch.tensor(kv_start, dtype=torch.int32, device=device)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=device)
    out = flash_decode_bshd(q, k, v, kl, ks, window=window)
    plain = decode_attention_ref(q, k, v, kl, kv_start=ks, window=window)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError("decode attention: non-finite output")
    err = _max_err(out, plain)
    tol = TOL[str(dtype).split(".")[-1]]
    if not torch.allclose(out.float(), plain.float(), rtol=tol, atol=tol):
        raise AssertionError(
            f"decode attention vs plain: max err {err:.3g} > {tol} at "
            f"b{b} skv{skv} hq{hq} hkv{hkv} d{d} {dtype} window {window}")
    return (q, k, v, kl, ks), err


def _wave_starts(s):
    """kv_start of the serving wave packed to width s (filler row: s)."""
    return [s - n for n in WAVE_LENGTHS]


def _decode_rows_alone(gen, dmain):
    """Kernel 2 row by row: each request's row of the wave's decode call
    (``dmain`` from ``_decode_case``: B 8 at the wave's capacity), launched
    alone at the capacity its prompt packed alone is grown to, with its
    keys placed after its own left pad and other values in the rest, must
    give its row of the wave's call bitwise.  Returns the rows checked."""
    import torch
    from repro_torch.kernels.decode_attention import flash_decode_bshd
    from repro_torch.runtime.server import shape_bucket
    q, k, v, kl, ks = dmain
    wave = flash_decode_bshd(q, k, v, kl, ks)
    for i, n in enumerate(WAVE_LENGTHS):
        lo, hi = int(ks[i]), int(kl[i])
        width = shape_bucket(n)
        cap = shape_bucket(width + MAX_NEW)
        start = width - n
        rows = []
        for t in (k, v):
            solo = _randn(gen, (1, cap, *t.shape[2:]), t.dtype, t.device)
            solo[0, start:start + hi - lo] = t[i, lo:hi]
            rows.append(solo)
        out = flash_decode_bshd(
            q[i:i + 1], *rows,
            torch.tensor([start + hi - lo], dtype=torch.int32,
                         device=q.device),
            torch.tensor([start], dtype=torch.int32, device=q.device))
        torch.cuda.synchronize()
        if not torch.equal(out[0], wave[i]):
            raise AssertionError(
                f"decode row {i} ({n}-token prompt) alone at capacity {cap} "
                f"!= its row of the B {q.shape[0]} call at capacity "
                f"{k.shape[1]}: max diff {_max_err(out[0], wave[i]):.3g}")
    return len(WAVE_LENGTHS)


def phase_kernels(cfg, device):
    import torch
    gen = torch.Generator(device=device).manual_seed(1)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bf16, f32 = torch.bfloat16, torch.float32
    s = max(WAVE_LENGTHS)
    b = len(WAVE_LENGTHS)
    starts = _wave_starts(s)
    errs = {"flash": 0.0, "decode": 0.0}

    # prefill: serving shapes, then D 20, a window, q_offset, filler rows
    for dt in (f32, bf16):
        main, e = _prefill_case(gen, device, dt, b, s, hq, hkv, d, starts)
        errs["flash"] = max(errs["flash"], e)
        print(f"[kernels] flash b{b} s{s} hq{hq}/{hkv} d{d} {dt}: "
              f"max err {e:.3g}")
        for kw in (dict(b=2, s=100, hq=3, hkv=1, d=20, kv_start=[0, 37]),
                   dict(b=2, s=96, hq=4, hkv=2, d=32, kv_start=[0, 5],
                        window=24),
                   dict(b=1, s=16, skv=48, hq=2, hkv=2, d=32, kv_start=[0],
                        q_offset=32),
                   dict(b=3, s=70, hq=6, hkv=2, d=128,
                        kv_start=[70, 3, 0])):
            _, e = _prefill_case(gen, device, dt, **kw)
            print(f"[kernels] flash {kw} {dt}: max err {e:.3g}")

    # decode: the grown serving cache, then D 20, a window, filler rows
    cap = 1 << (s + MAX_NEW - 1).bit_length()
    lens = [s + MAX_NEW // 2] * b
    for dt in (f32, bf16):
        dmain, e = _decode_case(gen, device, dt, b, cap, hq, hkv, d, starts,
                                lens)
        errs["decode"] = max(errs["decode"], e)
        print(f"[kernels] decode b{b} skv{cap} hq{hq}/{hkv} d{d} {dt}: "
              f"max err {e:.3g}")
        for kw in (dict(b=2, skv=300, hq=3, hkv=1, d=20, kv_start=[0, 40],
                        kv_len=[300, 177]),
                   dict(b=2, skv=300, hq=4, hkv=2, d=64, kv_start=[0, 10],
                        kv_len=[250, 300], window=64),
                   dict(b=3, skv=257, hq=8, hkv=1, d=128,
                        kv_start=[5, 257, 0], kv_len=[257, 257, 1])):
            _, e = _decode_case(gen, device, dt, **kw)
            print(f"[kernels] decode {kw} {dt}: max err {e:.3g}")

    n = _decode_rows_alone(gen, dmain)
    print(f"[kernels] decode bf16: each of the wave's {n} rows alone at its "
          f"solo capacity == its row of the B {b} call at capacity {cap}, "
          "bitwise")
    # times at the serving shapes in bf16 (the last `main` / `dmain`)
    fa, dec = _attn_serving_times(main, dmain, starts, cap, lens)
    fa["max_abs_err"], dec["max_abs_err"] = errs["flash"], errs["decode"]
    return fa, dec


def _attn_serving_times(main, dmain, starts, cap, lens):
    """Kernels 1 and 2, their plain versions and the library call, timed at
    a wave's serving shapes (``main`` from ``_prefill_case``, ``dmain`` from
    ``_decode_case``), beside their bounds."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                      flash_decode_bshd)
    from repro_torch.kernels.flash_attention import (attention_xla,
                                                     flash_attention_bshd)
    q, k, v, ks = main
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    device = q.device
    cols = torch.arange(s, device=device)
    mask = ((cols[None, :] <= cols[:, None])[None]
            & (cols[None, None, :] >= ks[:, None, None]))      # (B,S,S)
    pairs = int(mask.sum())
    live_rows = sum(s - st for st in starts)
    es = q.element_size()
    fa_bytes = es * (live_rows * (hq + 2 * hkv) * d + b * s * hq * d)
    fa_bound, fa_by, *fa_parts = _bound(fa_bytes, 4 * pairs * hq * d,
                                        "bfloat16")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fa = _times(lambda: flash_attention_bshd(q, k, v, ks),
                lambda: attention_xla(q, k, v, kv_start=ks),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True))
    fa.update(bound_ms=fa_bound, bound_by=fa_by)
    q, k, v, kl, ks = dmain
    valid = sum(max(0, min(n, cap) - st) for n, st in zip(lens, starts))
    dec_bytes = es * (valid * 2 * hkv * d + 2 * b * hq * d)
    dec_bound, dec_by, *dec_parts = _bound(dec_bytes, 4 * valid * hq * d,
                                           "bfloat16")
    ccols = torch.arange(cap, device=device)
    dmask = ((ccols[None, :] >= ks[:, None])
             & (ccols[None, :] < kl[:, None]))[:, None, None]  # (B,1,1,Skv)
    q4, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    dec = _times(lambda: flash_decode_bshd(q, k, v, kl, ks),
                 lambda: decode_attention_ref(q, k, v, kl, kv_start=ks),
                 lambda: F.scaled_dot_product_attention(
                     q4, kt, vt, attn_mask=dmask, enable_gqa=True))
    dec.update(bound_ms=dec_bound, bound_by=dec_by)
    for name, r, parts in (("flash", fa, fa_parts),
                           ("decode", dec, dec_parts)):
        _print_times(f"{name} bf16 serving shape hq{hq}/{hkv} d{d}", r,
                     *parts)
    return fa, dec


def _paged_bitwise(gen, device, dtype, *, b, skv, hq, hkv, d, bs, lens,
                   pads, window=0):
    """Kernel 3 on a pool against kernel 2 on the same logical keys, both
    contiguous from column 0 and after a left pad of P slots with
    kv_start = P: the bits must be equal."""
    import torch
    from repro_torch.kernels.decode_attention import (
        flash_decode_bshd, flash_decode_paged_bshd, pool_from_contiguous)
    q = _randn(gen, (b, hq, d), dtype, device)
    k = _randn(gen, (b, skv, hkv, d), dtype, device)
    v = _randn(gen, (b, skv, hkv, d), dtype, device)
    kl = torch.tensor(lens, dtype=torch.int32, device=device)
    pool_k, pool_v, table = pool_from_contiguous(
        k, v, bs, lens=kl, generator=gen)
    paged = flash_decode_paged_bshd(q, pool_k, pool_v, table, kl,
                                    window=window)
    for pad in pads:
        kp = torch.cat([k.new_zeros((b, pad, hkv, d)), k], 1)
        vp = torch.cat([v.new_zeros((b, pad, hkv, d)), v], 1)
        start = torch.full((b,), pad, dtype=torch.int32, device=device)
        contig = flash_decode_bshd(q, kp, vp, kl + pad, start, window=window)
        torch.cuda.synchronize()
        if not torch.equal(paged, contig):
            raise AssertionError(
                f"paged decode != contiguous decode bitwise: bs {bs} pad "
                f"{pad} d {d} window {window} {dtype}; max diff "
                f"{_max_err(paged, contig):.3g}")
    return len(pads)


def phase_kernels_paged(cfg, device):
    """Kernel 3 (paged decode) against its plain version and bitwise
    against kernel 2; kernel 1 with ``kv_len`` at a chunk shape; times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention_paged_ref, flash_decode_paged_bshd,
        pool_from_contiguous)
    from repro_torch.kernels.flash_attention import (attention_xla,
                                                     flash_attention_bshd)
    gen = torch.Generator(device=device).manual_seed(2)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, bs, tw = PAGED["slots"], PAGED["block_size"], PAGED["table_width"]
    cap = bs * tw
    lens = [1, 64, 97, 160, 233, 311, 420, 512]      # + 16 decoded, below
    lens = [n + 16 for n in lens]
    errs = {"paged": 0.0, "flash_chunk": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[str(dt).split(".")[-1]]
        q = _randn(gen, (b, hq, d), dt, device)
        k = _randn(gen, (b, cap, hkv, d), dt, device)
        v = _randn(gen, (b, cap, hkv, d), dt, device)
        kl = torch.tensor(lens, dtype=torch.int32, device=device)
        pool_k, pool_v, table = pool_from_contiguous(
        k, v, bs, lens=kl, generator=gen)
        out = flash_decode_paged_bshd(q, pool_k, pool_v, table, kl)
        plain = decode_attention_paged_ref(q, pool_k, pool_v, table, kl)
        torch.cuda.synchronize()
        e = _max_err(out, plain)
        if not torch.isfinite(out.float()).all() or not torch.allclose(
                out.float(), plain.float(), rtol=tol, atol=tol):
            raise AssertionError(f"paged decode vs plain: max err {e:.3g} "
                                 f"> {tol} ({dt})")
        errs["paged"] = max(errs["paged"], e)
        print(f"[kernels] paged decode b{b} bs{bs} T{tw} hq{hq}/{hkv} d{d} "
              f"{dt}: max err {e:.3g}")
        n = 0
        for kw in (dict(b=b, skv=cap, hq=hq, hkv=hkv, d=d, bs=bs, lens=lens,
                        pads=(0, 1, 37, 200)),
                   dict(b=b, skv=cap, hq=hq, hkv=hkv, d=d, bs=48, lens=lens,
                        pads=(0, 5, 200)),
                   dict(b=3, skv=300, hq=3, hkv=1, d=20, bs=16,
                        lens=[300, 0, 45], pads=(0, 7)),
                   dict(b=3, skv=600, hq=hq, hkv=hkv, d=d, bs=48,
                        lens=[600, 333, 64], pads=(0, 100), window=128)):
            n += _paged_bitwise(gen, device, dt, **kw)
        print(f"[kernels] paged decode == contiguous decode bitwise ({dt}): "
              f"{n} layouts (block sizes 16 and 48, left pads with kv_start,"
              f" d 20, window 128)")

        # kernel 1 at a chunk shape: Sq 256 at q_offset 256 against the
        # 1024-wide gathered view, masked at kv_len 512
        qc = _randn(gen, (1, 256, hq, d), dt, device)
        kc = _randn(gen, (1, cap, hkv, d), dt, device)
        vc = _randn(gen, (1, cap, hkv, d), dt, device)
        klc = torch.tensor([512], dtype=torch.int32, device=device)
        out = flash_attention_bshd(qc, kc, vc, kv_len=klc, q_offset=256)
        plain = attention_xla(qc, kc, vc, kv_len=klc, q_offset=256)
        torch.cuda.synchronize()
        e = _max_err(out, plain)
        if not torch.isfinite(out.float()).all() or not torch.allclose(
                out.float(), plain.float(), rtol=tol, atol=tol):
            raise AssertionError(f"flash with kv_len vs plain: max err "
                                 f"{e:.3g} > {tol} ({dt})")
        errs["flash_chunk"] = max(errs["flash_chunk"], e)
        print(f"[kernels] flash chunk sq256 q_offset256 skv{cap} kv_len512 "
              f"{dt}: max err {e:.3g}")

    # times in bf16 (the last case of the loop)
    es = q.element_size()
    valid = sum(lens)
    pd_bytes = (es * (valid * 2 * hkv * d + 2 * b * hq * d)
                + 4 * (table.numel() + 2 * b))
    pd_bound, pd_by, *pd_parts = _bound(pd_bytes, 4 * valid * hq * d,
                                        "bfloat16")
    kview = pool_k[table.long()].reshape(b, cap, hkv, d).transpose(1, 2)
    vview = pool_v[table.long()].reshape(b, cap, hkv, d).transpose(1, 2)
    cols = torch.arange(cap, device=device)
    dmask = (cols[None, :] < kl[:, None])[:, None, None]
    q4 = q[:, :, None]
    paged = _times(
        lambda: flash_decode_paged_bshd(q, pool_k, pool_v, table, kl),
        lambda: decode_attention_paged_ref(q, pool_k, pool_v, table, kl),
        lambda: F.scaled_dot_product_attention(
            q4, kview, vview, attn_mask=dmask, enable_gqa=True))
    paged.update(library_note="scaled_dot_product_attention on the "
                 "pre-gathered view; excludes the gather",
                 bound_ms=pd_bound, bound_by=pd_by,
                 max_abs_err=errs["paged"])
    rows = torch.arange(256, device=device)[:, None] + 256
    cmask = (cols[None, :] <= rows) & (cols[None, :] < 512)     # (Sq,Skv)
    pairs = int(cmask.sum())
    fc_bytes = es * (2 * 256 * hq * d + 512 * 2 * hkv * d) + 4
    fc_bound, fc_by, *fc_parts = _bound(fc_bytes, 4 * pairs * hq * d,
                                        "bfloat16")
    chunk = _times(
        lambda: flash_attention_bshd(qc, kc, vc, kv_len=klc, q_offset=256),
        lambda: attention_xla(qc, kc, vc, kv_len=klc, q_offset=256),
        lambda: F.scaled_dot_product_attention(
            qc.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=cmask[None, None], enable_gqa=True))
    chunk.update(bound_ms=fc_bound, bound_by=fc_by,
                 max_abs_err=errs["flash_chunk"])
    for name, r, parts in (("paged decode", paged, pd_parts),
                           ("flash chunk", chunk, fc_parts)):
        _print_times(f"{name} bf16 serving shape", r, *parts)
    print("[kernels] paged decode library time is scaled_dot_product_"
          "attention on the pre-gathered view: it excludes the gather")
    return paged, chunk


def _ssd_case(gen, device, dtype, b, s, h, p, g, n, chunk, *, starts=None,
              with_h0=False, zamba2_rates=False):
    """Kernel 4 against the plain chunked version on one input.  Steps
    before a row's ``starts`` entry are zeroed (x, dt, B, C), as the Mamba2
    block zeroes left pad, and the kernel is given them as ``start``.
    dt is drawn in [0.01, 0.2] and A in [-2, -0.5]; with ``zamba2_rates``
    dt is softplus(N(0, 0.88)) and A = -linspace(0.5, 8, H), as in
    zamba2-2.7b, where the running sum of dt·A falls several hundred below
    zero within a chunk."""
    import torch
    from repro_torch.kernels.mamba2_ssd import ssd, ssd_chunked_bshp
    x = _randn(gen, (b, s, h, p), dtype, device)
    if zamba2_rates:
        dt = torch.nn.functional.softplus(torch.randn(
            (b, s, h), generator=gen, device=device) * 0.88).to(dtype)
        A = -torch.linspace(0.5, 8.0, h, device=device)
    else:
        dt = (torch.rand((b, s, h), generator=gen, device=device) * 0.19
              + 0.01).to(dtype)
        A = -(torch.rand((h,), generator=gen, device=device) * 1.5 + 0.5)
    bm = _randn(gen, (b, s, g, n), dtype, device)
    cm = _randn(gen, (b, s, g, n), dtype, device)
    h0 = (torch.randn((b, h, p, n), generator=gen, device=device)
          if with_h0 else None)
    st = None
    if starts is not None:
        st = torch.tensor(starts, dtype=torch.int32, device=device)
        real = torch.arange(s, device=device)[None, :] >= st[:, None]
        x, dt, bm, cm = (t * real.view(b, s, *(1,) * (t.dim() - 2)).to(dtype)
                         for t in (x, dt, bm, cm))
    y, hl = ssd_chunked_bshp(x, dt, A, bm, cm, h0, chunk=chunk, start=st)
    yp, hp = ssd(x, dt, A, bm, cm, h0, chunk=chunk, impl="chunked")
    torch.cuda.synchronize()
    if not (torch.isfinite(y.float()).all() and torch.isfinite(hl).all()):
        raise AssertionError("ssd kernel: non-finite output")
    err = max(_max_err(y, yp), _max_err(hl, hp))
    tol = SSD_TOL[str(dtype).split(".")[-1]]
    if not (torch.allclose(y.float(), yp.float(), rtol=tol, atol=tol)
            and torch.allclose(hl, hp, rtol=tol, atol=tol)):
        raise AssertionError(
            f"ssd kernel vs plain: max err {err:.3g} > {tol} at b{b} s{s} "
            f"h{h} p{p} g{g} n{n} chunk {chunk} {dtype} start {starts} "
            f"h0 {with_h0}")
    if y.dtype != x.dtype or hl.dtype != torch.float32:
        raise AssertionError(f"ssd kernel dtypes {y.dtype}, {hl.dtype}")
    return (x, dt, A, bm, cm, st), err


def _ssd_bitwise(gen, device, dtype, *, n_real, pads, h, p, n, chunk):
    """One row of ``n_real`` steps after left pads of each length in
    ``pads``, with ``start`` set: kernel 4's y at the real steps and its
    final state must be the same bits for every pad."""
    import torch
    from repro_torch.kernels.mamba2_ssd import ssd_chunked_bshp
    x = _randn(gen, (1, n_real, h, p), dtype, device)
    dt = (torch.rand((1, n_real, h), generator=gen, device=device) * 0.19
          + 0.01).to(dtype)
    A = -(torch.rand((h,), generator=gen, device=device) * 1.5 + 0.5)
    bm = _randn(gen, (1, n_real, 1, n), dtype, device)
    cm = _randn(gen, (1, n_real, 1, n), dtype, device)
    outs = []
    for pad in pads:
        padded = [torch.cat([t.new_zeros((1, pad, *t.shape[2:])), t], 1)
                  for t in (x, dt, bm, cm)]
        st = torch.tensor([pad], dtype=torch.int32, device=device)
        y, hl = ssd_chunked_bshp(*padded[:2], A, *padded[2:], chunk=chunk,
                                 start=st)
        if pad and bool(y[:, :pad].float().abs().max() > 0):
            raise AssertionError(f"ssd kernel: y is not 0 at the left pad "
                                 f"({pad})")
        outs.append((y[:, pad:], hl))
    torch.cuda.synchronize()
    for pad, (y, hl) in zip(pads[1:], outs[1:]):
        if not (torch.equal(y, outs[0][0]) and torch.equal(hl, outs[0][1])):
            raise AssertionError(
                f"ssd kernel: left pad {pad} changed the row's bits (vs "
                f"pad {pads[0]}); max diff y {_max_err(y, outs[0][0]):.3g}, "
                f"state {_max_err(hl, outs[0][1]):.3g} ({dtype})")
    return len(pads)


def _ssd_bound(x, dt, bm, st, chunk):
    """(bound ms, by, bytes ms, ops ms) of one kernel-4 call: the real steps
    of x, dt, B and C read once, y and the final state written once; the
    flops of the chunks that hold real steps (causal scores and y, the
    state readout and update)."""
    b, s, h, p = x.shape
    g, n = bm.shape[2:]
    starts = st.tolist() if st is not None else [0] * b
    es = x.element_size()
    real = sum(s - v for v in starts)
    nbytes = (es * (real * (h * p + h + 2 * g * n) + b * s * h * p)
              + 4 * (b * h * p * n + h + b))
    flops = 0
    for v in starts:
        for c0 in range(v, s, chunk):
            nv = min(chunk, s - c0)
            flops += h * (nv * (nv + 1) * (n + p) + 4 * nv * n * p)
    return _bound(nbytes, flops, "bfloat16")


def phase_kernels_hybrid(hcfg, device):
    """Kernel 4 (SSD) against its plain version and bitwise under left pad;
    kernels 1 and 2 at the shared attention's shapes; times at the
    zamba2-2.7b serving shapes."""
    import torch
    from repro_torch.kernels.mamba2_ssd import ssd, ssd_chunked_bshp
    gen = torch.Generator(device=device).manual_seed(3)
    ssm = hcfg.ssm
    h, p, n, chunk = (ssm.expand * hcfg.d_model // ssm.head_dim,
                      ssm.head_dim, ssm.state_dim, ssm.chunk)
    b, s = len(WAVE_LENGTHS), max(WAVE_LENGTHS)
    starts = _wave_starts(s)
    errs = {"ssd": 0.0, "flash": 0.0, "decode": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        main, e = _ssd_case(gen, device, dt, b, s, h, p, 1, n, chunk,
                            starts=starts)
        errs["ssd"] = max(errs["ssd"], e)
        print(f"[kernels] ssd b{b} s{s} h{h} p{p} n{n} chunk {chunk} start "
              f"{dt}: max err {e:.3g}")
        _, e = _ssd_case(gen, device, dt, b, s, h, p, 1, n, chunk,
                         starts=starts, zamba2_rates=True)
        errs["ssd"] = max(errs["ssd"], e)
        print(f"[kernels] ssd b{b} s{s} h{h} p{p} n{n} chunk {chunk} start, "
              f"zamba2 decay rates {dt}: max err {e:.3g}")
        for kw in (dict(b=2, s=200, h=8, p=p, g=1, n=n, chunk=chunk),
                   dict(b=2, s=1, h=8, p=p, g=1, n=n, chunk=chunk),
                   dict(b=2, s=64, h=8, p=p, g=1, n=n, chunk=chunk),
                   dict(b=2, s=100, h=4, p=32, g=2, n=32, chunk=32),
                   dict(b=2, s=130, h=4, p=p, g=1, n=n, chunk=64,
                        with_h0=True),
                   dict(b=3, s=40, h=16, p=8, g=1, n=16, chunk=16,
                        starts=[0, 9, 40])):
            _, e = _ssd_case(gen, device, dt, **kw)
            print(f"[kernels] ssd {kw} {dt}: max err {e:.3g}")
        nb = _ssd_bitwise(gen, device, dt, n_real=97, pads=(0, 31, 415),
                          h=h, p=p, n=n, chunk=chunk)
        print(f"[kernels] ssd left pad 0, 31, 415 with start: y and final "
              f"state bitwise equal ({nb} layouts, {dt})")

        # kernels 1 and 2 at the shared attention's shapes
        hq, hkv, d = hcfg.n_heads, hcfg.n_kv_heads, hcfg.head_dim
        amain, e = _prefill_case(gen, device, dt, b, s, hq, hkv, d, starts)
        errs["flash"] = max(errs["flash"], e)
        print(f"[kernels] flash b{b} s{s} hq{hq}/{hkv} d{d} {dt}: max err "
              f"{e:.3g}")
        cap = 1 << (s + MAX_NEW - 1).bit_length()
        lens = [s + MAX_NEW // 2] * b
        dmain, e = _decode_case(gen, device, dt, b, cap, hq, hkv, d, starts,
                                lens)
        errs["decode"] = max(errs["decode"], e)
        print(f"[kernels] decode b{b} skv{cap} hq{hq}/{hkv} d{d} {dt}: max "
              f"err {e:.3g}")
        _, e = _decode_case(gen, device, dt, 2, 300, hq, hkv, d, [0, 40],
                            [300, 177])
        print(f"[kernels] decode b2 skv300 hq{hq}/{hkv} d{d} {dt}: max err "
              f"{e:.3g}")

    n = _decode_rows_alone(gen, dmain)
    print(f"[kernels] decode bf16 hq{hq}/{hkv} d{d}: each of the wave's {n} "
          f"rows alone at its solo capacity == its row of the B {b} call "
          f"at capacity {cap}, bitwise")
    # times at the serving shapes in bf16 (the last cases of the loop)
    x, dt, A, bm, cm, st = main
    bound, by, t_bytes, t_ops = _ssd_bound(x, dt, bm, st, chunk)
    ssd_r = _times(lambda: ssd_chunked_bshp(x, dt, A, bm, cm, chunk=chunk,
                                            start=st),
                   lambda: ssd(x, dt, A, bm, cm, chunk=chunk,
                               impl="chunked"))
    ssd_r.update(library_note="none: no single PyTorch call computes the "
                 "SSD scan", bound_ms=bound, bound_by=by,
                 max_abs_err=errs["ssd"])
    _print_times("ssd bf16 serving shape", ssd_r, t_bytes, t_ops)
    fa, dec = _attn_serving_times(amain, dmain, starts, cap, lens)
    fa["max_abs_err"], dec["max_abs_err"] = errs["flash"], errs["decode"]
    return ssd_r, fa, dec


def _wkv_case(gen, device, dtype, b, s, h, k, chunk, *, starts=None,
              with_s0=False):
    """Kernel 5 against its plain versions on one input: within
    ``WKV_TOL`` of the plain chunked form and of the plain scan (both walk
    over the left pad, the kernel starts at ``start``).  logw is
    drawn as rwkv6-1.6b makes it, -exp(w0 + lora) with w0 = -0.5 and the
    LoRA term N(0, 0.6), in f32; r, k, v in ``dtype``.  Steps before a
    row's ``starts`` entry hold r = k = v = 0, as the model's left pad
    does (logw stays nonzero there), and the kernel is given them as
    ``start``."""
    import torch
    from repro_torch.kernels.rwkv6_wkv import wkv6, wkv6_chunked_bshk
    r, kk, v = (_randn(gen, (b, s, h, k), dtype, device) for _ in range(3))
    logw = -torch.exp(-0.5 + 0.6 * torch.randn((b, s, h, k), generator=gen,
                                               device=device))
    u = 0.5 * torch.randn((h, k), generator=gen, device=device)
    s0 = (torch.randn((b, h, k, k), generator=gen, device=device)
          if with_s0 else None)
    st = None
    if starts is not None:
        st = torch.tensor(starts, dtype=torch.int32, device=device)
        real = (torch.arange(s, device=device)[None, :] >= st[:, None])
        real = real[:, :, None, None].to(dtype)
        r, kk, v = r * real, kk * real, v * real
    y, sl = wkv6_chunked_bshk(r, kk, v, logw, u, s0, chunk=chunk, start=st)
    yp, sp = wkv6(r, kk, v, logw, u, s0, chunk=chunk, start=st,
                  impl="chunked")
    ys, ss = wkv6(r, kk, v, logw, u, s0, impl="scan")
    torch.cuda.synchronize()
    if not (torch.isfinite(y.float()).all() and torch.isfinite(sl).all()):
        raise AssertionError("wkv kernel: non-finite output")
    where = (f"b{b} s{s} h{h} k{k} chunk {chunk} {dtype} start {starts} "
             f"s0 {with_s0}")
    tol = WKV_TOL[str(dtype).split(".")[-1]]
    errs = {}
    for name, (yr, sr) in (("chunked", (yp, sp)), ("scan", (ys, ss))):
        errs[name] = max(_max_err(y, yr), _max_err(sl, sr))
        if not (torch.allclose(y.float(), yr.float(), rtol=tol, atol=tol)
                and torch.allclose(sl, sr, rtol=tol, atol=tol)):
            raise AssertionError(f"wkv kernel vs plain {name}: max err "
                                 f"{errs[name]:.3g} > {tol} at {where}")
    if y.dtype != r.dtype or sl.dtype != torch.float32:
        raise AssertionError(f"wkv kernel dtypes {y.dtype}, {sl.dtype}")
    return (r, kk, v, logw, u, st), errs


def _wkv_bitwise(gen, device, dtype, *, n_real, pads, h, k, chunk):
    """One row of ``n_real`` steps after left pads of each length in
    ``pads`` (r = k = v = 0 there, logw as the model leaves it, -exp(-0.5)),
    with ``start`` set: kernel 5's y at the real steps and its final state
    must be the same bits for every pad, and y 0 at the pad."""
    import math

    import torch
    from repro_torch.kernels.rwkv6_wkv import wkv6_chunked_bshk
    r, kk, v = (_randn(gen, (1, n_real, h, k), dtype, device)
                for _ in range(3))
    logw = -torch.exp(-0.5 + 0.6 * torch.randn(
        (1, n_real, h, k), generator=gen, device=device))
    u = 0.5 * torch.randn((h, k), generator=gen, device=device)
    outs = []
    for pad in pads:
        padded = [torch.cat([t.new_zeros((1, pad, h, k)), t], 1)
                  for t in (r, kk, v)]
        lw = torch.cat([logw.new_full((1, pad, h, k), -math.exp(-0.5)),
                        logw], 1)
        st = torch.tensor([pad], dtype=torch.int32, device=device)
        y, sl = wkv6_chunked_bshk(*padded, lw, u, chunk=chunk, start=st)
        if pad and bool(y[:, :pad].float().abs().max() > 0):
            raise AssertionError(f"wkv kernel: y is not 0 at the left pad "
                                 f"({pad})")
        outs.append((y[:, pad:], sl))
    torch.cuda.synchronize()
    for pad, (y, sl) in zip(pads[1:], outs[1:]):
        if not (torch.equal(y, outs[0][0]) and torch.equal(sl, outs[0][1])):
            raise AssertionError(
                f"wkv kernel: left pad {pad} changed the row's bits (vs pad "
                f"{pads[0]}); max diff y {_max_err(y, outs[0][0]):.3g}, "
                f"state {_max_err(sl, outs[0][1]):.3g} ({dtype})")
    return len(pads)


def _wkv_bound(r, st, chunk):
    """(bound ms, by, bytes ms, ops ms) of one kernel-5 call: the real steps
    of r, k, v and logw (f32) read once, y and the final state written
    once; the operations of the chunks that hold real steps: per head, the
    pairwise scores (an exp, two products and a sum for each s < t and
    channel), their product with v, the u bonus, the state readout and the
    state update."""
    b, s, h, k = r.shape
    starts = st.tolist() if st is not None else [0] * b
    es = r.element_size()
    real = sum(s - v for v in starts)
    nbytes = (real * h * k * (3 * es + 4) + es * b * s * h * k
              + 4 * (b * h * k * k + h * k + b))
    ops = 0
    for v in starts:
        for c0 in range(v, s, chunk):
            nv = min(chunk, s - c0)
            pairs = nv * (nv - 1) // 2
            ops += h * (pairs * 6 * k + nv * (4 * k * k + 5 * k))
    return _bound(nbytes, ops, "bfloat16")


def phase_kernels_rwkv(rcfg, device):
    """Kernel 5 (WKV) against its plain version and bitwise under left pad;
    times at the rwkv6-1.6b serving shape."""
    import torch
    from repro_torch.kernels.rwkv6_wkv import wkv6, wkv6_chunked_bshk
    gen = torch.Generator(device=device).manual_seed(4)
    h, k, chunk = rcfg.ssm.n_heads, rcfg.ssm.head_dim, rcfg.ssm.chunk
    b, s = len(WAVE_LENGTHS), max(WAVE_LENGTHS)
    starts = _wave_starts(s)
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        main, e = _wkv_case(gen, device, dt, b, s, h, k, chunk,
                            starts=starts)
        err = max(err, e["chunked"])
        print(f"[kernels] wkv b{b} s{s} h{h} k{k} chunk {chunk} start {dt}: "
              f"max err vs the plain chunked form {e['chunked']:.3g}, vs "
              f"the scan {e['scan']:.3g}")
        for kw in (dict(b=2, s=200, h=h, k=k, chunk=chunk),
                   dict(b=2, s=1, h=h, k=k, chunk=chunk),
                   dict(b=2, s=64, h=h, k=k, chunk=chunk),
                   dict(b=2, s=130, h=8, k=k, chunk=chunk, with_s0=True),
                   dict(b=3, s=40, h=4, k=8, chunk=16, starts=[0, 9, 40])):
            _, e = _wkv_case(gen, device, dt, **kw)
            err = max(err, e["chunked"])
            print(f"[kernels] wkv {kw} {dt}: max err vs the plain chunked "
                  f"form {e['chunked']:.3g}, vs the scan {e['scan']:.3g}")
        nb = _wkv_bitwise(gen, device, dt, n_real=97, pads=(0, 31, 415),
                          h=h, k=k, chunk=chunk)
        print(f"[kernels] wkv left pad 0, 31, 415 with start: y and final "
              f"state bitwise equal ({nb} layouts, {dt})")

    # times at the serving shape in bf16 (the last case of the loop)
    r, kk, v, logw, u, st = main
    bound, by, t_bytes, t_ops = _wkv_bound(r, st, chunk)
    res = _times(lambda: wkv6_chunked_bshk(r, kk, v, logw, u, chunk=chunk,
                                           start=st),
                 lambda: wkv6(r, kk, v, logw, u, chunk=chunk,
                              impl="chunked"),
                 plain_iters=5, plain_warmup=1)
    res.update(library_note="none: no single PyTorch call computes the WKV "
               "scan", bound_ms=bound, bound_by=by, max_abs_err=err)
    _print_times("wkv bf16 serving shape", res, t_bytes, t_ops)
    return res


# ----------------------------------------------------------- phase 2b ----

ROW_COUNTS = (1, 8, 16, 64, 128, 256, 512, 1024)


def _products(cfg):
    """{name: (K, N)} of the products one layer (and the unembedding) of
    ``cfg`` runs, as the port computes them."""
    d, v = cfg.d_model, cfg.vocab_size
    if cfg.family == "dense":
        hd, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        return {"wq": (d, hd), "wk": (d, kv), "wo": (hd, d),
                "mlp wi": (d, cfg.d_ff), "mlp wo": (cfg.d_ff, d),
                "unembed": (d, v)}
    if cfg.family == "hybrid":
        di, hd = cfg.ssm.expand * d, cfg.n_heads * cfg.head_dim
        r = cfg.shared_attn_lora_rank
        return {"wz": (d, di), "wB": (d, cfg.ssm.state_dim),
                "wdt": (d, di // cfg.ssm.head_dim), "mamba wo": (di, d),
                "wq, lora q": (2 * d, hd), "wo": (hd, d), "lora oa": (hd, r),
                "lora ob": (r, d), "mlp wi": (2 * d, cfg.d_ff),
                "mlp wo": (cfg.d_ff, d), "unembed": (d, v)}
    att = cfg.ssm.n_heads * cfg.ssm.head_dim
    return {"wr": (d, att), "wo": (att, d), "mix_a": (d, 160),
            "mix_b": (32, d), "decay_a": (d, 64), "decay_b": (64, att),
            "cm_wk": (d, cfg.d_ff), "cm_wv": (cfg.d_ff, d), "unembed": (d, v)}


def _kernel_names(fn):
    """Names of the device kernels one call of ``fn`` launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [r.key[:64] for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA]


def phase_rows(cfgs, device):
    """Whether a row's bits depend on how many rows share the call, in
    bf16: row i of an M-row call against row i of a 4,096-row call, for
    each product the three models run (``torch.matmul`` as the library
    does it, and ``layers.linear`` with its row floor), for ``rms_norm``
    (the mean as ATen reduces it, and with its floor), and for the SSD and
    WKV decode readouts (a batch of 1 against a batch of 8).  The floored
    forms must give the 4,096-row bits at every M; the library forms are
    reported.  Returns {"matmul": {shape: [M that differ]}, ...}."""
    import torch
    from repro_torch.kernels.mamba2_ssd import ssd_decode
    from repro_torch.kernels.rwkv6_wkv import wkv6_decode
    from repro_torch.models.layers import linear, rms_norm
    gen = torch.Generator(device=device).manual_seed(5)
    bf16 = torch.bfloat16
    out = {"matmul": {}, "rms_mean": {}}
    for cfg in cfgs:
        for name, (k, n) in _products(cfg).items():
            w = (_randn(gen, (k, n), torch.float32, device) / k ** 0.5).to(
                bf16)
            x = _randn(gen, (4096, k), bf16, device)
            full = torch.matmul(x, w)
            bad = [m for m in ROW_COUNTS
                   if not torch.equal(torch.matmul(x[:m], w), full[:m])]
            fl = [m for m in ROW_COUNTS
                  if not torch.equal(linear(x[:m], w), full[:m])]
            if bad:
                out["matmul"][f"{cfg.name} {name} K{k} N{n}"] = bad
            if fl:
                raise AssertionError(f"{cfg.name} {name} (K {k}, N {n}): "
                                     f"linear's rows at M {fl} differ from "
                                     "a 4096-row product")
    # the hybrid's LoRA q as the JAX package computes it, u @ qa: split-K
    # at every M the floor could reach, which is why the port folds qa @ qb
    # into wq once per parameter tree (``hybrid._folded_q``)
    kq, nq = 2 * cfgs[1].d_model, cfgs[1].shared_attn_lora_rank
    w = _randn(gen, (kq, nq), bf16, device)
    x = _randn(gen, (4096, kq), bf16, device)
    full = torch.matmul(x, w)
    out["lora_qa_as_jax"] = [m for m in ROW_COUNTS if not torch.equal(
        torch.matmul(x[:m], w), full[:m])]
    for d in sorted({c.d_model for c in cfgs} | {2 * cfgs[1].d_model}):
        x = _randn(gen, (4096, d), bf16, device)
        g = torch.zeros((d,), dtype=bf16, device=device)
        full, xf = rms_norm(x, g, 1e-6), x.float()
        mean = (xf * xf).mean(-1)
        bad = [m for m in (1, 2, 4, 8, 15, 16, 64)
               if not torch.equal((xf[:m] * xf[:m]).mean(-1), mean[:m])]
        if bad:
            out["rms_mean"][f"d{d}"] = bad
        fl = [m for m in (1, 2, 4, 8, 15) if not torch.equal(
            rms_norm(x[:m], g, 1e-6), full[:m])]
        if fl:
            raise AssertionError(f"rms_norm d{d}: rows at M {fl} differ from "
                                 "a 4096-row call")
    hs = torch.randn((8, 80, 64, 64), generator=gen, device=device)
    ch = torch.randn((8, 80, 64), generator=gen, device=device)
    e8 = torch.einsum("bhpn,bhn->bhp", hs, ch)
    out["ssd_readout_einsum_rows_equal"] = sum(
        bool(torch.equal(torch.einsum("bhpn,bhn->bhp", hs[i:i + 1],
                                      ch[i:i + 1])[0], e8[i]))
        for i in range(8))
    ssd_args = [torch.randn(sh, generator=gen, device=device)
                for sh in ((8, 80, 64), (8, 80), (80,), (8, 1, 64),
                           (8, 1, 64), (8, 80, 64, 64))]
    ssd_args[1] = ssd_args[1].abs()
    ssd_args[2] = -ssd_args[2].abs()
    wkv_args = [torch.randn(sh, generator=gen, device=device)
                for sh in ((8, 32, 64),) * 4 + ((32, 64), (8, 32, 64, 64))]
    wkv_args[3] = -wkv_args[3].abs()
    for name, fn, args in (("ssd", ssd_decode, ssd_args),
                           ("wkv", wkv6_decode, wkv_args)):
        y8, s8 = fn(*args)
        for i in range(8):
            y1, s1 = fn(*[a if a.shape[0] != 8 else a[i:i + 1]
                          for a in args])
            if not (torch.equal(y1[0], y8[i]) and torch.equal(s1[0], s8[i])):
                raise AssertionError(f"{name} decode: row {i} alone differs "
                                     "from its row in a batch of 8")
    k, n = _products(cfgs[1])["mamba wo"]
    w = _randn(gen, (k, n), bf16, device)
    xs = {m: _randn(gen, (m, k), bf16, device) for m in (1, 64, 256, 4096)}
    kernels = {f"matmul M{m} K{k} N{n}": _kernel_names(
        lambda x=x: torch.matmul(x, w)) for m, x in xs.items()}
    xf = xs[1].float()
    kernels["rms_norm mean, 1 row"] = _kernel_names(
        lambda: (xf * xf).mean(-1))
    kernels["SSD decode readout einsum, B 1"] = _kernel_names(
        lambda: torch.einsum("bhpn,bhn->bhp", hs[:1], ch[:1]))
    out["kernels"] = kernels
    print(f"[rows] bf16 rows that differ from a 4096-row call: matmul "
          f"{out['matmul']}; the hybrid's u @ qa (K {kq}, N {nq}) at M "
          f"{out['lora_qa_as_jax']}; rms_norm's f32 mean "
          f"{out['rms_mean']}; SSD decode readout as an einsum: "
          f"{out['ssd_readout_einsum_rows_equal']}/8 rows equal alone; "
          "linear, rms_norm and the decode readouts hold every row")
    print(f"[rows] kernels: {kernels}")
    return out


# ------------------------------------------------------------ phase 3 ----

def _kernels():
    """{name: wrapper} of every kernel; each wrapper counts its launches."""
    from repro_torch.kernels.decode_attention import (
        flash_decode_bshd, flash_decode_paged_bshd)
    from repro_torch.kernels.flash_attention import flash_attention_bshd
    from repro_torch.kernels.mamba2_ssd import ssd_chunked_bshp
    from repro_torch.kernels.rwkv6_wkv import wkv6_chunked_bshk
    return {"flash": flash_attention_bshd, "decode": flash_decode_bshd,
            "paged": flash_decode_paged_bshd, "ssd": ssd_chunked_bshp,
            "wkv": wkv6_chunked_bshk}


def _zero_launches():
    for fn in _kernels().values():
        fn.launches = 0


def _read_launches():
    return {name: fn.launches for name, fn in _kernels().items()}


def wave_prompts(cfg, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in WAVE_LENGTHS]
    prompts[3][::7] = [cfg.pad_id] * len(prompts[3][::7])   # holds pad_id
    return prompts


def _serve_waves(cfg, params, device, per_wave, label, *, repeats,
                 solo_rows):
    """The two waves of ``wave_prompts`` in bf16: exact launch counts
    (``per_wave`` for each wave), tokens of the right shape and vocabulary,
    the times (fastest of ``repeats``) and the device's busy share of one
    prefill and one decode step.  bf16 solo == packed is asserted for every
    request, served alone as a batch of each of ``solo_rows`` rows.
    Returns (launches, {rows: solo tokens}, stats)."""
    import torch
    from repro_torch.models import build_model, grow_cache
    from repro_torch.runtime.server import make_generate_fn, pack_prompts
    prompts = wave_prompts(cfg)
    waves = [pack_prompts(prompts, pad=cfg.pad_id),
             pack_prompts(prompts[:3], pad=cfg.pad_id, min_rows=8)]
    generate = make_generate_fn(cfg, MAX_NEW, device)
    first = make_generate_fn(cfg, 1, device)
    generate(params, *waves[0])          # warm-up: allocator, cuBLAS
    torch.cuda.synchronize()

    _zero_launches()
    outs = [generate(params, toks, lens) for toks, lens in waves]
    torch.cuda.synchronize()
    launches = _read_launches()
    want = {k: v * len(waves) for k, v in per_wave.items()}
    if launches != want:
        raise AssertionError(f"{cfg.name} launch counts {launches} != "
                             f"expected {want}")
    for (toks, lens), out in zip(waves, outs):
        if tuple(out.shape) != (toks.shape[0], MAX_NEW):
            raise AssertionError(f"tokens shape {tuple(out.shape)}")
        if bool((out < 0).any() or (out >= cfg.vocab_size).any()):
            raise AssertionError("generated ids outside the vocabulary")
    print(f"[{label}] launches in the two waves: {launches}")

    toks, lens = waves[0]
    prefill_ms = min(_wall_ms(lambda: first(params, toks, lens))
                     for _ in range(repeats))
    wave_ms = min(_wall_ms(lambda: generate(params, toks, lens))
                  for _ in range(repeats))
    decode_ms = (wave_ms - prefill_ms) / (MAX_NEW - 1)
    tok_s = len(prompts) * MAX_NEW / (wave_ms / 1e3)
    print(f"[{label}] {cfg.name} bf16 wave of {len(prompts)} (B"
          f"{toks.shape[0]} S{toks.shape[1]}, max_new {MAX_NEW}): prefill "
          f"{prefill_ms:.2f} ms, decode {decode_ms:.3f} ms/step, wave "
          f"{wave_ms:.1f} ms, {tok_s:.1f} tokens/s")

    model = build_model(cfg, device)
    batch = {"tokens": torch.as_tensor(toks, device=device),
             "lengths": torch.as_tensor(lens, device=device)}
    prof = {"prefill": _profile(f"{cfg.name} prefill", lambda: model.prefill(
        params, batch), prefill_ms)}
    logits, cache = model.prefill(params, batch)
    cache = grow_cache(cfg, cache, toks.shape[1] + MAX_NEW)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    prof["decode"] = _profile(f"{cfg.name} decode step", lambda: model.decode(
        params, cache, tok), decode_ms)
    del cache

    stats = {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
             "wave_ms": wave_ms, "tokens_per_s": tok_s, "profile": prof}
    solos = {}
    for rows in solo_rows:
        solos[rows] = [generate(params, *pack_prompts(
            [p], pad=cfg.pad_id, min_rows=rows))[0] for p in prompts]
        same = sum(bool((t == outs[0][i]).all())
                   for i, t in enumerate(solos[rows]))
        stats["bf16_solo_equal" if rows == 1
              else f"bf16_solo_{rows}_rows_equal"] = same
        print(f"[{label}] bf16 solo (batch of {rows}) == packed for "
              f"{same}/{len(prompts)} requests")
        if same != len(prompts):
            raise AssertionError(f"{cfg.name} bf16: solo (batch of {rows}) "
                                 f"== packed for only {same}/"
                                 f"{len(prompts)} requests")
    return launches, solos, stats


def phase_serve(cfg, params, device):
    """smollm-360m wave serving in bf16; the decode steps run kernel 2.
    Solo tokens (batch of 1) are returned for phase 5."""
    per_wave = {"flash": cfg.n_layers,
                "decode": cfg.n_layers * (MAX_NEW - 1), "paged": 0, "ssd": 0,
                "wkv": 0}
    launches, solos, stats = _serve_waves(cfg, params, device, per_wave,
                                          "serve", repeats=3, solo_rows=(1,))
    return launches, solos[1], stats


# ------------------------------------------------------------ phase 4 ----

def _check_f32(cfg32, params32, device, plain_prefill, *, rtol=1e-3,
               atol=1e-3):
    """f32: the wave's prefill logits with the kernels against
    ``plain_prefill(batch)`` (``rtol``, ``atol``), and each request's greedy
    tokens served alone equal to served packed.  Returns (max err, solo
    tokens, the logits with the kernels)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.runtime.server import make_generate_fn, pack_prompts
    prompts = wave_prompts(cfg32)
    toks, lens = pack_prompts(prompts, pad=cfg32.pad_id)
    batch = {"tokens": torch.as_tensor(toks, device=device),
             "lengths": torch.as_tensor(lens, device=device)}
    auto = build_model(cfg32, device).prefill(params32, batch)[0]
    plain = plain_prefill(batch)
    if not torch.isfinite(auto).all():
        raise AssertionError(f"f32 {cfg32.name} prefill logits are not "
                             "finite")
    err = _max_err(auto, plain)
    if not torch.allclose(auto, plain, rtol=rtol, atol=atol):
        raise AssertionError(f"f32 {cfg32.name} prefill logits, kernels vs "
                             f"plain: max err {err:.3g} > atol {atol} + "
                             f"rtol {rtol}")
    print(f"[check] f32 {cfg32.name} prefill logits kernels vs plain: max "
          f"err {err:.3g}")

    generate = make_generate_fn(cfg32, MAX_NEW, device)
    packed = generate(params32, toks, lens)
    solos = []
    for i, p in enumerate(prompts):
        solo = generate(params32, *pack_prompts([p], pad=cfg32.pad_id))[0]
        if not bool((solo == packed[i]).all()):
            raise AssertionError(f"f32 {cfg32.name} request {i} (length "
                                 f"{len(p)}): solo tokens differ from packed")
        solos.append(solo)
    print(f"[check] f32 {cfg32.name} greedy tokens: {len(prompts)} requests "
          "solo == packed")
    return err, solos, auto


def phase_check(cfg32, params32, device):
    """smollm-360m in f32 against the plain attention."""
    from repro_torch.models import build_model
    plain = build_model(cfg32.replace(attn_impl="ref"), device)
    return _check_f32(cfg32, params32, device,
                      lambda batch: plain.prefill(params32, batch)[0])


# ------------------------------------------------------------ phase 5 ----

def paged_prompts(cfg, seed=0):
    """The wave's 8 prompts, then exact repeats of the 311- and 512-token
    prompts (radix hits) and two prompts that share the first 160 tokens
    of the 233-token prompt and then differ."""
    import numpy as np
    prompts = wave_prompts(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    by_len = {len(p): p for p in prompts}
    head = by_len[233][:160]
    tails = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
             for n in (73, 120)]
    return prompts + [list(by_len[311]), list(by_len[512]),
                      head + tails[0], head + tails[1]]


def serve_paged(cfg, params, prompts, device, handle):
    """The shared client schedule (``runtime.schedule.serve_requests``) on
    the phase-5 pool and budget, each engine call timed to its device
    sync.  Returns (tokens per request, stats of the run)."""
    import torch
    from repro_torch.runtime import engine, state
    from repro_torch.runtime.schedule import serve_requests

    def timed(fn, into):
        def call(*args, **kw):
            t = time.perf_counter()
            r = fn(*args, **kw)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t) * 1e3)
            return r
        return call

    prefill_ms, decode_ms = [], []
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    toks, log = serve_requests(
        timed(engine.engine_paged_prefill, prefill_ms),
        timed(engine.engine_paged_decode, decode_ms), params, prompts,
        cfg=cfg, handle=handle, slots=PAGED["slots"], k=PAGED["k"],
        max_new=MAX_NEW, blocks=PAGED["blocks"],
        table_width=PAGED["table_width"], block_size=PAGED["block_size"],
        budget=PAGED["budget"], device=device)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t_run) * 1e3
    state.release(handle)

    prefills = [e for e in log if e["call"] == "prefill"]
    decodes = [e for e in log if e["call"] == "decode"]
    chunk_calls, matched = [0] * len(prompts), [0] * len(prompts)
    for e in prefills:
        for s, ent in e["reply"]["slots"].items():
            req = e["requests"][int(s)]
            chunk_calls[req] += 1
            matched[req] = ent["matched"]
    occs = [e["reply"]["occupancy"] for e in log]
    st = {"chunk_forwards": sum(len(e["reply"]["slots"]) for e in prefills),
          "chunk_calls": chunk_calls, "matched": matched,
          "decode_calls": len(decodes),
          "decode_live": [len(e["live"]) for e in decodes],
          "prefill_ms": [t for t, e in zip(prefill_ms, prefills)
                         if e["reply"]["slots"]],
          "decode_ms": decode_ms, "run_ms": run_ms,
          "peak_allocated_blocks": max(o["allocated_blocks"] for o in occs),
          "peak_shared_blocks": max(o["shared_blocks"] for o in occs),
          "admitted_into_freed": sum(len(e["reused"]) for e in prefills)}
    return toks, st


def decode_at_full_slots(cfg, params, prompts, device):
    """Every slot live: prefill the first 8 requests in one call (no
    budget), then three timed decode calls (their mean) and one under the
    profiler."""
    from repro_torch.runtime import engine, state
    slots, k = PAGED["slots"], PAGED["k"]
    kw = dict(cfg=cfg, handle="smoke-full", batch=slots,
              blocks=PAGED["blocks"], table_width=PAGED["table_width"],
              block_size=PAGED["block_size"], device=device)
    prefill_ms = _wall_ms(lambda: engine.engine_paged_prefill(
        params, admit=list(enumerate(prompts[:slots])), **kw))
    step = lambda: engine.engine_paged_decode(params, cfg=cfg,  # noqa: E731
                                              handle="smoke-full", k=k)
    call_ms = sum(_wall_ms(step) for _ in range(3)) / 3
    prof = _profile(f"paged decode call ({slots} live rows, {k} steps)",
                    step, call_ms)
    state.release("smoke-full")
    return prefill_ms, call_ms / k, prof


def phase_paged(cfg, params, device, solo_bf16):
    """Paged serving at full width in bf16; exact launch counts."""
    from repro_torch.runtime.server import make_generate_fn, pack_prompts
    prompts = paged_prompts(cfg)
    serve_paged(cfg, params, prompts[:2], device, "smoke-warm")
    _zero_launches()
    toks, st = serve_paged(cfg, params, prompts, device, "smoke-paged")
    launches = _read_launches()
    want = {"flash": cfg.n_layers * st["chunk_forwards"], "decode": 0,
            "paged": cfg.n_layers * PAGED["k"] * st["decode_calls"],
            "ssd": 0, "wkv": 0}
    if launches != want:
        raise AssertionError(f"paged launch counts {launches} != expected "
                             f"{want}")
    for i, t in enumerate(toks):
        if len(t) != MAX_NEW or min(t) < 0 or max(t) >= cfg.vocab_size:
            raise AssertionError(f"paged request {i}: bad tokens {t}")
    if st["peak_shared_blocks"] <= 0:
        raise AssertionError("no block was shared")
    if max(st["chunk_calls"]) < 2:
        raise AssertionError("no prompt was chunked over two calls")
    if st["admitted_into_freed"] != len(prompts) - PAGED["slots"]:
        raise AssertionError(f"{st['admitted_into_freed']} requests were "
                             "admitted into freed slots, want "
                             f"{len(prompts) - PAGED['slots']}")
    # admission-time radix hits: the 311 repeat and the two shared heads
    # (the 512 repeat is admitted before its original finished prefill, so
    # it adopts the shared blocks later, when its turn comes)
    if not all(st["matched"][i] for i in (8, 10, 11)):
        raise AssertionError(f"radix matches {st['matched']}")
    n_tok = len(prompts) * MAX_NEW
    full_prefill_ms, full_step_ms, prof = decode_at_full_slots(
        cfg, params, prompts, device)
    summary = {
        "launches": launches, "chunk_forwards": st["chunk_forwards"],
        "chunk_calls": st["chunk_calls"], "matched": st["matched"],
        "decode_calls": st["decode_calls"],
        "decode_live_rows": st["decode_live"],
        "prefill_call_ms_mean": sum(st["prefill_ms"]) / len(st["prefill_ms"]),
        "prefill_call_ms_max": max(st["prefill_ms"]),
        "decode_ms_per_step_mean": sum(st["decode_ms"]) / (
            PAGED["k"] * len(st["decode_ms"])),
        "run_ms": st["run_ms"], "tokens_per_s": n_tok / (st["run_ms"] / 1e3),
        "peak_allocated_blocks": st["peak_allocated_blocks"],
        "peak_shared_blocks": st["peak_shared_blocks"],
        "admitted_into_freed": st["admitted_into_freed"],
        "prefill_8_unbudgeted_ms": full_prefill_ms,
        "decode_ms_per_step_8_live": full_step_ms,
        "profile_decode_8_live": prof,
    }
    print(f"[paged] launches {launches}; {st['chunk_forwards']} chunk "
          f"forwards, chunk calls per request {st['chunk_calls']}, radix "
          f"matches at admission {st['matched']}, {st['decode_calls']} "
          f"decode calls at live rows {st['decode_live']}")
    print(f"[paged] smollm-360m bf16, 12 requests on 8 slots (block 16, "
          f"table 64, pool {PAGED['blocks']} blocks, budget "
          f"{PAGED['budget']}, k {PAGED['k']}, max_new {MAX_NEW}): prefill "
          f"call {summary['prefill_call_ms_mean']:.2f} ms mean, "
          f"{summary['prefill_call_ms_max']:.2f} ms max; decode "
          f"{summary['decode_ms_per_step_mean']:.3f} ms/step mean; run "
          f"{st['run_ms']:.1f} ms, {summary['tokens_per_s']:.1f} tokens/s; "
          f"peak {st['peak_allocated_blocks']} blocks allocated, "
          f"{st['peak_shared_blocks']} shared; "
          f"{st['admitted_into_freed']} admitted into freed slots")
    print(f"[paged] all 8 slots live: prefill of the wave's 8 prompts in one "
          f"call {full_prefill_ms:.2f} ms; decode {full_step_ms:.3f} ms/step "
          f"(mean of 3 calls of {PAGED['k']} steps)")
    generate = make_generate_fn(cfg, MAX_NEW, device)
    solo = list(solo_bf16) + [
        generate(params, *pack_prompts([p], pad=cfg.pad_id))[0]
        for p in prompts[len(solo_bf16):]]
    same = sum(s.tolist() == t for s, t in zip(solo, toks))
    summary["bf16_paged_equal_solo"] = same
    print(f"[paged] bf16 paged == solo for {same}/{len(prompts)} requests")
    if same != len(prompts):
        raise AssertionError(f"bf16 paged == solo for only {same}/"
                             f"{len(prompts)} requests")
    return launches, summary


def phase_check_paged(cfg32, params32, device, solo_f32):
    """f32: the 12 requests served paged give each request's solo tokens."""
    from repro_torch.runtime.server import make_generate_fn, pack_prompts
    prompts = paged_prompts(cfg32)
    generate = make_generate_fn(cfg32, MAX_NEW, device)
    solo = list(solo_f32) + [
        generate(params32, *pack_prompts([p], pad=cfg32.pad_id))[0]
        for p in prompts[len(solo_f32):]]
    toks, st = serve_paged(cfg32, params32, prompts, device, "smoke-f32")
    for i, (s, t) in enumerate(zip(solo, toks)):
        if s.tolist() != t:
            raise AssertionError(f"f32 request {i} (length "
                                 f"{len(prompts[i])}): paged tokens differ "
                                 "from solo")
    print(f"[check] f32 greedy tokens: {len(prompts)} requests paged == "
          f"solo ({st['chunk_forwards']} chunk forwards, "
          f"{st['decode_calls']} decode calls)")


# ------------------------------------------------------------ phase 6 ----

def phase_serve_hybrid(hcfg, params, device):
    """zamba2-2.7b wave serving in bf16: kernel 4 in every Mamba2 layer's
    prefill, kernels 1 and 2 in the shared attention.  bf16 solo == packed
    is measured as a batch of 1 (as phase 3) and pinned to the wave's 8
    rows, so that every GEMM of the decode steps has the packed shape."""
    groups = hcfg.n_layers // hcfg.shared_attn_every
    per_wave = {"ssd": hcfg.n_layers, "flash": groups,
                "decode": groups * (MAX_NEW - 1), "paged": 0, "wkv": 0}
    launches, _, stats = _serve_waves(
        hcfg, params, device, per_wave, "hybrid", repeats=2,
        solo_rows=(1, len(WAVE_LENGTHS)))
    return launches, stats


def phase_check_hybrid(hcfg32, params32, device):
    """zamba2-2.7b in f32 against the plain attention and SSD."""
    from repro_torch.models.hybrid import hybrid_forward
    return _check_f32(hcfg32, params32, device, lambda batch: hybrid_forward(
        params32, hcfg32, batch["tokens"], attn_impl="ref",
        ssm_impl="chunked", last_only=True,
        lengths=batch["lengths"])[0][:, -1])[0]


# ------------------------------------------------------------ phase 7 ----

def phase_serve_rwkv(rcfg, params, device):
    """rwkv6-1.6b wave serving in bf16: kernel 5 in every layer's prefill;
    decode runs the plain one-token WKV step.  bf16 solo == packed is
    asserted as a batch of 1 and pinned to the wave's 8 rows."""
    per_wave = {"wkv": rcfg.n_layers, "flash": 0, "decode": 0, "paged": 0,
                "ssd": 0}
    launches, _, stats = _serve_waves(
        rcfg, params, device, per_wave, "rwkv", repeats=2,
        solo_rows=(1, len(WAVE_LENGTHS)))
    return launches, stats


RWKV_LOGITS_LIMIT = 0.05    # f32 logits, two WKV orders (see below)


def _wkv_layers_vs_f64(rcfg32, params32, batch, device):
    """Every layer's WKV call in one f32 prefill with the kernels, each
    held against a float64 scan of that call's own inputs at ``WKV_TOL``
    (the plain chunked form is measured the same way, for comparison).
    Returns (kernel's max err per layer, chunked form's, max |y|)."""
    import torch
    from repro_torch.kernels.rwkv6_wkv import wkv6_chunked
    from repro_torch.models import build_model
    from repro_torch.models import rwkv6 as r6
    calls, wkv6 = [], r6.wkv6

    def record(r, k, v, logw, u, s0=None, **kw):
        y, sl = wkv6(r, k, v, logw, u, s0, **kw)
        calls.append(((r, k, v, logw, u), y, sl))
        return y, sl

    r6.wkv6 = record
    try:
        build_model(rcfg32, device).prefill(params32, batch)
    finally:
        r6.wkv6 = wkv6
    if len(calls) != rcfg32.n_layers:
        raise AssertionError(f"{len(calls)} WKV calls in one prefill")
    tol = WKV_TOL["float32"]
    kern, plain, ymax = [], [], 0.0
    for li, ((r, k, v, logw, u), y, sl) in enumerate(calls):
        rd, kd, vd, ud = (t.double() for t in (r, k, v, u))
        w = torch.exp(logw.double())
        S = torch.zeros(sl.shape, dtype=torch.float64, device=sl.device)
        ys = []
        for t in range(r.shape[1]):
            kv = kd[:, t, :, :, None] * vd[:, t, :, None, :]
            ys.append(torch.einsum("bhk,bhkv->bhv", rd[:, t],
                                   S + ud[..., :, None] * kv))
            S = w[:, t, :, :, None] * S + kv
        y64 = torch.stack(ys, dim=1)
        yc, sc = wkv6_chunked(r, k, v, logw, u, chunk=rcfg32.ssm.chunk)
        kern.append(max(_max_err(y, y64), _max_err(sl, S)))
        plain.append(max(_max_err(yc, y64), _max_err(sc, S)))
        ymax = max(ymax, float(y64.abs().max()))
        if not (torch.allclose(y.double(), y64, rtol=tol, atol=tol)
                and torch.allclose(sl.double(), S, rtol=tol, atol=tol)):
            raise AssertionError(f"f32 {rcfg32.name} layer {li}: WKV kernel "
                                 f"vs a float64 scan max err {kern[-1]:.3g} "
                                 f"> {tol}")
    return kern, plain, ymax


def phase_check_rwkv(rcfg32, params32, device):
    """rwkv6-1.6b in f32.  (a) Each layer's WKV kernel call against a
    float64 scan of its own inputs at ``WKV_TOL``.  (b) The prefill logits
    with the kernel against the plain chunked WKV, and the two plain WKV
    forms (scan and chunked) against each other, each within
    ``RWKV_LOGITS_LIMIT``: the model amplifies a rounding difference in
    the WKV sums about 1.5 times a layer (both packages do,
    ``tests/test_torch_rwkv.py``), so any two WKV orders put the logits
    about 1e-2 apart after 24 layers and 1e-3 holds for none of them; the
    limit was set from runs on the card where every layer held (a).
    (c) Every request's greedy tokens solo == packed.  Returns stats."""
    import torch
    from repro_torch.models.rwkv_model import rwkv_forward
    from repro_torch.runtime.server import pack_prompts

    def plain(batch, impl="chunked"):
        return rwkv_forward(params32, rcfg32, batch["tokens"], ssm_impl=impl,
                            last_only=True, lengths=batch["lengths"])[0][:, -1]

    toks, lens = pack_prompts(wave_prompts(rcfg32), pad=rcfg32.pad_id)
    batch = {"tokens": torch.as_tensor(toks, device=device),
             "lengths": torch.as_tensor(lens, device=device)}
    kern, chunked, ymax = _wkv_layers_vs_f64(rcfg32, params32, batch,
                                             device)
    print(f"[check] f32 {rcfg32.name} WKV per layer vs a float64 scan of "
          f"its inputs (max |y| {ymax:.4g}): kernel max err "
          f"{[float(f'{e:.3g}') for e in kern]}; plain chunked "
          f"{[float(f'{e:.3g}') for e in chunked]}")
    err, _, auto = _check_f32(rcfg32, params32, device, plain, rtol=0.0,
                              atol=RWKV_LOGITS_LIMIT)
    spread = _max_err(plain(batch, "scan"), plain(batch))
    print(f"[check] f32 {rcfg32.name} prefill logits (max |logit| "
          f"{float(auto.abs().max()):.4g}), plain scan vs plain chunked "
          f"WKV: max |diff| {spread:.3g}")
    if not spread <= RWKV_LOGITS_LIMIT:
        raise AssertionError(f"f32 {rcfg32.name} logits, plain scan vs "
                             f"chunked: {spread:.3g} > {RWKV_LOGITS_LIMIT}")
    return {"f32_logits_max_err": err, "f32_logits_scan_vs_chunked": spread,
            "f32_logits_max_abs": float(auto.abs().max()),
            "f32_wkv_layer_max_err": max(kern),
            "f32_wkv_layer_max_err_chunked": max(chunked),
            "f32_wkv_max_abs_y": ymax}


# --------------------------------------------------------------- main ----

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")

    phase_build()
    cfg = get_config("smollm-360m")
    hcfg = get_config("zamba2-2.7b")
    rcfg = get_config("rwkv6-1.6b")
    fa, dec = phase_kernels(cfg, device)
    paged_k, fa_chunk = phase_kernels_paged(cfg, device)
    ssd_k, fa_h, dec_h = phase_kernels_hybrid(hcfg, device)
    wkv_k = phase_kernels_rwkv(rcfg, device)
    rows = phase_rows((cfg, hcfg, rcfg), device)

    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    t = time.perf_counter()
    params32 = build_model(cfg32, device).init(
        torch.Generator().manual_seed(0))
    params = _cast(params32, torch.bfloat16)
    print(f"[init] smollm-360m random weights in {time.perf_counter() - t:.1f}"
          " s")
    launches, solo_bf16, serve = phase_serve(cfg, params, device)
    paged_launches, paged = phase_paged(cfg, params, device, solo_bf16)
    del params
    _, solo_f32, _ = phase_check(cfg32, params32, device)
    phase_check_paged(cfg32, params32, device, solo_f32)
    del params32

    hcfg32 = hcfg.replace(param_dtype="float32", compute_dtype="float32")
    t = time.perf_counter()
    params32 = build_model(hcfg32, device).init(
        torch.Generator(device=device).manual_seed(0))
    params = _cast(params32, torch.bfloat16)
    torch.cuda.synchronize()
    print(f"[init] {hcfg.name} random weights in "
          f"{time.perf_counter() - t:.1f} s")
    hybrid_launches, hybrid = phase_serve_hybrid(hcfg, params, device)
    del params
    torch.cuda.empty_cache()
    hybrid["f32_logits_max_err"] = phase_check_hybrid(hcfg32, params32,
                                                      device)
    del params32
    torch.cuda.empty_cache()

    rcfg32 = rcfg.replace(param_dtype="float32", compute_dtype="float32")
    t = time.perf_counter()
    params32 = build_model(rcfg32, device).init(
        torch.Generator(device=device).manual_seed(0))
    params = _cast(params32, torch.bfloat16)
    torch.cuda.synchronize()
    print(f"[init] {rcfg.name} random weights in "
          f"{time.perf_counter() - t:.1f} s")
    rwkv_launches, rwkv = phase_serve_rwkv(rcfg, params, device)
    del params
    torch.cuda.empty_cache()
    rwkv.update(phase_check_rwkv(rcfg32, params32, device))
    del params32

    by_path = {name: {"wave": launches[name], "paged": paged_launches[name],
                      "hybrid": hybrid_launches[name],
                      "rwkv": rwkv_launches[name]} for name in launches}
    kernels = [
        dict(name="flash_attention_bshd", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:95",
             launches=sum(by_path["flash"].values()),
             launches_by_path=by_path["flash"], **fa,
             at_chunk_shape=fa_chunk, at_hybrid_shape=fa_h),
        dict(name="flash_decode_bshd", route="cuda",
             source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:82",
             launches=sum(by_path["decode"].values()),
             launches_by_path=by_path["decode"], **dec,
             at_hybrid_shape=dec_h),
        dict(name="flash_decode_paged_bshd", route="cuda",
             source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:187",
             launches=sum(by_path["paged"].values()),
             launches_by_path=by_path["paged"], **paged_k),
        dict(name="ssd_chunked_bshp", route="cuda",
             source="src/repro_torch/csrc/mamba2_ssd.cu",
             replaces="src/repro/kernels/mamba2_ssd/kernel.py:71",
             launches=sum(by_path["ssd"].values()),
             launches_by_path=by_path["ssd"], **ssd_k),
        dict(name="wkv6_chunked_bshk", route="cuda",
             source="src/repro_torch/csrc/rwkv6_wkv.cu",
             replaces="src/repro/kernels/rwkv6_wkv/kernel.py:69",
             launches=sum(by_path["wkv"].values()),
             launches_by_path=by_path["wkv"], **wkv_k),
    ]
    print(json.dumps({"rows": rows, "serve": serve, "paged": paged,
                      "hybrid": hybrid, "rwkv": rwkv}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


if __name__ == "__main__":
    sys.exit(main())
