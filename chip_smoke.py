#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits nonzero):

1. build   — compile both CUDA kernels from ``src/repro_torch/csrc`` (one
             ``nvcc`` per source, started together) and print the seconds.
2. kernels — hold each kernel against its plain PyTorch version on the card
             (f32 at 2e-5, bf16 at 2e-2), at the serving shapes and at
             D 20, ragged ``kv_start``, filler rows and a window; time the
             kernel, the plain version and one PyTorch library call
             (``scaled_dot_product_attention``, timed only, never used by
             the port).
3. serve   — ``smollm-360m`` at full width in bf16 with random weights from
             ``torch.Generator().manual_seed(0)``: a wave of 8 ragged
             requests and a wave of 3 with filler rows, through
             ``pack_prompts`` and ``make_generate_fn``.  Both kernels'
             launch counts must move by exactly the expected amounts.
4. check   — in f32: prefill logits with the kernels against the plain
             path (1e-3), and greedy tokens of each request served alone
             equal to those served packed.

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
MAX_NEW = 32
WAVE_LENGTHS = (1, 64, 97, 160, 233, 311, 420, 512)


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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
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


def phase_kernels(cfg, device):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                      flash_decode_bshd)
    from repro_torch.kernels.flash_attention import (attention_xla,
                                                     flash_attention_bshd)
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

    # times at the serving shapes in bf16 (the last `main` / `dmain`)
    q, k, v, ks = main
    cols = torch.arange(s, device=device)
    mask = ((cols[None, :] <= cols[:, None])[None]
            & (cols[None, None, :] >= ks[:, None, None]))      # (B,S,S)
    pairs = int(mask.sum())
    live_rows = sum(WAVE_LENGTHS)
    es = q.element_size()
    fa_bytes = es * (live_rows * (hq + 2 * hkv) * d + b * s * hq * d)
    fa_bound, fa_by, *fa_parts = _bound(fa_bytes, 4 * pairs * hq * d,
                                        "bfloat16")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fa = {
        "ms": _time_ms(lambda: flash_attention_bshd(q, k, v, ks)),
        "plain_ms": _time_ms(lambda: attention_xla(q, k, v, kv_start=ks)),
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)),
        "bound_ms": fa_bound, "bound_by": fa_by, "max_abs_err": errs["flash"],
    }
    q, k, v, kl, ks = dmain
    valid = sum(max(0, min(n, cap) - st) for n, st in zip(lens, starts))
    dec_bytes = es * (valid * 2 * hkv * d + 2 * b * hq * d)
    dec_bound, dec_by, *dec_parts = _bound(dec_bytes, 4 * valid * hq * d,
                                           "bfloat16")
    ccols = torch.arange(cap, device=device)
    dmask = ((ccols[None, :] >= ks[:, None])
             & (ccols[None, :] < kl[:, None]))[:, None, None]  # (B,1,1,Skv)
    q4, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    dec = {
        "ms": _time_ms(lambda: flash_decode_bshd(q, k, v, kl, ks)),
        "plain_ms": _time_ms(lambda: decode_attention_ref(q, k, v, kl,
                                                          kv_start=ks)),
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=dmask, enable_gqa=True)),
        "bound_ms": dec_bound, "bound_by": dec_by,
        "max_abs_err": errs["decode"],
    }
    for name, r, (t_bytes, t_ops) in (("flash", fa, fa_parts),
                                       ("decode", dec, dec_parts)):
        print(f"[kernels] {name} bf16 serving shape: kernel {r['ms']:.4f} ms"
              f", plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}; bytes {t_bytes:.5f} ms, operations "
              f"{t_ops:.5f} ms)")
    return fa, dec


# ------------------------------------------------------------ phase 3 ----

def wave_prompts(cfg, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in WAVE_LENGTHS]
    prompts[3][::7] = [cfg.pad_id] * len(prompts[3][::7])   # holds pad_id
    return prompts


def phase_serve(cfg, params, device):
    import torch
    from repro_torch.kernels.decode_attention import flash_decode_bshd
    from repro_torch.kernels.flash_attention import flash_attention_bshd
    from repro_torch.models import build_model, grow_cache
    from repro_torch.runtime.server import make_generate_fn, pack_prompts
    prompts = wave_prompts(cfg)
    waves = [pack_prompts(prompts, pad=cfg.pad_id),
             pack_prompts(prompts[:3], pad=cfg.pad_id, min_rows=8)]
    generate = make_generate_fn(cfg, MAX_NEW, device)
    first = make_generate_fn(cfg, 1, device)
    generate(params, *waves[0])          # warm-up: allocator, cuBLAS
    torch.cuda.synchronize()

    flash_attention_bshd.launches = 0
    flash_decode_bshd.launches = 0
    outs = [generate(params, toks, lens) for toks, lens in waves]
    torch.cuda.synchronize()
    launches = {"flash": flash_attention_bshd.launches,
                "decode": flash_decode_bshd.launches}
    want = {"flash": cfg.n_layers * len(waves),
            "decode": cfg.n_layers * (MAX_NEW - 1) * len(waves)}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    for (toks, lens), out in zip(waves, outs):
        if tuple(out.shape) != (toks.shape[0], MAX_NEW):
            raise AssertionError(f"tokens shape {tuple(out.shape)}")
        if bool((out < 0).any() or (out >= cfg.vocab_size).any()):
            raise AssertionError("generated ids outside the vocabulary")
    print(f"[serve] launches in the two waves: {launches}")

    toks, lens = waves[0]
    prefill_ms = min(_wall_ms(lambda: first(params, toks, lens))
                     for _ in range(3))
    wave_ms = min(_wall_ms(lambda: generate(params, toks, lens))
                  for _ in range(3))
    decode_ms = (wave_ms - prefill_ms) / (MAX_NEW - 1)
    tok_s = len(prompts) * MAX_NEW / (wave_ms / 1e3)
    print(f"[serve] smollm-360m bf16 wave of {len(prompts)} (B{toks.shape[0]}"
          f" S{toks.shape[1]}, max_new {MAX_NEW}): prefill {prefill_ms:.2f}"
          f" ms, decode {decode_ms:.3f} ms/step, wave {wave_ms:.1f} ms, "
          f"{tok_s:.1f} tokens/s")

    model = build_model(cfg, device)
    batch = {"tokens": torch.as_tensor(toks, device=device),
             "lengths": torch.as_tensor(lens, device=device)}
    prof = {"prefill": _profile("prefill", lambda: model.prefill(
        params, batch), prefill_ms)}
    logits, cache = model.prefill(params, batch)
    cache = grow_cache(cfg, cache, toks.shape[1] + MAX_NEW)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    prof["decode"] = _profile("decode step", lambda: model.decode(
        params, cache, tok), decode_ms)

    # bf16 invariance is an open question: measured, not asserted
    same = sum(
        bool((generate(params, *pack_prompts([p], pad=cfg.pad_id))[0]
              == outs[0][i]).all())
        for i, p in enumerate(prompts))
    print(f"[serve] bf16 solo == packed for {same}/{len(prompts)} requests")
    return launches, {"prefill_ms": prefill_ms, "decode_ms_per_step":
                      decode_ms, "wave_ms": wave_ms, "tokens_per_s": tok_s,
                      "bf16_solo_equal": same, "profile": prof}


# ------------------------------------------------------------ phase 4 ----

def phase_check(cfg32, params32, device):
    import torch
    from repro_torch.models import build_model
    from repro_torch.runtime.server import make_generate_fn, pack_prompts
    prompts = wave_prompts(cfg32)
    toks, lens = pack_prompts(prompts, pad=cfg32.pad_id)
    batch = {"tokens": torch.as_tensor(toks, device=device),
             "lengths": torch.as_tensor(lens, device=device)}
    auto = build_model(cfg32, device).prefill(params32, batch)[0]
    ref = build_model(cfg32.replace(attn_impl="ref"),
                      device).prefill(params32, batch)[0]
    if not torch.isfinite(auto).all():
        raise AssertionError("f32 prefill logits are not finite")
    err = _max_err(auto, ref)
    if not torch.allclose(auto, ref, rtol=1e-3, atol=1e-3):
        raise AssertionError(f"f32 prefill logits, kernels vs plain: max "
                             f"err {err:.3g} > 1e-3")
    print(f"[check] f32 prefill logits kernels vs plain: max err {err:.3g}")

    generate = make_generate_fn(cfg32, MAX_NEW, device)
    packed = generate(params32, toks, lens)
    for i, p in enumerate(prompts):
        solo = generate(params32, *pack_prompts([p], pad=cfg32.pad_id))[0]
        if not bool((solo == packed[i]).all()):
            raise AssertionError(f"f32 request {i} (length {len(p)}): solo "
                                 f"tokens differ from packed")
    print(f"[check] f32 greedy tokens: {len(prompts)} requests solo == "
          "packed")
    return err


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
    fa, dec = phase_kernels(cfg, device)

    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    t = time.perf_counter()
    params32 = build_model(cfg32, device).init(
        torch.Generator().manual_seed(0))
    params = _cast(params32, torch.bfloat16)
    print(f"[init] smollm-360m random weights in {time.perf_counter() - t:.1f}"
          " s")
    launches, serve = phase_serve(cfg, params, device)
    del params
    phase_check(cfg32, params32, device)

    kernels = [
        dict(name="flash_attention_bshd", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:95",
             launches=launches["flash"], **fa),
        dict(name="flash_decode_bshd", route="cuda",
             source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:82",
             launches=launches["decode"], **dec),
    ]
    print(json.dumps({"serve": serve}))
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
