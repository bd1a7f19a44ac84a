#!/usr/bin/env python3
"""Where zamba2-2.7b's bf16 prefill first tells a request served alone from
the same request packed in the 8-request wave.

For each request it runs the hybrid prefill layer by layer twice (alone, and
packed with the wave of ``chip_smoke.py``), and compares the request's real
positions bit for bit after each stage: the Mamba2 in-projections (z, x, B,
C, dt), each Mamba2 layer's output, and each shared block's output.  It
prints the first stage that differs and its max |difference|.

Run on a CUDA card from the repository root:

    python3 tools/chip_hybrid_invariance.py
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def stages(cfg, params, toks, lens):
    """[(name, tensor (B, S, ...))] of one prefill, in order."""
    import torch
    from repro_torch.models import hybrid as H
    from repro_torch.models import mamba2 as M
    from repro_torch.models.layers import (embed_apply, pad_mask,
                                           ragged_positions, rms_norm)
    x = embed_apply(params["embed"], toks).to(getattr(torch,
                                                      cfg.compute_dtype))
    x0 = x
    b, s = toks.shape
    pos, start = ragged_positions(lens, b, s, x.device)
    mask = pad_mask(lens, s)
    out = []
    every = cfg.shared_attn_every
    for gi in range(cfg.n_layers // every):
        for li in range(gi * every, (gi + 1) * every):
            lp = H._mamba_layer(params, li)
            h = rms_norm(x, params["mamba"]["ln"][li], cfg.rms_eps)
            for nm, t in zip(("z", "x", "B", "C", "dt"),
                             M._inner(lp, h, head_dim=cfg.ssm.head_dim)):
                out.append((f"layer {li} in-proj {nm}", t))
            h, _ = M.mamba2_apply(lp, h, head_dim=cfg.ssm.head_dim,
                                  chunk=cfg.ssm.chunk, rms_eps=cfg.rms_eps,
                                  mask=mask, start=start)
            x = x + h
            out.append((f"layer {li} mamba2", x))
        x = H._shared_block(params["shared"], H._lora(params, gi), x, x0,
                            pos, cfg, "auto", kv_start=start)
        out.append((f"group {gi} shared block", x))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_hybrid_invariance: torch sees no CUDA card",
              file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime.server import pack_prompts

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("zamba2-2.7b")
    params = chip_smoke._cast(build_model(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(0)), torch.bfloat16)
    prompts = chip_smoke.wave_prompts(cfg)

    def run(batch):
        toks, lens = (torch.as_tensor(a, device="cuda")
                      for a in pack_prompts(batch, pad=cfg.pad_id))
        with torch.no_grad():
            return stages(cfg, params, toks, lens)

    packed = run(prompts)
    for i, p in enumerate(prompts):
        n = len(p)
        for (name, a), (_, b) in zip(run([p]), packed):
            sa, sb = a[0, -n:], b[i, -n:]
            if not torch.equal(sa, sb):
                diff = float((sa.float() - sb.float()).abs().max())
                print(f"request {i} (length {n}): first differs at {name}, "
                      f"max |diff| {diff:.3g}")
                break
        else:
            print(f"request {i} (length {n}): every stage bitwise equal")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
