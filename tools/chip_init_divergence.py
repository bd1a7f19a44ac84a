#!/usr/bin/env python3
"""How far smollm-360m's f32 residual stream drifts between the CUDA
attention kernels and the plain attention, under two random inits.

Per layer it prints (a) the max |difference| of the attention output when
both impls see the same input, and (b) the max |difference| of the residual
stream when each impl feeds its own, then the last-token logits' max error.
The two inits differ only in the attention weights' scale: the port's
``lm_init`` (1/sqrt of the true fan-in: d for wq/wk/wv, H·D for wo) and the
JAX package's (``dense_init`` takes ``shape[-2]``: H for wq/wk/wv, D for
wo), rebuilt here by rescaling.

With ``--arch zamba2-2.7b`` it does the same for the hybrid at full width
in f32, at the level of the last-token logits: the prefill with the kernels
(SSD, flash attention) against the plain path, under the port's
``hybrid_init`` and under the JAX package's scales (1/sqrt(H) for the
shared wq/wk/wv, 1/sqrt(D) for its wo, 1 for the Mamba2 wB/wC).

Run on a CUDA card from the repository root:

    python3 tools/chip_init_divergence.py [--arch zamba2-2.7b]
"""
from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def drift(cfg, params, toks, lens):
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import attn_full
    from repro_torch.models.layers import ragged_positions, rms_norm

    x = T._embed_in(params, cfg, toks)
    xr = x.clone()
    pos, ks = ragged_positions(lens, x.shape[0], x.shape[1], x.device)
    kw = dict(rope_theta=cfg.rope_theta, kv_start=ks)
    same, stream = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h_ref = rms_norm(xr, lp["ln1"], cfg.rms_eps)
        a_ref = attn_full(lp["attn"], h_ref, pos, impl="ref", **kw)
        a_cuda = attn_full(lp["attn"], h_ref, pos, impl="cuda", **kw)
        same.append(float((a_cuda - a_ref).abs().max()))
        h = rms_norm(x, lp["ln1"], cfg.rms_eps)
        x = x + attn_full(lp["attn"], h, pos, impl="cuda", **kw)
        x = x + T._ffn(lp, cfg, rms_norm(x, lp["ln2"], cfg.rms_eps))
        xr = xr + a_ref
        xr = xr + T._ffn(lp, cfg, rms_norm(xr, lp["ln2"], cfg.rms_eps))
        stream.append(float((x - xr).abs().max()))
    logits = (T._logits(params, cfg, x[:, -1])
              - T._logits(params, cfg, xr[:, -1]))
    return same, stream, float(logits.abs().max())


def hybrid_logits_gap(cfg, params, toks, lens):
    """Max |difference| of the f32 last-token logits, kernels against the
    plain path."""
    from repro_torch.models.hybrid import hybrid_forward
    kw = dict(last_only=True, lengths=lens)
    cuda = hybrid_forward(params, cfg, toks, attn_impl="auto",
                          ssm_impl="auto", **kw)[0]
    plain = hybrid_forward(params, cfg, toks, attn_impl="ref",
                           ssm_impl="chunked", **kw)[0]
    return float((cuda - plain).abs().max())


def main_hybrid(cfg, toks, lens) -> None:
    import torch
    from repro_torch.models import build_model
    params = build_model(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    shared = dict(params["shared"])
    for k, heads in (("wq", h), ("wk", cfg.n_kv_heads),
                     ("wv", cfg.n_kv_heads)):
        shared[k] = shared[k] * math.sqrt(2 * d / heads)
    shared["wo"] = shared["wo"] * math.sqrt(h)
    mamba = {**params["mamba"], "wB": params["mamba"]["wB"] * math.sqrt(d),
             "wC": params["mamba"]["wC"] * math.sqrt(d)}
    jax_params = {**params, "shared": shared, "mamba": mamba}
    for label, p in (("port init (true fan-in)", params),
                     ("JAX dense_init fan-in", jax_params)):
        gap = hybrid_logits_gap(cfg, p, toks, lens)
        print(f"{cfg.name} {label}: last-token logits max diff, kernels vs "
              f"plain: {gap:.3g}")


def main() -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m",
                    choices=("smollm-360m", "zamba2-2.7b"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_init_divergence: torch sees no CUDA card",
              file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime.server import pack_prompts

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch).replace(param_dtype="float32",
                                        compute_dtype="float32")
    toks, lens = pack_prompts(chip_smoke.wave_prompts(cfg), pad=cfg.pad_id)
    toks = torch.as_tensor(toks, device="cuda")
    lens = torch.as_tensor(lens, device="cuda")
    if args.arch == "zamba2-2.7b":
        main_hybrid(cfg, toks, lens)
        print(_card())
        return 0
    params = build_model(cfg, "cuda").init(torch.Generator().manual_seed(0))

    attn = params["layers"]["attn"]
    jax_attn = {k: v * math.sqrt(cfg.d_model / (cfg.n_heads if k == "wq"
                                                else cfg.n_kv_heads))
                for k, v in attn.items() if k in ("wq", "wk", "wv")}
    jax_attn["wo"] = attn["wo"] * math.sqrt(cfg.n_heads)
    jax_params = {**params, "layers": {**params["layers"],
                                       "attn": jax_attn}}
    for label, p in (("port init (true fan-in)", params),
                     ("JAX dense_init fan-in", jax_params)):
        same, stream, logits = drift(cfg, p, toks, lens)
        print(f"{label}: attention, same input, max diff per layer: "
              + " ".join(f"{v:.2g}" for v in same))
        print(f"{label}: residual stream max diff per layer: "
              + " ".join(f"{v:.2g}" for v in stream))
        print(f"{label}: last-token logits max diff {logits:.3g}")
    print(_card())
    return 0


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
