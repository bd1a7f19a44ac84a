"""RWKV-6 model: embed -> [time-mix + channel-mix] x L -> unembed.

Attention-free: the cache is O(1) in the sequence length, one WKV state
(B, H, K, V) f32 and two token-shift vectors (B, d) per layer.

Entry points from one parameter tree:

  rwkv_forward  tokens -> logits, optionally with the prefill cache
  rwkv_decode   one token + cache -> logits (B, V) + cache (updated in
                place)

On the card the prefill's WKV takes the CUDA kernel (``ssm_impl="auto"``);
the JAX package's ``build_model`` never passes its ``ssm_impl``, so its
serve path runs the plain ``"chunked"`` form.  Decode runs the plain
one-token step, as in JAX.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .layers import (embed_apply, embed_init, linear, pad_mask,
                     ragged_positions, rms_norm)
from .rwkv6 import (rwkv6_channel_mix, rwkv6_init, rwkv6_time_mix,
                    rwkv6_time_mix_decode)
from .stacking import scan_layers


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def rwkv_init(gen: torch.Generator, cfg: ModelConfig, device):
    """Random params from ``gen``, in the JAX package's tree and layouts."""
    dt = _dtype(cfg.param_dtype)
    L, d = cfg.n_layers, cfg.d_model
    p = {"embed": embed_init(gen, cfg.vocab_size, d, dt, device)}
    lp = rwkv6_init(gen, d, cfg.d_ff, n_heads=cfg.ssm.n_heads,
                    head_dim=cfg.ssm.head_dim, dtype=dt, device=device,
                    stack=(L,))
    lp["ln1"] = torch.zeros((L, d), dtype=dt, device=device)
    lp["ln2"] = torch.zeros((L, d), dtype=dt, device=device)
    p["layers"] = lp
    p["final_norm"] = torch.zeros((d,), dtype=dt, device=device)
    p["unembed"] = embed_init(gen, cfg.vocab_size, d, dt, device)
    return p


def _split(lp):
    tm = {k: v for k, v in lp.items()
          if not k.startswith("cm_") and k not in ("ln1", "ln2")}
    cm = {k: v for k, v in lp.items() if k.startswith("cm_")}
    return tm, cm


def _logits(p, cfg, x):
    x = rms_norm(x, p["final_norm"], cfg.rms_eps)
    logits = linear(x, p["unembed"].t())
    return logits.float() if cfg.logits_fp32 else logits


def rwkv_forward(p, cfg: ModelConfig, tokens, ssm_impl: str = "auto",
                 collect_cache: bool = False, last_only: bool = False,
                 lengths=None):
    """``lengths`` (B,) int32: real-token count per left-padded row.  The
    mix inputs of every layer are zeroed on pad slots, so a pad step
    contributes nothing to the WKV state or the token-shift stream: the
    first real token sees the zero shift and state a fresh decode would,
    whatever the batch's padded length.  The left-pad count goes to the WKV
    op as ``start``, so the kernel walks each row from its first real
    token.

    With ``collect_cache`` returns ``(logits, cache)``: ``wkv`` (L,B,H,K,V)
    f32, ``shift_att``/``shift_ffn`` (L,B,d) and ``idx``."""
    x = embed_apply(p["embed"], tokens).to(_dtype(cfg.compute_dtype))
    b, s_len = tokens.shape
    _, start = ragged_positions(lengths, b, s_len, x.device)
    mask = (None if lengths is None
            else pad_mask(lengths, s_len)[..., None].to(x.dtype))

    def body(x, lp):
        tm, cm = _split(lp)
        h = rms_norm(x, lp["ln1"], cfg.rms_eps)
        if mask is not None:
            h = h * mask
        h, s_last, tshift = rwkv6_time_mix(
            tm, h, n_heads=cfg.ssm.n_heads, head_dim=cfg.ssm.head_dim,
            chunk=cfg.ssm.chunk, impl=ssm_impl, start=start)
        x = x + h
        h = rms_norm(x, lp["ln2"], cfg.rms_eps)
        if mask is not None:
            h = h * mask
        h, cshift = rwkv6_channel_mix(cm, h)
        x = x + h
        return x, ((s_last, tshift, cshift) if collect_cache else None)

    x, caches = scan_layers(body, x, p["layers"])
    if last_only:
        x = x[:, -1:]
    logits = _logits(p, cfg, x)
    if not collect_cache:
        return logits, {}
    wkv, tshift, cshift = caches
    return logits, {"wkv": wkv, "shift_att": tshift, "shift_ffn": cshift,
                    "idx": s_len}


def rwkv_init_cache(cfg: ModelConfig, batch: int, cap: int, device,
                    filled: int | None = None):
    """Zero cache; ``cap`` only sets the default idx (cap - 1), as in JAX:
    the state has no sequence axis."""
    L, h, k = cfg.n_layers, cfg.ssm.n_heads, cfg.ssm.head_dim
    cdt = _dtype(cfg.compute_dtype)
    return {"wkv": torch.zeros((L, batch, h, k, k), dtype=torch.float32,
                               device=device),
            "shift_att": torch.zeros((L, batch, cfg.d_model), dtype=cdt,
                                     device=device),
            "shift_ffn": torch.zeros((L, batch, cfg.d_model), dtype=cdt,
                                     device=device),
            "idx": cap - 1 if filled is None else filled}


def rwkv_decode(p, cfg: ModelConfig, cache, tokens):
    """One decode step.  tokens (B, 1) -> logits (B, V) and the cache with
    every layer's WKV state and token shifts written in place (the JAX
    version returns updated copies) and ``idx`` advanced."""
    x = embed_apply(p["embed"], tokens).to(_dtype(cfg.compute_dtype))
    for li in range(cfg.n_layers):
        lp = {k: v[li] for k, v in p["layers"].items()}
        tm, cm = _split(lp)
        wkv, sa, sf = (cache[k][li] for k in ("wkv", "shift_att",
                                               "shift_ffn"))
        h = rms_norm(x, lp["ln1"], cfg.rms_eps)
        h_att = h[:, -1]
        h, wkv_new, _ = rwkv6_time_mix_decode(
            tm, h, wkv, sa, n_heads=cfg.ssm.n_heads,
            head_dim=cfg.ssm.head_dim)
        x = x + h
        h = rms_norm(x, lp["ln2"], cfg.rms_eps)
        h_ffn = h[:, -1]
        h, _ = rwkv6_channel_mix(cm, h, shift0=sf)
        x = x + h
        wkv.copy_(wkv_new)
        sa.copy_(h_att)
        sf.copy_(h_ffn)
    logits = _logits(p, cfg, x[:, -1])
    return logits, {**cache, "idx": cache["idx"] + 1}
