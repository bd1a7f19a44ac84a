"""Zamba2-style hybrid: a stack of Mamba2 blocks with ONE shared attention
block applied every k blocks, modulated per application by LoRA deltas.

The shared block consumes concat(x, x0) (current hidden + original
embedding, zamba2's re-injection trick) and projects back to d_model.  The
layers run in plain Python loops over the stacked parameters: G groups of
k Mamba2 layers, each group followed by the shared block with that group's
LoRA.

Entry points from one parameter tree:

  hybrid_forward  tokens -> logits, optionally with the prefill cache
  hybrid_decode   one token + cache -> logits (B, V) + cache (updated in
                  place)

On the card the Mamba2 layers' prefill runs the CUDA SSD kernel
(``ssm_impl="auto"``, the counterpart of the JAX package's
``ssm_impl="pallas"``), the shared block's prefill the flash attention
kernel and its decode the decode attention kernel.
"""
from __future__ import annotations

import weakref

import torch

from ..configs.base import ModelConfig
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import attention
from .layers import (apply_rope, dense_init, embed_apply, embed_init,
                     linear, mlp_apply, pad_mask, ragged_positions, rms_norm)
from .mamba2 import mamba2_apply, mamba2_decode, mamba2_init


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_every


def hybrid_init(gen: torch.Generator, cfg: ModelConfig, device):
    """Random params from ``gen``, in the JAX package's tree and layouts.

    Each weight is scaled by its true fan-in: 2d for wq/wk/wv and the
    LoRA's qa, H·D for the shared wo and the LoRA's oa, d for the Mamba2
    projections.  The JAX package's ``dense_init`` takes ``shape[-2]``,
    which is H, D and G = 1 for the first three (see the fault list in
    ROADMAP.md)."""
    dt = _dtype(cfg.param_dtype)
    L, G = cfg.n_layers, _n_groups(cfg)
    d, r = cfg.d_model, cfg.shared_attn_lora_rank
    hd = cfg.n_heads * cfg.head_dim
    kw = dict(dtype=dt, device=device)
    p = {"embed": embed_init(gen, cfg.vocab_size, d, dt, device)}
    mp = mamba2_init(gen, d, expand=cfg.ssm.expand,
                     state_dim=cfg.ssm.state_dim, head_dim=cfg.ssm.head_dim,
                     conv_width=cfg.ssm.conv_width, stack=(L,), **kw)
    p["mamba"] = {"ln": torch.zeros((L, d), **kw), **mp}

    # shared attention block on concat(x, x0) -> d
    p["shared"] = {
        "ln": torch.zeros((2 * d,), **kw),
        "wq": dense_init(gen, (2 * d, cfg.n_heads, cfg.head_dim),
                         fan_in=2 * d, **kw),
        "wk": dense_init(gen, (2 * d, cfg.n_kv_heads, cfg.head_dim),
                         fan_in=2 * d, **kw),
        "wv": dense_init(gen, (2 * d, cfg.n_kv_heads, cfg.head_dim),
                         fan_in=2 * d, **kw),
        "wo": dense_init(gen, (cfg.n_heads, cfg.head_dim, d), fan_in=hd,
                         **kw),
        "ln2": torch.zeros((2 * d,), **kw),
        # the GLU reads the 2d concat and projects back to d
        "mlp": {"wi": dense_init(gen, (2 * d, cfg.d_ff), **kw),
                "wg": dense_init(gen, (2 * d, cfg.d_ff), **kw),
                "wo": dense_init(gen, (cfg.d_ff, d), **kw)},
    }
    # per-application LoRA deltas on wq/wo
    p["lora"] = {
        "qa": dense_init(gen, (G, 2 * d, r), **kw),
        "qb": torch.zeros((G, r, hd), **kw),
        "oa": dense_init(gen, (G, hd, r), **kw),
        "ob": torch.zeros((G, r, d), **kw),
    }
    p["final_norm"] = torch.zeros((d,), **kw)
    p["unembed"] = embed_init(gen, cfg.vocab_size, d, dt, device)
    return p


def _heads(u, w):
    """u (B,S,2d) @ w (2d, H, D) -> (B,S,H,D)."""
    return linear(u, w.flatten(1)).unflatten(-1, w.shape[1:])


_FOLDED_Q = {}        # ids of (wq, qa, qb) -> (weakrefs, versions, folded)


def _folded_q(p):
    """wq + qa @ qb for every group, (G, 2d, H·D): the shared q projection
    with the group's LoRA folded in.  The JAX package computes the delta as
    (u @ qa) @ qb; with N = rank 128 and K = 2d cuBLAS takes split-K
    kernels for u @ qa up to 512 rows, so a row's q would depend on the
    batch.  The fold is formed once per parameter tree (the tensors'
    identity and version key it), not on every call."""
    ts = (p["shared"]["wq"], p["lora"]["qa"], p["lora"]["qb"])
    key, ver = tuple(map(id, ts)), tuple(t._version for t in ts)
    hit = _FOLDED_Q.get(key)
    if hit and hit[1] == ver and all(r() is t for r, t in zip(hit[0], ts)):
        return hit[2]
    folded = ts[0].flatten(1) + torch.matmul(ts[1], ts[2])
    refs = tuple(weakref.ref(t, lambda _, k=key: _FOLDED_Q.pop(k, None))
                 for t in ts)
    _FOLDED_Q[key] = (refs, ver, folded)
    return folded


def _shared_qkv(ap, lora, u, positions, cfg):
    """Project concat-input u (B,S,2d) -> q/k/v; q through the group's
    folded projection ``lora["wq"]`` (``_folded_q``)."""
    q = linear(u, lora["wq"]).unflatten(-1, ap["wq"].shape[1:])
    k = _heads(u, ap["wk"])
    v = _heads(u, ap["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _shared_out(ap, lora, o):
    """o (B,S,H,D) -> (B,S,d) with LoRA on the output proj."""
    flat = o.flatten(2)
    out = linear(flat, ap["wo"].flatten(0, 1))
    return out + linear(linear(flat, lora["oa"]), lora["ob"])


def _shared_mlp(ap, x, x0, cfg):
    h = rms_norm(torch.cat([x, x0], dim=-1), ap["ln2"], cfg.rms_eps)
    return x + mlp_apply(ap["mlp"], h, cfg.act)


def _shared_block(ap, lora, x, x0, positions, cfg, attn_impl,
                  return_kv=False, kv_start=None):
    u = torch.cat([x, x0], dim=-1)
    h = rms_norm(u, ap["ln"], cfg.rms_eps)
    q, k, v = _shared_qkv(ap, lora, h, positions, cfg)
    o = attention(q, k, v, causal=True, window=cfg.window, impl=attn_impl,
                  kv_start=kv_start)
    x = _shared_mlp(ap, x + _shared_out(ap, lora, o), x0, cfg)
    if return_kv:
        return x, (k, v)
    return x


def _mamba_layer(p, i):
    """Layer ``i``'s Mamba2 params (views) without its pre-norm."""
    return {k: v[i] for k, v in p["mamba"].items() if k != "ln"}


def _lora(p, gi):
    """Group ``gi``'s LoRA deltas (views) and, as ``"wq"``, its folded q
    projection."""
    return {**{k: v[gi] for k, v in p["lora"].items()},
            "wq": _folded_q(p)[gi]}


def hybrid_forward(p, cfg: ModelConfig, tokens, attn_impl: str = "auto",
                   ssm_impl: str = "auto", collect_cache: bool = False,
                   last_only: bool = False, lengths=None):
    """``lengths`` (B,) int32: real-token count per left-padded row.  Pad
    slots are identity transitions for the Mamba2 conv/SSD state and
    masked keys for the shared attention, so outputs at real positions (and
    the collected caches) do not depend on the batch.

    With ``collect_cache`` returns ``(logits, (states, (k, v)))``: states
    ``{"conv": (cx, cB, cC), "ssd": ...}`` stacked over the L layers and
    ``"start"``, the (B,) int32 left-pad count, k/v (G, B, S, Hkv, D) in the
    param dtype."""
    dt = _dtype(cfg.compute_dtype)
    x = embed_apply(p["embed"], tokens).to(dt)
    x0 = x
    b, s_len = x.shape[:2]
    positions, kv_start = ragged_positions(lengths, b, s_len, x.device)
    mask = None if lengths is None else pad_mask(lengths, s_len)
    G, k_every = _n_groups(cfg), cfg.shared_attn_every
    cdt = _dtype(cfg.param_dtype)
    states, kvs = [], []
    for gi in range(G):
        for j in range(k_every):
            li = gi * k_every + j
            h = rms_norm(x, p["mamba"]["ln"][li], cfg.rms_eps)
            h, st = mamba2_apply(
                _mamba_layer(p, li), h, head_dim=cfg.ssm.head_dim,
                chunk=cfg.ssm.chunk, impl=ssm_impl, rms_eps=cfg.rms_eps,
                mask=mask, start=kv_start)
            x = x + h
            if collect_cache:
                states.append(st)
        x, (ck, cv) = _shared_block(p["shared"], _lora(p, gi), x,
                                    x0, positions, cfg, attn_impl,
                                    return_kv=True, kv_start=kv_start)
        if collect_cache:
            kvs.append((ck.to(cdt), cv.to(cdt)))
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, p["final_norm"], cfg.rms_eps)
    logits = linear(x, p["unembed"].t())
    logits = logits.float() if cfg.logits_fp32 else logits
    if not collect_cache:
        return logits, {}
    msts = {"conv": tuple(torch.stack([st["conv"][i] for st in states])
                          for i in range(3)),
            "ssd": torch.stack([st["ssd"] for st in states]),
            "start": (torch.zeros((b,), dtype=torch.int32, device=x.device)
                      if kv_start is None else kv_start)}
    return logits, (msts, (torch.stack([kv[0] for kv in kvs]),
                           torch.stack([kv[1] for kv in kvs])))


def hybrid_init_cache(cfg: ModelConfig, batch: int, cap: int, device,
                      filled: int | None = None, start=None):
    """Zero cache of capacity ``cap``; idx = filled (default cap-1).
    ``start`` (B,) int32: per-row first valid slot; default 0."""
    cdt = _dtype(cfg.param_dtype)
    L, G = cfg.n_layers, _n_groups(cfg)
    d_in = cfg.ssm.expand * cfg.d_model
    h = d_in // cfg.ssm.head_dim
    w1 = cfg.ssm.conv_width - 1
    gn = cfg.ssm.state_dim
    kw = dict(dtype=cdt, device=device)
    if start is None:
        start = torch.zeros((batch,), dtype=torch.int32, device=device)
    kv = (G, batch, cap, cfg.n_kv_heads, cfg.head_dim)
    return {
        "conv_x": torch.zeros((L, batch, w1, d_in), **kw),
        "conv_B": torch.zeros((L, batch, w1, gn), **kw),
        "conv_C": torch.zeros((L, batch, w1, gn), **kw),
        "ssd": torch.zeros((L, batch, h, cfg.ssm.head_dim, cfg.ssm.state_dim),
                           dtype=torch.float32, device=device),
        "k": torch.zeros(kv, **kw),
        "v": torch.zeros(kv, **kw),
        "idx": cap - 1 if filled is None else filled,
        "start": start,
    }


def hybrid_decode(p, cfg: ModelConfig, cache, tokens,
                  attn_impl: str = "auto"):
    """One decode step.  tokens (B, 1) -> logits (B, V) and the cache with
    every layer's conv/SSD state and the shared block's new K/V written in
    place (the JAX version returns updated copies) and ``idx`` advanced."""
    dt = _dtype(cfg.compute_dtype)
    x = embed_apply(p["embed"], tokens).to(dt)
    x0 = x
    b = x.shape[0]
    idx = cache["idx"]
    start = cache.get("start")
    positions = torch.full((b, 1), idx, dtype=torch.int32, device=x.device)
    if start is not None:
        positions = positions - start[:, None]
    G, k_every = _n_groups(cfg), cfg.shared_attn_every
    kv_len = torch.full((b,), idx + 1, dtype=torch.int32, device=x.device)
    for gi in range(G):
        for j in range(k_every):
            li = gi * k_every + j
            h = rms_norm(x, p["mamba"]["ln"][li], cfg.rms_eps)
            conv = (cache["conv_x"][li], cache["conv_B"][li],
                    cache["conv_C"][li])
            h, new = mamba2_decode(_mamba_layer(p, li), h,
                                   {"conv": conv, "ssd": cache["ssd"][li]},
                                   head_dim=cfg.ssm.head_dim,
                                   rms_eps=cfg.rms_eps)
            x = x + h
            for old, nw in zip(conv, new["conv"]):
                old.copy_(nw)
            cache["ssd"][li].copy_(new["ssd"])

        ap, lora = p["shared"], _lora(p, gi)
        h = rms_norm(torch.cat([x, x0], dim=-1), ap["ln"], cfg.rms_eps)
        q, k, v = _shared_qkv(ap, lora, h, positions, cfg)
        ck, cv = cache["k"][gi], cache["v"][gi]
        ck[:, idx] = k[:, 0].to(ck.dtype)
        cv[:, idx] = v[:, 0].to(cv.dtype)
        o = decode_attention(q[:, 0], ck, cv, kv_len, window=cfg.window,
                             impl=attn_impl, kv_start=start)[:, None]
        x = _shared_mlp(ap, x + _shared_out(ap, lora, o), x0, cfg)
    x = rms_norm(x, p["final_norm"], cfg.rms_eps)
    logits = linear(x[:, -1], p["unembed"].t())
    logits = logits.float() if cfg.logits_fp32 else logits
    return logits, {**cache, "idx": idx + 1}
