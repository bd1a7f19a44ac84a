"""Decoder-only dense LM with its layers stacked on a leading axis.

Entry points from one parameter tree:

  prefill        tokens -> last-token logits (B, V) + KV cache
  decode         one token + cache -> logits (B, V) + cache (updated in
                 place)
  decode_paged   one token per row against shared block pools (updated in
                 place) -> logits (B, V)
  prefill_paged  one chunk of one row's prompt into the block pools ->
                 logits of its last real token (1, V)

The JAX package's training forward, MoE, M-RoPE and int8 KV are not ported
yet.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .attention import (attn_decode, attn_decode_paged, attn_full,
                        attn_init, attn_prefill_paged)
from .layers import (embed_apply, embed_init, mlp_apply, mlp_init,
                     ragged_positions, rms_norm)
from .stacking import scan_layers


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def lm_init(gen: torch.Generator, cfg: ModelConfig, device):
    """Random params from ``gen``, in the JAX package's tree and layouts."""
    dt = _dtype(cfg.param_dtype)
    L = cfg.n_layers
    p = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device)}
    p["layers"] = {
        "ln1": torch.zeros((L, cfg.d_model), dtype=dt, device=device),
        "ln2": torch.zeros((L, cfg.d_model), dtype=dt, device=device),
        "attn": attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, dt, device, bias=cfg.qkv_bias,
                          stack=(L,)),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dt, device,
                        stack=(L,)),
    }
    p["final_norm"] = torch.zeros((cfg.d_model,), dtype=dt, device=device)
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dt,
                                  device)
    return p


def _embed_in(p, cfg, tokens):
    return embed_apply(p["embed"], tokens).to(_dtype(cfg.compute_dtype))


def _logits(p, cfg, x):
    x = rms_norm(x, p["final_norm"], cfg.rms_eps)
    table = p["embed"] if cfg.tie_embeddings else p["unembed"]
    out = torch.matmul(x, table.t())
    return out.float() if cfg.logits_fp32 else out


def _ffn(lp, cfg: ModelConfig, h):
    if cfg.moe.n_experts:
        raise NotImplementedError("MoE layers are not ported yet")
    return mlp_apply(lp["mlp"], h, cfg.act)


def lm_prefill(p, cfg: ModelConfig, tokens, attn_impl: str = "auto",
               lengths=None):
    """Prefill: last-token logits + populated KV cache.

    ``lengths`` (B,) int32: real-token count per left-padded row.  Pad keys
    are masked out of every attention layer and RoPE positions count real
    tokens, so a prompt's logits (and its cache suffix) do not depend on
    the ragged company it was packed with.  The cache records each row's
    first valid slot under ``"start"`` and the next write slot under
    ``"idx"`` (a host int).
    """
    x = _embed_in(p, cfg, tokens)
    b, s_len = x.shape[:2]
    positions, kv_start = ragged_positions(lengths, b, s_len, x.device)
    cdt = _dtype(cfg.param_dtype)

    def body(x, lp):
        h = rms_norm(x, lp["ln1"], cfg.rms_eps)
        h, (k, v) = attn_full(lp["attn"], h, positions, causal=True,
                              window=cfg.window, rope_theta=cfg.rope_theta,
                              impl=attn_impl, kv_start=kv_start,
                              return_kv=True)
        x = x + h
        h = _ffn(lp, cfg, rms_norm(x, lp["ln2"], cfg.rms_eps))
        return x + h, (k.to(cdt), v.to(cdt))

    x, (ck, cv) = scan_layers(body, x, p["layers"])
    logits = _logits(p, cfg, x[:, -1])
    start = (torch.zeros((b,), dtype=torch.int32, device=x.device)
             if kv_start is None else kv_start)
    return logits, {"k": ck, "v": cv, "idx": s_len, "start": start}


def lm_init_cache(cfg: ModelConfig, batch: int, cap: int, device,
                  filled: int | None = None, start=None):
    """Zero cache of capacity ``cap``; idx = filled (default cap-1: a full
    cache with the new token in the last slot).  ``start`` (B,) int32:
    per-row first valid slot; default 0 = fully dense rows."""
    cdt = _dtype(cfg.param_dtype)
    shp = (cfg.n_layers, batch, cap, cfg.n_kv_heads, cfg.head_dim)
    if start is None:
        start = torch.zeros((batch,), dtype=torch.int32, device=device)
    return {"k": torch.zeros(shp, dtype=cdt, device=device),
            "v": torch.zeros(shp, dtype=cdt, device=device),
            "idx": cap - 1 if filled is None else filled, "start": start}


def lm_decode(p, cfg: ModelConfig, cache, tokens, attn_impl: str = "auto"):
    """One decode step.  tokens (B, 1) -> logits (B, V) and the cache with
    the new token's K/V written in place and ``idx`` advanced."""
    x = _embed_in(p, cfg, tokens)
    idx = cache["idx"]
    start = cache["start"]

    def body(x, xs):
        lp, ck, cv = xs
        h = rms_norm(x, lp["ln1"], cfg.rms_eps)
        h, _, _ = attn_decode(lp["attn"], h, ck, cv, idx, window=cfg.window,
                              rope_theta=cfg.rope_theta, impl=attn_impl,
                              kv_start=start)
        x = x + h
        h = _ffn(lp, cfg, rms_norm(x, lp["ln2"], cfg.rms_eps))
        return x + h, None

    x, _ = scan_layers(body, x, (p["layers"], cache["k"], cache["v"]))
    logits = _logits(p, cfg, x[:, -1])
    return logits, {**cache, "idx": idx + 1}


# -------------------------------------------------- paged (block-table) ----

def lm_decode_paged(p, cfg: ModelConfig, pool_k, pool_v, table, lens, live,
                    tokens, attn_impl: str = "auto"):
    """One decode step against a shared block pool.

    tokens (B,1); pool_k/pool_v (L,NB,BS,Hkv,D); table (B,T) int32;
    lens (B,) int32 resident tokens per row; live (B,) bool.  Each row's new
    K/V lands at logical column ``lens[b]`` through its table (dead rows
    write the trash block), in place.  Returns (logits (B,V), pool_k,
    pool_v) — per-row lens/table bookkeeping is the host's job (block
    refcounts live there).
    """
    x = _embed_in(p, cfg, tokens)

    def body(x, xs):
        lp, pk, pv = xs
        h = rms_norm(x, lp["ln1"], cfg.rms_eps)
        h, _, _ = attn_decode_paged(lp["attn"], h, pk, pv, table, lens, live,
                                    window=cfg.window,
                                    rope_theta=cfg.rope_theta,
                                    impl=attn_impl)
        x = x + h
        h = _ffn(lp, cfg, rms_norm(x, lp["ln2"], cfg.rms_eps))
        return x + h, None

    x, _ = scan_layers(body, x, (p["layers"], pool_k, pool_v))
    return _logits(p, cfg, x[:, -1]), pool_k, pool_v


def lm_prefill_paged_chunk(p, cfg: ModelConfig, tokens, pool_k, pool_v,
                           table, m: int, n_real: int,
                           attn_impl: str = "auto"):
    """One chunk of continued prefill for a single row (B == 1).

    tokens (1,C) right-padded, n_real real; ``m`` tokens of the row are
    already resident in the pool, so this chunk covers logical columns
    [m, m + n_real).  Returns (last-real-token logits (1,V), pools).
    Chaining chunks with growing m gives a monolithic prefill's logits
    and cache: the attention kernel walks the same tiles either way.
    """
    x = _embed_in(p, cfg, tokens)

    def body(x, xs):
        lp, pk, pv = xs
        h = rms_norm(x, lp["ln1"], cfg.rms_eps)
        h, _, _ = attn_prefill_paged(lp["attn"], h, pk, pv, table, m,
                                     n_real, window=cfg.window,
                                     rope_theta=cfg.rope_theta,
                                     impl=attn_impl)
        x = x + h
        h = _ffn(lp, cfg, rms_norm(x, lp["ln2"], cfg.rms_eps))
        return x + h, None

    x, _ = scan_layers(body, x, (p["layers"], pool_k, pool_v))
    return _logits(p, cfg, x[:, n_real - 1]), pool_k, pool_v
