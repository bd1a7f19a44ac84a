"""Plain PyTorch version of single-token (decode) attention over a cache.

q (B, Hq, D) — one new token per row.
k, v (B, Skv, Hkv, D) — the cache; entries at positions >= kv_len are junk.
kv_len (B,) int32 — valid cache length per row (the new token's k/v is
already written at kv_len-1).
kv_start (B,) int32 — first valid cache position per row; entries below it
are left-pad slots from a ragged prefill and are masked out.

``decode_attention_paged_ref`` reads the cache from a block pool
(NB, BS, Hkv, D) through a per-row block table (B, T): it gathers the table
into the contiguous layout and defers to ``decode_attention_ref``, as the
JAX package's plain path does.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def decode_attention_ref(q, k, v, kv_len, *, window: int = 0,
                         scale: float | None = None, kv_start=None):
    b, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)

    kr = k.repeat_interleave(g, dim=2)                  # (B,Skv,Hq,D)
    vr = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kr.float()) * scale

    kv_len = kv_len.to(q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]  # (1,Skv)
    mask = cols < kv_len
    if kv_start is not None:
        mask &= cols >= kv_start.to(q.device)[:, None]
    if window:
        mask &= cols >= torch.clamp(kv_len - window, min=0)
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    # all-masked row -> 0 output (the kernel's l == 0 convention), never NaN
    p = p * mask.any(-1, keepdim=True)[:, None, :]
    out = torch.einsum("bhk,bkhd->bhd", p, vr.float())
    return out.to(q.dtype)


def decode_attention_paged_ref(q, k_pool, v_pool, table, kv_len, *,
                               window: int = 0, scale: float | None = None,
                               kv_start=None):
    """Row b's logical column c is pool[table[b, c // BS], c % BS]; the
    gather is plain indexing, so this is the function the paged kernel
    computes."""
    b = q.shape[0]
    _, bs, hkv, d = k_pool.shape
    t = table.shape[1]
    table = table.long()
    kc = k_pool[table].reshape(b, t * bs, hkv, d)
    vc = v_pool[table].reshape(b, t * bs, hkv, d)
    return decode_attention_ref(q, kc, vc, kv_len, window=window,
                                scale=scale, kv_start=kv_start)


def pool_from_contiguous(k, v, block_size: int, *, lens=None,
                         generator=None):
    """Contiguous (B, Skv, Hkv, D) caches -> block pools (NB, BS, Hkv, D)
    and the (B, T) int32 table that gathers back to them, block 0 being
    the trash block.  ``generator`` scrambles the physical placement; with
    ``lens`` every table entry past a row's length points at the trash
    block."""
    b, skv, hkv, d = k.shape
    t = -(-skv // block_size)
    pad = t * block_size - skv
    if pad:
        k = torch.cat([k, k.new_zeros((b, pad, hkv, d))], 1)
        v = torch.cat([v, v.new_zeros((b, pad, hkv, d))], 1)
    nb = 1 + b * t
    perm = (torch.arange(nb - 1, device=k.device) if generator is None else
            torch.randperm(nb - 1, generator=generator, device=k.device))
    table = (1 + perm).reshape(b, t)
    pool_k = k.new_zeros((nb, block_size, hkv, d))
    pool_v = v.new_zeros((nb, block_size, hkv, d))
    pool_k[table] = k.reshape(b, t, block_size, hkv, d)
    pool_v[table] = v.reshape(b, t, block_size, hkv, d)
    if lens is not None:
        cols = torch.arange(t, device=k.device)[None, :] * block_size
        table = torch.where(cols < lens.to(k.device)[:, None], table, 0)
    return pool_k, pool_v, table.to(torch.int32).contiguous()
