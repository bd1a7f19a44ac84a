"""GQA attention block with a KV cache and RoPE.

Execution modes from the same params:
  * full          — prefill: the CUDA flash kernel (plain version on the
                    CPU), optionally returning the K/V that fill the cache
  * decode        — one token against the cache (CUDA decode kernel or
                    plain)
  * decode_paged  — one token against a block pool through a per-row block
                    table (CUDA paged decode kernel or plain)
  * prefill_paged — one chunk of continued prefill into a block pool (the
                    flash kernel with a kv_len bound, or plain)

The JAX package's int8 KV cache, M-RoPE and cross-attention are not ported
yet.
"""
from __future__ import annotations

import torch

from ..kernels.decode_attention import (decode_attention,
                                        decode_attention_paged)
from ..kernels.flash_attention import attention
from .layers import apply_rope, dense_init


def attn_init(gen, d_model: int, n_heads: int, n_kv_heads: int,
              head_dim: int, dtype, device, *, bias: bool = False,
              stack: tuple[int, ...] = ()):
    """Params in the JAX package's layouts: wq/wk/wv (d, H, D), wo (H, D, d).

    Each weight is scaled by its true fan-in (d for the projections in,
    H·D for the projection out).  The JAX package's ``dense_init`` takes
    ``shape[-2]`` (H) instead, which makes q·k/sqrt(D) ~100 wide at smollm
    width: attention turns one-hot and 1-ulp summation differences flip
    which key wins (see the fault list in ROADMAP.md)."""
    p = {
        "wq": dense_init(gen, (*stack, d_model, n_heads, head_dim), dtype,
                         device, fan_in=d_model),
        "wk": dense_init(gen, (*stack, d_model, n_kv_heads, head_dim), dtype,
                         device, fan_in=d_model),
        "wv": dense_init(gen, (*stack, d_model, n_kv_heads, head_dim), dtype,
                         device, fan_in=d_model),
        "wo": dense_init(gen, (*stack, n_heads, head_dim, d_model), dtype,
                         device, fan_in=n_heads * head_dim),
    }
    if bias:
        for nm, hs in (("bq", n_heads), ("bk", n_kv_heads),
                       ("bv", n_kv_heads)):
            p[nm] = torch.zeros((*stack, hs, head_dim), dtype=dtype,
                                device=device)
    return p


def _project(p, x, positions, *, rope_theta):
    """x (B,S,d) -> q (B,S,Hq,D), k/v (B,S,Hkv,D), rotary applied."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def attn_full(p, x, positions, *, causal=True, window=0, rope_theta=0.0,
              impl="auto", kv_start=None, return_kv=False):
    """Prefill attention.  kv_start (B,): per-row left-pad count — pad keys
    are masked out."""
    q, k, v = _project(p, x, positions, rope_theta=rope_theta)
    o = attention(q, k, v, causal=causal, window=window, impl=impl,
                  kv_start=kv_start)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def attn_decode(p, x, cache_k, cache_v, idx: int, *, window=0,
                rope_theta=0.0, impl="auto", kv_start=None):
    """One-token attention.  x (B,1,d); cache_k/v (B,Smax,Hkv,D); ``idx``
    the host-side position of the new token.  kv_start (B,): per-row first
    valid cache slot — it masks the left pad and offsets RoPE so the new
    token's position counts real tokens.

    The new K/V are written into ``cache_k``/``cache_v`` in place (the JAX
    version returns updated copies via dynamic_update_slice); the same
    tensors are returned.  Returns (out, cache_k, cache_v)."""
    b = x.shape[0]
    positions = torch.full((b, 1), idx, dtype=torch.int32, device=x.device)
    if kv_start is not None:
        positions = positions - kv_start[:, None]
    q, k, v = _project(p, x, positions, rope_theta=rope_theta)
    cache_k[:, idx] = k[:, 0].to(cache_k.dtype)
    cache_v[:, idx] = v[:, 0].to(cache_v.dtype)
    kv_len = torch.full((b,), idx + 1, dtype=torch.int32, device=x.device)
    o = decode_attention(q[:, 0], cache_k, cache_v, kv_len, window=window,
                         impl=impl, kv_start=kv_start)
    out = torch.einsum("bhk,hkd->bd", o, p["wo"])[:, None]
    return out, cache_k, cache_v


# -------------------------------------------------- paged (block-table) ----
# Paged rows are RIGHT-dense: row content occupies logical columns
# [0, len), kv_start is always 0, and RoPE position == logical column —
# the per-row block table maps logical columns to physical pool blocks.
# Both facts together are what make paged decode equal to the left-padded
# solo path: the per-token q/k values are equal (same RoPE positions), and
# the kernels walk the same logical keys in the same order.  The pools are
# updated in place (``index_put_`` on the layer's view); the JAX package
# returns updated copies.

def attn_decode_paged(p, x, pool_k, pool_v, table, lens, live, *, window=0,
                      rope_theta=0.0, impl="auto"):
    """One-token attention against a block pool.

    x (B,1,d); pool_k/pool_v (NB,BS,Hkv,D); table (B,T) int32;
    lens (B,) int32 tokens already resident per row; live (B,) bool.

    The new token is written at logical column ``lens`` — physically
    ``pool[table[b, lens // BS], lens % BS]``.  Dead rows write to the
    reserved trash block 0 (never read unmasked: their kv_len is 0, so
    the kernel's l == 0 guard zeroes the whole row).
    Returns (out, pool_k, pool_v)."""
    b = x.shape[0]
    bs = pool_k.shape[1]
    q, k, v = _project(p, x, lens[:, None], rope_theta=rope_theta)
    rows = torch.arange(b, device=x.device)
    col = torch.where(live, lens, 0)          # dead rows: no table lookup
    blk = torch.where(live, table[rows, col // bs], 0)
    off = lens % bs
    pool_k.index_put_((blk, off), k[:, 0].to(pool_k.dtype))
    pool_v.index_put_((blk, off), v[:, 0].to(pool_v.dtype))
    kv_len = torch.where(live, lens + 1, 0).to(torch.int32)
    o = decode_attention_paged(q[:, 0], pool_k, pool_v, table, kv_len,
                               window=window, impl=impl)
    out = torch.einsum("bhk,hkd->bd", o, p["wo"])[:, None]
    return out, pool_k, pool_v


def attn_prefill_paged(p, x, pool_k, pool_v, table, m: int, n_real: int, *,
                       window=0, rope_theta=0.0, impl="auto"):
    """One chunk of continued prefill against a block pool (B == 1).

    x (1,C,d) — the chunk's embeddings, real tokens in [0, n_real), the
    rest right-pad; ``m`` (a host int) is how many tokens of this row the
    pool already holds, so chunk token j is logical column m + j.  K/V for
    real chunk positions scatter into the row's table-mapped blocks (pad
    positions go to the trash block); attention runs q_offset = m against
    the full gathered table view, masked to kv_len = m + n_real.
    Returns (out (1,C,d-model), pool_k, pool_v)."""
    _, c, _ = x.shape
    bs = pool_k.shape[1]
    t = table.shape[1]
    j = torch.arange(c, dtype=torch.int32, device=x.device)
    q, k, v = _project(p, x, (m + j)[None, :], rope_theta=rope_theta)
    real = j < n_real
    ti = torch.where(real, (m + j) // bs, 0)          # clamp pad lookups
    blk = torch.where(real, table[0, ti], 0)
    off = (m + j) % bs
    pool_k.index_put_((blk, off), k[0].to(pool_k.dtype))
    pool_v.index_put_((blk, off), v[0].to(pool_v.dtype))
    row = table[0].long()
    kview = pool_k[row].reshape(1, t * bs, *pool_k.shape[2:])
    vview = pool_v[row].reshape(1, t * bs, *pool_v.shape[2:])
    kv_len = torch.full((1,), m + n_real, dtype=torch.int32, device=x.device)
    o = attention(q, kview.to(q.dtype), vview.to(q.dtype), causal=True,
                  window=window, q_offset=m, kv_len=kv_len, impl=impl)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, pool_k, pool_v
