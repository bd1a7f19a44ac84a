"""GQA attention block with a KV cache and RoPE.

Two execution modes from the same params:
  * full   — prefill: the CUDA flash kernel (plain version on the CPU),
             optionally returning the K/V that fill the cache
  * decode — one token against the cache (CUDA decode kernel or plain)

The JAX package's int8 KV cache, M-RoPE, cross-attention and paged
(block-table) functions are not ported yet.
"""
from __future__ import annotations

import torch

from ..kernels.decode_attention import decode_attention
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
