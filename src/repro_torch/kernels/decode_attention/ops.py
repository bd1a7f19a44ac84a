"""Public decode-attention ops.

- ``decode_attention``       — a contiguous (B, Skv, Hkv, D) cache.
- ``decode_attention_paged`` — a block pool (NB, BS, Hkv, D) addressed
  through a per-row int32 block table (B, T).

impl: "auto" or "cuda" — the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor; "ref" or "xla" — the plain version on any device.
The kernel groups the G query heads of a KV head itself and masks the
ragged tail, so no reshape, transpose or pad copy is made here.
"""
from __future__ import annotations

from .kernel import flash_decode_bshd, flash_decode_paged_bshd
from .ref import decode_attention_paged_ref, decode_attention_ref

IMPLS = ("auto", "cuda", "ref", "xla")


def decode_attention(q, k, v, kv_len, *, window: int = 0,
                     scale: float | None = None, kv_start=None,
                     impl: str = "auto"):
    """q (B,Hq,D); k,v (B,Skv,Hkv,D); kv_len (B,) -> (B,Hq,D).

    ``kv_start`` (B,) int32 masks cache slots below it — the left-pad
    prefix a ragged prefill left in the cache (None = no padding).
    """
    if impl in ("ref", "xla"):
        return decode_attention_ref(q, k, v, kv_len, window=window,
                                    scale=scale, kv_start=kv_start)
    if impl not in IMPLS:
        raise ValueError(f"decode_attention: impl {impl!r} not in {IMPLS}")
    return flash_decode_bshd(q, k, v, kv_len, kv_start, window=window,
                             scale=scale)


def decode_attention_paged(q, k_pool, v_pool, table, kv_len, *,
                           window: int = 0, scale: float | None = None,
                           kv_start=None, impl: str = "auto"):
    """q (B,Hq,D); k_pool/v_pool (NB,BS,Hkv,D); table (B,T) int32 of pool
    block ids; kv_len (B,) -> (B,Hq,D).  Row b's logical column c is
    pool[table[b, c // BS], c % BS]; entries past the row's length should
    be 0 (the reserved trash block) so every read stays in bounds."""
    if impl in ("ref", "xla"):
        return decode_attention_paged_ref(q, k_pool, v_pool, table, kv_len,
                                          window=window, scale=scale,
                                          kv_start=kv_start)
    if impl not in IMPLS:
        raise ValueError(f"decode_attention_paged: impl {impl!r} not in "
                         f"{IMPLS}")
    return flash_decode_paged_bshd(q, k_pool, v_pool, table, kv_len,
                                   kv_start, window=window, scale=scale)
