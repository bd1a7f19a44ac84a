"""Public attention op: impl dispatch over the (B, S, H, D) layout.

impl: "auto" or "cuda" — the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor; "ref" (the oracle) or "xla" (query-chunked) — an
explicit request for a plain version on any device.  The kernel reads the
model's layout by stride, so no transpose or pad copy is made here.
"""
from __future__ import annotations

from .kernel import flash_attention_bshd
from .ref import attention_ref, attention_xla

IMPLS = ("auto", "cuda", "ref", "xla")


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: int = 0, scale: float | None = None,
              kv_len=None, kv_start=None, impl: str = "auto"):
    """q (B,Sq,Hq,D); k,v (B,Skv,Hkv,D) -> (B,Sq,Hq,D).

    ``kv_start`` (B,) int32: per-row left-pad count — kv positions below it
    are masked on every impl.  A fully masked row outputs 0, never NaN.
    ``kv_len`` (B,) int32: valid cache length per row (chunked prefill
    over a gathered paged view); keys at or past it are masked on every
    impl.
    """
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale,
              kv_len=kv_len, kv_start=kv_start)
    if impl == "ref":
        return attention_ref(q, k, v, **kw)
    if impl == "xla":
        return attention_xla(q, k, v, **kw)
    if impl not in IMPLS:
        raise ValueError(f"attention: impl {impl!r} not in {IMPLS}")
    return flash_attention_bshd(q, k, v, **kw)
