"""Public WKV6 op: impl dispatch.

impl: "auto" — the CUDA kernel for a CUDA tensor, the plain chunked
version for a CPU tensor; "scan" (the exact sequential oracle) or
"chunked" (the plain chunked form) — an explicit request for a plain
version on any device.  The kernel reads the (B, S, H, K) layout by stride
and masks the ragged last chunk, so no transpose or pad copy is made for
it; the plain chunked form pads S to the chunk with r = k = v = 0 and
logw = 0 steps, as the JAX op does.
"""
from __future__ import annotations

from .kernel import wkv6_chunked_bshk
from .ref import wkv6_chunked, wkv6_decode_ref, wkv6_scan_ref

IMPLS = ("auto", "scan", "chunked")


def wkv6(r, k, v, logw, u, s0=None, *, chunk: int = 64, start=None,
         impl: str = "auto"):
    """RWKV-6 WKV.  r/k/v/logw (B,S,H,K); u (H,K); s0 (B,H,K,V) or None ->
    (y (B,S,H,V), s_final (B,H,K,V) f32).

    ``start`` (B,) int32: each row's first real token; the steps before it
    must be identities (r = k = v = 0 there, a zero state entering them).
    The kernel starts each row's chunk walk there and gives y = 0 before
    it; the plain versions ignore ``start`` and run over those steps, which
    is the same function.
    """
    if impl == "scan":
        return wkv6_scan_ref(r, k, v, logw, u, s0)
    if impl == "chunked":
        return wkv6_chunked(r, k, v, logw, u, s0, chunk=chunk)
    if impl not in IMPLS:
        raise ValueError(f"wkv6: impl {impl!r} not in {IMPLS}")
    return wkv6_chunked_bshk(r, k, v, logw, u, s0, chunk=chunk, start=start)


wkv6_decode = wkv6_decode_ref
