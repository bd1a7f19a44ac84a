"""Public SSD op: impl dispatch.

impl: "auto" — the CUDA kernel for a CUDA tensor, the plain chunked
version for a CPU tensor; "scan" (the exact sequential oracle) or
"chunked" (the plain chunked form) — an explicit request for a plain
version on any device.  "cuda" is another name for "auto", so that the
SSD op takes the impl names of the port's attention ops.  The kernel reads
B and C at their groups and masks the ragged last chunk, so no repeat or
pad copy is made for it.
"""
from __future__ import annotations

from .kernel import ssd_chunked_bshp
from .ref import ssd_chunked, ssd_decode_ref, ssd_scan_ref

IMPLS = ("auto", "scan", "chunked")


def ssd(x, dt, A, Bm, Cm, h0=None, *, chunk: int = 64, start=None,
        impl: str = "auto"):
    """Mamba2 SSD scan.  x (B,S,H,P); dt (B,S,H); A (H,); Bm/Cm (B,S,G,N);
    h0 (B,H,P,N) or None -> (y (B,S,H,P), h_final).

    ``start`` (B,) int32: each row's first real token; the steps before it
    must be identities (x, Bm, Cm and dt 0 there).  The kernel starts its
    chunk walk there; the plain versions run over them.
    """
    impl = "auto" if impl == "cuda" else impl     # the attention ops' name
    if impl == "scan":
        return ssd_scan_ref(x, dt, A, Bm, Cm, h0)
    if impl == "chunked":
        return ssd_chunked(x, dt, A, Bm, Cm, h0, chunk=chunk)
    if impl not in IMPLS:
        raise ValueError(f"ssd: impl {impl!r} not in {IMPLS}")
    return ssd_chunked_bshp(x, dt, A, Bm, Cm, h0, chunk=chunk, start=start)


ssd_decode = ssd_decode_ref
