"""Wrapper of the CUDA SSD scan kernel (``csrc/mamba2_ssd.cu``).

The port's counterpart of the TPU kernel ``ssd_chunked_pallas`` in
``repro/kernels/mamba2_ssd/kernel.py``.  It takes B and C at their G
groups (the kernel reads group ``h // (H // G)`` in place) and any S (the
ragged last chunk is masked in the kernel), so nothing is repeated or
padded.  A CPU tensor takes the plain chunked version; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import load, stream_of
from .ref import ssd_chunked

MAX_CHUNK = 128          # chunk rows the kernel stages
MAX_DIM = 64             # P and N the kernel stages
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
             + [ctypes.c_longlong] * 15 + [ctypes.c_void_p])


def _check(x, dt, A, Bm, Cm, h0, start, chunk):
    name = "ssd_chunked_bshp"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x is on {x.device}, the kernel needs a "
                         "CUDA tensor")
    for nm, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("h0", h0),
                  ("start", start)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: {nm} is on {t.device}, x on "
                             f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not in (float32, "
                        "bfloat16)")
    for nm, t in (("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: {nm} is {t.dtype}, x is {x.dtype}")
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"{name}: want x (B,S,H,P), dt (B,S,H) and Bm, Cm "
                         f"(B,S,G,N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    b, s, h, p = x.shape
    g, n = Bm.shape[2:]
    if dt.shape != (b, s, h) or Bm.shape[:2] != (b, s) or h % g:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not fit dt "
                         f"{tuple(dt.shape)} or Bm {tuple(Bm.shape)}")
    if not (1 <= p <= MAX_DIM and 1 <= n <= MAX_DIM
            and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"{name}: P {p} and N {n} must be in 1..{MAX_DIM}, "
                         f"chunk {chunk} in 1..{MAX_CHUNK}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)):
        raise ValueError(f"{name}: the last dim of x, Bm and Cm must be "
                         "contiguous")
    if A.dtype != torch.float32 or A.shape != (h,) or not A.is_contiguous():
        raise ValueError(f"{name}: A must be a contiguous ({h},) float32 "
                         "tensor")
    if h0 is not None and (h0.dtype != torch.float32
                           or h0.shape != (b, h, p, n)
                           or not h0.is_contiguous()):
        raise ValueError(f"{name}: h0 must be a contiguous {(b, h, p, n)} "
                         "float32 tensor")
    if start is not None and (start.dtype != torch.int32
                              or start.shape != (b,)
                              or not start.is_contiguous()):
        raise ValueError(f"{name}: start must be a contiguous (B,) int32 "
                         "tensor on x's device")


def ssd_chunked_bshp(x, dt, A, Bm, Cm, h0=None, *, chunk: int = 64,
                     start=None):
    """x (B,S,H,P); dt (B,S,H); A (H,) f32; Bm/Cm (B,S,G,N); h0 (B,H,P,N)
    f32 or None -> (y (B,S,H,P) in x's dtype, h_final (B,H,P,N) f32).

    ``start`` (B,) int32: each row's first real token (the left-pad count).
    The steps before it must be identities (x, Bm, Cm and dt 0 there); the
    kernel skips them and writes y = 0 there, so a row's result does not
    depend on how much left pad its batch added.  The plain version ignores
    ``start``: on such inputs it computes the same function."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, h0, chunk=chunk)
    _check(x, dt, A, Bm, Cm, h0, start, chunk)
    b, s, h, p = x.shape
    g, n = Bm.shape[2:]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    hout = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    fn = load("mamba2_ssd", "repro_ssd_chunked", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), h0.data_ptr() if h0 is not None else None,
                 start.data_ptr() if start is not None else None,
                 y.data_ptr(), hout.data_ptr(), _DTYPES[x.dtype], b, s, h,
                 g, p, n, int(chunk), *(x.stride()[:3]), *dt.stride(),
                 *(Bm.stride()[:3]), *(Cm.stride()[:3]), *(y.stride()[:3]),
                 stream_of(x))
    if err:
        raise RuntimeError(f"mamba2_ssd kernel launch failed: CUDA error "
                           f"{err}")
    ssd_chunked_bshp.launches += 1
    return y, hout


ssd_chunked_bshp.launches = 0           # kernel launches, for chip_smoke
