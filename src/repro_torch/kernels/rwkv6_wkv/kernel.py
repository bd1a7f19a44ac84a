"""Wrapper of the CUDA RWKV-6 WKV kernel (``csrc/rwkv6_wkv.cu``).

The port's counterpart of the TPU kernel ``wkv6_chunked_pallas`` in
``repro/kernels/rwkv6_wkv/kernel.py``.  It reads r, k, v, logw in their
(B, S, H, K) layout by stride and takes any S (the ragged last chunk is
masked in the kernel), so nothing is transposed or padded.  A CPU tensor
takes the plain chunked version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import load, stream_of
from .ref import wkv6_chunked

MAX_CHUNK = 64           # chunk rows the kernel stages
MAX_DIM = 64             # K (== V) the kernel stages
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 15 + [ctypes.c_void_p])


def _check(r, k, v, logw, u, s0, start, chunk):
    name = "wkv6_chunked_bshk"
    if r.device.type != "cuda":
        raise ValueError(f"{name}: r is on {r.device}, the kernel needs a "
                         "CUDA tensor")
    for nm, t in (("k", k), ("v", v), ("logw", logw), ("u", u), ("s0", s0),
                  ("start", start)):
        if t is not None and t.device != r.device:
            raise ValueError(f"{name}: {nm} is on {t.device}, r on "
                             f"{r.device}")
    if r.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {r.dtype} not in (float32, "
                        "bfloat16)")
    for nm, t in (("k", k), ("v", v)):
        if t.dtype != r.dtype:
            raise TypeError(f"{name}: {nm} is {t.dtype}, r is {r.dtype}")
    if logw.dtype != torch.float32:
        raise TypeError(f"{name}: logw is {logw.dtype}, the kernel takes "
                        "float32 log-decays")
    if r.dim() != 4 or k.shape != r.shape or logw.shape != r.shape:
        raise ValueError(f"{name}: want r, k, logw (B,S,H,K) of one shape; "
                         f"got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(logw.shape)}")
    if v.shape != r.shape:
        raise ValueError(f"{name}: v {tuple(v.shape)} must have r's shape "
                         f"{tuple(r.shape)} (K == V)")
    b, s, h, kk = r.shape
    if b < 1 or s < 1:
        raise ValueError(f"{name}: empty batch {tuple(r.shape)}")
    if not (1 <= kk <= MAX_DIM and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"{name}: K {kk} must be in 1..{MAX_DIM}, chunk "
                         f"{chunk} in 1..{MAX_CHUNK}")
    if any(t.stride(-1) != 1 for t in (r, k, v, logw)):
        raise ValueError(f"{name}: the last dim of r, k, v and logw must be "
                         "contiguous")
    if (u.dtype != torch.float32 or u.shape != (h, kk)
            or not u.is_contiguous()):
        raise ValueError(f"{name}: u must be a contiguous ({h}, {kk}) "
                         "float32 tensor")
    if s0 is not None and (s0.dtype != torch.float32
                           or s0.shape != (b, h, kk, kk)
                           or not s0.is_contiguous()):
        raise ValueError(f"{name}: s0 must be a contiguous "
                         f"{(b, h, kk, kk)} float32 tensor")
    if start is not None and (start.dtype != torch.int32
                              or start.shape != (b,)
                              or not start.is_contiguous()):
        raise ValueError(f"{name}: start must be a contiguous (B,) int32 "
                         "tensor on r's device")


def wkv6_chunked_bshk(r, k, v, logw, u, s0=None, *, chunk: int = 64,
                      start=None):
    """r/k/v (B,S,H,K); logw (B,S,H,K) f32; u (H,K) f32; s0 (B,H,K,K) f32
    or None -> (y (B,S,H,K) in r's dtype, s_final (B,H,K,K) f32).

    ``start`` (B,) int32: each row's first real token (the left-pad count).
    The steps before it must be identities for the row (r = k = v = 0 and
    a zero state entering them, as the model's left pad makes them); the
    kernel skips them and writes y = 0 there, so a row's result does not
    depend on how much left pad its batch added.  The plain chunked version,
    which a CPU tensor takes, ignores ``start`` and walks over those steps:
    the same function."""
    if r.device.type == "cpu":
        return wkv6_chunked(r, k, v, logw, u, s0, chunk=chunk)
    _check(r, k, v, logw, u, s0, start, chunk)
    b, s, h, kk = r.shape
    y = torch.empty((b, s, h, kk), dtype=r.dtype, device=r.device)
    sout = torch.empty((b, h, kk, kk), dtype=torch.float32, device=r.device)
    fn = load("rwkv6_wkv", "repro_wkv6_chunked", _ARGTYPES)
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                 u.data_ptr(), s0.data_ptr() if s0 is not None else None,
                 start.data_ptr() if start is not None else None,
                 y.data_ptr(), sout.data_ptr(), _DTYPES[r.dtype], b, s, h,
                 kk, int(chunk), *(r.stride()[:3]), *(k.stride()[:3]),
                 *(v.stride()[:3]), *(logw.stride()[:3]), *(y.stride()[:3]),
                 stream_of(r))
    if err:
        raise RuntimeError(f"rwkv6_wkv kernel launch failed: CUDA error "
                           f"{err}")
    wkv6_chunked_bshk.launches += 1
    return y, sout


wkv6_chunked_bshk.launches = 0          # kernel launches, for chip_smoke
