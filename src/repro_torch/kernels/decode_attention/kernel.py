"""Wrapper of the CUDA decode attention kernel (``csrc/decode_attention.cu``).

The port's counterpart of the TPU kernel ``flash_decode_bhgd`` in
``repro/kernels/decode_attention/kernel.py``.  It takes the cache in the
model's (B, Skv, Hkv, D) layout and hands the kernel the strides and the
per-row bounds, so nothing is transposed or padded.  A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import load, stream_of
from .ref import decode_attention_ref

MAX_GROUP = 8            # query heads per KV head the kernel holds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 10 + [ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p])


def _bounds_ok(t, q, b):
    return (t.device == q.device and t.dtype == torch.int32
            and t.shape == (b,) and t.is_contiguous())


def _check(q, k, v, kv_len, kv_start):
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_bshd: q is on {q.device}, the "
                         "kernel needs a CUDA tensor")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_decode_bshd: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_decode_bshd: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_decode_bshd: dtype {q.dtype} not in "
                        "(float32, bfloat16)")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_decode_bshd: want q (B,Hq,D) and k, v "
                         f"(B,Skv,Hkv,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, d = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"flash_decode_bshd: q {tuple(q.shape)} does not "
                         f"fit k {tuple(k.shape)}")
    if hq // hkv > MAX_GROUP or not 1 <= d <= 128:
        raise ValueError(f"flash_decode_bshd: group {hq // hkv} > "
                         f"{MAX_GROUP} or head_dim {d} not in 1..128")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_decode_bshd: the last dim of q, k and v "
                         "must be contiguous")
    if not _bounds_ok(kv_len, q, b) or (
            kv_start is not None and not _bounds_ok(kv_start, q, b)):
        raise ValueError("flash_decode_bshd: kv_len and kv_start must be "
                         "contiguous (B,) int32 tensors on q's device")


def flash_decode_bshd(q, k, v, kv_len, kv_start=None, *, window: int = 0,
                      scale: float | None = None):
    """q (B,Hq,D); k, v (B,Skv,Hkv,D); kv_len, kv_start (B,) int32 ->
    (B,Hq,D) in q's dtype.  Keys outside [kv_start, kv_len) and, with a
    window, below kv_len - window are masked."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len, window=window,
                                    scale=scale, kv_start=kv_start)
    _check(q, k, v, kv_len, kv_start)
    b, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = load("decode_attention", "repro_decode_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 kv_start.data_ptr() if kv_start is not None else None,
                 kv_len.data_ptr(), _DTYPES[q.dtype], b, skv, hq, hkv, d,
                 *(q.stride()[:2]), *(k.stride()[:3]), *(v.stride()[:3]),
                 *(out.stride()[:2]), int(window), float(scale),
                 stream_of(q))
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_decode_bshd.launches += 1
    return out


flash_decode_bshd.launches = 0          # kernel launches, for chip_smoke
