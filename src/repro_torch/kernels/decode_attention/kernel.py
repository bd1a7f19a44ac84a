"""Wrappers of the CUDA decode attention kernels (``csrc/decode_attention.cu``).

``flash_decode_bshd`` is the port's counterpart of the TPU kernel
``flash_decode_bhgd`` in ``repro/kernels/decode_attention/kernel.py``, and
``flash_decode_paged_bshd`` of ``flash_decode_paged_bhgd`` in the same
file.  They take the cache in the model's (B, Skv, Hkv, D) layout, or the
block pool in its (NB, BS, Hkv, D) layout, and hand the kernel the strides
and the per-row bounds, so nothing is transposed, gathered or padded.  Both
kernels share one body and walk the same logical keys in the same order, so
on the same keys they give the same bits.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import load, stream_of
from .ref import decode_attention_paged_ref, decode_attention_ref

MAX_GROUP = 8            # query heads per KV head the kernel holds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 10 + [ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p])
_PAGED_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 10
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _bounds_ok(t, q, b):
    return (t.device == q.device and t.dtype == torch.int32
            and t.shape == (b,) and t.is_contiguous())


def _check(name, q, k, v, kv_len, kv_start, table=None):
    """Raise on anything the kernel does not take.  k, v are the cache
    (B,Skv,Hkv,D) or, with ``table`` (B,T), the block pools (NB,BS,Hkv,D)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q is on {q.device}, the kernel needs a "
                         "CUDA tensor")
    for nm, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: {nm} is on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {nm} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not in (float32, "
                        "bfloat16)")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: want q (B,Hq,D) and k, v 4-d of one "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, d = q.shape
    hkv = k.shape[2]
    if (table is None and k.shape[0] != b) or k.shape[3] != d or hq % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    if hq // hkv > MAX_GROUP or not 1 <= d <= 128:
        raise ValueError(f"{name}: group {hq // hkv} > {MAX_GROUP} or "
                         f"head_dim {d} not in 1..128")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the last dim of q, k and v must be "
                         "contiguous")
    if table is not None and (
            table.device != q.device or table.dtype != torch.int32
            or table.dim() != 2 or table.shape[0] != b
            or not table.is_contiguous()):
        raise ValueError(f"{name}: table must be a contiguous (B,T) int32 "
                         "tensor on q's device")
    if not _bounds_ok(kv_len, q, b) or (
            kv_start is not None and not _bounds_ok(kv_start, q, b)):
        raise ValueError(f"{name}: kv_len and kv_start must be contiguous "
                         "(B,) int32 tensors on q's device")


def flash_decode_bshd(q, k, v, kv_len, kv_start=None, *, window: int = 0,
                      scale: float | None = None):
    """q (B,Hq,D); k, v (B,Skv,Hkv,D); kv_len, kv_start (B,) int32 ->
    (B,Hq,D) in q's dtype.  Keys outside [kv_start, kv_len) and, with a
    window, below kv_len - window are masked."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len, window=window,
                                    scale=scale, kv_start=kv_start)
    _check("flash_decode_bshd", q, k, v, kv_len, kv_start)
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


def flash_decode_paged_bshd(q, k_pool, v_pool, table, kv_len, kv_start=None,
                            *, window: int = 0, scale: float | None = None):
    """q (B,Hq,D); k_pool, v_pool (NB,BS,Hkv,D); table (B,T) int32 of pool
    block ids (every entry in [0, NB); dead entries 0, the trash block);
    kv_len, kv_start (B,) int32 -> (B,Hq,D) in q's dtype.

    Row b's logical column c is pool[table[b, c // BS], c % BS]; the
    masking is ``flash_decode_bshd``'s over logical columns."""
    if q.device.type == "cpu":
        return decode_attention_paged_ref(q, k_pool, v_pool, table, kv_len,
                                          window=window, scale=scale,
                                          kv_start=kv_start)
    _check("flash_decode_paged_bshd", q, k_pool, v_pool, kv_len, kv_start,
           table)
    b, hq, d = q.shape
    bs, hkv = k_pool.shape[1], k_pool.shape[2]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = load("decode_attention", "repro_decode_attention_paged",
              _PAGED_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 out.data_ptr(), table.data_ptr(),
                 kv_start.data_ptr() if kv_start is not None else None,
                 kv_len.data_ptr(), _DTYPES[q.dtype], b, table.shape[1], bs,
                 hq, hkv, d, *(q.stride()[:2]), *(k_pool.stride()[:3]),
                 *(v_pool.stride()[:3]), *(out.stride()[:2]), int(window),
                 float(scale), stream_of(q))
    if err:
        raise RuntimeError(f"paged decode attention kernel launch failed: "
                           f"CUDA error {err}")
    flash_decode_paged_bshd.launches += 1
    return out


flash_decode_paged_bshd.launches = 0    # kernel launches, for chip_smoke
