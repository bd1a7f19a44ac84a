"""Wrapper of the CUDA prefill attention kernel (``csrc/flash_attention.cu``).

The port's counterpart of the TPU kernel ``flash_attention_bhsd`` in
``repro/kernels/flash_attention/kernel.py``.  It takes the model's own
(B, S, H, D) layout and hands the kernel the strides, so nothing is
transposed or padded.  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import load, stream_of
from .ref import attention_xla

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_void_p])


def _check(q, k, v, kv_start, kv_len):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bshd: q is on {q.device}, "
                         "the kernel needs a CUDA tensor")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_bshd: {name} is on "
                             f"{t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention_bshd: {name} is {t.dtype}, "
                            f"q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_bshd: dtype {q.dtype} not in "
                        "(float32, bfloat16)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_bshd: want q (B,Sq,Hq,D) and "
                         f"k, v (B,Skv,Hkv,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"flash_attention_bshd: q {tuple(q.shape)} does "
                         f"not fit k {tuple(k.shape)}")
    if not 1 <= d <= 128:
        raise ValueError(f"flash_attention_bshd: head_dim {d} not in 1..128")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_bshd: the last dim of q, k and v "
                         "must be contiguous")
    for name, t in (("kv_start", kv_start), ("kv_len", kv_len)):
        if t is not None and (
                t.device != q.device or t.dtype != torch.int32
                or t.shape != (b,) or not t.is_contiguous()):
            raise ValueError(f"flash_attention_bshd: {name} must be a "
                             "contiguous (B,) int32 tensor on q's device")


def flash_attention_bshd(q, k, v, kv_start=None, *, kv_len=None,
                         causal: bool = True, window: int = 0,
                         q_offset: int = 0, scale: float | None = None):
    """q (B,Sq,Hq,D); k, v (B,Skv,Hkv,D) -> (B,Sq,Hq,D) in q's dtype.

    ``kv_start`` (B,) int32: per-row left-pad count, keys before it are
    masked (None = no padding).  ``kv_len`` (B,) int32: per-row valid cache
    length, keys at or past it are masked (None = all Skv).  ``q_offset``:
    absolute position of q[0] on the kv timeline."""
    if q.device.type == "cpu":
        return attention_xla(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale,
                             kv_len=kv_len, kv_start=kv_start)
    _check(q, k, v, kv_start, kv_len)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = load("flash_attention", "repro_flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 kv_start.data_ptr() if kv_start is not None else None,
                 kv_len.data_ptr() if kv_len is not None else None,
                 _DTYPES[q.dtype], b, sq, skv, hq, hkv, d,
                 *(q.stride()[:3]), *(k.stride()[:3]), *(v.stride()[:3]),
                 *(out.stride()[:3]), int(causal), int(window),
                 int(q_offset), float(scale), stream_of(q))
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_bshd.launches += 1
    return out


flash_attention_bshd.launches = 0       # kernel launches, for chip_smoke
