"""Plain PyTorch versions of (GQA / causal / windowed) attention.

Shapes:  q (B, Sq, Hq, D);  k, v (B, Skv, Hkv, D);  Hq % Hkv == 0.
``q_offset``: absolute position of q[0] within the kv timeline.
``window``: sliding-window size (0 = full).  ``kv_len`` (B,): valid cache
length per row; ``kv_start`` (B,): left-pad count per row.  A row with no
valid key outputs 0, never NaN.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def _mask(sq, skv, device, *, causal, window, q_offset, kv_len, kv_start,
          rows0=0):
    """(B|1, 1, Sq, Skv) bool mask for q rows rows0..rows0+Sq-1."""
    rows = torch.arange(sq, device=device)[:, None] + rows0 + q_offset
    cols = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window:
        mask &= cols > rows - window
    mask = mask[None]                                   # (B?,Sq,Skv)
    if kv_len is not None:
        mask = mask & (cols[None] < kv_len.to(device)[:, None, None])
    if kv_start is not None:
        mask = mask & (cols[None] >= kv_start.to(device)[:, None, None])
    return mask[:, None]


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0, scale: float | None = None,
                  kv_len=None, kv_start=None):
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq {hq} is not a multiple of Hkv {hkv}")
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)

    kr = k.repeat_interleave(g, dim=2)
    vr = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    mask = _mask(sq, skv, q.device, causal=causal, window=window,
                 q_offset=q_offset, kv_len=kv_len, kv_start=kv_start)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    # fully masked rows output 0, the flash kernel's l == 0 convention
    p = p * mask.any(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr.float())
    return out.to(q.dtype)


def attention_xla(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0, scale: float | None = None,
                  kv_len=None, kv_start=None, block_q: int = 512):
    """Query-chunked attention: the same math as ``attention_ref`` with q
    scaled before the dot (as the kernels do), scores built one q block at
    a time so memory is O(block_q·Skv·H), and GQA heads kept grouped."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq {hq} is not a multiple of Hkv {hkv}")
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    kf, vf = k.float(), v.float()
    out = []
    for r0 in range(0, sq, block_q):
        qb = q[:, r0:r0 + block_q]
        bq = qb.shape[1]
        qb = qb.reshape(b, bq, hkv, g, d).float() * scale
        s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kf)
        mask = _mask(bq, skv, q.device, causal=causal, window=window,
                     q_offset=q_offset, kv_len=kv_len, kv_start=kv_start,
                     rows0=r0)[:, :, None]              # (B?,1,1,bq,Skv)
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True)
        p = p * mask.any(-1, keepdim=True)              # all-masked row -> 0
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
        out.append(o.reshape(b, bq, hq, d).to(q.dtype))
    return torch.cat(out, dim=1)
