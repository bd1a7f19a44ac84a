"""Plain PyTorch version of single-token (decode) attention over a cache.

q (B, Hq, D) — one new token per row.
k, v (B, Skv, Hkv, D) — the cache; entries at positions >= kv_len are junk.
kv_len (B,) int32 — valid cache length per row (the new token's k/v is
already written at kv_len-1).
kv_start (B,) int32 — first valid cache position per row; entries below it
are left-pad slots from a ragged prefill and are masked out.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def decode_attention_ref(q, k, v, kv_len, *, window: int = 0,
                         scale: float | None = None, kv_start=None):
    b, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)

    kr = k.repeat_interleave(g, dim=2)                  # (B,Skv,Hq,D)
    vr = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kr.float()) * scale

    kv_len = kv_len.to(q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]  # (1,Skv)
    mask = cols < kv_len
    if kv_start is not None:
        mask &= cols >= kv_start.to(q.device)[:, None]
    if window:
        mask &= cols >= torch.clamp(kv_len - window, min=0)
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    # all-masked row -> 0 output (the kernel's l == 0 convention), never NaN
    p = p * mask.any(-1, keepdim=True)[:, None, :]
    out = torch.einsum("bhk,bkhd->bhd", p, vr.float())
    return out.to(q.dtype)
