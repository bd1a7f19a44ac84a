"""Shared neural layers: norms, rotary embeddings, the GLU MLP, embedding.

Everything is functional over plain dicts of tensors.  ``*_init`` draws
from an explicit ``torch.Generator``; the layouts are the JAX package's, so
its parameter trees load unchanged (``repro_torch.interop``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_ERF2 = math.erf(2.0 / math.sqrt(2.0))
_GLU = ("swiglu", "geglu")


def dense_init(gen: torch.Generator, shape, dtype, device, *,
               fan_in: int | None = None, scale: float | None = None):
    """Normal init truncated to [-2, 2], times 1/sqrt(fan_in).

    ``fan_in`` defaults to ``shape[-2]``, the input dim of a (stacked)
    matrix; weights that contract over other dims pass it explicitly."""
    fan_in = fan_in or (shape[-2] if len(shape) >= 2 else shape[-1])
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    u = torch.empty(shape, dtype=torch.float32, device=gen.device)
    u.uniform_(-_ERF2, _ERF2, generator=gen)
    x = u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return (x * scale).to(device=device, dtype=dtype)


# ------------------------------------------------------- row floors ----
# A row's result must not depend on how many rows share the call (greedy
# tokens of a prompt are the same alone and packed).  On the card two
# library ops break that below a row count, both measured on an H100:
#
# * cuBLAS picks split-K kernels (``nvjet_*_splitK`` + ``splitKreduce``)
#   for a product whose few row tiles would leave SMs idle, and their sums
#   run in another order.  Among the ported models' products it did so only
#   at K >= 5120: K 5120 (N 2560) below 64 rows, K 10240 (N 2560) below
#   128, K 7168 (N 2048) below 64 and at 128; from 256 rows on each row had
#   the bits of a 4,096-row product.  No product of K <= 2560 split at any
#   row count.
# * ATen's row reduction (``reduce_kernel<512, 1, ...MeanOps>``) spreads a
#   row over more threads when fewer than 16 rows are reduced.
#
# So a product with K >= SPLIT_K_MIN of fewer than ROW_FLOOR rows, and a
# norm of fewer than NORM_ROW_FLOOR rows, is computed on zero rows padded
# up to the floor.  ``chip_smoke.py`` ``phase_rows`` holds ``linear`` and
# ``rms_norm`` to a row's 4,096-row bits at every row count, for every
# product shape of the three ported models.

SPLIT_K_MIN = 4096
ROW_FLOOR = 256
NORM_ROW_FLOOR = 16


def _floor_rows(fn, x, floor: int):
    """``fn`` applied to the rows of ``x`` (its last dim is the row), with
    fewer than ``floor`` rows padded by zero rows that are dropped after."""
    lead, d = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, d)
    m = rows.shape[0]
    if m < floor:
        rows = torch.cat([rows, rows.new_zeros((floor - m, d))])
    out = fn(rows)[:m]
    return out.reshape(*lead, out.shape[-1])


def linear(x, w):
    """``x @ w`` for x (..., K) and w (K, N), with the row floor where
    K >= SPLIT_K_MIN."""
    if w.shape[0] < SPLIT_K_MIN:
        return torch.matmul(x, w)
    return _floor_rows(lambda rows: torch.matmul(rows, w), x, ROW_FLOOR)


# ----------------------------------------------------------------- norms ----

def _rms_rows(x, weight, eps: float):
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return x * (1.0 + weight.float())


def rms_norm(x, weight, eps: float):
    return _floor_rows(lambda rows: _rms_rows(rows, weight, eps), x,
                       NORM_ROW_FLOOR).to(x.dtype)


# ---------------------------------------------------------- ragged batch ----
# Prompts are LEFT-padded into shape-bucketed batches (runtime/server
# pack_prompts): row i holds `lengths[i]` real tokens in its last slots.
# These two helpers are the single source of truth for what that layout
# means, so a request's logits cannot depend on which batch it was packed
# into.

def pad_mask(lengths, s_len: int):
    """(B,) real-token counts -> (B, S) bool, True at real-token slots of a
    left-padded batch.  A zero length (filler row) is all-False."""
    cols = torch.arange(s_len, dtype=torch.int32, device=lengths.device)
    return cols[None, :] >= (s_len - lengths.to(torch.int32))[:, None]


def ragged_positions(lengths, batch: int, s_len: int, device):
    """Per-row token positions + left-pad counts for a left-padded batch.

    Returns ``(positions (B, S) int32, kv_start (B,) int32 | None)``:
    positions count from 0 at each row's first REAL token (pad slots clamp
    to 0 — they are masked out of attention anyway).  ``lengths=None``
    means a dense batch: absolute positions, no mask.
    """
    cols = torch.arange(s_len, dtype=torch.int32, device=device)
    if lengths is None:
        return cols.expand(batch, s_len), None
    kv_start = (s_len - lengths.to(torch.int32)).to(torch.int32)
    return torch.clamp(cols[None, :] - kv_start[:, None], min=0), kv_start


# ------------------------------------------------------------------ RoPE ----

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) float32, computed in float64 on ``device`` (no host
    copy, which would synchronise the card on every layer)."""
    lanes = torch.arange(0, head_dim, 2, dtype=torch.float64, device=device)
    return (1.0 / (theta ** (lanes / head_dim))).float()


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S) int32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # (D/2,)
    ang = positions[..., None].float() * freqs                 # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- MLP ----

def mlp_init(gen, d_model: int, d_ff: int, act: str, dtype, device,
             stack: tuple[int, ...] = ()):
    if act not in _GLU:
        raise NotImplementedError(f"mlp act {act!r}: only {_GLU} are ported")
    return {"wi": dense_init(gen, (*stack, d_model, d_ff), dtype, device),
            "wg": dense_init(gen, (*stack, d_model, d_ff), dtype, device),
            "wo": dense_init(gen, (*stack, d_ff, d_model), dtype, device)}


def mlp_apply(params, x, act: str):
    """GLU MLP.  GEGLU's gelu is the tanh form, as ``jax.nn.gelu``'s
    default is."""
    if act not in _GLU:
        raise NotImplementedError(f"mlp act {act!r}: only {_GLU} are ported")
    h = linear(x, params["wi"])
    g = linear(x, params["wg"])
    g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
    return linear(h * g, params["wo"])


# ------------------------------------------------------------- embedding ----

def embed_init(gen, vocab: int, d_model: int, dtype, device):
    return dense_init(gen, (vocab, d_model), dtype, device, scale=1.0)


def embed_apply(table, tokens):
    return table[tokens]
