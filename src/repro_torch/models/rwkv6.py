"""RWKV-6 (Finch) block: time-mix with a decay that depends on the data,
and channel-mix.

Time-mix uses the ddlerp token shift (a 5-way LoRA-modulated interpolation
with the previous token), a LoRA-projected decay per channel
w = exp(-exp(w0 + lora(x))), and the WKV recurrence of
``kernels/rwkv6_wkv``.  The model passes log w = -exp(...) in f32 straight
to the recurrence and never forms w, as the JAX package does.

Every product goes through ``layers.linear`` (the row floor), so a row's
result does not depend on the batch it rides in.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rwkv6_wkv import wkv6, wkv6_decode
from .layers import dense_init, linear

MIX_LORA = 32
DECAY_LORA = 64


def rwkv6_init(gen: torch.Generator, d_model: int, d_ff: int, *,
               n_heads: int, head_dim: int, dtype, device,
               stack: tuple[int, ...] = ()):
    """Params in the JAX package's tree and layouts.  Every matrix has its
    contraction axis at -2, so ``dense_init``'s default fan-in is the true
    one (unlike the attention and hybrid inits)."""
    att = n_heads * head_dim
    pre = stack
    kw = dict(dtype=dtype, device=device)
    p = {}
    # time-mix
    for nm in ("wr", "wk", "wv", "wg"):
        p[nm] = dense_init(gen, (*pre, d_model, att), **kw)
    p["wo"] = dense_init(gen, (*pre, att, d_model), **kw)
    p["mu_x"] = torch.full((*pre, d_model), 0.5, **kw)
    p["mu_rkvwg"] = torch.full((*pre, 5, d_model), 0.5, **kw)
    p["mix_a"] = dense_init(gen, (*pre, d_model, 5 * MIX_LORA), **kw)
    p["mix_b"] = dense_init(gen, (*pre, 5, MIX_LORA, d_model), **kw)
    p["w0"] = torch.full((*pre, att), -0.5, **kw)   # exp(-exp(-.5)) ≈ .55
    p["decay_a"] = dense_init(gen, (*pre, d_model, DECAY_LORA), **kw)
    p["decay_b"] = dense_init(gen, (*pre, DECAY_LORA, att), **kw)
    p["u"] = torch.zeros((*pre, att), **kw)
    p["ln_x_w"] = torch.ones((*pre, att), **kw)
    p["ln_x_b"] = torch.zeros((*pre, att), **kw)
    # channel-mix
    p["cm_mu_k"] = torch.full((*pre, d_model), 0.5, **kw)
    p["cm_mu_r"] = torch.full((*pre, d_model), 0.5, **kw)
    p["cm_wk"] = dense_init(gen, (*pre, d_model, d_ff), **kw)
    p["cm_wv"] = dense_init(gen, (*pre, d_ff, d_model), **kw)
    p["cm_wr"] = dense_init(gen, (*pre, d_model, d_model), **kw)
    return p


def _group_norm(x, w, b, n_heads: int, eps: float = 1e-5):
    """Per-head layernorm over the head's channels.  x (..., H, V) ->
    (..., H·V)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y.reshape(*x.shape[:-2], n_heads * x.shape[-1])
    return (y * w.float() + b.float()).to(x.dtype)


def _shift(x, shift0=None):
    """The previous token of each position: x shifted right by one, with
    ``shift0`` (B, d) or zeros before the first."""
    xprev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if shift0 is not None:
        xprev[:, 0] = shift0
    return xprev


def _ddlerp(p, x, xprev):
    """5-way LoRA-modulated token shift; returns (xr, xk, xv, xw, xg)."""
    dx = xprev - x
    xxx = x + dx * p["mu_x"]
    t = torch.tanh(linear(xxx, p["mix_a"])).unflatten(-1, (5, MIX_LORA))
    return tuple(x + dx * (p["mu_rkvwg"][i] + linear(t[..., i, :],
                                                     p["mix_b"][i]))
                 for i in range(5))


def _tmix_projections(p, x, xprev, n_heads: int, head_dim: int):
    xr, xk, xv, xw, xg = _ddlerp(p, x, xprev)
    shp = (*x.shape[:-1], n_heads, head_dim)
    r = linear(xr, p["wr"]).reshape(shp)
    k = linear(xk, p["wk"]).reshape(shp)
    v = linear(xv, p["wv"]).reshape(shp)
    g = linear(xg, p["wg"])
    dec = linear(torch.tanh(linear(xw, p["decay_a"])), p["decay_b"])
    logw = -torch.exp((p["w0"] + dec).float()).reshape(shp)
    return r, k, v, g, logw


def rwkv6_time_mix(p, x, *, n_heads: int, head_dim: int, s0=None,
                   shift0=None, chunk: int = 64, impl: str = "auto",
                   start=None):
    """x (B,S,d) -> (y, wkv state (B,H,K,V) f32, last x (B,d)).

    ``start`` (B,) int32, the left-pad count, lets the WKV kernel begin
    each row's chunk walk at its first real token."""
    xprev = _shift(x, shift0)
    r, k, v, g, logw = _tmix_projections(p, x, xprev, n_heads, head_dim)
    u = p["u"].float().reshape(n_heads, head_dim)
    o, s_last = wkv6(r, k, v, logw, u, s0, chunk=chunk, start=start,
                     impl=impl)
    o = _group_norm(o, p["ln_x_w"], p["ln_x_b"], n_heads)
    o = o * F.silu(g)
    return linear(o, p["wo"]), s_last, x[:, -1]


def rwkv6_time_mix_decode(p, x, s0, shift0, *, n_heads: int, head_dim: int):
    """One token.  x (B,1,d); shift0 (B,d); s0 (B,H,K,V)."""
    r, k, v, g, logw = _tmix_projections(p, x, shift0[:, None], n_heads,
                                         head_dim)
    u = p["u"].float().reshape(n_heads, head_dim)
    o, s_new = wkv6_decode(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u, s0)
    o = _group_norm(o[:, None], p["ln_x_w"], p["ln_x_b"], n_heads)
    o = o * F.silu(g)
    return linear(o, p["wo"]), s_new, x[:, -1]


def rwkv6_channel_mix(p, x, shift0=None):
    """x (B,S,d) -> (y, last x (B,d))."""
    dx = _shift(x, shift0) - x
    xk = x + dx * p["cm_mu_k"]
    xr = x + dx * p["cm_mu_r"]
    kk = torch.relu(linear(xk, p["cm_wk"])).square()
    kv = linear(kk, p["cm_wv"])
    r = torch.sigmoid(linear(xr, p["cm_wr"]))
    return r * kv, x[:, -1]
