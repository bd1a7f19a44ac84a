"""Mamba2 block (zamba2's SSM component): in-proj, causal depthwise conv,
SSD scan (``kernels/mamba2_ssd``), gated RMSNorm, out-proj.

The conv is W static shifts (W = 4), and each of x/B/C gets its own conv,
as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.mamba2_ssd import ssd, ssd_decode
from .layers import dense_init, linear, rms_norm


def mamba2_init(gen, d_model: int, *, expand: int, state_dim: int,
                head_dim: int, conv_width: int, dtype, device,
                stack: tuple[int, ...] = ()):
    """Params in the JAX package's tree and layouts.

    Each projection is scaled by its true fan-in, d_model.  The JAX
    package's ``dense_init`` takes ``shape[-2]``, which for wB/wC
    (d, G, N) is G = 1: a scale of 1 where 1/sqrt(d) is meant (see the
    fault list in ROADMAP.md)."""
    d_in = expand * d_model
    n_heads = d_in // head_dim
    g = 1                                    # B/C groups
    pre = stack
    kw = dict(dtype=dtype, device=device)
    p = {
        "wz": dense_init(gen, (*pre, d_model, d_in), **kw),
        "wx": dense_init(gen, (*pre, d_model, d_in), **kw),
        "wB": dense_init(gen, (*pre, d_model, g, state_dim), fan_in=d_model,
                         **kw),
        "wC": dense_init(gen, (*pre, d_model, g, state_dim), fan_in=d_model,
                         **kw),
        "wdt": dense_init(gen, (*pre, d_model, n_heads), **kw),
        "dt_bias": torch.zeros((*pre, n_heads), **kw),
    }
    # A_log in [log 0.5, log 8] (mamba2 default init range)
    a_log = torch.log(torch.linspace(0.5, 8.0, n_heads, dtype=torch.float32,
                                     device=device)).to(dtype)
    p["A_log"] = a_log * torch.ones((*pre, n_heads), **kw)
    p["D"] = torch.ones((*pre, n_heads), **kw)
    for nm, ch in (("conv_x", d_in), ("conv_B", g * state_dim),
                   ("conv_C", g * state_dim)):
        p[nm] = dense_init(gen, (*pre, conv_width, ch), scale=1.0 / conv_width,
                           **kw)
    p["norm"] = torch.zeros((*pre, d_in), **kw)
    p["wo"] = dense_init(gen, (*pre, d_in, d_model), **kw)
    return p


def _conv_shift(w, x):
    """Causal depthwise conv as static shifts.  w (W, C); x (B, S, C)."""
    width = w.shape[0]
    out = x * w[-1]
    for i in range(1, width):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[-1 - i]
    return out


def _conv_step(w, state, xt):
    """state (B, W-1, C); xt (B, 1, C) -> (yt (B, 1, C), new state)."""
    full = torch.cat([state, xt], dim=1)                  # (B, W, C)
    yt = torch.einsum("bwc,wc->bc", full, w)[:, None]
    return yt, full[:, 1:]


def _inner(p, x, *, head_dim):
    z = linear(x, p["wz"])
    xc = linear(x, p["wx"])
    d, g, n = p["wB"].shape
    Bc = linear(x, p["wB"].reshape(d, g * n)).unflatten(-1, (g, n))
    Cc = linear(x, p["wC"].reshape(d, g * n)).unflatten(-1, (g, n))
    dt = linear(x, p["wdt"])
    return z, xc, Bc, Cc, dt


def mamba2_apply(p, x, *, head_dim: int, chunk: int = 64,
                 impl: str = "auto", rms_eps: float = 1e-6, mask=None,
                 start=None):
    """Prefill path.  x (B,S,d) -> (y, final_state {conv, ssd}).

    ``mask`` (B,S) bool: True at real-token slots of a left-padded batch.
    Pad steps become identity transitions: their conv-tap inputs are zeroed
    (a real token near the boundary convolves over zeros, exactly the
    decode path's fresh conv state) and dt is 0, so the SSD recurrence
    neither decays nor absorbs anything on a pad step.  The returned
    conv/ssd states therefore do not depend on the batch.  ``start`` (B,)
    int32, the left-pad count, lets the SSD kernel begin each row's chunk
    walk at its first real token.
    """
    b, s_len, _ = x.shape
    z, xc, Bc, Cc, dt = _inner(p, x, head_dim=head_dim)
    g, n = Bc.shape[-2:]
    if mask is not None:
        m = mask[..., None].to(xc.dtype)
        xc = xc * m
        Bc = Bc * m[..., None]
        Cc = Cc * m[..., None]

    conv_in = (xc, Bc.reshape(b, s_len, g * n), Cc.reshape(b, s_len, g * n))
    xc = F.silu(_conv_shift(p["conv_x"], conv_in[0]))
    Bc = F.silu(_conv_shift(p["conv_B"], conv_in[1])).reshape(
        b, s_len, g, n)
    Cc = F.silu(_conv_shift(p["conv_C"], conv_in[2])).reshape(
        b, s_len, g, n)

    h = xc.shape[-1] // head_dim
    xh = xc.reshape(b, s_len, h, head_dim)
    dt = F.softplus(dt + p["dt_bias"])
    if mask is not None:
        # dt = 0 on pad steps: decay exp(dt*A) = 1 and input 0, so the SSD
        # state passes through pad slots unchanged
        dt = dt * mask[..., None].to(dt.dtype)
    A = -torch.exp(p["A_log"].float())

    y, ssd_state = ssd(xh, dt, A, Bc, Cc, chunk=chunk, start=start,
                       impl=impl)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(b, s_len, h * head_dim)
    y = rms_norm(y * F.silu(z), p["norm"], rms_eps)
    out = linear(y, p["wo"])
    w1 = p["conv_x"].shape[0] - 1
    conv_tail = tuple(F.pad(ci, (0, 0, max(0, w1 - ci.shape[1]), 0))[:, -w1:]
                      for ci in conv_in)
    return out, {"conv": conv_tail, "ssd": ssd_state}


def mamba2_decode(p, x, state, *, head_dim: int, rms_eps: float = 1e-6):
    """One token.  x (B,1,d); state {conv: (cx,cB,cC), ssd: (B,H,P,N)}."""
    b = x.shape[0]
    z, xc, Bc, Cc, dt = _inner(p, x, head_dim=head_dim)
    g, n = Bc.shape[-2:]

    cx, cB, cC = state["conv"]
    xc, cx = _conv_step(p["conv_x"], cx, xc)
    Bc2, cB = _conv_step(p["conv_B"], cB, Bc.reshape(b, 1, g * n))
    Cc2, cC = _conv_step(p["conv_C"], cC, Cc.reshape(b, 1, g * n))
    xc = F.silu(xc)
    Bc = F.silu(Bc2).reshape(b, g, n)
    Cc = F.silu(Cc2).reshape(b, g, n)

    h = xc.shape[-1] // head_dim
    xh = xc.reshape(b, h, head_dim)
    dt = F.softplus(dt + p["dt_bias"])[:, 0]               # (B, H)
    A = -torch.exp(p["A_log"].float())

    y, ssd_state = ssd_decode(xh, dt, A, Bc, Cc, state["ssd"])
    y = y + p["D"].to(y.dtype)[None, :, None] * xh
    y = y.reshape(b, 1, h * head_dim)
    y = rms_norm(y * F.silu(z), p["norm"], rms_eps)
    out = linear(y, p["wo"])
    return out, {"conv": (cx, cB, cC), "ssd": ssd_state}
