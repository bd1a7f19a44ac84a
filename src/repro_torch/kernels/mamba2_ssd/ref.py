"""Plain PyTorch versions of the Mamba2 SSD (state-space duality) scan.

Shapes (G groups share B/C across H heads, H % G == 0):
  x  (B, S, H, P)    head channels
  dt (B, S, H)       softplus-ed timestep >= 0
  A  (H,)            negative per-head decay rate
  Bm (B, S, G, N)    input projection onto state
  Cm (B, S, G, N)    state readout
  h0 (B, H, P, N)    initial state (or None)
Returns y (B, S, H, P) in x's dtype, h_final (B, H, P, N) float32.

``ssd_scan_ref`` is the exact sequential recurrence (the oracle).
``ssd_chunked`` is the chunked form (same math, O(S L) not O(S^2)); it
mirrors the CUDA kernel's blocking.  Both copy
``repro/kernels/mamba2_ssd/ref.py``, except that the chunked form sums each
decay segment directly instead of differencing the running sum (see
``ssd_chunked``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _expand_groups(Bm, h):
    return Bm.repeat_interleave(h // Bm.shape[2], dim=2)


def _h_init(x, n, h0):
    b, _, h, p = x.shape
    if h0 is None:
        return torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    return h0.float()


def ssd_scan_ref(x, dt, A, Bm, Cm, h0=None):
    h = x.shape[2]
    Bh = _expand_groups(Bm, h).float()                   # (B,S,H,N)
    Ch = _expand_groups(Cm, h).float()
    xf, dtf = x.float(), dt.float()
    a = torch.exp(dtf * A.float())                       # (B,S,H) in (0,1]
    hs = _h_init(x, Bm.shape[-1], h0)
    ys = []
    for t in range(x.shape[1]):
        # h <- a h + (dt x) B^T   (outer product over (P, N))
        hs = (a[:, t, :, None, None] * hs
              + (dtf[:, t, :, None] * xf[:, t])[..., None]
              * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", hs, Ch[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype)
    return y, hs


def ssd_chunked(x, dt, A, Bm, Cm, h0=None, *, chunk: int = 64):
    """Any S: S is padded up to a multiple of ``chunk`` with dt = 0 steps
    (decay 1, input 0: the state passes through, the final state is exact)
    and y is sliced back, as the JAX op does."""
    s_in = x.shape[1]
    pad = (-s_in) % chunk
    if pad:
        x, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                         for t in (x, dt, Bm, Cm))
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    nc, L = s // chunk, chunk
    Bc = _expand_groups(Bm, h).float().reshape(b, nc, L, h, n)
    Cc = _expand_groups(Cm, h).float().reshape(b, nc, L, h, n)
    xf = x.float().reshape(b, nc, L, h, p)
    dtf = dt.float().reshape(b, nc, L, h)

    da = dtf * A.float()                                   # (B,nc,L,H) <= 0
    la = torch.cumsum(da, dim=2)
    xb = xf * dtf[..., None]                               # dt-scaled input

    # intra-chunk (attention-like, causal).  The segment sums
    # seg[t, s] = sum_{s < r <= t} da[r] are summed directly, not taken as
    # la[t] - la[s]: la falls several hundred below zero within a chunk at
    # zamba2-2.7b's decay rates, and that difference would lose 3e-5 to
    # 6e-5 (an f32 ulp there) of each decay weight to cancellation.  Mask
    # BEFORE exp: for s > t the masked entries would be positive.
    ones = torch.ones((L, L), dtype=torch.bool, device=x.device)
    after = ones.tril(-1)[None, None, :, :, None]          # r > s
    seg = torch.cumsum(torch.where(after, da[:, :, :, None, :], 0.0),
                       dim=2)                              # (B,nc,L,L,H)
    causal = ones.tril()[None, None, :, :, None]
    lmat = torch.exp(torch.where(causal, seg, -torch.inf))
    scores = torch.einsum("bclhn,bcshn->bclsh", Cc, Bc) * lmat
    y_intra = torch.einsum("bclsh,bcshp->bclhp", scores, xb)

    # per-chunk input state contribution; ws[s] = exp(seg[L-1, s])
    ws = lmat[:, :, -1]                                    # (B,nc,L,H)
    chunk_state = torch.einsum("bclhp,bclhn->bchpn", xb * ws[..., None], Bc)
    chunk_decay = torch.exp(la[:, :, -1])                  # (B,nc,H)

    # inter-chunk recurrence over chunk states; keep the state *before*
    hs = _h_init(x, n, h0)
    hprevs = []
    for c in range(nc):
        hprevs.append(hs)
        hs = chunk_decay[:, c, :, None, None] * hs + chunk_state[:, c]
    hprevs = torch.stack(hprevs, dim=1)                    # (B,nc,H,P,N)

    # inter-chunk output: readout of the carried-in state
    y_inter = torch.einsum("bclhn,bchpn->bclhp", Cc, hprevs) * torch.exp(
        la)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p).to(x.dtype)
    return y[:, :s_in], hs


def ssd_decode_ref(xt, dtt, A, Bt, Ct, hprev):
    """Single-token state update.  xt (B,H,P); dtt (B,H); Bt/Ct (B,G,N);
    hprev (B,H,P,N) -> (y (B,H,P), hnew)."""
    h = xt.shape[1]
    Bh = Bt.repeat_interleave(h // Bt.shape[1], dim=1).float()   # (B,H,N)
    Ch = Ct.repeat_interleave(h // Ct.shape[1], dim=1).float()
    a = torch.exp(dtt.float() * A.float())
    hnew = (a[..., None, None] * hprev.float()
            + (dtt[..., None] * xt.float())[..., None] * Bh[..., None, :])
    # the readout as a product and a row sum, not an einsum: the einsum
    # becomes a batched cuBLAS gemv whose sums depend on the B·H count, so
    # a row's y would depend on the batch (measured on an H100)
    y = (hnew * Ch[:, :, None, :]).sum(-1)
    return y.to(xt.dtype), hnew.float()

