"""Plain PyTorch versions of the RWKV-6 (Finch) WKV recurrence.

Per head (K key channels, V value channels, K == V), with a decay per key
channel that depends on the data:

  S_t = diag(w_t) S_{t-1} + k_t^T v_t          state (K, V)
  o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)      the current token gets bonus u

Shapes: r, k, v, logw (B, S, H, K), logw = log w_t <= 0 (the model passes
-exp(...) and never forms w); u (H, K); s0 (B, H, K, V) or None.  Returns y
(B, S, H, V) in r's dtype and the final state (B, H, K, V) in float32.

``wkv6_scan_ref`` is the exact sequential recurrence (the oracle).
``wkv6_chunked`` is the chunked form: within a chunk every decay weight is
exp of a sum of log-decays (<= 0, so nothing overflows), and a (K, V) state
carries across chunks.  Both copy ``repro/kernels/rwkv6_wkv/ref.py``,
except that the chunked form sums each decay segment directly instead of
differencing the running sum and pads S to the chunk itself, as the JAX op
does (see ``wkv6_chunked``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _s_init(r, s0):
    b, _, h, kk = r.shape
    if s0 is None:
        return torch.zeros((b, h, kk, kk), dtype=torch.float32,
                           device=r.device)
    return s0.float()


def wkv6_scan_ref(r, k, v, logw, u, s0=None):
    rf, kf, vf = (t.float() for t in (r, k, v))
    w = torch.exp(logw.float())
    uf = u.float()
    S = _s_init(r, s0)
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]       # (B,H,K,V)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                               S + uf[..., :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1).to(r.dtype), S


def wkv6_chunked(r, k, v, logw, u, s0=None, *, chunk: int = 64):
    """Any S: S is padded up to a multiple of ``chunk`` with r = k = v = 0
    and logw = 0 steps (w = 1, no input: the state passes through and the
    final state is exact) and y is sliced back, as the JAX op does."""
    s_in = r.shape[1]
    pad = (-s_in) % chunk
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
    b, s, h, kk = r.shape
    nc, L = s // chunk, chunk
    rf, kf, vf, lw = (t.float().reshape(b, nc, L, h, kk)
                      for t in (r, k, v, logw))
    uf = u.float()

    # Every decay weight is exp of a segment sum of logw taken directly, not
    # as a difference of running sums as the JAX form takes it: the running
    # sum falls by tens to hundreds within a chunk at rwkv6-1.6b's rates,
    # where an f32 ulp is 4e-6 to 1.5e-5, and a difference would carry that
    # error into every weight (past 1e-6 of max |y| against a float64 scan,
    # where the direct sums stay within it: tests/test_torch_wkv.py).
    #   run[s, q] = sum_{s < q' <= q} logw[q']     (0 for q <= s)
    #   seg[s, t] = run[s, t-1] = sum_{s < q < t}  pairwise weights, s < t
    #   tail[s]   = run[s, L-1]                    into the chunk's end state
    #   head[t]   = sum_{q < t} logw[q]            carried-in state readout
    pos = torch.arange(L, device=r.device)
    after = (pos[None, :] > pos[:, None])[None, None, :, :, None, None]
    run = torch.cumsum(torch.where(after, lw[:, :, None], 0.0), dim=3)
    seg = F.pad(run, (0, 0, 0, 0, 1, 0))[:, :, :, :L]        # (B,nc,s,t,H,K)
    tail = run[:, :, :, L - 1]
    cum = torch.cumsum(lw, dim=2)
    head = F.pad(cum, (0, 0, 0, 0, 1, 0))[:, :, :L]

    # intra-chunk: A[t,s] = sum_k r_t k_s exp(seg[s,t]), s < t (seg <= 0
    # everywhere, so the mask may follow the exp), plus the u bonus at t == s
    strict = (pos[:, None] > pos[None, :])[None, None, :, :, None]
    A = torch.einsum("bcthk,bcshk,bcsthk->bctsh", rf, kf, torch.exp(seg))
    A = torch.where(strict, A, 0.0)
    diag = torch.einsum("bcthk,hk,bcthk->bcth", rf, uf, kf)
    y_intra = (torch.einsum("bctsh,bcshv->bcthv", A, vf)
               + diag[..., None] * vf)

    # inter-chunk: the carried-in state read out through exp(head); the
    # chunk's decay and its input to the state
    r_dec = rf * torch.exp(head)
    chunk_kv = torch.einsum("bcshk,bcshv->bchkv", kf * torch.exp(tail), vf)
    chunk_decay = torch.exp(cum[:, :, -1])                   # (B,nc,H,K)
    S = _s_init(r, s0)
    ys = []
    for c in range(nc):
        ys.append(y_intra[:, c]
                  + torch.einsum("bthk,bhkv->bthv", r_dec[:, c], S))
        S = chunk_decay[:, c, :, :, None] * S + chunk_kv[:, c]
    y = torch.stack(ys, dim=1).reshape(b, s, h, kk)[:, :s_in].to(r.dtype)
    return y, S


def wkv6_decode_ref(rt, kt, vt, logwt, u, S):
    """One token: rt/kt/vt/logwt (B,H,K); S (B,H,K,V) -> (o (B,H,V),
    Snew f32)."""
    rf, kf, vf = (t.float() for t in (rt, kt, vt))
    w = torch.exp(logwt.float())
    kv = kf[..., :, None] * vf[..., None, :]
    # the readout as a product and a sum over k, not an einsum: the einsum
    # becomes a batched cuBLAS gemv whose sums depend on the B·H count, so
    # a row's o would depend on the batch
    o = (rf[..., :, None]
         * (S.float() + u.float()[..., :, None] * kv)).sum(-2)
    snew = w[..., :, None] * S.float() + kv
    return o.to(rt.dtype), snew
