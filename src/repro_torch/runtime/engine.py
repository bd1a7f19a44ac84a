"""Iteration-level serving engine: the paged worker entry points.

The port of the paged half of ``repro/runtime/engine.py``.  The worker
keeps a refcounted pool of fixed-size KV blocks plus per-row block tables
(host accounting in ``models.api.PagedArena``, device pools updated in
place by the model's paged functions) in the state registry
(``runtime/state.py``), keyed by a client-generated handle:

* :func:`engine_paged_prefill` — free evicted rows, admit new rows
  (matching their prompt against a radix index of block-aligned token runs,
  so rows sharing a prefix share physical blocks copy-free), and advance
  pending rows by CHUNKED prefill under a token budget, so a long prompt
  never stalls live decode rows for more than one chunk.
* :func:`engine_paged_decode` — free evicted rows, reserve blocks, and
  advance every live row ``k`` greedy steps.

They are called in process (as the JAX package's ``inline`` backend runs
them: the registry lives in the caller's process).  Every host rule —
free before admit, the match capped one block short, the chunk width
``shape_bucket(c_real)``, the radix insert and evict order — is the JAX
engine's, so the host accounting comes out identical.  The slot-arena
entry points, row migration and the ``EngineClient`` are not ported yet.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import transformer
from ..models.api import PagedArena, paged_init_pool, resolve_device
from . import state
from .radix import RadixIndex
from .server import shape_bucket


def is_state_lost(err: BaseException) -> bool:
    """The signature of a reclaimed/respawned arena."""
    return isinstance(err, KeyError) and "state handle" in str(err)


# ------------------------------------------------------ worker-side fns ----

@lru_cache(maxsize=64)
def _paged_chunk_fn(cfg: ModelConfig):
    """One chunk of continued prefill for one row (B == 1)."""
    impl = cfg.attn_impl

    def run(params, pool_k, pool_v, tokens, table, m, n_real):
        logits, pk, pv = transformer.lm_prefill_paged_chunk(
            params, cfg, tokens, pool_k, pool_v, table, m, n_real,
            attn_impl=impl)
        return torch.argmax(logits, -1).to(torch.int32), pk, pv

    return run


@lru_cache(maxsize=256)
def _paged_decode_fn(cfg: ModelConfig, k: int):
    """``k`` greedy steps over every row.  lens, tokens and the live mask
    stay on the device for the whole loop: nothing is read back per step."""
    impl = cfg.attn_impl

    def run(params, pool_k, pool_v, table, lens, live, last):
        pad = torch.full_like(last, cfg.pad_id)
        tok = torch.where(live, last, pad)[:, None]
        step_live = live.to(torch.int32)
        toks = []
        for _ in range(k):
            logits, pool_k, pool_v = transformer.lm_decode_paged(
                params, cfg, pool_k, pool_v, table, lens, live, tok,
                attn_impl=impl)
            nxt = torch.where(live, torch.argmax(logits, -1).to(torch.int32),
                              pad)
            lens = lens + step_live
            tok = nxt[:, None]
            toks.append(nxt)
        return pool_k, pool_v, tok[:, 0], torch.stack(toks, dim=1)  # (B, k)

    return run


def _paged_reserve(pa: PagedArena, radix: RadixIndex, slot: int,
                   n_tokens: int, handle) -> None:
    """Allocate blocks so row ``slot`` can hold ``n_tokens``; on pool
    exhaustion, evict LRU radix runs (refcount drop — blocks free only if
    no live row shares them) and retry before giving up."""
    while True:
        try:
            pa.ensure(slot, n_tokens)
            return
        except IndexError:
            dropped = radix.evict_blocks(1)
            if not dropped:
                raise RuntimeError(
                    f"paged arena {handle!r} out of blocks: "
                    f"{pa.occupancy()} and nothing evictable") from None
            pa.ref_dec(dropped)


def _paged_match(pa: PagedArena, radix: RadixIndex, slot: int,
                 toks: list, done: int) -> int:
    """Adopt any radix-shared prefix blocks beyond ``done`` (refcount++,
    copy-free).  The match is capped one block short of the full prompt so
    at least one token always re-prefills — the chunk path needs a real
    last-token forward for the first output logits."""
    bs = pa.bs
    if done % bs:
        return done
    h, payloads = radix.match(toks)
    h = min(h, ((len(toks) - 1) // bs) * bs)
    if h <= done:
        return done
    ids = payloads[done // bs:h // bs]
    if any(pa.table[slot, done // bs:h // bs]):
        return done                      # row already allocated past here
    pa.ref_inc(ids)
    pa.table[slot, done // bs:h // bs] = ids
    pa.owned[slot].extend(int(i) for i in ids)
    return h


def _check_device(params, pool: torch.Tensor) -> None:
    if params["embed"].device != pool.device:
        raise ValueError(f"params are on {params['embed'].device}, the "
                         f"paged pool on {pool.device}")


def engine_paged_prefill(params, *, cfg, handle, batch, blocks, table_width,
                         block_size, admit=(), free=(), budget=0,
                         radix_tokens=1 << 16, create=True,
                         ttl_s=state.DEFAULT_TTL_S, device="cuda"):
    """Paged prefill entry point: admit rows, advance chunked prefill.

    ``free``: slots evicted since the last call — released FIRST (refcount
    drops), because a slot must give its blocks back before the same slot
    id is re-admitted: an un-released table row would alias the new row's
    writes onto blocks the radix index may still share with live rows.
    ``admit``: ``[(slot, prompt_tokens), ...]`` new rows (the worker is
    authoritative for prefix matching).  Each call then advances pending
    rows FIFO by at most ``budget`` real tokens total (``budget <= 0`` =
    finish everything), so one call's prefill stall is bounded no matter
    how long the prompt.  Completed rows land live with their first decoded
    token; their full blocks are inserted into the radix index (refcount++)
    and the index is LRU-evicted back under ``radix_tokens``.  The pools
    are made on ``device`` when the handle is new; params must be there.
    Returns per-slot progress + pool occupancy.
    """
    dev = resolve_device(device)

    def make():
        pool = paged_init_pool(cfg, blocks, block_size, dev)
        return {"paged": True, "cfg": cfg,
                "pool_k": pool["k"], "pool_v": pool["v"],
                "pa": PagedArena(batch, blocks, table_width, block_size),
                "radix": RadixIndex(block_size, radix_tokens),
                "pending": {}, "order": [],
                "last": np.full((batch,), cfg.pad_id, np.int32),
                "prefix_tokens": 0}

    a = state.lease(handle, ttl_s=float(ttl_s),
                    make=make if create else None)
    _check_device(params, a["pool_k"])
    dev = a["pool_k"].device
    pa, radix = a["pa"], a["radix"]
    pending, order = a["pending"], a["order"]

    for slot in free:
        slot = int(slot)
        pa.ref_dec(radix.evict())
        pa.release(slot)
        pending.pop(slot, None)

    for slot, toks in admit:
        slot = int(slot)
        toks = [int(t) for t in toks]
        matched = _paged_match(pa, radix, slot, toks, 0)
        pending[slot] = {"tokens": toks, "done": matched, "matched": matched}
        order.append(slot)

    spent = 0
    out: dict[int, dict] = {}
    while order:
        slot = order[0]
        ent = pending.get(slot)
        if ent is None:                       # freed mid-prefill
            order.pop(0)
            continue
        toks, done = ent["tokens"], ent["done"]
        done = _paged_match(pa, radix, slot, toks, done)
        need = len(toks) - done
        room = (len(toks) if budget <= 0
                else budget - spent)
        c_real = min(need, room)
        if c_real <= 0:
            break                             # budget exhausted this call
        _paged_reserve(pa, radix, slot, done + c_real, handle)
        c_b = shape_bucket(c_real)
        chunk = np.full((1, c_b), cfg.pad_id, np.int32)
        chunk[0, :c_real] = toks[done:done + c_real]
        first, pk, pv = _paged_chunk_fn(cfg)(
            params, a["pool_k"], a["pool_v"],
            torch.from_numpy(chunk).to(dev),
            torch.from_numpy(pa.table[slot:slot + 1].copy()).to(dev),
            done, c_real)
        a["pool_k"], a["pool_v"] = pk, pv
        done += c_real
        spent += c_real
        ent["done"] = done
        if done == len(toks):
            order.pop(0)
            pending.pop(slot)
            pa.len[slot] = done
            pa.live[slot] = True
            t0 = int(first[0])
            a["last"][slot] = t0
            nb_full = (done // pa.bs) * pa.bs
            if nb_full and radix_tokens > 0:
                new = radix.insert(toks[:nb_full],
                                   list(pa.table[slot, :nb_full // pa.bs]))
                pa.ref_inc(new)
                pa.ref_dec(radix.evict())
            out[slot] = {"live": True, "first": t0, "done": done,
                         "matched": ent["matched"], "total": done}
        else:
            out[slot] = {"live": False, "first": None, "done": done,
                         "matched": ent["matched"], "total": len(toks)}
    a["prefix_tokens"] = radix.tokens
    occ = pa.occupancy()
    occ["radix_tokens"] = radix.tokens
    a["occupancy"] = occ
    # str slot keys, as the JAX engine returns them (its wire format)
    return {"slots": {str(s): v for s, v in out.items()},
            "pending": len(pending), "occupancy": occ}


def engine_paged_decode(params, *, cfg, handle, k, free_slots=(),
                        ttl_s=state.DEFAULT_TTL_S):
    """Paged decode-step entry point: release evicted rows (refcount drops
    — the paged analogue of compaction), reserve blocks for ``k`` new
    tokens per live row, advance every live row ``k`` greedy steps.  The
    table, lens, live mask and last tokens cross to the device once per
    call, and the ``(B, k)`` tokens come back once."""
    a = state.get(handle, ttl_s=float(ttl_s))
    _check_device(params, a["pool_k"])
    dev = a["pool_k"].device
    pa, radix = a["pa"], a["radix"]
    k = int(k)
    for slot in free_slots:
        slot = int(slot)
        pa.ref_dec(radix.evict())            # keep index inside its budget
        pa.release(slot)
        a["pending"].pop(slot, None)
    for slot in np.nonzero(pa.live)[0]:
        _paged_reserve(pa, radix, int(slot), int(pa.len[slot]) + k, handle)
    pk, pv, last, toks = _paged_decode_fn(cfg, k)(
        params, a["pool_k"], a["pool_v"],
        *(torch.from_numpy(np.array(x)).to(dev)
          for x in (pa.table, pa.len, pa.live, a["last"])))
    a["pool_k"], a["pool_v"] = pk, pv
    a["last"] = last.cpu().numpy().astype(np.int32)
    pa.len[pa.live] += k
    occ = pa.occupancy()
    occ["radix_tokens"] = radix.tokens
    a["occupancy"] = occ
    return {"tokens": toks.cpu().numpy(), "occupancy": occ}
