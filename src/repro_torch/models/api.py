"""Model facade: one ``Model`` per configuration.

  model.init(gen)                  -> params (a dict tree of tensors)
  model.prefill(params, batch)     -> (last logits (B,V), cache)
  model.decode(params, cache, tok) -> (logits (B,V), cache')
  model.init_cache(batch, cap)     -> zero cache

Ragged batches: ``batch["lengths"]`` (B,) int32 marks how many REAL tokens
each left-padded row holds (see ``runtime/server.pack_prompts``); pad slots
are masked out of attention and the cache carries the per-row first valid
slot as ``cache["start"]``, so greedy decode of a prompt does not depend on
the batch it was packed into.

The paged-arena primitives (``paged_init_pool``, ``PagedArena``) serve
``runtime/engine.py``'s paged entry points.

Everything runs on ``device`` — ``"cuda"`` unless the caller asks for the
CPU.  The dense, hybrid and ssm families are ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..configs.base import ModelConfig
from . import hybrid, rwkv_model, transformer


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA without a card
    raises instead of running somewhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "card; pass device='cpu' to run on the CPU")
    return dev


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    if cfg.family not in ("dense", "hybrid", "ssm") or cfg.moe.n_experts:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    if cfg.kv_quant != "none" or cfg.mrope_sections or cfg.embeds_input:
        raise NotImplementedError("int8 KV, M-RoPE and embedding inputs are "
                                  "not ported yet")
    dev = resolve_device(device)
    impl = cfg.attn_impl

    if cfg.family == "hybrid":
        return _build_hybrid(cfg, dev, impl)
    if cfg.family == "ssm":
        return _build_ssm(cfg, dev)

    def prefill(p, batch):
        return transformer.lm_prefill(p, cfg, batch["tokens"],
                                      attn_impl=impl,
                                      lengths=batch.get("lengths"))

    def decode(p, cache, tokens):
        return transformer.lm_decode(p, cfg, cache, tokens, attn_impl=impl)

    return Model(cfg, dev, lambda gen: transformer.lm_init(gen, cfg, dev),
                 prefill, decode,
                 lambda b, cap, **kw: transformer.lm_init_cache(
                     cfg, b, cap, dev, **kw))


def _build_hybrid(cfg: ModelConfig, dev, impl) -> Model:
    """The hybrid facade.  Its prefill takes the SSD op's default impl,
    "auto": the CUDA kernel on the card (the counterpart of the JAX
    package's ``ssm_impl="pallas"``), the plain chunked form on the CPU."""
    def prefill(p, batch):
        tokens = batch["tokens"]
        logits, (msts, (ck, cv)) = hybrid.hybrid_forward(
            p, cfg, tokens, attn_impl=impl, collect_cache=True,
            last_only=True, lengths=batch.get("lengths"))
        cache = {"conv_x": msts["conv"][0], "conv_B": msts["conv"][1],
                 "conv_C": msts["conv"][2], "ssd": msts["ssd"], "k": ck,
                 "v": cv, "idx": tokens.shape[1], "start": msts["start"]}
        return logits[:, -1], cache

    def decode(p, cache, tokens):
        return hybrid.hybrid_decode(p, cfg, cache, tokens, attn_impl=impl)

    return Model(cfg, dev, lambda gen: hybrid.hybrid_init(gen, cfg, dev),
                 prefill, decode,
                 lambda b, cap, **kw: hybrid.hybrid_init_cache(
                     cfg, b, cap, dev, **kw))


def _build_ssm(cfg: ModelConfig, dev) -> Model:
    """The ssm (RWKV-6) facade.  Its prefill takes the WKV op's default
    impl, "auto": the CUDA kernel on the card, the plain chunked form on
    the CPU.  The JAX package's ``build_model`` passes no ``ssm_impl``, so
    its serve path runs the plain chunked form.  Decode is the plain
    one-token step, as in JAX."""
    def prefill(p, batch):
        logits, cache = rwkv_model.rwkv_forward(
            p, cfg, batch["tokens"], collect_cache=True, last_only=True,
            lengths=batch.get("lengths"))
        return logits[:, -1], cache

    def decode(p, cache, tokens):
        return rwkv_model.rwkv_decode(p, cfg, cache, tokens)

    return Model(cfg, dev, lambda gen: rwkv_model.rwkv_init(gen, cfg, dev),
                 prefill, decode,
                 lambda b, cap, **kw: rwkv_model.rwkv_init_cache(
                     cfg, b, cap, dev, **kw))


def grow_cache(cfg: ModelConfig, cache, new_cap: int, bucket: bool = True):
    """Pad the seq-capacity dim of a prefill cache so decode can append.

    ``bucket`` rounds the grown capacity up to the next power of two, as
    the JAX package does; the extra slots are masked out of attention like
    left pad.  An ssm cache has no sequence axis and comes back as it is."""
    if cfg.family == "ssm":
        return cache
    if bucket:
        new_cap = 1 << max(0, int(new_cap) - 1).bit_length()
    out = dict(cache)
    for k in ("k", "v"):
        pad = new_cap - cache[k].shape[2]
        if pad > 0:
            a = cache[k]
            grown = a.new_zeros((*a.shape[:2], new_cap, *a.shape[3:]))
            grown[:, :, :a.shape[2]] = a
            out[k] = grown
    return out


# ------------------------------------------------- paged-arena primitives --
# A refcounted pool of fixed-size KV *blocks* plus a per-row int32 block
# table: capacity is live tokens, not slots × max-len, rows sharing a
# block-aligned prompt prefix share the physical blocks (refcount++), and
# "compaction" is dropping refcounts.  Block id 0 is reserved as the TRASH
# block: never allocated, pinned at refcount 1, the landing zone for
# dead-row and pad-position writes (always masked out of attention by
# kv_len).
#
# The device side is two pool tensors (L, NB, BS, Hkv, D) that the model's
# paged functions update in place; everything below is HOST accounting
# (numpy), copied from ``repro/models/api.py`` so that the port's host
# bookkeeping is the JAX engine's, step for step.

def paged_supported(cfg: ModelConfig) -> bool:
    """Families servable from a paged arena.  Attention families need the
    plain (unquantized) KV pool layout; ssm has O(1) state and is served
    paged via whole-state snapshots at the engine layer (no block pool) —
    the answer is the JAX package's, but the port's paged engine has no
    ssm snapshot path yet.  hybrid keeps per-row conv/ssd state interleaved
    with KV — it stays on the slot arena."""
    if cfg.family == "ssm":
        return True
    return (cfg.family in ("dense", "moe", "vlm")
            and not cfg.embeds_input and cfg.kv_quant != "int8")


def paged_init_pool(cfg: ModelConfig, blocks: int, block_size: int,
                    device="cuda"):
    """Zeroed K/V block pools: (L, NB, BS, Hkv, D) in the cache dtype, on
    ``device``.  Block 0 is the trash block — part of the tensor, never
    handed out."""
    dev = resolve_device(device)
    cdt = getattr(torch, cfg.param_dtype)
    shp = (cfg.n_layers, blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shp, dtype=cdt, device=dev),
            "v": torch.zeros(shp, dtype=cdt, device=dev)}


class PagedArena:
    """Host-side block accounting for one worker's paged KV pool.

    Tracks, per physical block, a refcount (rows holding it + the radix
    index holding it each count one reference); per row, the int32 block
    table, resident token count, and liveness.  A block returns to the
    free list only when its refcount hits zero — which is why LRU index
    eviction can never free a block a live row references.
    """

    def __init__(self, batch: int, blocks: int, table_width: int,
                 block_size: int):
        self.batch = int(batch)
        self.nb = int(blocks)
        self.T = int(table_width)
        self.bs = int(block_size)
        self.table = np.zeros((batch, table_width), np.int32)
        self.ref = np.zeros((blocks,), np.int32)
        self.ref[0] = 1                         # pin the trash block
        self.free = list(range(blocks - 1, 0, -1))
        self.len = np.zeros((batch,), np.int32)
        self.live = np.zeros((batch,), bool)
        self.owned: dict[int, list[int]] = {s: [] for s in range(batch)}

    # ---- block lifecycle ----
    def alloc(self) -> int:
        """One fresh block at refcount 1; raises IndexError when exhausted
        (callers relieve pressure by evicting radix-held blocks first)."""
        if not self.free:
            raise IndexError("paged arena: block pool exhausted")
        bid = self.free.pop()
        self.ref[bid] = 1
        return bid

    def ref_inc(self, ids) -> None:
        for bid in ids:
            assert bid != 0 and self.ref[bid] > 0, bid
            self.ref[bid] += 1

    def ref_dec(self, ids) -> list[int]:
        """Drop one reference per id; returns the ids that hit zero (their
        slots are back on the free list — physical contents are stale
        garbage, always masked until overwritten)."""
        freed = []
        for bid in ids:
            assert bid != 0 and self.ref[bid] > 0, bid
            self.ref[bid] -= 1
            if self.ref[bid] == 0:
                self.free.append(bid)
                freed.append(bid)
        return freed

    # ---- row lifecycle ----
    def adopt(self, slot: int, ids, n_tokens: int) -> None:
        """Bind already-referenced blocks (a radix prefix hit, refcounts
        bumped by the caller) as the row's head: table[:len(ids)] = ids."""
        self.table[slot, :len(ids)] = ids
        self.owned[slot].extend(int(i) for i in ids)
        self.len[slot] = n_tokens

    def ensure(self, slot: int, n_tokens: int) -> list[int]:
        """Allocate blocks so the row can hold ``n_tokens`` tokens; returns
        the newly allocated ids (table entries already set)."""
        need = -(-int(n_tokens) // self.bs)     # ceil
        if need > self.T:
            raise ValueError(
                f"paged arena: row needs {need} blocks > table width "
                f"{self.T}")
        new = []
        for bi in range(need):
            if self.table[slot, bi] == 0:
                bid = self.alloc()
                self.table[slot, bi] = bid
                self.owned[slot].append(bid)
                new.append(bid)
        return new

    def release(self, slot: int) -> list[int]:
        """Free a row: drop one reference on every block it holds, clear
        its table row.  Returns the block ids whose refcount hit zero."""
        freed = self.ref_dec(self.owned[slot])
        self.owned[slot] = []
        self.table[slot, :] = 0
        self.len[slot] = 0
        self.live[slot] = False
        return freed

    # ---- observability ----
    def occupancy(self) -> dict:
        allocated = self.nb - 1 - len(self.free)
        shared = int((self.ref[1:] > 1).sum())
        return {"live_tokens": int(self.len[self.live].sum()),
                "allocated_blocks": int(allocated),
                "shared_blocks": shared,
                "free_blocks": len(self.free),
                "total_blocks": self.nb - 1,
                "block_size": self.bs}
