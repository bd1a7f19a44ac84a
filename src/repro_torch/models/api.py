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

Everything runs on ``device`` — ``"cuda"`` unless the caller asks for the
CPU.  Only the dense family is ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..configs.base import ModelConfig
from . import transformer


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
    if cfg.family != "dense" or cfg.moe.n_experts:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    if cfg.kv_quant != "none" or cfg.mrope_sections or cfg.embeds_input:
        raise NotImplementedError("int8 KV, M-RoPE and embedding inputs are "
                                  "not ported yet")
    dev = resolve_device(device)
    impl = cfg.attn_impl

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


def grow_cache(cfg: ModelConfig, cache, new_cap: int, bucket: bool = True):
    """Pad the seq-capacity dim of a prefill cache so decode can append.

    ``bucket`` rounds the grown capacity up to the next power of two, as
    the JAX package does; the extra slots are masked out of attention like
    left pad."""
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
