"""LM serving: the stateless wave task that a worker runs per batch.

``pack_prompts`` packs a wave of prompts into one shape-bucketed, left-padded
token batch, and ``make_generate_fn`` builds the task that prefills it,
grows the cache to its pow2 bucket and decodes greedily.  This is the part
of ``repro/runtime/server.py`` that runs on the card; the ``LMServer``
facade over a serverless session is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import build_model, grow_cache


@dataclass
class Request:
    prompt: list[int]
    max_new: int = 16


@dataclass
class Completion:
    tokens: list[int]
    latency_ms: float = 0.0
    cost_gb_s: float = 0.0
    # time to first token (ms); None = "same as latency_ms" (a wave has no
    # token stream: the whole batch returns at once)
    ttft_ms: float | None = None
    # per-token arrival times (ms since request arrival), where a scheduler
    # streams tokens; None on wave paths
    token_times_ms: list[float] | None = None
    # True when the completion survived a failover (re-prefill elsewhere)
    recovered: bool = False

    @property
    def ttft(self) -> float:
        return self.latency_ms if self.ttft_ms is None else self.ttft_ms


def shape_bucket(n: int) -> int:
    """Next power of two ≥ ``n`` — the shape-stability quantum."""
    return 1 << max(0, int(n) - 1).bit_length()


def decode_bucket(max_new: int) -> int:
    """Decode-length bucket: next power of two ≥ ``max_new``."""
    return shape_bucket(max_new)


def pack_prompts(prompts: Sequence[Sequence[int]], pad: int = 0,
                 min_rows: int = 1):
    """Pack prompts into a shape-*bucketed* token batch; returns
    ``(tokens (B, S) int32, lengths (B,) int32)`` as numpy arrays.

    Both dims round up to powers of two, so a server sees few distinct
    shapes.  Rows are left-padded (last real token aligned) with ``pad``
    (the model's ``cfg.pad_id`` — NOT a sentinel: ``lengths`` is the source
    of truth for what is padding).  Filler rows below the row bucket are
    all-pad with length 0, fully masked.  ``min_rows`` pins the row bucket
    from below.
    """
    if not prompts:
        raise ValueError("pack_prompts: empty prompt list — nothing to "
                         "pack into a batch")
    for i, p in enumerate(prompts):
        if len(p) == 0:
            raise ValueError(
                f"pack_prompts: prompt {i} is empty — a zero-length prompt "
                "has no last token to decode from (it would silently become "
                "an all-pad row)")
    b = shape_bucket(max(len(prompts), min_rows))
    s = shape_bucket(max(len(p) for p in prompts))
    out = np.full((b, s), pad, np.int32)
    lengths = np.zeros((b,), np.int32)   # filler rows: length 0, fully masked
    for i, p in enumerate(prompts):
        out[i, s - len(p):] = p          # left-pad so last token aligns
        lengths[i] = len(p)
    return out, lengths


def make_generate_fn(cfg: ModelConfig, max_new: int, device="cuda"):
    """Build the stateless serve task:
    ``(params, tokens, lengths) -> generated ids (B, max_new) int32``.

    ``lengths`` (B,) int32 rides with every batch: prefill masks each row's
    left pad, and the cache's ``start`` plane keeps masking it through
    decode — so the tokens for a prompt do not depend on what it was packed
    with.  ``tokens``/``lengths`` may be numpy arrays (``pack_prompts``) or
    tensors; the result is a tensor on ``device``.
    """
    model = build_model(cfg, device)

    def generate(params, tokens, lengths):
        tokens = torch.as_tensor(tokens, dtype=torch.int32,
                                 device=model.device)
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=model.device)
        s = tokens.shape[1]
        logits, cache = model.prefill(params, {"tokens": tokens,
                                               "lengths": lengths})
        cache = grow_cache(cfg, cache, s + max_new)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        out = []
        # the cache index stays a host int and each step writes its K/V into
        # the cache in place; a token is recorded before the step that reads
        # it, and the step after the last recorded token is not run (its
        # logits would be discarded)
        for i in range(max_new):
            out.append(tok[:, 0])
            if i + 1 < max_new:
                logits, cache = model.decode(params, cache, tok)
                tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        return torch.stack(out, dim=1)

    return generate
