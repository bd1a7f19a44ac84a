"""A small client of the paged worker entry points.

:func:`serve_requests` plays the client half of paged serving in process:
it admits waiting requests into free slots, chunk-prefills them under the
worker's token budget, steps every live row ``k`` greedy tokens at a time,
frees finished rows and admits the next waiting requests into the freed
slots.  It is not a port of the JAX package's ``ContinuousBatcher``; it
takes the two entry points as callables, so the same schedule can drive
any engine with their signatures.
"""
from __future__ import annotations

import numpy as np


def serve_requests(prefill, decode, params, prompts, *, cfg, handle, slots,
                   k, max_new, **prefill_kw):
    """Serve ``prompts`` through ``prefill(params, cfg=, handle=, batch=,
    admit=, free=, **prefill_kw)`` and ``decode(params, cfg=, handle=,
    k=)`` until every request has ``max_new`` tokens.

    Returns (tokens per request, log).  The log holds one dict per engine
    call, in call order: ``{"call": "prefill", "reply": ..., "requests":
    {slot: request}, "reused": slots admitted this call that a finished row
    had freed}`` or ``{"call": "decode", "reply": ..., "tokens": (B, k)
    ndarray, "live": [slot, ...]}``.
    """
    waiting = list(enumerate(prompts))
    slot_req: dict[int, int] = {}
    live: set[int] = set()
    to_free: list[int] = []
    freed: set[int] = set()
    out: dict[int, list[int]] = {i: [] for i in range(len(prompts))}
    log: list[dict] = []
    while waiting or slot_req:
        admit = []
        for slot in range(slots):
            if slot not in slot_req and waiting:
                req, p = waiting.pop(0)
                slot_req[slot] = req
                admit.append((slot, p))
        r = prefill(params, cfg=cfg, handle=handle, batch=slots, admit=admit,
                    free=to_free, **prefill_kw)
        log.append({"call": "prefill", "reply": r,
                    "requests": dict(slot_req),
                    "reused": [s for s, _ in admit if s in freed]})
        to_free = []
        for s, ent in r["slots"].items():
            if ent["live"]:
                live.add(int(s))
                out[slot_req[int(s)]].append(ent["first"])
        if not live:
            continue
        d = decode(params, cfg=cfg, handle=handle, k=k)
        toks = np.asarray(d["tokens"])
        log.append({"call": "decode", "reply": d, "tokens": toks,
                    "live": sorted(live)})
        for slot in sorted(live):
            req = slot_req[slot]
            out[req].extend(int(t) for t in toks[slot])
            if len(out[req]) >= max_new:
                out[req] = out[req][:max_new]
                live.discard(slot)
                del slot_req[slot]
                to_free.append(slot)
                freed.add(slot)
    return [out[i] for i in range(len(prompts))], log
