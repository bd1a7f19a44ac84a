"""Worker-resident serving state: leased handles over a process registry.

A copy of ``repro/runtime/state.py``; the port keeps its own registry.

Cppless functions are stateless by contract — and Hellerstein et al.'s
critique (PAPERS.md) is that this forces serving systems to ship data to
code on every call.  Iteration-level serving needs the opposite
on its hottest path: the KV-cache arena a decode loop advances must stay
*resident* where the compute runs, across invocations.  This module is
that residence — a process-level registry of state entries keyed by
client-generated handles, living in whatever process executes entry
points:

* in-process backends (``inline``/``threads``) share this exact module
  with the client — the arena is process-local and free;
* out-of-process workers (``processes``/``http``/``http-aio``) hold their
  own copy, reached by pinning every invocation that names a handle to
  one worker (``FunctionConfig.affinity``) and managed through wire
  ``CONTROL`` verbs (``state_lease`` / ``state_release`` / ``state_stats``
  in the JAX package's ``runtime/worker_host``; not ported yet).

Leases, not ownership: every touch renews a TTL, and expired entries are
reclaimed on the next registry access — a client that died mid-serve
cannot pin worker memory forever.  A reclaimed (or respawned-worker)
handle surfaces as ``KeyError`` mentioning "state handle", which the wire
reconstructs client-side; schedulers treat it as *state lost* and rebuild
rather than retry.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

# test seam: unit tests monkeypatch this to drive TTL expiry without sleeping
_now = time.monotonic

DEFAULT_TTL_S = 60.0


@dataclass
class StateEntry:
    handle: str
    data: dict[str, Any]
    ttl_s: float
    deadline: float
    created: float = field(default_factory=lambda: _now())
    touches: int = 0


_ENTRIES: dict[str, StateEntry] = {}
_LOCK = threading.Lock()


def _state_lost(handle: str) -> KeyError:
    # KeyError is a builtin: the wire reconstructs it client-side, and the
    # "state handle" marker is the documented state-lost signature
    return KeyError(f"state handle {handle!r} not resident "
                    "(expired lease, released, or a fresh worker process)")


def _sweep_locked(now: float) -> list[str]:
    dead = [h for h, e in _ENTRIES.items() if e.deadline < now]
    for h in dead:
        del _ENTRIES[h]
    return dead


def sweep() -> list[str]:
    """Reclaim every expired lease; returns the reclaimed handles."""
    with _LOCK:
        return _sweep_locked(_now())


def lease(handle: str, *, ttl_s: float = DEFAULT_TTL_S,
          make: Callable[[], dict] | None = None) -> dict[str, Any]:
    """Fetch-or-create the state under ``handle``, renewing its lease.

    ``make()`` builds the initial data dict on first use; without it a
    missing handle raises the state-lost ``KeyError``.
    """
    now = _now()
    with _LOCK:
        _sweep_locked(now)
        e = _ENTRIES.get(handle)
        if e is None:
            if make is None:
                raise _state_lost(handle)
            e = StateEntry(handle=handle, data=make(), ttl_s=ttl_s,
                           deadline=now + ttl_s)
            _ENTRIES[handle] = e
        e.ttl_s = ttl_s
        e.deadline = now + ttl_s
        e.touches += 1
        return e.data


def get(handle: str, *, ttl_s: float | None = None) -> dict[str, Any]:
    """Fetch existing state, renewing its lease; ``KeyError`` if lost."""
    now = _now()
    with _LOCK:
        _sweep_locked(now)
        e = _ENTRIES.get(handle)
        if e is None:
            raise _state_lost(handle)
        if ttl_s is not None:
            e.ttl_s = ttl_s
        e.deadline = now + e.ttl_s
        e.touches += 1
        return e.data


def release(handle: str) -> bool:
    """Drop a handle (idempotent); returns whether it was resident."""
    with _LOCK:
        return _ENTRIES.pop(handle, None) is not None


def renew(handle: str, *, ttl_s: float | None = None) -> bool:
    """Extend a lease WITHOUT touching the data — the heartbeat verb.

    ``get``/``lease`` renew only on touch, so a long client-side stall
    (GC pause, chaos-injected straggle) between engine calls can expire a
    lease under a *live* row.  The batcher's heartbeat sends this between
    engine calls to keep the lease honest; returns whether the handle was
    still resident (a False tells the client the state is already gone).
    """
    now = _now()
    with _LOCK:
        _sweep_locked(now)
        e = _ENTRIES.get(handle)
        if e is None:
            return False
        if ttl_s is not None:
            e.ttl_s = float(ttl_s)
        e.deadline = now + e.ttl_s
        e.touches += 1
        return True


def expire_all(handles: list[str] | None = None) -> list[str]:
    """Force leases to expire NOW (chaos injection: ``lease.expired``).

    Backdates the deadline of every named handle (default: all resident
    handles) so the next registry access reclaims them — the next engine
    call on an affected handle surfaces the state-lost ``KeyError`` and
    exercises the replay-failover path without killing the process.
    """
    now = _now()
    with _LOCK:
        targets = list(_ENTRIES) if handles is None else \
            [h for h in handles if h in _ENTRIES]
        for h in targets:
            _ENTRIES[h].deadline = now - 1.0
        return targets


def stats() -> dict[str, Any]:
    now = _now()
    with _LOCK:
        _sweep_locked(now)
        detail = {}
        # paged-arena occupancy rollup: live tokens / allocated blocks /
        # shared (refcount > 1) blocks across every resident arena on this
        # worker — block reuse is observable, not inferred
        arena = {"live_tokens": 0, "allocated_blocks": 0, "shared_blocks": 0}
        for h, e in _ENTRIES.items():
            d = {"age_s": round(now - e.created, 3),
                 "ttl_s": e.ttl_s,
                 "expires_in_s": round(e.deadline - now, 3),
                 "touches": e.touches}
            occ = e.data.get("occupancy")
            if occ:
                d["occupancy"] = dict(occ)
                for key in arena:
                    arena[key] += int(occ.get(key, 0))
            detail[h] = d
        return {"handles": sorted(_ENTRIES),
                "count": len(_ENTRIES),
                "prefix_tokens": sum(
                    int(e.data.get("prefix_tokens", 0))
                    for e in _ENTRIES.values()),
                "arena": arena,
                # per-handle lease detail: what a scale-down refusal names
                # and what fleet observability reports per worker
                "detail": detail}


def control(op: str, data: dict[str, Any]) -> dict[str, Any]:
    """The CONTROL-verb surface shared by the worker host and local
    backends: lease renewal, release, and observability."""
    if op == "state_lease":
        handle = data["handle"]
        ttl_s = float(data.get("ttl_s", DEFAULT_TTL_S))
        try:
            get(handle, ttl_s=ttl_s)
            return {"ok": True, "known": True}
        except KeyError:
            return {"ok": True, "known": False}
    if op == "state_renew":
        ttl = data.get("ttl_s")
        return {"ok": True,
                "renewed": renew(data["handle"],
                                 ttl_s=None if ttl is None else float(ttl))}
    if op == "state_release":
        return {"ok": True, "released": release(data["handle"])}
    if op == "state_stats":
        return stats()
    raise ValueError(f"unknown state op {op!r}")
