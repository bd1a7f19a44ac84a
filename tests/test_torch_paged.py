"""The port's paged KV serving (``repro_torch.runtime.engine``) against the
JAX package's.

* Host pieces: the port's ``RadixIndex`` and ``PagedArena`` and the JAX
  ones, driven through the same seeded operation sequence, agree exactly at
  every step.
* ``decode_attention_paged`` (plain, on the CPU) against the JAX oracle at
  2e-5, and bitwise against the port's contiguous plain decode at a
  power-of-two gathered width.
* ``lm_prefill_paged_chunk`` chained over 3 chunks against JAX (logits and
  pools at 1e-4) and ``lm_decode_paged`` over 8 steps (logits at 1e-3: each
  step reads every earlier step's K/V; tokens equal), on ``smollm-smoke``
  f32 with the JAX weights carried over by ``from_jax_params``.
* A scripted schedule through both packages' ``engine_paged_prefill`` /
  ``engine_paged_decode``, called in process on separate handles: equal
  tokens, identical per-call progress and occupancy, pools at 1e-4.
* Within the port, paged tokens equal each request served alone by
  ``make_generate_fn`` (T·BS kept a power of two, as the JAX batcher keeps
  it).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.interop import from_jax_params
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_paged,
                                                  decode_attention_ref,
                                                  flash_decode_paged_bshd,
                                                  pool_from_contiguous)
from repro_torch.kernels.flash_attention import attention
from repro_torch.models import (PagedArena, build_model, paged_init_pool,
                                paged_supported)
from repro_torch.models import transformer
from repro_torch.runtime import engine, state
from repro_torch.runtime.radix import RadixIndex
from repro_torch.runtime.schedule import serve_requests
from repro_torch.runtime.server import make_generate_fn, pack_prompts

torch.set_num_threads(1)

RNG = np.random.default_rng(11)
TOL = dict(rtol=1e-4, atol=1e-4)

# the scripted schedule: 3 slots, block size 4, table width 16 (T·BS 64),
# a prefill budget of 16 real tokens per call, 4 decode steps per call
SLOTS, BS, TW, NBLK, BUDGET, K, MAX_NEW = 3, 4, 16, 48, 16, 4, 10


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    return jnp


@pytest.fixture(scope="module")
def pair(jx):
    """(JAX cfg, JAX params, port cfg, port params) on smollm-smoke f32."""
    import jax
    from repro.configs import get_smoke as jax_smoke
    from repro.models import build_model as jax_build

    jcfg = jax_smoke("smollm-360m").replace(param_dtype="float32",
                                            compute_dtype="float32")
    jparams, _ = jax_build(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_smoke("smollm-360m").replace(param_dtype="float32",
                                           compute_dtype="float32")
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


# ------------------------------------------------------- host pieces ----

def _radix_ops(rng, n_ops, bs):
    """A seeded op sequence over a small alphabet, so prefixes recur."""
    stems = [list(map(int, rng.integers(1, 4, 6 * bs))) for _ in range(3)]
    for _ in range(n_ops):
        op = rng.choice(["insert", "match", "evict", "evict_blocks"],
                        p=[0.45, 0.35, 0.1, 0.1])
        stem = stems[rng.integers(len(stems))]
        n = int(rng.integers(1, len(stem) + 1))
        toks = stem[:n] + list(map(int, rng.integers(1, 4, rng.integers(
            0, 2 * bs))))
        if op == "insert":
            yield op, (toks, list(range(100, 100 + len(toks) // bs)))
        elif op == "match":
            yield op, (toks,)
        elif op == "evict":
            yield op, (int(rng.integers(0, 8 * bs)),)
        else:
            yield op, (int(rng.integers(1, 3)),)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_index_parity_with_jax(seed):
    pytest.importorskip("jax")
    from repro.runtime.radix import RadixIndex as JaxRadix
    bs = 4
    ours, ref = RadixIndex(bs, 40), JaxRadix(bs, 40)
    for op, args in _radix_ops(np.random.default_rng(seed), 120, bs):
        assert getattr(ours, op)(*args) == getattr(ref, op)(*args), op
        assert ours.stats() == ref.stats()
        assert ours.tokens == ref.tokens


def _arena_ops(rng, pa_batch, n_ops):
    for _ in range(n_ops):
        op = rng.choice(["ensure", "release", "share", "adopt"],
                        p=[0.5, 0.2, 0.15, 0.15])
        slot = int(rng.integers(pa_batch))
        yield op, slot, int(rng.integers(1, 4 * TW))


def _arena_state(pa):
    return (pa.table.tolist(), pa.ref.tolist(), list(pa.free),
            pa.len.tolist(), pa.live.tolist(),
            {s: list(v) for s, v in pa.owned.items()}, pa.occupancy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_arena_parity_with_jax(seed):
    """Allocation, sharing (refcount++ and adoption of another row's
    blocks), release and pool exhaustion in the same order in both."""
    pytest.importorskip("jax")
    from repro.models.api import PagedArena as JaxArena
    rng = np.random.default_rng(seed)
    ours, ref = PagedArena(3, 24, TW, 4), JaxArena(3, 24, TW, 4)
    for op, slot, n in _arena_ops(rng, 3, 150):
        results = []
        for pa in (ours, ref):
            try:
                if op == "ensure":
                    res = pa.ensure(slot, min(n, pa.T * pa.bs))
                    pa.live[slot] = True
                    pa.len[slot] = max(int(pa.len[slot]), n // 2)
                elif op == "release":
                    res = pa.release(slot)
                else:
                    other = (slot + 1) % pa.batch
                    ids = [int(i) for i in pa.owned[other][:2]]
                    pa.ref_inc(ids)
                    if op == "adopt" and not pa.owned[slot]:
                        pa.adopt(slot, ids, len(ids) * pa.bs)
                        res = ("adopted", ids)
                    else:
                        res = pa.ref_dec(ids)
            except IndexError as e:
                res = ("exhausted", str(e))
            results.append([int(x) for x in res] if isinstance(res, list)
                           else res)
        assert results[0] == results[1], op
        assert _arena_state(ours) == _arena_state(ref)


def test_paged_arena_trash_block_pinned_and_occupancy():
    pa = PagedArena(2, 8, 4, 4)
    assert pa.ref[0] == 1 and 0 not in pa.free
    new = pa.ensure(0, 9)
    assert len(new) == 3 and 0 not in new
    pa.live[0], pa.len[0] = True, 9
    pa.ref_inc(new[:1])
    occ = pa.occupancy()
    assert occ == {"live_tokens": 9, "allocated_blocks": 3,
                   "shared_blocks": 1, "free_blocks": 4, "total_blocks": 7,
                   "block_size": 4}
    assert pa.release(0) == new[1:]
    assert pa.ref_dec(new[:1]) == new[:1] and pa.ref[0] == 1


def test_paged_supported_and_pool_match_jax(pair):
    from repro.models.api import paged_init_pool as jax_pool
    from repro.models.api import paged_supported as jax_supported
    jcfg, _, cfg, _ = pair
    assert paged_supported(cfg) is jax_supported(jcfg) is True
    pool = paged_init_pool(cfg, 5, 4, device="cpu")
    jpool = jax_pool(jcfg, 5, 4)
    for key in ("k", "v"):
        assert tuple(pool[key].shape) == jpool[key].shape
        assert pool[key].dtype == torch.float32 and not pool[key].any()


# ------------------------------------------------ paged decode (plain) --

@pytest.mark.parametrize("b,skv,bs,hq,hkv,d,window", [
    (3, 32, 8, 4, 2, 32, 0),
    (2, 48, 16, 6, 2, 20, 0),
    (2, 64, 4, 3, 1, 20, 9),
    (3, 96, 48, 15, 5, 64, 0),
])
def test_decode_attention_paged_matches_jax_ref(jx, b, skv, bs, hq, hkv, d,
                                                window):
    """A scrambled table with a trash tail past each row's length."""
    from repro.kernels.decode_attention import (
        decode_attention_paged as jax_paged)
    rng = np.random.default_rng(b * 100 + bs)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    lens = rng.integers(1, skv + 1, size=(b,)).astype(np.int32)
    lens[0] = skv // 3 + 1
    pk, pv, table = (x.numpy() for x in pool_from_contiguous(
        torch.from_numpy(k), torch.from_numpy(v), bs,
        lens=torch.from_numpy(lens),        # columns past kv_len -> trash
        generator=torch.Generator().manual_seed(b * 100 + bs)))
    ref = jax_paged(jx.asarray(q), jx.asarray(pk), jx.asarray(pv),
                    jx.asarray(table), jx.asarray(lens), window=window,
                    impl="ref")
    args = [torch.from_numpy(a) for a in (q, pk, pv, table, lens)]
    out = decode_attention_paged(*args, window=window)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5, atol=2e-5)
    # the same logical keys, contiguous: within the tolerance of the oracle
    contig = decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), args[-1],
                                  window=window)
    np.testing.assert_allclose(_np(out), _np(contig), rtol=2e-5, atol=2e-5)


def test_paged_decode_bitwise_at_pow2_width():
    """At a power-of-two gathered width the plain paged path is BITWISE the
    port's contiguous plain decode (the serving invariant on the CPU)."""
    b, skv, bs, hq, hkv, d = 2, 64, 16, 6, 2, 32
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(b, hq, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, skv, hkv, d)).astype(
        np.float32))
    v = torch.from_numpy(rng.normal(size=(b, skv, hkv, d)).astype(
        np.float32))
    lens = torch.tensor([40, 23], dtype=torch.int32)
    pk, pv, table = pool_from_contiguous(
        k, v, bs, generator=torch.Generator().manual_seed(5))
    out = decode_attention_paged(q, pk, pv, table, lens)
    ref = decode_attention(q, k, v, lens)
    assert torch.equal(out, ref)


def test_paged_decode_scrambled_table_and_trash_tail_bitwise():
    """Physical placement is invisible: another scramble, or the masked
    tail pointing at the trash block, gives the same bits."""
    b, skv, bs, hq, hkv, d = 2, 32, 8, 4, 2, 16
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(size=(b, hq, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, skv, hkv, d)).astype(
        np.float32))
    v = torch.from_numpy(rng.normal(size=(b, skv, hkv, d)).astype(
        np.float32))
    lens = torch.tensor([20, 9], dtype=torch.int32)
    gen = torch.Generator().manual_seed(6)
    outs = []
    for scramble in (None, gen, gen):
        pk, pv, table = pool_from_contiguous(k, v, bs, generator=scramble)
        outs.append(decode_attention_paged(q, pk, pv, table, lens))
    table[0, 3:] = 0
    table[1, 2:] = 0
    outs.append(decode_attention_paged(q, pk, pv, table, lens))
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.parametrize("skv,bs", [(32, 8), (30, 16), (20, 48)])
def test_pool_from_contiguous_gathers_back(skv, bs):
    """The pool builder's table gathers back to the contiguous caches (zero
    tail where Skv is not a multiple of BS), every block once, block 0
    unused; with lens, entries past a row's length are the trash block."""
    b, hkv, d = 3, 2, 4
    k = torch.randn((b, skv, hkv, d), generator=torch.Generator()
                    .manual_seed(skv))
    lens = torch.tensor([skv, 0, skv // 2 + 1], dtype=torch.int32)
    pk, pv, table = pool_from_contiguous(
        k, -k, bs, generator=torch.Generator().manual_seed(bs))
    t = -(-skv // bs)
    assert table.dtype == torch.int32 and table.is_contiguous()
    assert sorted(table.flatten().tolist()) == list(range(1, 1 + b * t))
    assert not pk[0].any()
    view = pk[table.long()].reshape(b, t * bs, hkv, d)
    assert torch.equal(view[:, :skv], k) and not view[:, skv:].any()
    assert torch.equal(pv, -pk)
    _, _, trashed = pool_from_contiguous(
        k, k, bs, lens=lens, generator=torch.Generator().manual_seed(bs))
    cols = torch.arange(t)[None, :] * bs
    assert torch.equal(trashed, torch.where(cols < lens[:, None], table, 0))


def test_paged_decode_cpu_dispatch_dead_rows_and_impls():
    """A CPU tensor takes the plain version (no launch); a row with
    kv_len 0 outputs 0; an unknown impl raises."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.normal(size=(2, 3, 20)).astype(np.float32))
    pool = torch.from_numpy(rng.normal(size=(5, 4, 1, 20)).astype(
        np.float32))
    table = torch.tensor([[1, 2, 3, 4], [0, 0, 0, 0]], dtype=torch.int32)
    lens = torch.tensor([13, 0], dtype=torch.int32)
    before = flash_decode_paged_bshd.launches
    outs = [decode_attention_paged(q, pool, pool, table, lens, impl=impl)
            for impl in ("auto", "cuda", "ref", "xla")]
    assert flash_decode_paged_bshd.launches == before
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert torch.isfinite(outs[0]).all() and (outs[0][1] == 0).all()
    with pytest.raises(ValueError, match="impl"):
        decode_attention_paged(q, pool, pool, table, lens, impl="pallas")


@pytest.mark.parametrize("sq,skv,q_offset,lens", [
    (8, 32, 12, [20, 32]),
    (16, 64, 16, [17, 32]),
    (4, 48, 40, [44, 41]),
])
def test_attention_kv_len_q_offset_matches_jax_xla(jx, sq, skv, q_offset,
                                                   lens):
    """kv_len with q_offset (a prefill chunk against a gathered view)."""
    from repro.kernels.flash_attention.ref import attention_xla as jax_xla
    rng = np.random.default_rng(sq + skv)
    q = rng.normal(size=(2, sq, 6, 20)).astype(np.float32)
    k, v = (rng.normal(size=(2, skv, 2, 20)).astype(np.float32)
            for _ in range(2))
    kl = np.asarray(lens, np.int32)
    ref = jax_xla(*(jx.asarray(a) for a in (q, k, v)), causal=True,
                  q_offset=q_offset, kv_len=jx.asarray(kl))
    for impl in ("auto", "ref", "xla"):
        out = attention(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=True, q_offset=q_offset,
                        kv_len=torch.from_numpy(kl), impl=impl)
        np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5, atol=2e-5,
                                   err_msg=impl)


# --------------------------------------------------- model (vs JAX) ----

def _both_pools(jx, cfg, blocks):
    from repro.models.api import paged_init_pool as jax_pool
    jp = jax_pool(cfg, blocks, BS)
    tp = paged_init_pool(cfg, blocks, BS, device="cpu")
    return (jp["k"], jp["v"]), (tp["k"], tp["v"])


def _chunked_prefill(jx, pair, prompt, table_row, chunks):
    """Prefill ``prompt`` into both packages' pools, one chunk per entry of
    ``chunks`` (real token counts), each right-padded to a pow2 width."""
    from repro.models import transformer as jtr
    jcfg, jparams, cfg, params = pair
    (jk, jv), (tk, tv) = _both_pools(jx, cfg, 1 + int(table_row.max()))
    tab = table_row[None].astype(np.int32)
    m, logits = 0, []
    for n in chunks:
        c = 1 << max(0, n - 1).bit_length()
        chunk = np.full((1, c), cfg.pad_id, np.int32)
        chunk[0, :n] = prompt[m:m + n]
        jl, jk, jv = jtr.lm_prefill_paged_chunk(
            jparams, jcfg, jx.asarray(chunk), jk, jv, jx.asarray(tab),
            jx.int32(m), jx.int32(n), attn_impl="xla")
        tl, tk, tv = transformer.lm_prefill_paged_chunk(
            params, cfg, torch.from_numpy(chunk), tk, tv,
            torch.from_numpy(tab), m, n)
        logits.append((jl, tl))
        m += n
    return logits, (jk, jv), (tk, tv)


def test_prefill_paged_chunk_chained_matches_jax(jx, pair):
    prompt = list(map(int, RNG.integers(1, 256, 37)))
    table_row = np.zeros((TW,), np.int32)
    table_row[:10] = np.random.default_rng(3).permutation(np.arange(1, 11))
    logits, (jk, jv), (tk, tv) = _chunked_prefill(jx, pair, prompt,
                                                  table_row, (16, 13, 8))
    assert len(logits) == 3
    for jl, tl in logits:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_prefill_paged_chunked_equals_one_chunk(jx, pair):
    """Chaining chunks gives the one-chunk prefill's logits and pools."""
    prompt = list(map(int, RNG.integers(1, 256, 29)))
    table_row = np.zeros((TW,), np.int32)
    table_row[:8] = np.arange(8, 0, -1)
    chained, _, (ck, cv) = _chunked_prefill(jx, pair, prompt, table_row,
                                            (8, 8, 13))
    whole, _, (wk, wv) = _chunked_prefill(jx, pair, prompt, table_row, (29,))
    np.testing.assert_allclose(chained[-1][1].numpy(), whole[0][1].numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ck.numpy(), wk.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(cv.numpy(), wv.numpy(), rtol=2e-5, atol=2e-5)


def test_decode_paged_8_steps_matches_jax(jx, pair):
    """Three rows prefilled into one pool (one dead), 8 greedy steps."""
    from repro.models import transformer as jtr
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(4)
    lens0 = [9, 0, 14]
    live = np.asarray([n > 0 for n in lens0])
    table = np.zeros((3, TW), np.int32)
    table[0, :5] = [3, 7, 1, 9, 11]
    table[2, :6] = [2, 4, 6, 8, 10, 12]
    (jk, jv), (tk, tv) = _both_pools(jx, cfg, 13)
    last = np.zeros((3,), np.int32)
    for r, n in enumerate(lens0):
        if not n:
            continue
        chunk = np.full((1, 16), cfg.pad_id, np.int32)
        chunk[0, :n] = rng.integers(1, 256, n)
        tab = table[r:r + 1]
        jl, jk, jv = jtr.lm_prefill_paged_chunk(
            jparams, jcfg, jx.asarray(chunk), jk, jv, jx.asarray(tab),
            jx.int32(0), jx.int32(n), attn_impl="xla")
        tl, tk, tv = transformer.lm_prefill_paged_chunk(
            params, cfg, torch.from_numpy(chunk), tk, tv,
            torch.from_numpy(tab), 0, n)
        last[r] = int(np.argmax(np.asarray(jl)))
        assert int(torch.argmax(tl)) == last[r]
    lens = np.asarray(lens0, np.int32)
    for _ in range(8):
        tok = np.where(live, last, cfg.pad_id).astype(np.int32)[:, None]
        jl, jk, jv = jtr.lm_decode_paged(
            jparams, jcfg, jk, jv, jx.asarray(table), jx.asarray(lens),
            jx.asarray(live), jx.asarray(tok), attn_impl="xla")
        tl, tk, tv = transformer.lm_decode_paged(
            params, cfg, tk, tv, torch.from_numpy(table),
            torch.from_numpy(lens), torch.from_numpy(live),
            torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                                   atol=1e-3)
        last = np.asarray(np.argmax(np.asarray(jl), -1), np.int32)
        np.testing.assert_array_equal(
            torch.argmax(tl, -1).numpy()[live], last[live])
        lens = lens + live
    np.testing.assert_allclose(tk[:, 1:].numpy(), np.asarray(jk)[:, 1:],
                               rtol=1e-3, atol=1e-3)


# ------------------------------------------------------- the engines ----

def serve_paged(prefill, decode, params, cfg, prompts, handle, **dev):
    """The shared client schedule on the test's pool and budget.  Returns
    (tokens per request, every engine reply in comparable form)."""
    toks, log = serve_requests(
        prefill, decode, params, prompts, cfg=cfg, handle=handle,
        slots=SLOTS, k=K, max_new=MAX_NEW, blocks=NBLK, table_width=TW,
        block_size=BS, budget=BUDGET, **dev)
    return toks, [
        ("prefill", e["reply"]["slots"], e["reply"]["pending"],
         e["reply"]["occupancy"]) if e["call"] == "prefill" else
        ("decode", e["tokens"].tolist(), e["reply"]["occupancy"])
        for e in log]


def _schedule_prompts():
    """A 40-token prompt the budget splits, short ones, exact repeats
    (radix hits) and one sharing a 2-block head with another: 6 requests
    for 3 slots, so the last ones are admitted into freed slots."""
    rng = np.random.default_rng(21)
    p = [list(map(int, rng.integers(1, 256, n))) for n in (40, 9, 13)]
    p[1][3] = 0                                  # holds the pad id
    return p + [list(p[0]), p[2][:8] + [5, 6, 7, 8, 9], list(p[1])]


@pytest.fixture(scope="module")
def schedule(pair):
    """Both engines through the same scripted schedule."""
    from repro.runtime import engine as jeng
    from repro.runtime import state as jstate
    jcfg, jparams, cfg, params = pair
    prompts = _schedule_prompts()
    jt, jlog = serve_paged(jeng.engine_paged_prefill,
                           jeng.engine_paged_decode, jparams, jcfg, prompts,
                           "test-paged-jax")
    tt, tlog = serve_paged(engine.engine_paged_prefill,
                           engine.engine_paged_decode, params, cfg, prompts,
                           "test-paged-port", device="cpu")
    jpools = {k: np.asarray(jstate.get("test-paged-jax")[f"pool_{k}"])
              for k in "kv"}
    tpools = {k: state.get("test-paged-port")[f"pool_{k}"] for k in "kv"}
    jstate.release("test-paged-jax")
    state.release("test-paged-port")
    return prompts, (jt, jlog, jpools), (tt, tlog, tpools)


def test_engine_schedule_tokens_match_jax(schedule):
    prompts, (jt, _, _), (tt, _, _) = schedule
    assert [len(t) for t in tt] == [MAX_NEW] * len(prompts)
    assert tt == jt


def test_engine_schedule_host_accounting_matches_jax(schedule):
    """Every reply — per-slot progress, pending count, occupancy — is
    identical, call for call."""
    _, (_, jlog, _), (_, tlog, _) = schedule
    assert len(tlog) == len(jlog)
    for ours, ref in zip(tlog, jlog):
        assert ours == ref


def test_engine_schedule_exercised_the_paged_features(schedule):
    """The 40-token prompt took 3 chunk calls, repeats hit the radix index,
    blocks were shared, and the last requests reused freed slots."""
    _, _, (_, tlog, _) = schedule
    prefills = [e for e in tlog if e[0] == "prefill"]
    progress = [ent for e in prefills for ent in e[1].values()]
    assert sum(1 for ent in progress if ent["total"] == 40
               and not ent["matched"]) >= 3
    assert max(ent["matched"] for ent in progress) >= 36
    assert any(ent["matched"] == 8 for ent in progress)
    assert max(e[-1]["shared_blocks"] for e in tlog) > 0
    assert sum(e[1] != {} for e in prefills) >= 4


@pytest.mark.parametrize("key", ["k", "v"])
def test_engine_schedule_pools_match_jax(schedule, key):
    _, (_, _, jpools), (_, _, tpools) = schedule
    np.testing.assert_allclose(tpools[key][:, 1:].numpy(),
                               jpools[key][:, 1:], **TOL)


def test_paged_tokens_equal_solo_wave_tokens(schedule, pair):
    """Invariance within the port: each request's paged tokens equal the
    tokens it gets served alone by ``make_generate_fn``."""
    prompts, _, (tt, _, _) = schedule
    cfg, params = pair[2], pair[3]
    generate = make_generate_fn(cfg, MAX_NEW, device="cpu")
    for p, paged in zip(prompts, tt):
        solo = generate(params, *pack_prompts([p], pad=cfg.pad_id))[0]
        assert solo.tolist() == paged


# --------------------------------------------- devices and the registry ----

def _tiny():
    cfg = get_smoke("smollm-360m").replace(param_dtype="float32",
                                           compute_dtype="float32")
    return cfg, build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA card")
    cfg, params = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        paged_init_pool(cfg, 4, 4)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        engine.engine_paged_prefill(params, cfg=cfg, handle="test-no-card",
                                    batch=1, blocks=4, table_width=2,
                                    block_size=4, admit=[(0, [1, 2])])
    assert "test-no-card" not in state.stats()["handles"]


def test_params_and_pool_on_other_devices_raise():
    cfg, params = _tiny()
    meta = {k: (v if not isinstance(v, torch.Tensor) else v.to("meta"))
            for k, v in params.items()}
    engine.engine_paged_prefill(params, cfg=cfg, handle="test-devices",
                                batch=1, blocks=4, table_width=2,
                                block_size=4, device="cpu")
    try:
        with pytest.raises(ValueError, match="params are on meta"):
            engine.engine_paged_prefill(meta, cfg=cfg, handle="test-devices",
                                        batch=1, blocks=4, table_width=2,
                                        block_size=4, device="cpu")
        with pytest.raises(ValueError, match="params are on meta"):
            engine.engine_paged_decode(meta, cfg=cfg, handle="test-devices",
                                       k=1)
    finally:
        state.release("test-devices")


def test_lost_handle_is_state_lost():
    cfg, params = _tiny()
    with pytest.raises(KeyError) as err:
        engine.engine_paged_decode(params, cfg=cfg, handle="test-lost", k=1)
    assert engine.is_state_lost(err.value)
    with pytest.raises(KeyError) as err:
        engine.engine_paged_prefill(params, cfg=cfg, handle="test-lost",
                                    batch=1, blocks=4, table_width=2,
                                    block_size=4, create=False,
                                    device="cpu")
    assert engine.is_state_lost(err.value)
    assert not engine.is_state_lost(KeyError("other"))


def test_state_registry_lease_expiry_and_stats(monkeypatch):
    """The copied registry: leases renew on touch, expire on the clock,
    and ``stats`` rolls up the arenas' occupancy."""
    now = [100.0]
    monkeypatch.setattr(state, "_now", lambda: now[0])
    state.lease("test-lease", ttl_s=5.0,
                make=lambda: {"occupancy": {"live_tokens": 3,
                                            "allocated_blocks": 2,
                                            "shared_blocks": 1}})
    st = state.stats()
    assert "test-lease" in st["handles"]
    assert st["arena"]["shared_blocks"] >= 1
    now[0] += 4.0
    assert state.renew("test-lease", ttl_s=5.0)
    now[0] += 4.0
    assert state.get("test-lease")["occupancy"]["live_tokens"] == 3
    assert state.expire_all(["test-lease"]) == ["test-lease"]
    assert state.control("state_lease", {"handle": "test-lease"}) == {
        "ok": True, "known": False}
    assert not state.release("test-lease")
