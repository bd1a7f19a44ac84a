"""The port's wave-serving task (``repro_torch.runtime.server``) against the
JAX package's, and its batch-composition invariance.

``make_generate_fn`` of both packages runs on the same JAX-initialised
``smollm-smoke`` f32 weights and the same packed ragged batch; the tokens
must be equal.  Within the port, a request served alone must get the same
greedy tokens as when it is packed with others (the invariance that
``tests/test_apps_server.py`` checks for the JAX package).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.interop import from_jax_params
from repro_torch.models import build_model, grow_cache
from repro_torch.runtime.server import (Completion, Request, decode_bucket,
                                        make_generate_fn, pack_prompts,
                                        shape_bucket)

torch.set_num_threads(1)

MAX_NEW = 8


@pytest.fixture(scope="module")
def served():
    """(JAX cfg, JAX params, port cfg, port params, ragged requests)."""
    pytest.importorskip("jax")
    import jax
    from conftest import make_ragged_requests
    from repro.configs import get_smoke as jax_smoke
    from repro.models import build_model as jax_build

    jcfg = jax_smoke("smollm-360m").replace(param_dtype="float32",
                                            compute_dtype="float32")
    jparams, _ = jax_build(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_smoke("smollm-360m").replace(param_dtype="float32",
                                           compute_dtype="float32")
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params, make_ragged_requests(jcfg)


@pytest.mark.parametrize("prompts,pad,min_rows", [
    ([[5, 0, 7], [9]], 3, 4),
    ([[0, 0, 4, 0]], 0, 1),
    ([[1] * 9, [2] * 3, [3]], 0, 1),
    ([[7, 8]], 1, 5),
])
def test_pack_prompts_matches_jax(prompts, pad, min_rows):
    pytest.importorskip("jax")
    from repro.runtime.server import pack_prompts as jax_pack
    toks, lens = pack_prompts(prompts, pad=pad, min_rows=min_rows)
    jtoks, jlens = jax_pack(prompts, pad=pad, min_rows=min_rows)
    assert toks.dtype == jtoks.dtype == np.int32
    np.testing.assert_array_equal(toks, jtoks)
    np.testing.assert_array_equal(lens, jlens)


def test_pack_prompts_rejects_empty_inputs():
    with pytest.raises(ValueError, match="empty prompt list"):
        pack_prompts([])
    with pytest.raises(ValueError, match="prompt 1 is empty"):
        pack_prompts([[1, 2], []])


def test_buckets_match_jax():
    pytest.importorskip("jax")
    from repro.runtime import server as js
    for n in range(0, 70):
        assert shape_bucket(n) == js.shape_bucket(n)
        assert decode_bucket(n) == js.decode_bucket(n)


def test_request_and_completion_defaults():
    r = Request(prompt=[1, 2])
    assert r.max_new == 16
    c = Completion(tokens=[3], latency_ms=5.0)
    assert c.ttft == 5.0 and not c.recovered
    assert Completion(tokens=[], latency_ms=5.0, ttft_ms=2.0).ttft == 2.0


def test_generate_tokens_equal_jax(served):
    import jax.numpy as jnp
    from repro.runtime.server import make_generate_fn as jax_generate
    jcfg, jparams, cfg, params, reqs = served
    toks, lens = pack_prompts([r.prompt for r in reqs], pad=cfg.pad_id)
    want = np.asarray(jax_generate(jcfg, MAX_NEW)(
        jparams, jnp.asarray(toks), jnp.asarray(lens)))
    got = make_generate_fn(cfg, MAX_NEW, device="cpu")(params, toks, lens)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("max_new", [1, 2, 5])
def test_generate_short_runs_are_prefixes(served, max_new):
    """A shorter generation is a prefix of a longer one (the last decode
    step is skipped, never a recorded token)."""
    _, _, cfg, params, reqs = served
    toks, lens = pack_prompts([r.prompt for r in reqs], pad=cfg.pad_id)
    full = make_generate_fn(cfg, MAX_NEW, device="cpu")(params, toks, lens)
    short = make_generate_fn(cfg, max_new, device="cpu")(params, toks, lens)
    assert torch.equal(short, full[:, :max_new])


def test_solo_and_packed_requests_get_equal_tokens(served):
    _, _, cfg, params, reqs = served
    generate = make_generate_fn(cfg, MAX_NEW, device="cpu")
    prompts = [r.prompt for r in reqs]
    packed = generate(params, *pack_prompts(prompts, pad=cfg.pad_id))
    for i, p in enumerate(prompts):
        solo = generate(params, *pack_prompts([p], pad=cfg.pad_id))
        assert solo[0].tolist() == packed[i].tolist(), i
    # pinned row bucket: filler rows ride along without touching real rows
    pinned = generate(params, *pack_prompts(prompts[:2], pad=cfg.pad_id,
                                            min_rows=8))
    assert pinned.shape[0] == 8
    assert torch.equal(pinned[:2], packed[:2])


def test_filler_rows_decode_finite(served):
    _, _, cfg, params, _ = served
    model = build_model(cfg, "cpu")
    toks, lens = pack_prompts([[1, 2, 3]], pad=cfg.pad_id, min_rows=4)
    assert list(lens) == [3, 0, 0, 0]
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                           "lengths": torch.from_numpy(lens)})
    assert torch.isfinite(logits).all()
    cache = grow_cache(cfg, cache, toks.shape[1] + 4)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    for _ in range(4):
        logits, cache = model.decode(params, cache, tok)
        assert torch.isfinite(logits).all()
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
