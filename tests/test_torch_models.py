"""The port's dense model (``repro_torch.models``) against the JAX package's.

``smollm-smoke`` in f32 (as ``tests/conftest.py`` sets the family fixture),
with the JAX-initialised weights carried over by ``from_jax_params``, on the
ragged batch of ``conftest.make_ragged_requests`` (it holds a prompt made of
the pad id).  Prefill logits and the K/V cache agree at rtol = atol = 1e-4:
the sums run in another order than XLA's, across 2 layers.  Greedy decode
tokens agree exactly over 16 steps.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.interop import from_jax_params
from repro_torch.models import build_model, grow_cache
from repro_torch.models.layers import (apply_rope, pad_mask,
                                       ragged_positions, rms_norm)
from repro_torch.runtime.server import pack_prompts

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    """(jax.numpy, JAX model, JAX params, port cfg, port model, port params,
    packed ragged batch)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from conftest import make_ragged_requests
    from repro.configs import get_smoke as jax_smoke
    from repro.models import build_model as jax_build

    jcfg = jax_smoke("smollm-360m").replace(param_dtype="float32",
                                            compute_dtype="float32")
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke("smollm-360m").replace(param_dtype="float32",
                                           compute_dtype="float32")
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    reqs = make_ragged_requests(jcfg)
    toks, lens = pack_prompts([r.prompt for r in reqs], pad=cfg.pad_id)
    return (jnp, jmodel, jparams, cfg, build_model(cfg, "cpu"), params,
            (toks, lens))


def _prefill_both(pair):
    jnp, jmodel, jparams, cfg, model, params, (toks, lens) = pair
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks),
                                      "lengths": jnp.asarray(lens)})
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                    "lengths": torch.from_numpy(lens)})
    return (jl, jc), (tl, tc)


def test_prefill_logits_match_jax(pair):
    (jl, _), (tl, _) = _prefill_both(pair)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("key", ["k", "v"])
def test_prefill_cache_matches_jax(pair, key):
    (_, jc), (_, tc) = _prefill_both(pair)
    assert tuple(tc[key].shape) == jc[key].shape
    np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL)
    assert tc["idx"] == int(jc["idx"])
    np.testing.assert_array_equal(tc["start"].numpy(),
                                  np.asarray(jc["start"]))


def test_greedy_decode_16_steps_match_jax(pair):
    jnp, jmodel, jparams, cfg, model, params, (toks, _) = pair
    from repro.models.api import grow_cache as jax_grow
    (jl, jc), (tl, tc) = _prefill_both(pair)
    s = toks.shape[1]
    jc = jax_grow(cfg, jc, s + 16)
    tc = grow_cache(cfg, tc, s + 16)
    jt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl, -1).to(torch.int32)[:, None]
    for _ in range(16):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc = jmodel.decode(jparams, jc, jt)
        tl, tc = model.decode(params, tc, tt)
        # each step reads every earlier step's K/V, so the last-ulp
        # differences compound: 1e-3 here, and the tokens must be equal
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                                   atol=1e-3)
        jt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl, -1).to(torch.int32)[:, None]
    assert tc["idx"] == int(jc["idx"]) == s + 16


@pytest.mark.parametrize("new_cap,bucket", [(13, True), (17, True),
                                            (13, False), (8, True)])
def test_grow_cache_shapes_match_jax(pair, new_cap, bucket):
    from repro.models.api import grow_cache as jax_grow
    (_, jc), (_, tc) = _prefill_both(pair)
    cfg = pair[3]
    jg = jax_grow(cfg, jc, new_cap, bucket=bucket)
    tg = grow_cache(cfg, tc, new_cap, bucket=bucket)
    for key in ("k", "v"):
        assert tuple(tg[key].shape) == jg[key].shape
        np.testing.assert_allclose(tg[key].numpy(), np.asarray(jg[key]),
                                   **TOL)


@pytest.mark.parametrize("kw", [{}, {"filled": 3}])
def test_init_cache_matches_jax(pair, kw):
    from repro.models.transformer import lm_init_cache as jax_init_cache
    cfg, model = pair[3], pair[4]
    starts = np.asarray([0, 2], np.int32)
    jc = jax_init_cache(cfg, 2, 8, start=pair[0].asarray(starts), **kw)
    tc = model.init_cache(2, 8, start=torch.from_numpy(starts), **kw)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        assert tc[key].dtype == torch.float32 and not tc[key].any()
    assert tc["idx"] == int(jc["idx"])
    np.testing.assert_array_equal(tc["start"].numpy(), starts)


def test_decode_plain_impls_agree_on_cpu(pair):
    """impl "auto" on CPU tensors is the plain path: same tokens as "ref"."""
    _, _, _, cfg, model, params, (toks, lens) = pair
    ref = build_model(cfg.replace(attn_impl="ref"), "cpu")
    batch = {"tokens": torch.from_numpy(toks),
             "lengths": torch.from_numpy(lens)}
    (la, ca), (lr, cr) = model.prefill(params, batch), ref.prefill(params,
                                                                   batch)
    np.testing.assert_allclose(la.numpy(), lr.numpy(), rtol=2e-5, atol=2e-5)
    ca, cr = grow_cache(cfg, ca, toks.shape[1] + 4), grow_cache(
        cfg, cr, toks.shape[1] + 4)
    tok = torch.argmax(la, -1).to(torch.int32)[:, None]
    for _ in range(4):
        la, ca = model.decode(params, ca, tok)
        lr, cr = ref.decode(params, cr, tok)
        np.testing.assert_allclose(la.numpy(), lr.numpy(), rtol=2e-5,
                                   atol=2e-5)
        tok = torch.argmax(la, -1).to(torch.int32)[:, None]


# ------------------------------------------------------------- layers ----

def test_rms_norm_and_rope_match_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import layers as jl
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 20)).astype(np.float32)
    w = rng.normal(size=(20,)).astype(np.float32) * 0.1
    pos = rng.integers(0, 50, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                   10_000.0).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 10_000.0)), rtol=1e-5, atol=1e-5)


def test_ragged_positions_and_pad_mask_match_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import layers as jl
    lens = np.asarray([5, 3, 0, 8], np.int32)
    pos, ks = ragged_positions(torch.from_numpy(lens), 4, 8, "cpu")
    jpos, jks = jl.ragged_positions(jnp.asarray(lens), 4, 8)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))
    np.testing.assert_array_equal(pad_mask(torch.from_numpy(lens), 8).numpy(),
                                  np.asarray(jl.pad_mask(jnp.asarray(lens),
                                                         8)))
    dense, none = ragged_positions(None, 2, 4, "cpu")
    assert none is None and dense.tolist() == [[0, 1, 2, 3]] * 2


# ---------------------------------------------------- weights and init ----

def test_from_jax_params_keeps_tree_layout_and_bf16():
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_smoke as jax_smoke
    from repro.models import build_model as jax_build
    jcfg = jax_smoke("smollm-360m")                       # bf16 params
    jparams, _ = jax_build(jcfg).init(jax.random.PRNGKey(1))
    leaves = jax.tree.map(np.asarray, jparams)
    params = from_jax_params(leaves, device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(leaves)
    assert len(flat_j) == 11
    for path, a in flat_j:
        t = params
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))


def test_lm_init_matches_jax_tree_shapes():
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_smoke as jax_smoke
    from repro.models import build_model as jax_build
    jparams, _ = jax_build(jax_smoke("smollm-360m")).init(
        jax.random.PRNGKey(0))
    cfg = get_smoke("smollm-360m")
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jparams)
    ours = jax.tree.map(lambda t: (tuple(t.shape),
                                   str(t.dtype).split(".")[-1]), params)
    assert ours == shapes


def test_lm_init_is_seeded_and_scaled_by_fan_in():
    cfg = get_smoke("smollm-360m").replace(param_dtype="float32")
    model = build_model(cfg, "cpu")
    a = model.init(torch.Generator().manual_seed(0))
    b = model.init(torch.Generator().manual_seed(0))
    c = model.init(torch.Generator().manual_seed(1))
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not torch.equal(a["embed"], c["embed"])
    wq, wo = a["layers"]["attn"]["wq"], a["layers"]["attn"]["wo"]
    # truncated normal in [-2, 2] / sqrt(fan_in): d for wq, H*D for wo
    assert float(wq.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) + 1e-6
    assert float(wo.abs().max()) <= 2.0 / np.sqrt(
        cfg.n_heads * cfg.head_dim) + 1e-6
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 0.88) < 0.1


def test_cuda_is_the_default_device():
    """Entry points default to the card; without one they raise instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = get_config("smollm-360m")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        from_jax_params({"w": np.zeros(2, np.float32)})


def test_unported_families_raise():
    cfg = get_smoke("smollm-360m")
    for bad in (cfg.replace(family="moe"), cfg.replace(kv_quant="int8"),
                cfg.replace(mrope_sections=(4, 3, 3))):
        with pytest.raises(NotImplementedError):
            build_model(bad, "cpu")
