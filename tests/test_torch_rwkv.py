"""The port's RWKV-6 model (``repro_torch.models.rwkv_model``) against the
JAX package's.

``rwkv6-smoke`` in f32, with the JAX-initialised weights carried over by
``from_jax_params``, on the ragged batch of ``conftest.make_ragged_requests``
(it holds a prompt made of the pad id).  Prefill logits and every cache
entry agree at rtol = atol = 1e-4 (sums in another order than XLA's, over 2
layers), also against the JAX forward that runs the Pallas WKV kernel in
interpret mode.  Greedy tokens agree exactly with the JAX serve task over
16 steps, decode steps agree with JAX's, and within the port a request
served alone gives the tokens it gets packed.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.interop import from_jax_params
from repro_torch.models import build_model, grow_cache, paged_supported
from repro_torch.models.rwkv_model import rwkv_forward
from repro_torch.runtime.server import make_generate_fn, pack_prompts

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_KEYS = ("wkv", "shift_att", "shift_ffn")


def _f32(cfg):
    return cfg.replace(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def pair():
    """(jax, jax.numpy, JAX cfg, JAX model, JAX params, port cfg, port
    model, port params, packed ragged batch, the requests)."""
    pytest.importorskip("jax")
    import jax
    from conftest import make_ragged_requests
    import jax.numpy as jnp
    from repro.configs import get_smoke as jax_smoke
    from repro.models import build_model as jax_build

    jcfg = _f32(jax_smoke("rwkv6-1.6b"))
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = _f32(get_smoke("rwkv6-1.6b"))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    reqs = make_ragged_requests(jcfg)
    toks, lens = pack_prompts([r.prompt for r in reqs], pad=cfg.pad_id)
    return (jax, jnp, jcfg, jmodel, jparams, cfg, build_model(cfg, "cpu"),
            params, (toks, lens), reqs)


@pytest.fixture(scope="module")
def prefilled(pair):
    """Both packages' prefill of the ragged batch: ((logits, cache) JAX,
    (logits, cache) port)."""
    _, jnp, _, jmodel, jparams, _, model, params, (toks, lens), _ = pair
    jout = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks),
                                    "lengths": jnp.asarray(lens)})
    tout = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                  "lengths": torch.from_numpy(lens)})
    return jout, tout


def test_prefill_logits_match_jax(prefilled):
    (jl, _), (tl, _) = prefilled
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("key", CACHE_KEYS)
def test_prefill_cache_matches_jax(prefilled, key):
    (_, jc), (_, tc) = prefilled
    assert tuple(tc[key].shape) == jc[key].shape
    assert str(tc[key].dtype).split(".")[-1] == str(jc[key].dtype)
    np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL)
    assert tc["idx"] == int(jc["idx"])


def test_prefill_logits_match_jax_pallas_wkv(pair, prefilled):
    """The JAX forward through the Pallas WKV kernel (interpret mode) — the
    path the port's kernel stands for on the card."""
    _, jnp, jcfg, _, jparams, _, _, _, (toks, lens), _ = pair
    from repro.models.rwkv_model import rwkv_forward as jax_forward
    jl, _ = jax_forward(jparams, jcfg, jnp.asarray(toks),
                        ssm_impl="pallas_interpret", last_only=True,
                        lengths=jnp.asarray(lens))
    (_, _), (tl, _) = prefilled
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, -1], **TOL)


@pytest.mark.parametrize("ssm_impl", ["scan", "chunked"])
def test_forward_plain_wkv_impls_agree(pair, prefilled, ssm_impl):
    """rwkv_forward with an explicit plain WKV gives the facade's (auto =
    chunked on the CPU) logits."""
    _, _, _, _, _, cfg, _, params, (toks, lens), _ = pair
    logits, _ = rwkv_forward(params, cfg, torch.from_numpy(toks),
                             ssm_impl=ssm_impl, last_only=True,
                             lengths=torch.from_numpy(lens))
    (_, _), (tl, _) = prefilled
    np.testing.assert_allclose(logits[:, -1].numpy(), tl.numpy(), **TOL)


def test_greedy_tokens_16_steps_match_jax_serve_task(pair):
    jax, jnp, jcfg, _, jparams, cfg, _, params, (toks, lens), _ = pair
    from repro.runtime.server import make_generate_fn as jax_generate_fn
    jt = jax.jit(jax_generate_fn(jcfg, 16))(jparams, jnp.asarray(toks),
                                           jnp.asarray(lens))
    tt = make_generate_fn(cfg, 16, "cpu")(params, toks, lens)
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (len(toks), 16)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_decode_steps_match_jax(pair, prefilled):
    """Decode logits and the in-place updated cache against JAX's decode
    over 6 steps."""
    _, jnp, _, jmodel, jparams, _, model, params, (toks, _), _ = pair
    (jl, jc), (tl, tc) = prefilled
    tc = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
          for k, v in tc.items()}
    jt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl, -1).to(torch.int32)[:, None]
    for _ in range(6):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc = jmodel.decode(jparams, jc, jt)
        tl, tc = model.decode(params, tc, tt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                                   atol=1e-3)
        jt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl, -1).to(torch.int32)[:, None]
    for key in CACHE_KEYS:
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=1e-3, atol=1e-3, err_msg=key)
    assert tc["idx"] == int(jc["idx"]) == toks.shape[1] + 6


def test_solo_equals_packed(pair):
    """Within the port: each request served alone gets its packed tokens,
    as a batch of 1 and pinned to 8 rows."""
    _, _, _, _, _, cfg, _, params, (toks, lens), reqs = pair
    generate = make_generate_fn(cfg, 8, "cpu")
    packed = generate(params, toks, lens)
    for rows in (1, 8):
        for i, r in enumerate(reqs):
            solo = generate(params, *pack_prompts([r.prompt], pad=cfg.pad_id,
                                                  min_rows=rows))
            assert torch.equal(solo[0], packed[i]), (rows, i)


def test_grow_cache_returns_an_ssm_cache_as_it_is(pair, prefilled):
    _, _, jcfg, _, _, cfg, _, _, _, _ = pair
    from repro.models.api import grow_cache as jax_grow
    (_, jc), (_, tc) = prefilled
    assert jax_grow(jcfg, jc, 100) is jc
    assert grow_cache(cfg, tc, 100) is tc
    assert grow_cache(cfg, tc, 100, bucket=False) is tc


@pytest.mark.parametrize("kw", [{}, {"filled": 3}])
def test_init_cache_matches_jax(pair, kw):
    _, _, jcfg, _, _, _, model, _, _, _ = pair
    from repro.models.rwkv_model import rwkv_init_cache as jax_init_cache
    jc = jax_init_cache(jcfg, 2, 8, **kw)
    tc = model.init_cache(2, 8, **kw)
    for key in CACHE_KEYS:
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert str(tc[key].dtype).split(".")[-1] == str(jc[key].dtype)
        assert not tc[key].any()
    assert tc["idx"] == int(jc["idx"])


# ------------------------------------------------------------------ init --

def test_rwkv_init_matches_jax_tree():
    """Keys, shapes and dtypes of the port's rwkv_init equal JAX's."""
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_smoke as jax_smoke
    from repro.models import build_model as jax_build
    jparams, _ = jax_build(jax_smoke("rwkv6-1.6b")).init(
        jax.random.PRNGKey(0))
    params = build_model(get_smoke("rwkv6-1.6b"), "cpu").init(
        torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jparams)
    ours = jax.tree.map(lambda t: (tuple(t.shape),
                                   str(t.dtype).split(".")[-1]), params)
    assert ours == shapes


def test_rwkv_init_is_seeded_and_scaled_as_jax():
    """Every matrix is a truncated normal in [-2, 2] / sqrt(shape[-2]),
    the true fan-in (as the JAX init, which takes shape[-2] too); the
    constant leaves hold the JAX values."""
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_smoke as jax_smoke
    from repro.models import build_model as jax_build
    cfg = _f32(get_smoke("rwkv6-1.6b"))
    model = build_model(cfg, "cpu")
    a = model.init(torch.Generator().manual_seed(0))
    b = model.init(torch.Generator().manual_seed(0))
    assert torch.equal(a["layers"]["wr"], b["layers"]["wr"])
    jparams, _ = jax_build(_f32(jax_smoke("rwkv6-1.6b"))).init(
        jax.random.PRNGKey(0))
    jl = jax.tree.map(np.asarray, jparams["layers"])
    for key in ("wr", "wk", "wv", "wg", "wo", "mix_a", "mix_b", "decay_a",
                "decay_b", "cm_wk", "cm_wv", "cm_wr"):
        w, fan_in = a["layers"][key], a["layers"][key].shape[-2]
        assert float(w.abs().max()) <= 2.0 / np.sqrt(fan_in) + 1e-6, key
        assert abs(float(w.std()) * np.sqrt(fan_in) - 0.88) < 0.15, key
        assert abs(float(np.std(jl[key])) * np.sqrt(fan_in) - 0.88) < 0.15
    for key in ("mu_x", "mu_rkvwg", "w0", "u", "ln_x_w", "ln_x_b",
                "cm_mu_k", "cm_mu_r", "ln1", "ln2"):
        np.testing.assert_array_equal(a["layers"][key].numpy(), jl[key],
                                      err_msg=key)
    assert not a["final_norm"].any()


def test_from_jax_params_keeps_the_rwkv_tree_and_bf16():
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_smoke as jax_smoke
    from repro.models import build_model as jax_build
    jparams, _ = jax_build(jax_smoke("rwkv6-1.6b")).init(
        jax.random.PRNGKey(1))                            # bf16 params
    leaves = jax.tree.map(np.asarray, jparams)
    params = from_jax_params(leaves, device="cpu")
    flat = jax.tree_util.tree_leaves_with_path(leaves)
    assert len(flat) == 25
    for path, arr in flat:
        t = params
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == arr.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      arr.view(np.int16))


def test_rwkv_is_registered():
    assert "rwkv6-1.6b" in ARCHS
    cfg = get_config("rwkv6-1.6b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.d_ff,
            cfg.vocab_size) == ("ssm", 24, 2048, 7168, 65536)
    assert (cfg.ssm.n_heads, cfg.ssm.head_dim, cfg.ssm.chunk) == (32, 64, 64)
    assert get_smoke("rwkv6-1.6b").name == "rwkv6-smoke"
    assert paged_supported(cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(cfg)


def _layer_outputs(tm_mix, cm_mix, rms, split, layers, x, cfg, impl, n):
    """The residual stream after each of ``n`` rwkv6 layers, through one
    package's modules (``rwkv_forward``'s layer body without the pad
    mask)."""
    outs = []
    for li in range(n):
        lp = {k: v[li] for k, v in layers.items()}
        tm, cm = split(lp)
        h, _, _ = tm_mix(tm, rms(x, lp["ln1"], cfg.rms_eps),
                         n_heads=cfg.ssm.n_heads, head_dim=cfg.ssm.head_dim,
                         chunk=cfg.ssm.chunk, impl=impl)
        x = x + h
        h, _ = cm_mix(cm, rms(x, lp["ln2"], cfg.rms_eps))
        x = x + h
        outs.append(np.asarray(x))
    return outs


def test_both_packages_amplify_a_wkv_rounding_difference_layer_by_layer():
    """At rwkv6-1.6b's full width (d 2048, d_ff 7168, 32 heads of 64; 4
    layers, a vocabulary of 4,096 and one 256-token prompt to keep it
    small), the two plain WKV forms, scan and chunked, put the residual
    stream apart by f32 rounding after layer 1, and each further layer
    makes that gap larger, in the JAX package as in the port.  This is why
    the full 24-layer model's f32 logits differ by about 1e-2 between any
    two WKV orders on the card (PERF.md §7): the model amplifies, not a
    fault of one form."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_config
    from repro.models import rwkv6 as jr6
    from repro.models import rwkv_model as jrm
    from repro.models.layers import rms_norm as jax_rms
    from repro_torch.models import rwkv6 as tr6
    from repro_torch.models import rwkv_model as trm
    from repro_torch.models.layers import rms_norm
    n = 4
    cfg = _f32(get_config("rwkv6-1.6b")).replace(n_layers=n,
                                                  vocab_size=4096)
    jcfg = _f32(jax_config("rwkv6-1.6b")).replace(n_layers=n,
                                                   vocab_size=4096)
    jp, _ = jrm.rwkv_init(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(0).integers(1, 4096, (1, 256))
    jx = jp["embed"][jnp.asarray(toks)].astype(jnp.float32)
    tx = tp["embed"][torch.from_numpy(toks)].float()
    gaps = {}
    for name, mods, x in (
            ("jax", (jr6.rwkv6_time_mix, jr6.rwkv6_channel_mix, jax_rms,
                     jrm._split, jp["layers"]), jx),
            ("port", (tr6.rwkv6_time_mix, tr6.rwkv6_channel_mix, rms_norm,
                      trm._split, tp["layers"]), tx)):
        scan, chunked = (_layer_outputs(*mods, x, cfg, impl, n)
                         for impl in ("scan", "chunked"))
        gaps[name] = [float(np.abs(a - b).max())
                      for a, b in zip(scan, chunked)]
    print("max |scan - chunked| of the residual stream after each layer:",
          gaps)
    for name, g in gaps.items():
        assert 0 < g[0] < 1e-4, (name, g)
        assert all(b > a for a, b in zip(g, g[1:])), (name, g)
        assert g[-1] >= 2 * g[0], (name, g)
