"""The port's hybrid model (``repro_torch.models.hybrid``) against the JAX
package's.

``zamba2-smoke`` in f32, with the JAX-initialised weights carried over by
``from_jax_params``, on the ragged batch of ``conftest.make_ragged_requests``
(it holds a prompt made of the pad id).  Prefill logits and every cache
entry agree at rtol = atol = 1e-4 (sums in another order than XLA's, over 4
Mamba2 layers and 2 shared blocks), also against the JAX forward that runs
the Pallas SSD kernel in interpret mode.  Greedy tokens agree exactly with
the JAX serve task over 16 steps, and within the port a request served
alone gives the tokens it gets packed.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.interop import from_jax_params
from repro_torch.models import build_model, grow_cache, paged_supported
from repro_torch.models.hybrid import hybrid_forward
from repro_torch.models.layers import mlp_apply, mlp_init
from repro_torch.runtime.server import make_generate_fn, pack_prompts

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_KEYS = ("conv_x", "conv_B", "conv_C", "ssd", "k", "v")


def _f32(cfg):
    return cfg.replace(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def pair():
    """(jax, jax.numpy, JAX cfg, JAX model, JAX params, port cfg, port
    model, port params, packed ragged batch, the requests)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from conftest import make_ragged_requests
    from repro.configs import get_smoke as jax_smoke
    from repro.models import build_model as jax_build

    jcfg = _f32(jax_smoke("zamba2-2.7b"))
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = _f32(get_smoke("zamba2-2.7b"))
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
    np.testing.assert_array_equal(tc["start"].numpy(),
                                  np.asarray(jc["start"]))


def test_prefill_logits_match_jax_pallas_ssd(pair, prefilled):
    """The JAX forward through the Pallas SSD kernel (interpret mode) — the
    path the port's kernel stands for on the card."""
    _, jnp, jcfg, _, jparams, _, _, _, (toks, lens), _ = pair
    from repro.models.hybrid import hybrid_forward as jax_forward
    jl, _ = jax_forward(jparams, jcfg, jnp.asarray(toks), attn_impl="ref",
                        ssm_impl="pallas_interpret", last_only=True,
                        lengths=jnp.asarray(lens))
    (_, _), (tl, _) = prefilled
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, -1], **TOL)


@pytest.mark.parametrize("ssm_impl", ["scan", "chunked"])
def test_forward_plain_ssd_impls_agree(pair, prefilled, ssm_impl):
    """hybrid_forward with an explicit plain SSD gives the facade's
    (auto = chunked on the CPU) logits."""
    _, _, _, _, _, cfg, _, params, (toks, lens), _ = pair
    logits, _ = hybrid_forward(params, cfg, torch.from_numpy(toks),
                               attn_impl="ref", ssm_impl=ssm_impl,
                               last_only=True,
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
    _, jnp, jcfg, jmodel, jparams, cfg, model, params, (toks, _), _ = pair
    from repro.models.api import grow_cache as jax_grow
    (jl, jc), (tl, tc) = prefilled
    s = toks.shape[1]
    jc = jax_grow(jcfg, jc, s + 6)
    tc = grow_cache(cfg, {k: (v.clone() if isinstance(v, torch.Tensor)
                              else v) for k, v in tc.items()}, s + 6)
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
    assert tc["idx"] == int(jc["idx"]) == s + 6


def test_solo_equals_packed(pair):
    """Within the port: each request served alone gets its packed tokens."""
    _, _, _, _, _, cfg, _, params, (toks, lens), reqs = pair
    generate = make_generate_fn(cfg, 8, "cpu")
    packed = generate(params, toks, lens)
    for i, r in enumerate(reqs):
        solo = generate(params, *pack_prompts([r.prompt], pad=cfg.pad_id))
        assert torch.equal(solo[0], packed[i]), i


@pytest.mark.parametrize("new_cap,bucket", [(13, True), (17, False)])
def test_grow_cache_pads_the_kv_capacity_axis_as_jax(pair, prefilled,
                                                     new_cap, bucket):
    """Axis 2 of the hybrid's (G, B, cap, H, D) k/v is the capacity axis;
    the conv and SSD states pass through."""
    _, _, jcfg, _, _, cfg, _, _, _, _ = pair
    from repro.models.api import grow_cache as jax_grow
    (_, jc), (_, tc) = prefilled
    jg = jax_grow(jcfg, jc, new_cap, bucket=bucket)
    tg = grow_cache(cfg, tc, new_cap, bucket=bucket)
    for key in CACHE_KEYS:
        assert tuple(tg[key].shape) == jg[key].shape, key
        np.testing.assert_allclose(tg[key].numpy(), np.asarray(jg[key]),
                                   err_msg=key, **TOL)
    for key in ("conv_x", "conv_B", "conv_C", "ssd"):
        assert tg[key] is tc[key]


@pytest.mark.parametrize("kw", [{}, {"filled": 3}])
def test_init_cache_matches_jax(pair, kw):
    _, jnp, jcfg, _, _, cfg, model, _, _, _ = pair
    from repro.models.hybrid import hybrid_init_cache as jax_init_cache
    starts = np.asarray([0, 2], np.int32)
    jc = jax_init_cache(jcfg, 2, 8, start=jnp.asarray(starts), **kw)
    tc = model.init_cache(2, 8, start=torch.from_numpy(starts), **kw)
    for key in CACHE_KEYS:
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert str(tc[key].dtype).split(".")[-1] == str(jc[key].dtype)
        assert not tc[key].any()
    assert tc["idx"] == int(jc["idx"])
    np.testing.assert_array_equal(tc["start"].numpy(), starts)


# ------------------------------------------------------ layers and init --

def test_geglu_mlp_matches_jax():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models import layers as jl
    p, _ = jl.mlp_init(jax.random.PRNGKey(3), 24, 40, "geglu", jnp.float32)
    x = np.random.default_rng(4).normal(size=(2, 5, 24)).astype(np.float32)
    ref = jl.mlp_apply(p, jnp.asarray(x), "geglu")
    tp = from_jax_params(jax.tree.map(np.asarray, p), device="cpu")
    out = mlp_apply(tp, torch.from_numpy(x), "geglu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # jax.nn.gelu's default is the tanh form; the erf form differs
    h, g = (torch.from_numpy(x) @ tp[k] for k in ("wi", "wg"))
    erf = torch.matmul(h * torch.nn.functional.gelu(g), tp["wo"])
    assert float((erf - out).abs().max()) > 1e-5
    tree = mlp_init(torch.Generator().manual_seed(0), 24, 40, "geglu",
                    torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tree.items()} == {
        k: v.shape for k, v in p.items()}


def test_hybrid_init_matches_jax_tree():
    """Keys, shapes and dtypes of the port's hybrid_init equal JAX's."""
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_smoke as jax_smoke
    from repro.models import build_model as jax_build
    jparams, _ = jax_build(jax_smoke("zamba2-2.7b")).init(
        jax.random.PRNGKey(0))
    params = build_model(get_smoke("zamba2-2.7b"), "cpu").init(
        torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jparams)
    ours = jax.tree.map(lambda t: (tuple(t.shape),
                                   str(t.dtype).split(".")[-1]), params)
    assert ours == shapes
    assert set(params["mamba"]) == {
        "ln", "wz", "wx", "wB", "wC", "wdt", "dt_bias", "A_log", "D",
        "conv_x", "conv_B", "conv_C", "norm", "wo"}


def test_from_jax_params_keeps_the_hybrid_tree_and_bf16():
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_smoke as jax_smoke
    from repro.models import build_model as jax_build
    jparams, _ = jax_build(jax_smoke("zamba2-2.7b")).init(
        jax.random.PRNGKey(1))                            # bf16 params
    leaves = jax.tree.map(np.asarray, jparams)
    params = from_jax_params(leaves, device="cpu")
    flat = jax.tree_util.tree_leaves_with_path(leaves)
    assert len(flat) == 30
    for path, a in flat:
        t = params
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))


def test_hybrid_init_is_seeded_and_scaled_by_true_fan_in():
    cfg = _f32(get_smoke("zamba2-2.7b"))
    model = build_model(cfg, "cpu")
    a = model.init(torch.Generator().manual_seed(0))
    b = model.init(torch.Generator().manual_seed(0))
    assert torch.equal(a["shared"]["wq"], b["shared"]["wq"])
    d, hd = cfg.d_model, cfg.n_heads * cfg.head_dim
    # truncated normal in [-2, 2] / sqrt(fan_in)
    for w, fan_in in ((a["shared"]["wq"], 2 * d), (a["shared"]["wk"], 2 * d),
                      (a["shared"]["wo"], hd), (a["mamba"]["wB"], d),
                      (a["mamba"]["wC"], d), (a["lora"]["qa"], 2 * d),
                      (a["lora"]["oa"], hd)):
        assert float(w.abs().max()) <= 2.0 / np.sqrt(fan_in) + 1e-6
        assert abs(float(w.std()) * np.sqrt(fan_in) - 0.88) < 0.15
    assert not a["lora"]["qb"].any() and not a["lora"]["ob"].any()


def test_hybrid_is_registered_and_not_paged():
    cfg = get_config("zamba2-2.7b")
    assert (cfg.n_layers, cfg.d_model, cfg.ssm.chunk) == (54, 2560, 128)
    assert cfg.n_layers // cfg.shared_attn_every == 9
    assert not paged_supported(cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(cfg)


# ------------------------------------------- rows independent of the batch --

def test_row_floors_give_a_row_the_same_bits_at_any_row_count(monkeypatch):
    """``linear`` computes a product with K >= SPLIT_K_MIN of fewer than
    ROW_FLOOR rows on zero rows padded up to the floor, and ``rms_norm``
    fewer than NORM_ROW_FLOOR rows likewise, so a row's bits do not depend
    on how many rows share the call (on the card cuBLAS takes split-K
    kernels at such K, and ATen's row reduction another thread layout,
    below those counts).  A product of smaller K reaches the library as it
    is, with no padded rows."""
    from repro_torch.models.layers import (NORM_ROW_FLOOR, ROW_FLOOR,
                                           SPLIT_K_MIN, linear, rms_norm)
    rng = np.random.default_rng(8)
    w = torch.from_numpy(
        rng.normal(size=(SPLIT_K_MIN, 8)).astype(np.float32))
    x = torch.from_numpy(
        rng.normal(size=(ROW_FLOOR, SPLIT_K_MIN)).astype(np.float32))
    full = linear(x, w)
    assert torch.equal(full, torch.matmul(x, w))
    for m in (1, 8, 64, ROW_FLOOR - 1):
        assert torch.equal(linear(x[:m], w), full[:m]), m
    x3 = x.reshape(8, 32, SPLIT_K_MIN)
    assert torch.equal(linear(x3[:1, :3], w)[0], full[:3])

    rows, matmul = [], torch.matmul
    monkeypatch.setattr(torch, "matmul",
                        lambda a, b: rows.append(a.shape[:-1]) or matmul(a, b))
    linear(x[:3], w)
    linear(x[:3, :96], w[:96])
    assert rows == [(ROW_FLOOR,), (3,)]
    monkeypatch.undo()

    g = torch.from_numpy(rng.normal(size=(96,)).astype(np.float32))
    xn = x[:NORM_ROW_FLOOR, :96]
    normed = rms_norm(xn, g, 1e-6)
    for m in (1, 2, 8, NORM_ROW_FLOOR - 1):
        assert torch.equal(rms_norm(xn[:m], g, 1e-6), normed[:m]), m
    xb = xn[:8].bfloat16()
    assert rms_norm(xb[:1], g, 1e-6).dtype == torch.bfloat16
    assert torch.equal(rms_norm(xb[:1], g, 1e-6), rms_norm(xb, g, 1e-6)[:1])


def test_ssd_decode_row_does_not_depend_on_the_batch():
    """The SSD decode step's readout is a product and a row sum, not an
    einsum (on the card a batched gemv whose sums depend on the B·H count):
    a row alone gives the bits it gets in a batch of 4.  The whole hybrid
    decode step is not held so here: on the CPU even ``F.silu`` gives an
    element other bits in the vector body than in the scalar tail, so the
    end-to-end guard is ``chip_smoke.py`` phase 6 (bf16 solo == packed, 8
    of 8, as a batch of 1 and pinned to 8 rows)."""
    from repro_torch.kernels.mamba2_ssd import ssd_decode
    rng = np.random.default_rng(9)
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((4, 16, 8), (4, 16), (16,), (4, 1, 16), (4, 1, 16),
                      (4, 16, 8, 16))]
    y4, h4 = ssd_decode(*args)
    for i in range(4):
        y1, h1 = ssd_decode(*[a if a.dim() == 1 else a[i:i + 1]
                              for a in args])
        assert torch.equal(y1[0], y4[i]) and torch.equal(h1[0], h4[i])


def test_folded_q_is_formed_once_per_parameter_tree():
    """The shared q projection with each group's LoRA folded in, wq + qa @
    qb, is formed on the first call for a parameter tree and reused after;
    an in-place change of qb forms it anew, and the entry goes with the
    tree."""
    from repro_torch.models import hybrid
    cfg = _f32(get_smoke("zamba2-2.7b"))
    p = build_model(cfg, "cpu").init(torch.Generator().manual_seed(3))
    p["lora"]["qb"].normal_(generator=torch.Generator().manual_seed(4))
    first = hybrid._folded_q(p)
    assert hybrid._folded_q(p) is first
    want = p["shared"]["wq"].flatten(1) + torch.matmul(p["lora"]["qa"],
                                                       p["lora"]["qb"])
    assert torch.equal(first, want)
    assert first.shape == (cfg.n_layers // cfg.shared_attn_every,
                           2 * cfg.d_model, cfg.n_heads * cfg.head_dim)
    p["lora"]["qb"].mul_(2.0)
    again = hybrid._folded_q(p)
    assert again is not first and not torch.equal(again, first)
    key = tuple(map(id, (p["shared"]["wq"], p["lora"]["qa"],
                         p["lora"]["qb"])))
    assert key in hybrid._FOLDED_Q
    del p
    assert key not in hybrid._FOLDED_Q
