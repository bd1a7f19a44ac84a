"""The port's RWKV-6 WKV recurrence (``repro_torch.kernels.rwkv6_wkv``)
against the JAX package's.

On the CPU the port's op runs its plain versions (the sequential scan and
the chunked form; ``impl="auto"`` takes the chunked form for a CPU tensor).
They are held against the JAX oracle ``wkv6_scan_ref`` and against the JAX
Pallas kernel in interpret mode, on the same f32 inputs made from a numpy
seed, at rtol = atol = 5e-4 (``tests/test_kernels.py``'s WKV tolerance: the
chunked sums run in another order than the scan's), and 1e-3 for the
hypothesis case, as there.  The CUDA kernel's own tests are in
``tests/test_torch_kernels.py`` (marked ``cuda``).
"""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro_torch.kernels.rwkv6_wkv import (wkv6, wkv6_chunked,
                                           wkv6_chunked_bshk, wkv6_decode,
                                           wkv6_decode_ref, wkv6_scan_ref)

torch.set_num_threads(1)

RNG = np.random.default_rng(6)
TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture
def jwkv():
    """The JAX package's WKV module (jax.numpy, ops)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import rwkv6_wkv
    return jnp, rwkv6_wkv


def _inputs(b, s, h, k, lw_max=1.0):
    """Numpy inputs as in tests/test_kernels.py: normal r, k, v, u; logw
    uniform in [-lw_max, -0.01]."""
    return (RNG.normal(size=(b, s, h, k)).astype(np.float32),
            RNG.normal(size=(b, s, h, k)).astype(np.float32),
            RNG.normal(size=(b, s, h, k)).astype(np.float32),
            -RNG.uniform(0.01, lw_max, size=(b, s, h, k)).astype(np.float32),
            RNG.normal(size=(h, k)).astype(np.float32))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


SWEEP = [
    (2, 96, 4, 8, 32),              # tests/test_kernels.py's sweep
    (1, 64, 2, 16, 16),
    (2, 70, 4, 8, 32),              # needs padding
    (2, 5, 4, 8, 32),               # S below the chunk
    (1, 1, 2, 8, 16),               # one step
    (2, 40, 4, 8, 16),              # rwkv6-smoke heads
]


@pytest.mark.parametrize("b,s,h,k,chunk", SWEEP)
def test_wkv6_matches_jax_scan_and_pallas(jwkv, b, s, h, k, chunk):
    jnp, jm = jwkv
    arrays = _inputs(b, s, h, k)
    ja = [jnp.asarray(a) for a in arrays]
    y0, s0 = jm.wkv6_scan_ref(*ja)
    yk, sk = jm.wkv6(*ja, chunk=chunk, impl="pallas_interpret")
    outs = [wkv6_scan_ref(*_t(arrays))]
    outs += [wkv6(*_t(arrays), chunk=chunk, impl=impl)
             for impl in ("scan", "chunked", "auto")]
    for i, (y, sl) in enumerate(outs):
        assert y.dtype == torch.float32 and sl.dtype == torch.float32
        assert tuple(y.shape) == (b, s, h, k) and tuple(sl.shape) == (
            b, h, k, k)
        for ref_y, ref_s in ((y0, s0), (yk, sk)):
            np.testing.assert_allclose(y.numpy(), np.asarray(ref_y),
                                       err_msg=str(i), **TOL)
            np.testing.assert_allclose(sl.numpy(), np.asarray(ref_s),
                                       err_msg=str(i), **TOL)


def test_wkv6_chunked_form_matches_jax_chunked(jwkv):
    """The chunked form itself against JAX's: at a multiple of the chunk,
    and at S 64 over chunk 24, which it pads as JAX's op pads."""
    jnp, jm = jwkv
    arrays = _inputs(2, 64, 4, 8)
    ja = [jnp.asarray(a) for a in arrays]
    for chunk, (yj, sj) in ((16, jm.wkv6_chunked(*ja, chunk=16)),
                            (24, jm.wkv6(*ja, chunk=24, impl="chunked"))):
        y, sl = wkv6_chunked(*_t(arrays), chunk=chunk)
        assert y.shape == (2, 64, 4, 8)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj),
                                   err_msg=str(chunk), **TOL)
        np.testing.assert_allclose(sl.numpy(), np.asarray(sj),
                                   err_msg=str(chunk), **TOL)


def test_wkv6_decode_consistency_matches_jax(jwkv):
    """tests/test_kernels.py's decode case: a chunked prefix and one decode
    step give the scan of the whole sequence; the step agrees with JAX's."""
    jnp, jm = jwkv
    r, k, v, lw, u = _inputs(1, 33, 2, 8)
    yf, sf = jm.wkv6_scan_ref(*(jnp.asarray(a) for a in (r, k, v, lw, u)))
    _, s1 = wkv6(*_t((r[:, :-1], k[:, :-1], v[:, :-1], lw[:, :-1], u)),
                 chunk=8, impl="chunked")
    last = [a[:, -1] for a in (r, k, v, lw)]
    y2, s2 = wkv6_decode(*_t(last), torch.from_numpy(u), s1)
    yj, sj = jm.wkv6_decode(*(jnp.asarray(a) for a in last), jnp.asarray(u),
                            jnp.asarray(s1.numpy()))
    for got, want in ((y2, yf[:, -1]), (s2, sf), (y2, yj), (s2, sj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert wkv6_decode is wkv6_decode_ref


@settings(max_examples=10, deadline=None, database=None)
@given(s=st.integers(4, 70), chunk=st.sampled_from([8, 16, 32]))
def test_wkv6_hypothesis(s, chunk):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.rwkv6_wkv import wkv6_scan_ref as jax_scan
    arrays = _inputs(1, s, 2, 4, lw_max=2.0)
    y0, s0 = jax_scan(*(jnp.asarray(a) for a in arrays))
    y1, s1 = wkv6(*_t(arrays), chunk=chunk)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y0), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s0), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("split,chunk", [(32, 16), (20, 16), (7, 32)])
def test_wkv6_s0_chaining_matches_jax(jwkv, split, chunk):
    """Running a prefix and then the rest from its final state gives the
    whole sequence; the second part with s0 agrees with JAX's Pallas
    kernel."""
    jnp, jm = jwkv
    arrays = _inputs(1, 64, 2, 8)
    yf, sf = jm.wkv6_scan_ref(*(jnp.asarray(a) for a in arrays))
    head = [a[:, :split] for a in arrays[:4]]
    tail = [a[:, split:] for a in arrays[:4]]
    u = torch.from_numpy(arrays[4])
    _, s1 = wkv6(*_t(head), u, chunk=chunk)
    for impl in ("scan", "chunked", "auto"):
        y2, s2 = wkv6(*_t(tail), u, s1, chunk=chunk, impl=impl)
        np.testing.assert_allclose(y2.numpy(), np.asarray(yf)[:, split:],
                                   err_msg=impl, **TOL)
        np.testing.assert_allclose(s2.numpy(), np.asarray(sf),
                                   err_msg=impl, **TOL)
    yj, sj = jm.wkv6(*(jnp.asarray(a) for a in tail),
                     jnp.asarray(arrays[4]), jnp.asarray(s1.numpy()),
                     chunk=chunk, impl="pallas_interpret")
    np.testing.assert_allclose(y2.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(sj), **TOL)


def test_wkv6_bf16_plain_versions_agree():
    """bf16 r, k, v with f32 logw (as the model gives them): y in bf16, the
    state in f32; scan and chunked agree at the bf16 tolerance."""
    r, k, v, lw, u = _t(_inputs(2, 50, 4, 8))
    r, k, v = (t.bfloat16() for t in (r, k, v))
    ys, ss = wkv6(r, k, v, lw, u, chunk=16, impl="scan")
    yc, sc = wkv6(r, k, v, lw, u, chunk=16)
    assert ys.dtype == yc.dtype == torch.bfloat16
    assert ss.dtype == sc.dtype == torch.float32
    np.testing.assert_allclose(yc.float().numpy(), ys.float().numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(sc.numpy(), ss.numpy(), rtol=2e-2, atol=2e-2)


def test_wkv6_cpu_dispatch_is_plain_and_ignores_start():
    """A CPU tensor takes the plain chunked version and launches nothing.
    ``start`` is ignored there: on left pad with r = k = v = 0 (logw as
    the model leaves it there, nonzero) the walk over the pad is the same
    function as the kernel's walk from ``start``, so y is 0 at the pad and
    the rest agrees with the scan of the row alone; a bad impl raises."""
    r, k, v, lw, u = _t(_inputs(2, 30, 4, 8))
    pad = torch.tensor([0, 11], dtype=torch.int32)
    real = (torch.arange(30)[None, :] >= pad[:, None]).float()
    r, k, v = (t * real[:, :, None, None] for t in (r, k, v))
    before = wkv6_chunked_bshk.launches
    y, sl = wkv6(r, k, v, lw, u, chunk=16, start=pad)
    yk, sk = wkv6_chunked_bshk(r, k, v, lw, u, chunk=16, start=pad)
    assert wkv6_chunked_bshk.launches == before
    y0, s0 = wkv6_chunked(r, k, v, lw, u, chunk=16)
    for got in ((y, sl), (yk, sk)):
        assert torch.equal(got[0], y0) and torch.equal(got[1], s0)
    assert (y[1, :11] == 0).all()
    ys, ss = wkv6(r[1:, 11:], k[1:, 11:], v[1:, 11:], lw[1:, 11:], u,
                  chunk=16, impl="scan")
    np.testing.assert_allclose(y[1:, 11:].numpy(), ys.numpy(), **TOL)
    np.testing.assert_allclose(sl[1:].numpy(), ss.numpy(), **TOL)
    with pytest.raises(ValueError, match="impl"):
        wkv6(r, k, v, lw, u, chunk=16, impl="pallas")


def test_wkv6_decode_row_does_not_depend_on_the_batch():
    """The decode step's readout is a product and a sum, not a batched
    gemv: a row alone gives the bits it gets in a batch of 8."""
    r, k, v, lw = (torch.from_numpy(a[:, 0]) for a in _inputs(8, 1, 4, 16)[:4])
    u = torch.from_numpy(RNG.normal(size=(4, 16)).astype(np.float32))
    s = torch.from_numpy(RNG.normal(size=(8, 4, 16, 16)).astype(np.float32))
    o8, s8 = wkv6_decode(r, k, v, lw, u, s)
    for i in range(8):
        o1, s1 = wkv6_decode(r[i:i + 1], k[i:i + 1], v[i:i + 1],
                             lw[i:i + 1], u, s[i:i + 1])
        assert torch.equal(o1[0], o8[i]) and torch.equal(s1[0], s8[i])


def _scan_f64(r, k, v, lw, u):
    """The sequential recurrence in float64."""
    r, k, v, lw, u = (t.double() for t in (r, k, v, lw, u))
    w = torch.exp(lw)
    b, s, h, kk = r.shape
    S = torch.zeros((b, h, kk, kk), dtype=torch.float64)
    ys = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               S + u[..., :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1), S


@pytest.mark.parametrize("seed,spread", [(0, 0.6), (1, 1.0)])
def test_wkv6_chunked_holds_an_f64_scan_at_rwkv6_decay_rates(jwkv, seed,
                                                              spread):
    """rwkv6-1.6b's decays: logw = -exp(w0 + lora) with w0 = -0.5 and the
    LoRA term spread by 0.6 to 1.0, so the running sum of logw falls to
    about -60 to -115 within a 64-step chunk (K 64).  The chunked form sums
    each decay segment directly and stays within 1e-6 of the largest |y|
    and |state| of a float64 scan, as the f32 scan does; the JAX package's
    chunked form, which differences the running sum, misses that here (by
    1.5e-6 to 4.2e-6)."""
    jnp, jm = jwkv
    rng = np.random.default_rng(seed)
    b, s, h, kk = 1, 256, 4, 64

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    r, k, v = (normal(b, s, h, kk) for _ in range(3))
    lw = -torch.exp(-0.5 + spread * normal(b, s, h, kk))
    u = 0.5 * normal(h, kk)
    y64, s64 = _scan_f64(r, k, v, lw, u)
    yj, sj = jm.wkv6_chunked(*(jnp.asarray(t.numpy()) for t in (r, k, v, lw,
                                                               u)), chunk=64)
    outs = {impl: wkv6(r, k, v, lw, u, chunk=64, impl=impl)
            for impl in ("chunked", "scan")}
    outs["jax"] = tuple(torch.from_numpy(np.array(t)) for t in (yj, sj))
    rel = {name: max(float((y.double() - y64).abs().max() / y64.abs().max()),
                     float((sl.double() - s64).abs().max() / s64.abs().max()))
           for name, (y, sl) in outs.items()}
    assert rel["chunked"] <= 1e-6 and rel["scan"] <= 1e-6, rel
    assert rel["jax"] > 1e-6, rel
