"""The port's Mamba2 SSD scan (``repro_torch.kernels.mamba2_ssd``) against
the JAX package's.

On the CPU the port's op runs its plain versions (the sequential scan and
the chunked form; ``impl="auto"`` takes the chunked form for a CPU tensor).
They are held against the JAX oracle ``ssd_scan_ref`` and against the JAX
Pallas kernel in interpret mode, on the same f32 inputs made from a numpy
seed, at rtol = atol = 2e-4 (``tests/test_kernels.py``'s SSD tolerance: the
chunked sums run in another order than the scan's).  The CUDA kernel's own
tests are in ``tests/test_torch_kernels.py`` (marked ``cuda``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.mamba2_ssd import (ssd, ssd_chunked,
                                            ssd_chunked_bshp, ssd_decode,
                                            ssd_decode_ref, ssd_scan_ref)

torch.set_num_threads(1)

RNG = np.random.default_rng(5)
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def jssd():
    """The JAX package's SSD module (jax.numpy, ops)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import mamba2_ssd
    return jnp, mamba2_ssd


def _inputs(b, s, h, p, g, n):
    """Numpy inputs as in tests/test_kernels.py: normal x, B, C; dt in
    [0.01, 0.2]; A in [-2, -0.5]."""
    return (RNG.normal(size=(b, s, h, p)).astype(np.float32),
            RNG.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32),
            -RNG.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
            RNG.normal(size=(b, s, g, n)).astype(np.float32),
            RNG.normal(size=(b, s, g, n)).astype(np.float32))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


SWEEP = [
    (2, 96, 4, 8, 2, 16, 32),       # tests/test_kernels.py's sweep
    (1, 64, 2, 16, 1, 8, 16),
    (2, 100, 4, 8, 1, 16, 32),      # needs padding
    (2, 5, 4, 8, 2, 16, 32),        # S below the chunk
    (1, 1, 2, 8, 1, 16, 16),        # one step
    (2, 40, 16, 8, 1, 16, 16),      # zamba2-smoke heads
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SWEEP)
def test_ssd_matches_jax_scan_and_pallas(jssd, b, s, h, p, g, n, chunk):
    jnp, jm = jssd
    arrays = _inputs(b, s, h, p, g, n)
    ja = [jnp.asarray(a) for a in arrays]
    y0, h0 = jm.ssd_scan_ref(*ja)
    yk, hk = jm.ssd(*ja, chunk=chunk, impl="pallas_interpret")
    outs = [ssd_scan_ref(*_t(arrays))]
    outs += [ssd(*_t(arrays), chunk=chunk, impl=impl)
             for impl in ("scan", "chunked", "auto", "cuda")]
    for i, (y, hl) in enumerate(outs):
        assert y.dtype == torch.float32 and hl.dtype == torch.float32
        for ref_y, ref_h in ((y0, h0), (yk, hk)):
            np.testing.assert_allclose(y.numpy(), np.asarray(ref_y),
                                       err_msg=str(i), **TOL)
            np.testing.assert_allclose(hl.numpy(), np.asarray(ref_h),
                                       err_msg=str(i), **TOL)


def test_ssd_chunked_form_matches_jax_chunked(jssd):
    """The chunked form itself against JAX's: at a multiple of the chunk,
    and at S 64 over chunk 24, which it pads as JAX's op pads."""
    jnp, jm = jssd
    arrays = _inputs(2, 64, 4, 8, 2, 16)
    ja = [jnp.asarray(a) for a in arrays]
    for chunk, (yj, hj) in ((16, jm.ssd_chunked(*ja, chunk=16)),
                            (24, jm.ssd(*ja, chunk=24, impl="chunked"))):
        y, hl = ssd_chunked(*_t(arrays), chunk=chunk)
        assert y.shape == (2, 64, 4, 8)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj),
                                   err_msg=str(chunk), **TOL)
        np.testing.assert_allclose(hl.numpy(), np.asarray(hj),
                                   err_msg=str(chunk), **TOL)


@pytest.mark.parametrize("split,chunk", [(32, 16), (20, 16), (7, 32)])
def test_ssd_h0_chaining_matches_jax(jssd, split, chunk):
    """Scanning a prefix and then the rest from its final state gives the
    whole sequence; the second part with h0 agrees with JAX's."""
    jnp, jm = jssd
    x, dt, a, bm, cm = _inputs(1, 64, 2, 8, 1, 8)
    yf, hf = jm.ssd_scan_ref(*(jnp.asarray(t) for t in (x, dt, a, bm, cm)))
    head = [t[:, :split] for t in (x, dt, bm, cm)]
    tail = [t[:, split:] for t in (x, dt, bm, cm)]
    _, h1 = ssd(*_t(head[:2]), torch.from_numpy(a), *_t(head[2:]),
                chunk=chunk)
    for impl in ("scan", "chunked", "auto"):
        y2, h2 = ssd(*_t(tail[:2]), torch.from_numpy(a), *_t(tail[2:]),
                     h0=h1, chunk=chunk, impl=impl)
        np.testing.assert_allclose(y2.numpy(), np.asarray(yf)[:, split:],
                                   err_msg=impl, **TOL)
        np.testing.assert_allclose(h2.numpy(), np.asarray(hf),
                                   err_msg=impl, **TOL)
    jt = [jnp.asarray(t) for t in tail]
    yj, hj = jm.ssd(*jt[:2], jnp.asarray(a), *jt[2:],
                    h0=jnp.asarray(h1.numpy()), chunk=chunk,
                    impl="pallas_interpret")
    np.testing.assert_allclose(y2.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(h2.numpy(), np.asarray(hj), **TOL)


def test_ssd_decode_continues_a_prefix_as_jax(jssd):
    """Decode steps after a chunked prefix equal the scan of the whole
    sequence and JAX's decode step."""
    jnp, jm = jssd
    x, dt, a, bm, cm = _inputs(2, 24, 4, 8, 2, 16)
    yf, hf = ssd_scan_ref(*_t((x, dt, a, bm, cm)))
    _, hs = ssd(*_t((x[:, :20], dt[:, :20], a, bm[:, :20], cm[:, :20])),
                chunk=16)
    for t in range(20, 24):
        args = [x[:, t], dt[:, t], a, bm[:, t], cm[:, t]]
        yj, hj = jm.ssd_decode(*(jnp.asarray(v) for v in args),
                               jnp.asarray(hs.numpy()))
        yt, hs = ssd_decode(*_t(args), hs)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        np.testing.assert_allclose(hs.numpy(), np.asarray(hj), **TOL)
        np.testing.assert_allclose(yt.numpy(), yf[:, t].numpy(), **TOL)
    np.testing.assert_allclose(hs.numpy(), hf.numpy(), **TOL)
    assert ssd_decode is ssd_decode_ref


def test_ssd_bf16_plain_versions_agree():
    """bf16 inputs: y in bf16, the state in f32; scan and chunked agree at
    the bf16 tolerance."""
    x, dt, a, bm, cm = _t(_inputs(2, 50, 4, 8, 1, 16))
    x, dt, bm, cm = (t.bfloat16() for t in (x, dt, bm, cm))
    ys, hs = ssd(x, dt, a, bm, cm, chunk=16, impl="scan")
    yc, hc = ssd(x, dt, a, bm, cm, chunk=16)
    assert ys.dtype == yc.dtype == torch.bfloat16
    assert hs.dtype == hc.dtype == torch.float32
    np.testing.assert_allclose(yc.float().numpy(), ys.float().numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(hc.numpy(), hs.numpy(), rtol=2e-2, atol=2e-2)


def test_ssd_cpu_dispatch_is_plain_and_ignores_start():
    """A CPU tensor takes the plain chunked version and launches nothing;
    with identity pad steps ``start`` changes nothing; a bad impl raises."""
    x, dt, a, bm, cm = _t(_inputs(2, 30, 4, 8, 1, 16))
    pad = torch.tensor([0, 11], dtype=torch.int32)
    real = (torch.arange(30)[None, :] >= pad[:, None]).float()
    x, bm, cm = (t * real[:, :, None, None] for t in (x, bm, cm))
    dt = dt * real[:, :, None]
    before = ssd_chunked_bshp.launches
    y, hl = ssd(x, dt, a, bm, cm, chunk=16, start=pad)
    yc, hc = ssd(x, dt, a, bm, cm, chunk=16, impl="chunked")
    assert ssd_chunked_bshp.launches == before
    assert torch.equal(y, yc) and torch.equal(hl, hc)
    assert (y[1, :11] == 0).all()
    ys, hs = ssd(x[1:, 11:], dt[1:, 11:], a, bm[1:, 11:], cm[1:, 11:],
                 chunk=16, impl="scan")
    np.testing.assert_allclose(y[1:, 11:].numpy(), ys.numpy(), **TOL)
    np.testing.assert_allclose(hl[1:].numpy(), hs.numpy(), **TOL)
    with pytest.raises(ValueError, match="impl"):
        ssd(x, dt, a, bm, cm, chunk=16, impl="pallas")


def _scan_f64(x, dt, a, bm, cm):
    """The sequential recurrence in float64, G = 1."""
    x, dt, a, bm, cm = (t.double() for t in (x, dt, a, bm, cm))
    decay = torch.exp(dt * a)
    hs = torch.zeros((x.shape[0], x.shape[2], x.shape[3], bm.shape[-1]),
                     dtype=torch.float64)
    ys = []
    for t in range(x.shape[1]):
        hs = (decay[:, t, :, None, None] * hs
              + (dt[:, t, :, None] * x[:, t])[..., None]
              * bm[:, t, 0][:, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", hs, cm[:, t, 0]))
    return torch.stack(ys, dim=1), hs


@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_chunked_holds_an_f64_scan_at_zamba2_decay_rates(seed):
    """At zamba2-2.7b's decay rates (A down to -8, dt a softplus of about
    1) the running sum of dt·A reaches several hundred within a 128-step
    chunk.  The chunked form sums each decay segment directly, so it stays
    within 1e-6 of the largest |y| of a float64 scan, as the f32 scan does;
    differencing the running sum (la[t] - la[s]) misses that by more than
    2x at these inputs."""
    rng = np.random.default_rng(seed)
    b, s, h, p, n = 1, 256, 8, 16, 16
    x = torch.from_numpy(rng.normal(size=(b, s, h, p)).astype(np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.normal(0, 0.88, size=(b, s, h)).astype(np.float32)))
    a = -torch.linspace(0.5, 8.0, h)
    bm, cm = (torch.from_numpy(rng.normal(size=(b, s, 1, n)).astype(
        np.float32)) for _ in range(2))
    y64, h64 = _scan_f64(x, dt, a, bm, cm)
    for impl in ("chunked", "scan"):
        y, hl = ssd(x, dt, a, bm, cm, chunk=128, impl=impl)
        assert float((y.double() - y64).abs().max()) <= 1e-6 * float(
            y64.abs().max()), impl
        assert float((hl.double() - h64).abs().max()) <= 1e-6 * float(
            h64.abs().max()), impl
