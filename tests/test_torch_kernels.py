"""The port's attention (``repro_torch.kernels``) against the JAX package's,
and the CUDA kernels against their plain versions on the card.

On the CPU the port's ops run their plain PyTorch versions; they are held
against the JAX Pallas kernels in interpret mode and against the JAX
oracles, on the same inputs made from a numpy seed, with the tolerances of
``tests/test_kernels.py`` (2e-5 in f32, 2e-2 in bf16).  The tests marked
``cuda`` hold the CUDA kernels against the plain versions, and the paged
decode kernel bitwise against the contiguous one on the same logical keys;
they skip without a card.  Among them, the SSD scan kernel is held against
the plain chunked version (2e-4 in f32, the JAX package's SSD tolerance;
2e-2 in bf16) and bitwise against itself under left pad with ``start``, and
the WKV kernel against the plain chunked version and the plain scan at
5e-4 in f32 (the JAX package's WKV tolerance) and 2e-2 in bf16, and
bitwise against itself under left pad with ``start``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_paged,
                                                  decode_attention_paged_ref,
                                                  decode_attention_ref,
                                                  flash_decode_bshd,
                                                  flash_decode_paged_bshd,
                                                  pool_from_contiguous)
from repro_torch.kernels.flash_attention import (attention, attention_ref,
                                                 attention_xla,
                                                 flash_attention_bshd)
from repro_torch.kernels.mamba2_ssd import ssd, ssd_chunked_bshp
from repro_torch.kernels.rwkv6_wkv import wkv6, wkv6_chunked_bshk

torch.set_num_threads(1)

RNG = np.random.default_rng(42)
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


@pytest.fixture
def jx():
    """(jax.numpy, JAX attention ops); the tests compare with JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import decode_attention as jdec
    from repro.kernels import flash_attention as jfa
    return jnp, jfa, jdec


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _both(jnp, shape, dtype="float32"):
    """The same normal draw as a JAX array and as a CPU tensor of
    ``dtype`` (a name)."""
    a = RNG.normal(size=shape).astype(np.float32)
    j = jnp.asarray(a, getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(j, np.float32)).to(TORCH_DT[dtype])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


# ------------------------------------------------------- flash attention --

SWEEP = [
    (1, 64, 64, 4, 4, 32, True, 0),       # MHA causal
    (2, 80, 80, 6, 2, 64, True, 0),       # GQA, non-multiple seq
    (2, 48, 48, 4, 1, 128, True, 0),      # MQA, big head
    (1, 64, 64, 4, 2, 32, False, 0),      # bidirectional
    (2, 96, 96, 4, 2, 32, True, 24),      # sliding window
    (1, 33, 33, 2, 2, 16, True, 0),       # odd seq
    (2, 40, 40, 3, 1, 20, True, 0),       # smollm-smoke head_dim 20
    (1, 70, 70, 15, 5, 64, True, 0),      # smollm-360m heads
    (1, 70, 70, 32, 32, 80, True, 0),     # zamba2-2.7b shared attention
    (2, 40, 40, 4, 4, 16, True, 0),       # zamba2-smoke shared attention
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window", SWEEP)
def test_attention_matches_jax_pallas(jx, b, sq, skv, hq, hkv, d, causal,
                                      window, dtype):
    jnp, jfa, _ = jx
    (qj, q), (kj, k), (vj, v) = (_both(jnp, (b, s, h, d), dtype)
                                 for s, h in ((sq, hq), (skv, hkv),
                                              (skv, hkv)))
    pal = jfa.attention(qj, kj, vj, causal=causal, window=window,
                        impl="pallas_interpret", block_q=32, block_k=32)
    for out in (attention(q, k, v, causal=causal, window=window),
                attention_ref(q, k, v, causal=causal, window=window),
                attention_xla(q, k, v, causal=causal, window=window,
                              block_q=32)):
        assert out.dtype == TORCH_DT[dtype]
        np.testing.assert_allclose(_np(out), _np(pal), **_tol(dtype))


def test_attention_q_offset_matches_jax(jx):
    """Chunked prefill: a q block continuing an existing kv timeline."""
    jnp, jfa, _ = jx
    (qj, q), (kj, k), (vj, v) = (_both(jnp, sh) for sh in (
        (1, 16, 2, 32), (1, 48, 2, 32), (1, 48, 2, 32)))
    pal = jfa.attention(qj, kj, vj, causal=True, q_offset=32,
                        impl="pallas_interpret", block_q=16, block_k=16)
    for impl in ("auto", "ref", "xla"):
        out = attention(q, k, v, causal=True, q_offset=32, impl=impl)
        np.testing.assert_allclose(_np(out), _np(pal), rtol=2e-5, atol=2e-5,
                                   err_msg=impl)


def test_attention_kv_start_left_pad_matches_jax(jx):
    jnp, jfa, _ = jx
    b, s, hq, hkv, d = 3, 64, 4, 2, 32
    (qj, q), (kj, k), (vj, v) = (_both(jnp, (b, s, h, d))
                                 for h in (hq, hkv, hkv))
    starts = np.asarray([0, 17, 40], np.int32)
    pal = jfa.attention(qj, kj, vj, causal=True,
                        kv_start=jnp.asarray(starts),
                        impl="pallas_interpret", block_q=32, block_k=32)
    ks = torch.from_numpy(starts)
    for impl in ("auto", "ref", "xla"):
        out = attention(q, k, v, causal=True, kv_start=ks, impl=impl)
        np.testing.assert_allclose(_np(out), _np(pal), rtol=2e-5, atol=2e-5,
                                   err_msg=impl)
    # row 2: the masked suffix equals attention over the suffix alone
    solo = attention_ref(q[2:, 40:], k[2:, 40:], v[2:, 40:], causal=True)
    out = attention_ref(q, k, v, causal=True, kv_start=ks)
    np.testing.assert_allclose(_np(out[2, 40:]), _np(solo[0]), rtol=2e-5,
                               atol=2e-5)


def test_attention_kv_len_matches_jax_ref(jx):
    """kv_len (chunked prefill) takes the plain path on the CPU."""
    jnp, jfa, _ = jx
    (qj, q), (kj, k), (vj, v) = (_both(jnp, sh) for sh in (
        (2, 8, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16)))
    lens = np.asarray([20, 32], np.int32)
    ref = jfa.attention_ref(qj, kj, vj, causal=True, q_offset=12,
                            kv_len=jnp.asarray(lens))
    for impl in ("auto", "ref", "xla"):
        out = attention(q, k, v, causal=True, q_offset=12,
                        kv_len=torch.from_numpy(lens), impl=impl)
        np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5, atol=2e-5,
                                   err_msg=impl)


@pytest.mark.parametrize("impl", ["auto", "ref", "xla"])
def test_attention_fully_masked_rows_output_zero(impl):
    """kv_start == Skv (a filler row): zeros, never NaN."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 32, 2, 16), generator=g) for _ in range(3))
    out = attention(q, k, v, kv_start=torch.tensor([32, 5],
                                                   dtype=torch.int32),
                    impl=impl)
    assert torch.isfinite(out).all()
    assert (out[0] == 0).all()
    # the pad queries of row 1 (positions < 5) see no key either
    assert (out[1, :5] == 0).all() and (out[1, 5:].abs().sum() > 0)


def test_attention_cpu_dispatch_uses_plain_version():
    """A CPU tensor takes the plain version and launches nothing."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((1, 24, 3, 20), generator=g) for _ in range(3))
    before = flash_attention_bshd.launches
    out = attention(q, k, v, impl="auto")
    assert torch.equal(out, attention_xla(q, k, v))
    assert torch.equal(attention(q, k, v, impl="cuda"), out)
    assert flash_attention_bshd.launches == before
    with pytest.raises(ValueError, match="impl"):
        attention(q, k, v, impl="pallas")


# ------------------------------------------------------ decode attention --

DEC_SWEEP = [
    (2, 300, 4, 2, 64, 0),
    (1, 128, 8, 1, 32, 0),        # MQA
    (3, 257, 6, 6, 32, 0),        # MHA odd cache
    (2, 300, 4, 2, 64, 64),       # windowed
    (2, 100, 3, 1, 20, 0),        # smollm-smoke head_dim 20
    (2, 160, 15, 5, 64, 0),       # smollm-360m heads
    (2, 300, 32, 32, 80, 0),      # zamba2-2.7b shared attention (G 1)
    (2, 100, 4, 4, 16, 0),        # zamba2-smoke shared attention
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,skv,hq,hkv,d,window", DEC_SWEEP)
def test_decode_attention_matches_jax_pallas(jx, b, skv, hq, hkv, d, window,
                                             dtype):
    jnp, _, jdec = jx
    qj, q = _both(jnp, (b, hq, d), dtype)
    kj, k = _both(jnp, (b, skv, hkv, d), dtype)
    vj, v = _both(jnp, (b, skv, hkv, d), dtype)
    lens = RNG.integers(window + 1 if window else 1, skv + 1,
                        size=(b,)).astype(np.int32)
    pal = jdec.decode_attention(qj, kj, vj, jnp.asarray(lens), window=window,
                                impl="pallas_interpret", block_k=128)
    kl = torch.from_numpy(lens)
    for out in (decode_attention(q, k, v, kl, window=window),
                decode_attention_ref(q, k, v, kl, window=window)):
        assert out.dtype == TORCH_DT[dtype]
        np.testing.assert_allclose(_np(out), _np(pal), **_tol(dtype))


def test_decode_attention_kv_start_matches_jax_and_unpadded(jx):
    jnp, _, jdec = jx
    b, skv, hq, hkv, d = 2, 64, 4, 2, 32
    qj, q = _both(jnp, (b, hq, d))
    kj, k = _both(jnp, (b, skv, hkv, d))
    vj, v = _both(jnp, (b, skv, hkv, d))
    starts, lens = (np.asarray(a, np.int32) for a in ([0, 24], [50, 64]))
    pal = jdec.decode_attention(qj, kj, vj, jnp.asarray(lens),
                                kv_start=jnp.asarray(starts),
                                impl="pallas_interpret", block_k=128)
    out = decode_attention(q, k, v, torch.from_numpy(lens),
                           kv_start=torch.from_numpy(starts))
    np.testing.assert_allclose(_np(out), _np(pal), rtol=2e-5, atol=2e-5)
    solo = decode_attention_ref(q[1:], k[1:, 24:], v[1:, 24:],
                                torch.tensor([40], dtype=torch.int32))
    np.testing.assert_allclose(_np(out[1]), _np(solo[0]), rtol=2e-5,
                               atol=2e-5)


def test_decode_matches_full_attention_last_row():
    """decode(q_last | cache) == full causal attention's last row."""
    g = torch.Generator().manual_seed(2)
    b, s, hq, hkv, d = 2, 40, 4, 2, 32
    q = torch.randn((b, s, hq, d), generator=g)
    k, v = (torch.randn((b, s, hkv, d), generator=g) for _ in range(2))
    full = attention_ref(q, k, v, causal=True)
    dec = decode_attention(q[:, -1], k, v, torch.full((b,), s,
                                                      dtype=torch.int32))
    np.testing.assert_allclose(_np(dec), _np(full[:, -1]), rtol=1e-5,
                               atol=1e-5)


def test_decode_filler_rows_output_zero_and_dispatch_is_plain():
    g = torch.Generator().manual_seed(3)
    q = torch.randn((3, 6, 20), generator=g)
    k, v = (torch.randn((3, 50, 2, 20), generator=g) for _ in range(2))
    lens = torch.tensor([50, 50, 7], dtype=torch.int32)
    starts = torch.tensor([0, 50, 7], dtype=torch.int32)   # rows 1, 2 empty
    before = flash_decode_bshd.launches
    out = decode_attention(q, k, v, lens, kv_start=starts)
    assert flash_decode_bshd.launches == before
    assert torch.equal(out, decode_attention_ref(q, k, v, lens,
                                                 kv_start=starts))
    assert torch.isfinite(out).all() and (out[1:] == 0).all()
    with pytest.raises(ValueError, match="impl"):
        decode_attention(q, k, v, lens, impl="pallas")


# ------------------------------------------------- CUDA kernels (card) --

@pytest.mark.cuda
def test_cuda_attention_with_kv_len_raises(cuda):
    """A kv_len of the wrong type, device or shape raises."""
    q = torch.zeros((1, 4, 2, 16), device=cuda)
    for bad in (torch.tensor([4], dtype=torch.int64, device=cuda),
                torch.tensor([4], dtype=torch.int32),
                torch.tensor([4, 4], dtype=torch.int32, device=cuda)):
        with pytest.raises(ValueError, match="kv_len"):
            attention(q, q, q, kv_len=bad)


@pytest.mark.cuda
def test_cuda_attention_with_kv_len_launches_the_kernel(cuda):
    """A good kv_len on a CUDA tensor runs kernel 1, with no fallback."""
    q = torch.zeros((1, 4, 2, 16), device=cuda)
    before = flash_attention_bshd.launches
    out = attention(q, q, q, kv_len=torch.tensor([4], dtype=torch.int32,
                                                 device=cuda))
    assert flash_attention_bshd.launches == before + 1
    assert torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window", SWEEP)
def test_cuda_flash_kernel_matches_plain(cuda, b, sq, skv, hq, hkv, d,
                                         causal, window, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    dt = TORCH_DT[dtype]
    q = torch.randn((b, sq, hq, d), generator=g, device=cuda).to(dt)
    k, v = (torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(dt)
            for _ in range(2))
    starts = torch.arange(b, dtype=torch.int32, device=cuda) * 5
    before = flash_attention_bshd.launches
    out = attention(q, k, v, causal=causal, window=window, kv_start=starts)
    assert flash_attention_bshd.launches == before + 1
    ref = attention_ref(q, k, v, causal=causal, window=window,
                        kv_start=starts)
    np.testing.assert_allclose(_np(out.cpu()), _np(ref.cpu()),
                               **_tol(dtype))


# The decode kernels cut a row's valid keys into tiles of 64 at fixed
# logical positions and give each (row, KV head) a cluster of blocks
# (``cluster_of`` in ``decode_attention.cu``: 8, or 2 at G 1), which take
# the tiles in turn: valid lengths at the tile's edges, and 600 and 1,900,
# which span more tiles (10, 30) than the cluster has blocks.
TILE_EDGE_LENS = [0, 1, 63, 64, 65, 1900]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,skv,hq,hkv,d,window,n_valid", [
    *(pytest.param(*c, None, id="-".join(map(str, c))) for c in DEC_SWEEP),
    *(pytest.param(3, 2048, 15, 5, 64, 0, n, id=f"valid{n}")
      for n in TILE_EDGE_LENS),
    pytest.param(3, 2048, 32, 32, 80, 100, 65, id="valid65-g1-d80-window"),
    pytest.param(3, 2048, 8, 1, 128, 0, 1900, id="valid1900-g8-d128"),
])
def test_cuda_decode_kernel_matches_plain(cuda, b, skv, hq, hkv, d, window,
                                          n_valid, dtype):
    """With ``n_valid`` every row holds that many valid keys: from column
    0, after a left pad of 37 with kv_start, and at the end of the cache."""
    g = torch.Generator(device=cuda).manual_seed(5)
    dt = TORCH_DT[dtype]
    q = torch.randn((b, hq, d), generator=g, device=cuda).to(dt)
    k, v = (torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(dt)
            for _ in range(2))
    lens = torch.full((b,), skv, dtype=torch.int32, device=cuda)
    lens[0] = max(1, skv // 3)
    starts = torch.zeros((b,), dtype=torch.int32, device=cuda)
    starts[-1] = skv // 4
    if n_valid is not None:
        lens = torch.tensor([n_valid, 37 + n_valid, skv], dtype=torch.int32,
                            device=cuda)
        starts = torch.tensor([0, 37, skv - n_valid], dtype=torch.int32,
                              device=cuda)
    before = flash_decode_bshd.launches
    out = decode_attention(q, k, v, lens, window=window, kv_start=starts)
    assert flash_decode_bshd.launches == before + 1
    ref = decode_attention_ref(q, k, v, lens, window=window,
                               kv_start=starts)
    np.testing.assert_allclose(_np(out.cpu()), _np(ref.cpu()),
                               **_tol(dtype))
    if n_valid == 0:
        assert (out == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("n_valid", [0, 1, 63, 64, 65, 600])
@pytest.mark.parametrize("hq,hkv,d", [(32, 32, 80), (16, 16, 128),
                                      (15, 5, 64), (3, 1, 20),
                                      (8, 1, 128), (16, 2, 64)])
def test_cuda_decode_row_bits_do_not_depend_on_batch_or_capacity(
        cuda, hq, hkv, d, n_valid, window, dtype):
    """A row's bits are the same alone (B 1, a cache of exactly its keys)
    as inside a B 8 call at capacity 1,024, where it sits after a left pad
    with kv_start among rows of other lengths; and the paged kernel gives
    them on a pool of the B 8 cache (block size 16).  G 1, 3 and 8; D 20,
    64, 80 and 128."""
    g = torch.Generator(device=cuda).manual_seed(9)
    dt = TORCH_DT[dtype]
    b, cap, row = 8, 1024, 5
    q = torch.randn((b, hq, d), generator=g, device=cuda).to(dt)
    k, v = (torch.randn((b, cap, hkv, d), generator=g, device=cuda).to(dt)
            for _ in range(2))
    lens = torch.randint(1, cap + 1, (b,), generator=g, device=cuda)
    starts = (torch.rand((b,), generator=g, device=cuda)
              * lens).to(torch.int32)
    pad = cap - n_valid - 11
    lens[row], starts[row] = pad + n_valid, pad
    lens = lens.to(torch.int32)
    wave = decode_attention(q, k, v, lens, window=window, kv_start=starts)
    solo_cap = max(n_valid, 1)
    alone = decode_attention(
        q[row:row + 1], k[row:row + 1, pad:pad + solo_cap].contiguous(),
        v[row:row + 1, pad:pad + solo_cap].contiguous(),
        torch.tensor([n_valid], dtype=torch.int32, device=cuda),
        window=window)
    assert torch.equal(alone[0], wave[row])
    pool_k, pool_v, table = pool_from_contiguous(k, v, 16, lens=lens,
                                                 generator=g)
    paged = decode_attention_paged(q, pool_k, pool_v, table, lens,
                                   window=window, kv_start=starts)
    assert torch.equal(paged, wave)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,q_offset,lens", [
    (64, 256, 100, [164, 130]),
    (100, 512, 0, [100, 37]),
    (16, 1024, 1000, [1016, 1010]),
])
def test_cuda_flash_kernel_kv_len_matches_plain(cuda, dtype, sq, skv,
                                                q_offset, lens):
    """A prefill chunk at q_offset against a wider view masked at kv_len."""
    g = torch.Generator(device=cuda).manual_seed(6)
    dt = TORCH_DT[dtype]
    q = torch.randn((2, sq, 15, 64), generator=g, device=cuda).to(dt)
    k, v = (torch.randn((2, skv, 5, 64), generator=g, device=cuda).to(dt)
            for _ in range(2))
    kl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = flash_attention_bshd.launches
    out = attention(q, k, v, causal=True, q_offset=q_offset, kv_len=kl)
    assert flash_attention_bshd.launches == before + 1
    ref = attention_ref(q, k, v, causal=True, q_offset=q_offset, kv_len=kl)
    np.testing.assert_allclose(_np(out.cpu()), _np(ref.cpu()),
                               **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [1, 4, 16, 48, 64])
@pytest.mark.parametrize("hq,hkv,d,window,lens", [
    *(pytest.param(*c, [192, 0, 77, 1], id="-".join(map(str, c)))
      for c in ((15, 5, 64, 0), (3, 1, 20, 0), (8, 2, 64, 40))),
    pytest.param(15, 5, 64, 0, [63, 64, 65, 1900], id="15-5-64-0-edges"),
    pytest.param(8, 1, 128, 100, [1900, 1, 0, 65], id="8-1-128-100-edges"),
])
def test_cuda_paged_decode_kernel_matches_plain(cuda, dtype, bs, hq, hkv, d,
                                                window, lens):
    """Ragged kv_len (one row 0), a scrambled table with a trash tail; and
    lengths at the kernel's tile edges over a 2,048-key view."""
    g = torch.Generator(device=cuda).manual_seed(7)
    dt = TORCH_DT[dtype]
    b, skv = 4, max(192, *lens)
    q = torch.randn((b, hq, d), generator=g, device=cuda).to(dt)
    k, v = (torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(dt)
            for _ in range(2))
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    pool_k, pool_v, table = pool_from_contiguous(k, v, bs, lens=lens,
                                                 generator=g)
    before = flash_decode_paged_bshd.launches
    out = decode_attention_paged(q, pool_k, pool_v, table, lens,
                                 window=window)
    assert flash_decode_paged_bshd.launches == before + 1
    ref = decode_attention_paged_ref(q, pool_k, pool_v, table, lens,
                                     window=window)
    np.testing.assert_allclose(_np(out.cpu()), _np(ref.cpu()),
                               **_tol(dtype))
    assert (out[lens == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [1, 16, 48])
@pytest.mark.parametrize("left_pad,lens", [
    *(pytest.param(p, [320, 250, 33], id=str(p)) for p in (0, 5, 100)),
    pytest.param(0, [0, 1, 63], id="0-edges-0-1-63"),
    pytest.param(37, [64, 65, 600], id="37-edges-64-65-600"),
])
def test_cuda_paged_decode_bitwise_equals_contiguous_kernel(cuda, dtype, bs,
                                                            left_pad, lens):
    """The serving contract: on the same logical keys the paged kernel gives
    the contiguous kernel's bits — on the gathered view (left_pad 0), and on
    the keys placed after a left pad with kv_start (how a solo wave holds
    them); also at lengths on the kernel's tile edges and over more tiles
    than its cluster has blocks."""
    g = torch.Generator(device=cuda).manual_seed(8)
    dt = TORCH_DT[dtype]
    b, skv, hq, hkv, d = 3, max(320, *lens), 15, 5, 64
    q = torch.randn((b, hq, d), generator=g, device=cuda).to(dt)
    k, v = (torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(dt)
            for _ in range(2))
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    pool_k, pool_v, table = pool_from_contiguous(k, v, bs, lens=lens,
                                                 generator=g)
    for window in (0, 70):
        paged = decode_attention_paged(q, pool_k, pool_v, table, lens,
                                       window=window)
        padded_k = torch.cat([k.new_zeros((b, left_pad, hkv, d)), k], 1)
        padded_v = torch.cat([v.new_zeros((b, left_pad, hkv, d)), v], 1)
        start = torch.full((b,), left_pad, dtype=torch.int32, device=cuda)
        contig = decode_attention(q, padded_k, padded_v, lens + left_pad,
                                  window=window,
                                  kv_start=start if left_pad else None)
        assert torch.equal(paged, contig), (window, left_pad)


@pytest.mark.cuda
def test_cuda_paged_decode_wrapper_rejects(cuda):
    q = torch.zeros((2, 6, 32), device=cuda)
    pool = torch.zeros((5, 4, 2, 32), device=cuda)
    lens = torch.tensor([3, 0], dtype=torch.int32, device=cuda)
    table = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    for bad in (table.long(), table.cpu(), table.t(), table[:1]):
        with pytest.raises(ValueError, match="table"):
            flash_decode_paged_bshd(q, pool, pool, bad, lens)
    with pytest.raises(TypeError, match="float64"):
        flash_decode_paged_bshd(q, pool.double(), pool, table, lens)
    with pytest.raises(ValueError, match="kv_len"):
        flash_decode_paged_bshd(q, pool, pool, table, lens.long())
    with pytest.raises(ValueError, match="group"):
        flash_decode_paged_bshd(torch.zeros((2, 18, 32), device=cuda),
                                pool, pool, table, lens)


# ------------------------------------------------- SSD scan kernel (card) --

SSD_SWEEP = [
    (2, 96, 4, 8, 2, 16, 32),       # tests/test_kernels.py's SSD sweep
    (1, 64, 2, 16, 1, 8, 16),
    (2, 100, 4, 8, 1, 16, 32),      # S not a multiple of the chunk
    (2, 200, 8, 64, 1, 64, 128),    # zamba2-2.7b heads, ragged S
    (2, 1, 8, 64, 1, 64, 128),      # S below the chunk
    (2, 64, 8, 64, 1, 64, 128),
    (3, 40, 16, 8, 1, 16, 16),      # zamba2-smoke
    (2, 100, 4, 32, 2, 32, 32),     # G 2 over 4 heads
]


def _ssd_inputs(g, dev, dtype, b, s, h, p, grp, n, pad=None):
    """Normal x, B, C and dt in [0.01, 0.2] as in tests/test_kernels.py;
    with ``pad`` (B,) the steps before it are zeroed, as the Mamba2 block
    zeroes left pad."""
    x = torch.randn((b, s, h, p), generator=g, device=dev).to(dtype)
    dt = (torch.rand((b, s, h), generator=g, device=dev) * 0.19
          + 0.01).to(dtype)
    a = -(torch.rand((h,), generator=g, device=dev) * 1.5 + 0.5)
    bm, cm = (torch.randn((b, s, grp, n), generator=g, device=dev).to(dtype)
              for _ in range(2))
    if pad is not None:
        real = torch.arange(s, device=dev)[None, :] >= pad[:, None]
        x, dt, bm, cm = (t * real.view(b, s, *(1,) * (t.dim() - 2)).to(dtype)
                         for t in (x, dt, bm, cm))
    return x, dt, a, bm, cm


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,grp,n,chunk", SSD_SWEEP)
def test_cuda_ssd_kernel_matches_plain(cuda, b, s, h, p, grp, n, chunk,
                                       dtype, with_h0):
    g = torch.Generator(device=cuda).manual_seed(9)
    dt_ = TORCH_DT[dtype]
    x, dt, a, bm, cm = _ssd_inputs(g, cuda, dt_, b, s, h, p, grp, n)
    h0 = (torch.randn((b, h, p, n), generator=g, device=cuda)
          if with_h0 else None)
    before = ssd_chunked_bshp.launches
    y, hl = ssd(x, dt, a, bm, cm, h0, chunk=chunk)
    assert ssd_chunked_bshp.launches == before + 1
    assert y.dtype == dt_ and hl.dtype == torch.float32
    yp, hp = ssd(x, dt, a, bm, cm, h0, chunk=chunk, impl="chunked")
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
           else dict(rtol=2e-4, atol=2e-4))
    np.testing.assert_allclose(_np(y.cpu()), _np(yp.cpu()), **tol)
    np.testing.assert_allclose(_np(hl.cpu()), _np(hp.cpu()), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_kernel_with_start_matches_plain(cuda, dtype):
    """Ragged left pad with start (one row all pad): the kernel skips the
    pad steps, the plain version runs over them; y is 0 there."""
    g = torch.Generator(device=cuda).manual_seed(10)
    pad = torch.tensor([0, 77, 300, 5], dtype=torch.int32, device=cuda)
    x, dt, a, bm, cm = _ssd_inputs(g, cuda, TORCH_DT[dtype], 4, 300, 8, 64,
                                   1, 64, pad=pad)
    y, hl = ssd(x, dt, a, bm, cm, chunk=128, start=pad)
    yp, hp = ssd(x, dt, a, bm, cm, chunk=128, impl="chunked")
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
           else dict(rtol=2e-4, atol=2e-4))
    np.testing.assert_allclose(_np(y.cpu()), _np(yp.cpu()), **tol)
    np.testing.assert_allclose(_np(hl.cpu()), _np(hp.cpu()), **tol)
    assert (y[1, :77] == 0).all() and (y[2] == 0).all()
    assert (hl[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [16, 128])
def test_cuda_ssd_kernel_bitwise_under_left_pad(cuda, dtype, chunk):
    """One row after left pads of 0, 5, 31 and 200 steps, with start: its y
    at the real steps and its final state are the same bits."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x, dt, a, bm, cm = _ssd_inputs(g, cuda, TORCH_DT[dtype], 1, 97, 8, 64,
                                   1, 64)
    outs = []
    for pad in (0, 5, 31, 200):
        padded = [torch.cat([t.new_zeros((1, pad, *t.shape[2:])), t], 1)
                  for t in (x, dt, bm, cm)]
        start = torch.tensor([pad], dtype=torch.int32, device=cuda)
        y, hl = ssd(*padded[:2], a, *padded[2:], chunk=chunk, start=start)
        assert (y[:, :pad] == 0).all()
        outs.append((y[:, pad:], hl))
    for y, hl in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(hl, outs[0][1])


@pytest.mark.cuda
def test_cuda_ssd_kernel_rejects(cuda):
    """A CPU operand beside a CUDA x, a wrong dtype, shape or size raises;
    nothing falls back to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(12)
    x, dt, a, bm, cm = _ssd_inputs(g, cuda, torch.float32, 2, 20, 4, 8, 2,
                                   16)
    before = ssd_chunked_bshp.launches
    with pytest.raises(ValueError, match="dt"):
        ssd(x, dt.cpu(), a, bm, cm, chunk=16)
    with pytest.raises(TypeError, match="Bm"):
        ssd(x, dt, a, bm.bfloat16(), cm, chunk=16)
    with pytest.raises(TypeError, match="float64"):
        ssd(x.double(), dt, a, bm, cm, chunk=16)
    with pytest.raises(ValueError, match="A must"):
        ssd(x, dt, a.bfloat16(), bm, cm, chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        ssd(x, dt, a, bm, cm, chunk=256)
    with pytest.raises(ValueError, match="does not fit"):
        ssd(x, dt, a, bm[:, :, :1].expand(2, 20, 3, 16).contiguous(),
            cm[:, :, :1].expand(2, 20, 3, 16).contiguous(), chunk=16)
    with pytest.raises(ValueError, match="start"):
        ssd(x, dt, a, bm, cm, chunk=16,
            start=torch.zeros((2,), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="h0"):
        ssd(x, dt, a, bm, cm, torch.zeros((2, 4, 8, 16), device=cuda,
                                          dtype=torch.bfloat16), chunk=16)
    big = torch.zeros((1, 4, 1, 80), device=cuda)
    with pytest.raises(ValueError, match="P 80"):
        ssd(big, torch.zeros((1, 4, 1), device=cuda), a[:1],
            torch.zeros((1, 4, 1, 16), device=cuda),
            torch.zeros((1, 4, 1, 16), device=cuda), chunk=16)
    assert ssd_chunked_bshp.launches == before


@pytest.mark.cuda
def test_cuda_ssd_kernel_holds_an_f64_scan_at_zamba2_decay_rates(cuda):
    """A down to -8 and dt a softplus of about 1, as in zamba2-2.7b: the
    kernel sums each decay segment directly and stays within 1e-6 of the
    largest |y| of a float64 scan (differencing the running sum of dt·A
    loses about 1e-4 of the decay weights there)."""
    g = torch.Generator(device=cuda).manual_seed(13)
    b, s, h, p, n = 2, 300, 8, 64, 64
    x = torch.randn((b, s, h, p), generator=g, device=cuda)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=g, device=cuda) * 0.88)
    a = -torch.linspace(0.5, 8.0, h, device=cuda)
    bm, cm = (torch.randn((b, s, 1, n), generator=g, device=cuda)
              for _ in range(2))
    y, hl = ssd(x, dt, a, bm, cm, chunk=128)
    xd, dtd, ad, bd, cd = (t.double() for t in (x, dt, a, bm, cm))
    decay = torch.exp(dtd * ad)
    hs = torch.zeros((b, h, p, n), dtype=torch.float64, device=cuda)
    ys = []
    for t in range(s):
        hs = (decay[:, t, :, None, None] * hs
              + (dtd[:, t, :, None] * xd[:, t])[..., None]
              * bd[:, t, 0][:, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", hs, cd[:, t, 0]))
    y64 = torch.stack(ys, dim=1)
    assert float((y.double() - y64).abs().max()) <= 1e-6 * float(
        y64.abs().max())
    assert float((hl.double() - hs).abs().max()) <= 1e-6 * float(
        hs.abs().max())


# ------------------------------------------------------ WKV kernel (card) --

WKV_SWEEP = [
    (2, 96, 4, 8, 32),              # tests/test_kernels.py's WKV sweep
    (1, 64, 2, 16, 16),
    (2, 70, 4, 8, 32),              # S not a multiple of the chunk
    (8, 512, 32, 64, 64),           # rwkv6-1.6b serving shape
    (2, 200, 8, 64, 64),            # rwkv6-1.6b heads, ragged S
    (2, 1, 8, 64, 64),              # S below the chunk
    (3, 40, 4, 8, 16),              # rwkv6-smoke
    (2, 50, 4, 24, 15),             # K no power of two, an odd chunk
]


def _wkv_inputs(g, dev, dtype, b, s, h, k, pad=None):
    """Normal r, k, v (in ``dtype``) and u; logw = -exp(-0.5 + 0.6 N) in
    f32, as rwkv6-1.6b's decays; with ``pad`` (B,) r, k, v are zeroed
    before it, as the model's left pad zeroes them (logw stays)."""
    r, kk, v = (torch.randn((b, s, h, k), generator=g, device=dev).to(dtype)
                for _ in range(3))
    lw = -torch.exp(-0.5 + 0.6 * torch.randn((b, s, h, k), generator=g,
                                             device=dev))
    u = 0.5 * torch.randn((h, k), generator=g, device=dev)
    if pad is not None:
        real = (torch.arange(s, device=dev)[None, :] >= pad[:, None])
        real = real[:, :, None, None].to(dtype)
        r, kk, v = r * real, kk * real, v * real
    return r, kk, v, lw, u


def _wkv_tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=5e-4, atol=5e-4))


@pytest.mark.cuda
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,k,chunk", WKV_SWEEP)
def test_cuda_wkv_kernel_matches_plain(cuda, b, s, h, k, chunk, dtype,
                                       with_s0):
    g = torch.Generator(device=cuda).manual_seed(14)
    dt_ = TORCH_DT[dtype]
    r, kk, v, lw, u = _wkv_inputs(g, cuda, dt_, b, s, h, k)
    s0 = (torch.randn((b, h, k, k), generator=g, device=cuda)
          if with_s0 else None)
    before = wkv6_chunked_bshk.launches
    y, sl = wkv6(r, kk, v, lw, u, s0, chunk=chunk)
    assert wkv6_chunked_bshk.launches == before + 1
    assert y.dtype == dt_ and sl.dtype == torch.float32
    for impl in ("chunked", "scan"):
        yp, sp = wkv6(r, kk, v, lw, u, s0, chunk=chunk, impl=impl)
        np.testing.assert_allclose(_np(y.cpu()), _np(yp.cpu()), err_msg=impl,
                                   **_wkv_tol(dtype))
        np.testing.assert_allclose(_np(sl.cpu()), _np(sp.cpu()),
                                   err_msg=impl, **_wkv_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_wkv_kernel_with_start_matches_plain(cuda, dtype):
    """Ragged left pad with start (one row all pad): the kernel skips the
    pad steps; the plain chunked form, which walks over them, agrees at
    the tolerance; y is 0 there."""
    g = torch.Generator(device=cuda).manual_seed(15)
    pad = torch.tensor([0, 77, 300, 5], dtype=torch.int32, device=cuda)
    r, kk, v, lw, u = _wkv_inputs(g, cuda, TORCH_DT[dtype], 4, 300, 8, 64,
                                  pad=pad)
    y, sl = wkv6(r, kk, v, lw, u, chunk=64, start=pad)
    yp, sp = wkv6(r, kk, v, lw, u, chunk=64, impl="chunked")
    np.testing.assert_allclose(_np(y.cpu()), _np(yp.cpu()), **_wkv_tol(dtype))
    np.testing.assert_allclose(_np(sl.cpu()), _np(sp.cpu()),
                               **_wkv_tol(dtype))
    assert (y[1, :77] == 0).all() and (y[2] == 0).all()
    assert (sl[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [16, 64])
def test_cuda_wkv_kernel_bitwise_under_left_pad(cuda, dtype, chunk):
    """One row after left pads of 0, 5, 31 and 415 steps (r = k = v = 0,
    logw -exp(-0.5) there, as the model leaves them), with start: its y at
    the real steps and its final state are the same bits."""
    g = torch.Generator(device=cuda).manual_seed(16)
    r, kk, v, lw, u = _wkv_inputs(g, cuda, TORCH_DT[dtype], 1, 97, 8, 64)
    outs = []
    for pad in (0, 5, 31, 415):
        padded = [torch.cat([t.new_zeros((1, pad, 8, 64)), t], 1)
                  for t in (r, kk, v)]
        lwp = torch.cat([lw.new_full((1, pad, 8, 64), -np.exp(-0.5)), lw], 1)
        start = torch.tensor([pad], dtype=torch.int32, device=cuda)
        y, sl = wkv6(*padded, lwp, u, chunk=chunk, start=start)
        assert (y[:, :pad] == 0).all()
        outs.append((y[:, pad:], sl))
    for y, sl in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(sl, outs[0][1])


@pytest.mark.cuda
def test_cuda_wkv_kernel_rejects(cuda):
    """A CPU operand beside a CUDA r, a wrong dtype, shape or size raises;
    nothing falls back to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(17)
    r, kk, v, lw, u = _wkv_inputs(g, cuda, torch.float32, 2, 20, 4, 8)
    before = wkv6_chunked_bshk.launches
    with pytest.raises(ValueError, match="k is on"):
        wkv6(r, kk.cpu(), v, lw, u, chunk=16)
    with pytest.raises(TypeError, match="v is"):
        wkv6(r, kk, v.bfloat16(), lw, u, chunk=16)
    with pytest.raises(TypeError, match="float64"):
        wkv6(r.double(), kk, v, lw, u, chunk=16)
    with pytest.raises(TypeError, match="logw"):
        wkv6(r, kk, v, lw.bfloat16(), u, chunk=16)
    with pytest.raises(ValueError, match="K == V"):
        wkv6(r, kk, v[..., :4], lw, u, chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        wkv6(r, kk, v, lw, u, chunk=128)
    with pytest.raises(ValueError, match="u must"):
        wkv6(r, kk, v, lw, u[:2], chunk=16)
    with pytest.raises(ValueError, match="start"):
        wkv6(r, kk, v, lw, u, chunk=16,
             start=torch.zeros((2,), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="s0"):
        wkv6(r, kk, v, lw, u, torch.zeros((2, 4, 8, 8), device=cuda,
                                          dtype=torch.bfloat16), chunk=16)
    big = torch.zeros((1, 4, 1, 80), device=cuda)
    with pytest.raises(ValueError, match="K 80"):
        wkv6(big, big, big, big, torch.zeros((1, 80), device=cuda), chunk=16)
    assert wkv6_chunked_bshk.launches == before


@pytest.mark.cuda
def test_cuda_wkv_kernel_holds_an_f64_scan_at_rwkv6_decay_rates(cuda):
    """rwkv6-1.6b's decays (logw = -exp(-0.5 + N(0, 1)), the running sum
    near -100 within a chunk): the kernel sums each decay segment directly
    and stays within 1e-6 of the largest |y| and |state| of a float64 scan
    (the JAX package's differencing of the running sum misses that at
    these rates, ``tests/test_torch_wkv.py``)."""
    g = torch.Generator(device=cuda).manual_seed(18)
    b, s, h, k = 2, 256, 4, 64
    r, kk, v = (torch.randn((b, s, h, k), generator=g, device=cuda)
                for _ in range(3))
    lw = -torch.exp(-0.5 + torch.randn((b, s, h, k), generator=g,
                                       device=cuda))
    u = 0.5 * torch.randn((h, k), generator=g, device=cuda)
    y, sl = wkv6(r, kk, v, lw, u, chunk=64)
    rd, kd, vd, ud = (t.double() for t in (r, kk, v, u))
    w = torch.exp(lw.double())
    S = torch.zeros((b, h, k, k), dtype=torch.float64, device=cuda)
    ys = []
    for t in range(s):
        kv = kd[:, t, :, :, None] * vd[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rd[:, t],
                               S + ud[..., :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    y64 = torch.stack(ys, dim=1)
    assert float((y.double() - y64).abs().max()) <= 1e-6 * float(
        y64.abs().max())
    assert float((sl.double() - S).abs().max()) <= 1e-6 * float(
        S.abs().max())
