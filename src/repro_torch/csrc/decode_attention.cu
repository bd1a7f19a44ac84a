// Decode attention for Hopper: one query token per row against a KV cache,
// GQA, bounds [kv_start, kv_len) and an optional window.  Two entry points
// share one body:
//
// * repro_decode_attention — a contiguous cache.  Replaces the TPU kernel
//   `flash_decode_bhgd` (`_dec_kernel`) in
//   src/repro/kernels/decode_attention/kernel.py.
// * repro_decode_attention_paged — a block pool addressed through a per-row
//   int32 block table.  Replaces `flash_decode_paged_bhgd`
//   (`_dec_paged_kernel`) in the same file.  Row b's logical column c lives
//   at pool[table[b, c / BS], c % BS]; dead table entries point at the
//   trash block 0 and are masked by kv_len.
//
// Same function as the TPU kernels: keys outside
// [max(kv_start, kv_len - window), min(kv_len, Skv)) are masked, and a row
// with no valid key outputs 0.
//
// Layout: q (B,Hq,D) and o (B,Hq,D); the cache is (B,Skv,Hkv,D) or the pool
// (NB,BS,Hkv,D), read by stride (the last dim must be contiguous), so the
// TPU path's swapaxes of the pool is not made.  One thread block per (kv
// head, batch row); its 8 warps take 32-key chunks of the valid range in
// turn, starting at the row's first valid key.  Every K/V row loaded serves
// all G query heads of the group, so the valid cache is read once.  A warp
// stages its K chunk in shared memory (coalesced), each lane scores one key
// for all G heads, the warp updates its running (m, l) once per chunk, and
// then the lanes split D to accumulate p.V from coalesced V rows.  The
// warps' partial (m, l, acc) are merged in shared memory at the end.  G (3
// for smollm) is far below any tensor-core tile, so the products are FMAs
// on the CUDA cores.  The ragged tail is masked; nothing is padded or
// copied.
//
// The paged kernel walks the same 32-key chunks in LOGICAL columns, whatever
// the block size (a chunk may span blocks; BS need not divide 32): the body
// below is one template over how a key row is addressed (`Contig` or
// `Paged`), with every float operation written out (explicit fmaf), so the
// two kernels give the same bits on the same logical keys.  That is what
// keeps paged serving equal to solo serving.  A block reads its row's table
// entries itself (there is no scalar prefetch): one cached load per key row,
// the same address for the whole warp.
//
// Bound on the card: bytes.  The valid K/V rows once, plus q, o (and the
// table), over 3.35 TB/s; the flops (4 G D per key) are negligible beside
// them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = (float)(-0.7 * 3.4028234663852886e38);
constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;
constexpr int MAXG = 8;  // query heads per KV head

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_start;  // (B,) or null
  const int* kv_len;    // (B,)
  const int* table;     // (B,T) contiguous, paged kernel only
  int skv, hq, hkv, d, window;
  int bs, tw;           // paged: block size, table width (skv = bs * tw)
  // contiguous: k_sb is the row stride; paged: the pool's block stride
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Key row `c` (a logical column) of one (row, kv head) in a contiguous cache.
template <typename T>
struct Contig {
  const T* base;
  long long ss;
  __device__ __forceinline__ const T* row(int c) const {
    return base + (long long)c * ss;
  }
};

// Key row `c` of one (row, kv head) through the row's block table.
template <typename T>
struct Paged {
  const T* base;      // pool, at this kv head
  const int* table;   // this row's table entries
  int bs;
  long long sb, ss;
  __device__ __forceinline__ const T* row(int c) const {
    const int blk = __ldg(table + c / bs);
    return base + (long long)blk * sb + (long long)(c % bs) * ss;
  }
};

constexpr size_t smem_bytes(int dp) {
  // per-warp K chunk (reused for the merge), q, p, and the warps' (m, l)
  return sizeof(float) * (size_t)(WARPS * 32 * (dp + 1) + MAXG * dp +
                                  WARPS * MAXG * 32 + 2 * WARPS * MAXG);
}

// The shared body: q/o at this (row, kv head), K/V rows by `KV`, keys
// [lo, hi).  Every float operation is written out, so that the contiguous
// and paged instantiations compute the same bits.
template <typename T, int DP, class KV>
__device__ __forceinline__ void dec_body(const Args& a, const T* q, KV k,
                                         KV v, T* o, int lo, int hi) {
  constexpr int LD = DP + 1;
  constexpr int NC = DP / 32;  // d columns per lane
  static_assert(MAXG * DP <= 32 * LD, "merge buffer must fit a warp's chunk");
  extern __shared__ float smem[];
  float* Kall = smem;                    // WARPS x 32 x LD
  float* Qs = Kall + WARPS * 32 * LD;    // MAXG x DP, pre-scaled
  float* Pall = Qs + MAXG * DP;          // WARPS x MAXG x 32
  float* Ms = Pall + WARPS * MAXG * 32;  // WARPS x MAXG
  float* Ls = Ms + WARPS * MAXG;         // WARPS x MAXG

  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31;
  const int g = a.hq / a.hkv;
  float* Ks = Kall + w * 32 * LD;
  float* Ps = Pall + w * MAXG * 32;

  for (int i = tid; i < MAXG * DP; i += NT) {
    const int hh = i / DP, c = i % DP;
    float x = 0.f;
    if (hh < g && c < a.d) x = __fmul_rn(to_f(q[hh * a.q_sh + c]), a.scale);
    Qs[i] = x;
  }
  __syncthreads();

  float m[MAXG], l[MAXG], acc[MAXG][NC];
#pragma unroll
  for (int hh = 0; hh < MAXG; ++hh) {
    m[hh] = NEG_INF;
    l[hh] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[hh][c] = 0.f;
  }

  for (int c0 = lo + 32 * w; c0 < hi; c0 += 32 * WARPS) {
    const int n = min(32, hi - c0);  // valid keys in this chunk
    for (int r = 0; r < 32; ++r) {
      const T* kr = k.row(r < n ? c0 + r : c0);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int dc = lane + 32 * c;
        float x = 0.f;
        if (r < n && dc < a.d) x = to_f(kr[dc]);
        Ks[r * LD + dc] = x;
      }
    }
    __syncwarp();

    float s[MAXG];
#pragma unroll
    for (int hh = 0; hh < MAXG; ++hh) s[hh] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < DP; ++dd) {
      const float kx = Ks[lane * LD + dd];
#pragma unroll
      for (int hh = 0; hh < MAXG; ++hh)
        if (hh < g) s[hh] = fmaf(Qs[hh * DP + dd], kx, s[hh]);
    }

#pragma unroll
    for (int hh = 0; hh < MAXG; ++hh) {
      if (hh >= g) break;
      const float sv = lane < n ? s[hh] : NEG_INF;
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[hh], mx);
      // no valid key so far: p must be 0, not exp(NEG_INF - NEG_INF) = 1
      const float p =
          m_new > 0.5f * NEG_INF ? expf(__fsub_rn(sv, m_new)) : 0.f;
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, off));
      const float alpha = expf(__fsub_rn(m[hh], m_new));
      l[hh] = fmaf(alpha, l[hh], psum);
      m[hh] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[hh][c] = __fmul_rn(acc[hh][c], alpha);
      Ps[hh * 32 + lane] = p;
    }
    __syncwarp();

    for (int r = 0; r < n; ++r) {
      const T* vr = v.row(c0 + r);
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int dc = lane + 32 * c;
        vv[c] = dc < a.d ? to_f(vr[dc]) : 0.f;
      }
#pragma unroll
      for (int hh = 0; hh < MAXG; ++hh) {
        if (hh >= g) break;
        const float p = Ps[hh * 32 + r];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[hh][c] = fmaf(p, vv[c], acc[hh][c]);
      }
    }
    __syncwarp();  // Ks and Ps are rewritten by the next chunk
  }

  // merge the warps' partial softmax states; Ks becomes this warp's acc
  if (lane == 0) {
    for (int hh = 0; hh < g; ++hh) {
      Ms[w * MAXG + hh] = m[hh];
      Ls[w * MAXG + hh] = l[hh];
    }
  }
#pragma unroll
  for (int hh = 0; hh < MAXG; ++hh) {
    if (hh >= g) break;
#pragma unroll
    for (int c = 0; c < NC; ++c) Ks[hh * DP + lane + 32 * c] = acc[hh][c];
  }
  __syncthreads();

  for (int i = tid; i < g * DP; i += NT) {
    const int hh = i / DP, dc = i % DP;
    if (dc >= a.d) continue;
    float mx = NEG_INF;
    for (int ww = 0; ww < WARPS; ++ww) mx = fmaxf(mx, Ms[ww * MAXG + hh]);
    float lsum = 0.f, asum = 0.f;
    for (int ww = 0; ww < WARPS; ++ww) {
      const float f = expf(__fsub_rn(Ms[ww * MAXG + hh], mx));
      lsum = fmaf(f, Ls[ww * MAXG + hh], lsum);
      asum = fmaf(f, Kall[ww * 32 * LD + hh * DP + dc], asum);
    }
    if (lsum == 0.f) lsum = 1.f;  // fully masked row -> 0
    o[hh * a.o_sh + dc] = from_f<T>(__fdiv_rn(asum, lsum));
  }
}

// The row's valid key range [lo, hi) from its bounds and the window.
__device__ __forceinline__ void key_range(const Args& a, int b, int* lo,
                                          int* hi) {
  const int len = a.kv_len[b];
  int start = a.kv_start ? a.kv_start[b] : 0;
  if (a.window) start = max(start, len - a.window);
  *lo = max(start, 0);
  *hi = min(len, a.skv);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT) dec_kernel(Args a) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int g = a.hq / a.hkv;
  const T* q = (const T*)a.q + b * a.q_sb + (long long)hk * g * a.q_sh;
  T* o = (T*)a.o + b * a.o_sb + (long long)hk * g * a.o_sh;
  const Contig<T> k{(const T*)a.k + b * a.k_sb + hk * a.k_sh, a.k_ss};
  const Contig<T> v{(const T*)a.v + b * a.v_sb + hk * a.v_sh, a.v_ss};
  int lo, hi;
  key_range(a, b, &lo, &hi);
  dec_body<T, DP>(a, q, k, v, o, lo, hi);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT) dec_paged_kernel(Args a) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int g = a.hq / a.hkv;
  const T* q = (const T*)a.q + b * a.q_sb + (long long)hk * g * a.q_sh;
  T* o = (T*)a.o + b * a.o_sb + (long long)hk * g * a.o_sh;
  const int* trow = a.table + (long long)b * a.tw;
  const Paged<T> k{(const T*)a.k + hk * a.k_sh, trow, a.bs, a.k_sb, a.k_ss};
  const Paged<T> v{(const T*)a.v + hk * a.v_sh, trow, a.bs, a.v_sb, a.v_ss};
  int lo, hi;
  key_range(a, b, &lo, &hi);
  dec_body<T, DP>(a, q, k, v, o, lo, hi);
}

template <typename T, int DP>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes(DP);
  auto kern = a.table ? dec_paged_kernel<T, DP> : dec_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.hkv, b);
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int b, cudaStream_t stream) {
  if (a.d <= 32) return launch<T, 32>(a, b, stream);
  if (a.d <= 64) return launch<T, 64>(a, b, stream);
  return launch<T, 128>(a, b, stream);
}

int run(const Args& a, int dtype, int b, void* stream) {
  if (a.d < 1 || a.d > 128 || a.hkv < 1 || a.hq % a.hkv != 0 ||
      a.hq / a.hkv > MAXG)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = dtype == 1 ? dispatch_d<__nv_bfloat16>(a, b, s)
                               : dispatch_d<float>(a, b, s);
  return (int)err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns the
// CUDA error of the launch (0 on success); the kernel runs asynchronously on
// `stream`.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, void* o, const int* kv_start,
    const int* kv_len, int dtype, int b, int skv, int hq, int hkv, int d,
    long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, int window, float scale, void* stream) {
  Args a{q,    k,    v,    o,    kv_start, kv_len, nullptr, skv,  hq,
         hkv,  d,    window, 0,  0,        q_sb,   q_sh,    k_sb, k_ss,
         k_sh, v_sb, v_ss, v_sh, o_sb,     o_sh,   scale};
  return run(a, dtype, b, stream);
}

// The paged twin: k_pool/v_pool (NB,BS,Hkv,D) by strides (block, slot,
// head), table (B,T) int32 contiguous with every entry in [0, NB).
extern "C" int repro_decode_attention_paged(
    const void* q, const void* k_pool, const void* v_pool, void* o,
    const int* table, const int* kv_start, const int* kv_len, int dtype,
    int b, int tw, int bs, int hq, int hkv, int d, long long q_sb,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_sh, int window, float scale, void* stream) {
  if (bs < 1 || tw < 0) return (int)cudaErrorInvalidValue;
  Args a{q,    k_pool, v_pool, o,    kv_start, kv_len, table, bs * tw, hq,
         hkv,  d,      window, bs,   tw,       q_sb,   q_sh,  k_sb,    k_ss,
         k_sh, v_sb,   v_ss,   v_sh, o_sb,     o_sh,   scale};
  return run(a, dtype, b, stream);
}
