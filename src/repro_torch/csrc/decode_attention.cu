// Decode attention for Hopper: one query token per row against a contiguous
// KV cache, GQA, bounds [kv_start, kv_len) and an optional window.
//
// Replaces the TPU kernel `flash_decode_bhgd` (`_dec_kernel`) in
// src/repro/kernels/decode_attention/kernel.py.  Same function: keys outside
// [max(kv_start, kv_len - window), min(kv_len, Skv)) are masked, and a row
// with no valid key outputs 0.
//
// Layout: q (B,Hq,D) and o (B,Hq,D); k/v (B,Skv,Hkv,D) read by stride (the
// last dim must be contiguous).  One thread block per (kv head, batch row);
// its 8 warps take 32-key chunks of the valid range in turn, starting at the
// row's first valid key.  Every K/V row loaded serves all G query heads of
// the group, so the valid cache is read once.  A warp stages its K chunk in
// shared memory (coalesced), each lane scores one key for all G heads, the
// warp updates its running (m, l) once per chunk, and then the lanes split D
// to accumulate p.V from coalesced V rows.  The warps' partial (m, l, acc)
// are merged in shared memory at the end.  G (3 for smollm) is far below any
// tensor-core tile, so the products are FMAs on the CUDA cores.  The ragged
// tail is masked; nothing is padded or copied.
//
// Bound on the card: bytes.  The valid K/V slots once, plus q and o, over
// 3.35 TB/s; the flops (4 G D per key) are negligible beside them.
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
  int skv, hq, hkv, d, window;
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

constexpr size_t smem_bytes(int dp) {
  // per-warp K chunk (reused for the merge), q, p, and the warps' (m, l)
  return sizeof(float) * (size_t)(WARPS * 32 * (dp + 1) + MAXG * dp +
                                  WARPS * MAXG * 32 + 2 * WARPS * MAXG);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT) dec_kernel(Args a) {
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
  const int hk = blockIdx.x, b = blockIdx.y;
  const int g = a.hq / a.hkv;
  const T* q = (const T*)a.q + b * a.q_sb + (long long)hk * g * a.q_sh;
  const T* k = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* v = (const T*)a.v + b * a.v_sb + hk * a.v_sh;
  T* o = (T*)a.o + b * a.o_sb + (long long)hk * g * a.o_sh;
  float* Ks = Kall + w * 32 * LD;
  float* Ps = Pall + w * MAXG * 32;

  const int len = a.kv_len[b];
  int lo = a.kv_start ? a.kv_start[b] : 0;
  if (a.window) lo = max(lo, len - a.window);
  lo = max(lo, 0);
  const int hi = min(len, a.skv);

  for (int i = tid; i < MAXG * DP; i += NT) {
    const int hh = i / DP, c = i % DP;
    float x = 0.f;
    if (hh < g && c < a.d) x = to_f(q[hh * a.q_sh + c]) * a.scale;
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
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int dc = lane + 32 * c;
        float x = 0.f;
        if (r < n && dc < a.d) x = to_f(k[(long long)(c0 + r) * a.k_ss + dc]);
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
      const float p = m_new > 0.5f * NEG_INF ? expf(sv - m_new) : 0.f;
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = expf(m[hh] - m_new);
      l[hh] = alpha * l[hh] + psum;
      m[hh] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[hh][c] *= alpha;
      Ps[hh * 32 + lane] = p;
    }
    __syncwarp();

    for (int r = 0; r < n; ++r) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int dc = lane + 32 * c;
        vv[c] = dc < a.d ? to_f(v[(long long)(c0 + r) * a.v_ss + dc]) : 0.f;
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
      const float f = expf(Ms[ww * MAXG + hh] - mx);
      lsum += f * Ls[ww * MAXG + hh];
      asum += f * Kall[ww * 32 * LD + hh * DP + dc];
    }
    if (lsum == 0.f) lsum = 1.f;  // fully masked row -> 0
    o[hh * a.o_sh + dc] = from_f<T>(asum / lsum);
  }
}

template <typename T, int DP>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(
      dec_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.hkv, b);
  dec_kernel<T, DP><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int b, cudaStream_t stream) {
  if (a.d <= 32) return launch<T, 32>(a, b, stream);
  if (a.d <= 64) return launch<T, 64>(a, b, stream);
  return launch<T, 128>(a, b, stream);
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
  if (d < 1 || d > 128 || hkv < 1 || hq % hkv != 0 || hq / hkv > MAXG)
    return (int)cudaErrorInvalidValue;
  Args a{q,    k,    v,    o,    kv_start, kv_len, skv,  hq,   hkv,
         d,    window, q_sb, q_sh, k_sb, k_ss,   k_sh,   v_sb, v_ss,
         v_sh, o_sb, o_sh, scale};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = dtype == 1 ? dispatch_d<__nv_bfloat16>(a, b, s)
                               : dispatch_d<float>(a, b, s);
  return (int)err;
}
