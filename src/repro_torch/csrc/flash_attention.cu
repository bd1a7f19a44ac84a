// Prefill (flash) attention for Hopper: GQA, causal, sliding window,
// q_offset, a per-row kv_start left-pad mask and an optional per-row kv_len
// bound (chunked prefill), online softmax in f32.
//
// Replaces the TPU kernel `flash_attention_bhsd` (`_fa_kernel`) in
// src/repro/kernels/flash_attention/kernel.py.  Same function: a row with no
// valid key outputs 0 (l == 0), p is 0 while the running max is NEG_INF,
// and K/V tiles that are fully masked for the whole q tile are skipped.
//
// Layout: q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D) and o (B,Sq,Hq,D) are read and
// written by stride (the last dim must be contiguous), so the caller makes
// no swapaxes or pad-to-multiple copy.  One thread block per (q tile of 64
// rows, q head, batch row); the KV head is h / (Hq / Hkv).  The block walks
// K/V tiles of 64 keys staged in shared memory as f32 and keeps (acc, m, l)
// in registers.  K tiles start at the row's kv_start, not at 0: a row's
// sums then run in the same order however much left pad its batch added,
// so a prompt's output does not depend on what it was packed with.  With
// kv_len, keys at col >= kv_len[b] are masked (and not loaded) and the K
// loop stops there; tiles stay aligned at kv_start (0 for a paged row), so
// a prompt prefilled in one wave and one prefilled in chunks with growing
// q_offset walk the same tiles.
//
// Bound on the card: at the serving shapes (B 8, S 512, Hq 15, D 64, bf16)
// the bytes (q, k, v read once and o written once) take longer at 3.35 TB/s
// than the causal flops at the bf16 tensor-core peak.  This first version
// multiplies on the CUDA cores in f32 (exact for f32 inputs, where TF32 would
// break the 2e-5 tolerance), so it sits far above that bound; mma/wgmma
// tiles for bf16 are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = (float)(-0.7 * 3.4028234663852886e38);
constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // keys per K/V tile
constexpr int NT = 256;  // threads: 16 row groups x 16 column groups

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_start;  // (B,) or null
  const int* kv_len;    // (B,) or null: keys at col >= kv_len[b] masked
  int sq, skv, hq, hkv, d;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window, q_offset;
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
  return sizeof(float) * (size_t)(BQ * (dp + 1) + 2 * BK * (dp + 1) +
                                  BQ * (BK + 1));
}

// DP: D rounded up to 32, 64 or 128; columns d..DP-1 are loaded as 0.
template <typename T, int DP>
__global__ void __launch_bounds__(NT) fa_kernel(Args a) {
  constexpr int LD = DP + 1;  // padded row stride: conflict-free columns
  constexpr int LP = BK + 1;
  constexpr int NC = DP / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x LD, pre-scaled
  float* Ks = Qs + BQ * LD;    // BK x LD
  float* Vs = Ks + BK * LD;    // BK x LD
  float* Ps = Vs + BK * LD;    // BQ x LP

  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // owns rows rg + 16 i
  const int cg = tid & 15;  // owns key columns / d columns cg + 16 j
  const int row0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int start = a.kv_start ? a.kv_start[b] : 0;
  const int hi = a.kv_len ? max(0, min(a.skv, a.kv_len[b])) : a.skv;

  const T* q = (const T*)a.q + b * a.q_sb + h * a.q_sh;
  const T* k = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* v = (const T*)a.v + b * a.v_sb + hk * a.v_sh;
  T* o = (T*)a.o + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < BQ * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (row0 + r < a.sq && c < a.d)
      x = to_f(q[(long long)(row0 + r) * a.q_ss + c]) * a.scale;
    Qs[r * LD + c] = x;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int qmin = row0 + a.q_offset;  // absolute position of the first row
  const int qmax = qmin + BQ - 1;
  for (int col0 = start; col0 < hi; col0 += BK) {
    if (a.causal && col0 > qmax) break;  // above the diagonal from here on
    if (a.window && col0 + BK - 1 <= qmin - a.window) continue;

    __syncthreads();  // the previous tile's Ks/Vs/Ps are consumed
    for (int i = tid; i < BK * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      float kx = 0.f, vx = 0.f;
      if (col0 + r < hi && c < a.d) {
        kx = to_f(k[(long long)(col0 + r) * a.k_ss + c]);
        vx = to_f(v[(long long)(col0 + r) * a.v_ss + c]);
      }
      Ks[r * LD + c] = kx;
      Vs[r * LD + c] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < DP; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg + 16 * i) * LD + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(cg + 16 * j) * LD + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = qmin + rg + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + cg + 16 * j;
        bool ok = col < hi;  // col >= start holds: tiles begin there
        if (a.causal) ok = ok && col <= row;
        if (a.window) ok = ok && col > row - a.window;
        s[i][j] = ok ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // no valid key so far: p must be 0, not exp(NEG_INF - NEG_INF) = 1
      const bool live = m_new > 0.5f * NEG_INF;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live ? expf(s[i][j] - m_new) : 0.f;
        Ps[(rg + 16 * i) * LP + cg + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[j * LD + cg + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(rg + 16 * i) * LP + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + rg + 16 * i;
    if (r >= a.sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];  // fully masked row -> 0
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int dc = cg + 16 * c;
      if (dc < a.d) o[(long long)r * a.o_ss + dc] = from_f<T>(acc[i][c] / li);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + BQ - 1) / BQ, a.hq, b);
  fa_kernel<T, DP><<<grid, NT, smem, stream>>>(a);
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
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, const int* kv_start,
    const int* kv_len, int dtype, int b, int sq, int skv, int hq, int hkv,
    int d,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, int q_offset, float scale, void* stream) {
  if (d < 1 || d > 128 || hkv < 1 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  Args a{q,    k,    v,    o,    kv_start, kv_len, sq,   skv,  hq,
         hkv,  d,    q_sb, q_ss, q_sh,     k_sb,   k_ss, k_sh, v_sb,
         v_ss, v_sh, o_sb, o_ss, o_sh,     causal, window, q_offset, scale};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = dtype == 1 ? dispatch_d<__nv_bfloat16>(a, b, s)
                               : dispatch_d<float>(a, b, s);
  return (int)err;
}
