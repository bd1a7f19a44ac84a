// Chunked RWKV-6 WKV recurrence for Hopper.
//
// Replaces the TPU kernel `wkv6_chunked_pallas` (`_wkv_kernel`) in
// src/repro/kernels/rwkv6_wkv/kernel.py.  Same function, chunk by chunk,
// for one head with K key and K value channels and a decay per key channel
// (w = exp(logw), logw <= 0):
//
//   A[t,s] = sum_k r[t,k] k[s,k] exp(seg[t,s,k])      s < t   (L, L)
//   y[t]   = sum_{s<t} A[t,s] v[s] + (sum_k r[t,k] u[k] k[t,k]) v[t]
//            + (r[t] * exp(head[t])) @ state
//   state  = exp(head[L]) * state + (k * exp(tail))^T @ v
//
// with seg[t,s] = sum_{s<q<t} logw[q], head[t] = sum_{q<t} logw[q] and
// tail[s] = sum_{s<q<L} logw[q], the (K, V) f32 state carried across
// chunks; y comes back in r's dtype and the final state in f32.  Each
// segment sum is taken directly, as the port's plain chunked version takes
// it, not as a difference of running sums as the TPU kernel does: the
// running sum falls by tens to hundreds within a chunk at rwkv6-1.6b's
// decay rates, and a difference there keeps only an f32 ulp of it (4e-6 to
// 1.5e-5) in every weight (tests/test_torch_wkv.py holds the direct sums
// against a float64 scan at those rates).
//
// Layout: r, k, v (B,S,H,K) in one dtype, logw (B,S,H,K) f32 and y
// (B,S,H,K) are read and written by stride (the last dim contiguous); u
// (H,K) f32, s0 and the final state (B,H,K,K) f32 are contiguous.  S is not
// padded to a multiple of the chunk: steps past S are identities (r = k =
// v = 0, logw = 0) and no y is written there.
//
// One thread block per (head, batch row) walks the row's chunks in order:
// the Pallas grid's sequential chunk axis has no counterpart on a GPU, so
// the block owns the walk and keeps the state in shared memory.  The TPU
// kernel forms an (L, L, K) tile of decay weights (1 MiB of f32 at L = K =
// 64), far above the 227 KB a Hopper block may hold; here a chunk's r, k,
// v, logw and the (L, L) score tile sit in shared memory as f32 (about 100
// KB, two blocks an SM), and the weights are formed in registers as the
// scores are summed.  Score phase: thread (p, g) owns score columns p and
// L-1-p (together L-1 rows, so every thread does the same work) and
// channel group g; it walks its columns' rows carrying the segment sums of
// its 8 channels, and the 8 groups of a column pair, adjacent lanes of a
// warp, add their parts by shuffles in a fixed order.  The arithmetic is
// f32 FMAs on the CUDA cores (TF32 would break the f32 tolerance of 5e-4).
//
// With `start` (B,) the walk of row b begins at start[b], its first real
// token, and y is 0 before it.  The caller guarantees that the steps before
// start are identities for the row (r = k = v = 0 and a zero state entering
// them, as the model's left pad makes them), so the result is the same
// function; and since every sum of a row then runs over the same chunks in
// the same order, a row's y and final state are the same bits however much
// left pad its batch added.
//
// Bound on the card: bytes.  At the rwkv6-1.6b serving shape (B 8, S 512,
// H 32, K 64, chunk 64) the real steps of r, k, v (bf16) and logw (f32),
// all of y and the final state come to about 58 MB, 0.017 ms at 3.35 TB/s,
// against about 1.7 GFLOP.  This first version sits well above that bound
// (exps, products and sums on the CUDA cores, one block per (row, head));
// tensor-core tiles and TMA staging are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads
constexpr int LMAX = 64;         // largest chunk
constexpr int KMAX = 64;         // largest head size (K == V)
constexpr int LD = KMAX + 1;     // row stride of the (L, K) tiles
constexpr int AS = LMAX + 1;     // row stride of the (L, L) score tile
constexpr int NG = 8;            // channel groups in the score phase
constexpr int KG = KMAX / NG;    // channels per group
constexpr int RI = LMAX / 16;    // y rows per thread
constexpr int CJ = KMAX / 16;    // y / state columns per thread

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const float* u;      // (H, K)
  const float* s0;     // (B,H,K,K) or null
  const int* start;    // (B,) or null
  void* y;
  float* sout;         // (B,H,K,K)
  int s, h, kd, chunk;
  long long r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh, y_sb, y_ss, y_sh;
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

constexpr size_t SMEM_FLOATS =
    4 * (size_t)LMAX * LD + (size_t)LMAX * AS + (size_t)KMAX * LD +
    2 * (size_t)LMAX + 2 * (size_t)KMAX;

template <typename T>
__global__ void __launch_bounds__(NT) wkv_kernel(Args a) {
  extern __shared__ float smem[];
  float* Rs = smem;                // L x LD: r, then r * exp(head)
  float* Ks = Rs + LMAX * LD;      // L x LD: k, then k * exp(tail)
  float* Vs = Ks + LMAX * LD;      // L x LD: v
  float* Ws = Vs + LMAX * LD;      // L x LD: logw
  float* As = Ws + LMAX * LD;      // L x AS: scores, s < t
  float* Ss = As + LMAX * AS;      // K x LD: the carried state (K x V)
  float* Dg = Ss + KMAX * LD;      // L: the u bonus sum_k r u k at t
  float* Us = Dg + LMAX;           // K: u
  float* Ed = Us + KMAX;           // K: exp(head[L]), the chunk's decay

  const int tid = threadIdx.x;
  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int L = a.chunk;
  const int K = a.kd;
  const int st = a.start ? min(max(a.start[b], 0), a.s) : 0;

  const T* r = (const T*)a.r + b * a.r_sb + hh * a.r_sh;
  const T* kp = (const T*)a.k + b * a.k_sb + hh * a.k_sh;
  const T* vp = (const T*)a.v + b * a.v_sb + hh * a.v_sh;
  const float* lw = a.logw + b * a.w_sb + hh * a.w_sh;
  T* y = (T*)a.y + b * a.y_sb + hh * a.y_sh;
  const long long soff = ((long long)b * a.h + hh) * K * K;

  // y is 0 at the skipped left pad, as r = 0 makes it in the reference
  for (int i = tid; i < st * K; i += NT)
    y[(long long)(i / K) * a.y_ss + i % K] = from_f<T>(0.f);
  for (int i = tid; i < KMAX * KMAX; i += NT) {
    const int ki = i / KMAX, vi = i % KMAX;
    Ss[ki * LD + vi] =
        (a.s0 && ki < K && vi < K) ? a.s0[soff + (long long)ki * K + vi] : 0.f;
  }
  for (int i = tid; i < LMAX * AS; i += NT) As[i] = 0.f;  // s >= t stays 0
  if (tid < KMAX) Us[tid] = tid < K ? a.u[(long long)hh * K + tid] : 0.f;

  // score phase: column pair p (columns p and L-1-p), channel group g
  const int p = tid / NG;
  const int g = tid % NG;
  const int npairs = (L + 1) / 2;
  const int c1 = p;
  const int c2 = L - 1 - p;
  const bool has1 = p < npairs;
  const bool has2 = has1 && c2 != c1;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  for (int c0 = st; c0 < a.s; c0 += L) {
    const int nv = min(L, a.s - c0);  // real steps; the rest are identities
    __syncthreads();  // the previous chunk's tiles are consumed
    for (int i = tid; i < L * KMAX; i += NT) {
      const int t = i / KMAX, c = i % KMAX;
      float rv = 0.f, kv = 0.f, vv = 0.f, wv = 0.f;
      if (t < nv && c < K) {
        const long long row = c0 + t;
        rv = to_f(r[row * a.r_ss + c]);
        kv = to_f(kp[row * a.k_ss + c]);
        vv = to_f(vp[row * a.v_ss + c]);
        wv = lw[row * a.w_ss + c];
      }
      Rs[t * LD + c] = rv;
      Ks[t * LD + c] = kv;
      Vs[t * LD + c] = vv;
      Ws[t * LD + c] = wv;
    }
    __syncthreads();

    if (tid < L) {  // the u bonus of row t
      float acc = 0.f;
      for (int c = 0; c < K; ++c)
        acc = fmaf(Rs[tid * LD + c] * Us[c], Ks[tid * LD + c], acc);
      Dg[tid] = acc;
    }
    __syncthreads();

    // scores.  Iteration i serves column c1 at row c1 + 1 + i for the first
    // L-1-c1 iterations, then column c2 at row c2 + 1 + (i - (L-1-c1)); the
    // segment sum of a column starts at 0 on the row below its diagonal and
    // takes logw of each row after that row's use.
    {
      float e1[KG], e2[KG], k1[KG], k2[KG];
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        const int c = g * KG + j;
        e1[j] = 0.f;
        e2[j] = 0.f;
        k1[j] = has1 ? Ks[c1 * LD + c] : 0.f;
        k2[j] = has2 ? Ks[c2 * LD + c] : 0.f;
      }
      const int n1 = L - 1 - c1;
      for (int i = 0; i < L - 1; ++i) {
        const bool first = i < n1;
        const bool live = first ? has1 : has2;
        const int sc = first ? c1 : c2;
        const int t = first ? c1 + 1 + i : c2 + 1 + (i - n1);
        float part = 0.f;
        if (live) {
          const float* rt = &Rs[t * LD + g * KG];
          const float* wt = &Ws[t * LD + g * KG];
#pragma unroll
          for (int j = 0; j < KG; ++j) {
            const float e = first ? e1[j] : e2[j];
            const float kv = first ? k1[j] : k2[j];
            part = fmaf(rt[j] * kv, expf(e), part);
          }
#pragma unroll
          for (int j = 0; j < KG; ++j) {
            if (first)
              e1[j] += wt[j];
            else
              e2[j] += wt[j];
          }
        }
#pragma unroll
        for (int off = 1; off < NG; off <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (live && g == 0) As[t * AS + sc] = part;
      }
      // the segment sums now run to the chunk's end: k * exp(tail), in
      // place (only this thread reads these entries of Ks in this phase)
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        const int c = g * KG + j;
        if (has1) Ks[c1 * LD + c] = k1[j] * expf(e1[j]);
        if (has2) Ks[c2 * LD + c] = k2[j] * expf(e2[j]);
      }
    }
    __syncthreads();  // every read of r for the scores is done

    if (tid < KMAX) {  // r * exp(head), in place, and the chunk's decay
      const int c = tid;
      float e = 0.f;
      for (int t = 0; t < L; ++t) {
        Rs[t * LD + c] *= expf(e);
        e += Ws[t * LD + c];
      }
      Ed[c] = expf(e);
    }
    __syncthreads();

    // y: rows t = ty + 16 i, columns v = tx + 16 j; the state's input term
    // (rows k = ty + 16 i) from the same tiles
    float hacc[CJ][CJ];
#pragma unroll
    for (int i = 0; i < CJ; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) hacc[i][j] = 0.f;
    {
      float yi[RI][CJ], yo[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) yi[i][j] = yo[i][j] = 0.f;
      for (int sc = 0; sc < L; ++sc) {
        float vv[CJ], av[RI], kv[CJ];
#pragma unroll
        for (int j = 0; j < CJ; ++j) vv[j] = Vs[sc * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          av[i] = As[min(ty + 16 * i, LMAX - 1) * AS + sc];
          kv[i] = Ks[sc * LD + ty + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            yi[i][j] = fmaf(av[i], vv[j], yi[i][j]);
            hacc[i][j] = fmaf(kv[i], vv[j], hacc[i][j]);
          }
      }
      for (int c = 0; c < K; ++c) {
        float rv[RI], sv[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i)
          rv[i] = Rs[min(ty + 16 * i, LMAX - 1) * LD + c];
#pragma unroll
        for (int j = 0; j < CJ; ++j) sv[j] = Ss[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j)
            yo[i][j] = fmaf(rv[i], sv[j], yo[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int t = ty + 16 * i;
        if (t >= nv) continue;
        const float d = Dg[t];
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int vc = tx + 16 * j;
          if (vc < K)
            y[(long long)(c0 + t) * a.y_ss + vc] =
                from_f<T>(fmaf(d, Vs[t * LD + vc], yi[i][j]) + yo[i][j]);
        }
      }
    }
    __syncthreads();  // every read of the old state is done

#pragma unroll
    for (int i = 0; i < CJ; ++i) {
      const float dec = Ed[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        float* sp = &Ss[(ty + 16 * i) * LD + tx + 16 * j];
        *sp = fmaf(dec, *sp, hacc[i][j]);
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < K * K; i += NT)
    a.sout[soff + i] = Ss[(i / K) * LD + i % K];
}

template <typename T>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const size_t smem = sizeof(float) * SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      wkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.h, b);
  wkv_kernel<T><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v and y; logw is float32).
// Strides are in elements.  Returns the CUDA error of the launch (0 on
// success); the kernel runs asynchronously on `stream`.
extern "C" int repro_wkv6_chunked(
    const void* r, const void* k, const void* v, const float* logw,
    const float* u, const float* s0, const int* start, void* y, float* sout,
    int dtype, int b, int s, int h, int kd, int chunk, long long r_sb,
    long long r_ss, long long r_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long w_sb, long long w_ss, long long w_sh, long long y_sb,
    long long y_ss, long long y_sh, void* stream) {
  if (kd < 1 || kd > KMAX || chunk < 1 || chunk > LMAX)
    return (int)cudaErrorInvalidValue;
  Args a{r,    k,    v,    logw, u,    s0,   start, y,    sout, s,
         h,    kd,   chunk, r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb,
         v_ss, v_sh, w_sb, w_ss, w_sh, y_sb, y_ss,  y_sh};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = dtype == 1 ? launch<__nv_bfloat16>(a, b, st)
                               : launch<float>(a, b, st);
  return (int)err;
}
