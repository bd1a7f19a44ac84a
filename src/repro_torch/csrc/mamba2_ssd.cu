// Chunked Mamba2 SSD scan for Hopper.
//
// Replaces the TPU kernel `ssd_chunked_pallas` (`_ssd_kernel`) in
// src/repro/kernels/mamba2_ssd/kernel.py.  Same function, chunk by chunk:
//
//   la     = cumsum(dt * A)                      (L,)     decay log-weights
//   scores = (C B^T) * exp(la_t - la_s), s <= t  (L, L)   masked before exp
//   y      = scores @ (dt x) + exp(la) * (C @ state^T)
//   state  = exp(la_L) state + ((dt x) * exp(la_L - la))^T @ B
//
// with the (P, N) f32 state carried across chunks; returns y in x's dtype
// and the final state in f32.  The segment sums la_t - la_s are summed
// directly (see the decay weights below), as the port's plain chunked
// version sums them, rather than differenced as the TPU kernel does.
//
// Layout: x (B,S,H,P), dt (B,S,H), B/C (B,S,G,N) and y (B,S,H,P) are read
// and written by stride (the last dim of x, B, C must be contiguous); h0
// and the final state are contiguous (B,H,P,N) f32.  Head h reads B and C
// of group h / (H / G) in place, so the TPU path's repeat of B/C over the
// heads (H times the bytes at G = 1) is not made, and S is not padded to a
// multiple of the chunk: steps past S are dt = 0 identities and no y is
// written there.
//
// One thread block per (head, batch row) walks the row's chunks in order:
// the Pallas grid's sequential chunk axis has no counterpart on a GPU, so
// the block owns the walk and keeps the state in shared memory.  A chunk's
// dt-scaled x, B, C and the (L, L) score tile are staged in shared memory
// as f32 (about 184 KB at L 128, P = N = 64, behind the dynamic
// shared-memory opt-in); the products are f32 FMAs on the CUDA cores (TF32
// would break the f32 tolerance of 2e-4).  Score tiles above the diagonal
// are neither computed nor read.
//
// With `start` (B,) the walk of row b begins at start[b], its first real
// token, and y is 0 before it.  The caller guarantees that the steps before
// start are identities (x, B, C and dt are 0 there, as the Mamba2 block
// makes them at left pad), so the result is the same function; and since
// every sum of a row then runs over the same chunks in the same order, a
// row's y and final state are the same bits however much left pad its
// batch added.
//
// Bound on the card: bytes.  At the serving shape (x (8,512,80,64) bf16,
// chunk 128) x and y move 42 MB each and the final state 10.5 MB against
// about 11 GFLOP (causal scores and y, the state readout and update), so
// the bytes take longer at 3.35 TB/s than the flops at the bf16
// tensor-core peak.  This first version sits well above that
// bound (one block per (row, head), one block per SM for its shared
// memory, FMAs on the CUDA cores); wgmma tiles and TMA staging are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;    // threads: 16 row groups x 16 column groups
constexpr int LMAX = 128;  // largest chunk
constexpr int RI = LMAX / 16;  // score / output rows per thread

struct Args {
  const void* x;
  const void* dt;
  const float* A;      // (H,)
  const void* bm;
  const void* cm;
  const float* h0;     // (B,H,P,N) or null
  const int* start;    // (B,) or null
  void* y;
  float* hout;         // (B,H,P,N)
  int s, h, g, p, n, chunk;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
  long long y_sb, y_ss, y_sh;
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

// Shared memory in floats for chunk L and D = P, N rounded up.
constexpr size_t smem_floats(int l, int d) {
  return (size_t)3 * l * (d + 1) + (size_t)l * (l + 1) +
         (size_t)d * (d + 1) + 4 * (size_t)l;
}

// D: P and N rounded up to 16, 32 or 64; lanes past P or N are loaded as 0.
template <typename T, int D>
__global__ void __launch_bounds__(NT) ssd_kernel(Args a) {
  constexpr int LD = D + 1;   // padded row stride: conflict-free columns
  constexpr int DJ = D / 16;  // output / state columns per thread
  const int L = a.chunk;
  const int LS = L + 1;
  extern __shared__ float smem[];
  float* Xs = smem;            // L x LD: dt * x
  float* Bs = Xs + L * LD;     // L x LD
  float* Cs = Bs + L * LD;     // L x LD
  float* Ss = Cs + L * LD;     // L x LS: causal decay-weighted scores
  float* Hs = Ss + L * LS;     // D x LD: the carried state (P x N)
  float* Ds = Hs + D * LD;     // L: dt
  float* La = Ds + L;          // L: cumsum(dt * A)
  float* Ea = La + L;          // L: exp(la)
  float* We = Ea + L;          // L: exp(la_L - la)

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int gi = hh / (a.h / a.g);
  const int st = a.start ? min(max(a.start[b], 0), a.s) : 0;
  const float A = a.A[hh];

  const T* x = (const T*)a.x + b * a.x_sb + hh * a.x_sh;
  const T* dt = (const T*)a.dt + b * a.dt_sb + hh * a.dt_sh;
  const T* bm = (const T*)a.bm + b * a.b_sb + gi * a.b_sg;
  const T* cm = (const T*)a.cm + b * a.c_sb + gi * a.c_sg;
  T* y = (T*)a.y + b * a.y_sb + hh * a.y_sh;
  const long long hoff = ((long long)b * a.h + hh) * a.p * a.n;

  // y is 0 at the skipped left pad, as C = 0 makes it in the reference
  for (int i = tid; i < st * a.p; i += NT)
    y[(long long)(i / a.p) * a.y_ss + i % a.p] = from_f<T>(0.f);
  for (int i = tid; i < D * D; i += NT) {
    const int pi = i / D, ni = i % D;
    Hs[pi * LD + ni] = (a.h0 && pi < a.p && ni < a.n)
                           ? a.h0[hoff + (long long)pi * a.n + ni]
                           : 0.f;
  }

  for (int c0 = st; c0 < a.s; c0 += L) {
    const int nv = min(L, a.s - c0);  // real steps; the rest are identities
    __syncthreads();  // the previous chunk's tiles are consumed
    for (int t = tid; t < L; t += NT)
      Ds[t] = t < nv ? to_f(dt[(long long)(c0 + t) * a.dt_ss]) : 0.f;
    __syncthreads();
    for (int i = tid; i < L * D; i += NT) {
      const int t = i / D, c = i % D;
      const long long row = c0 + t;
      float xv = 0.f, bv = 0.f, cv = 0.f;
      if (t < nv) {
        if (c < a.p) xv = to_f(x[row * a.x_ss + c]) * Ds[t];
        if (c < a.n) {
          bv = to_f(bm[row * a.b_ss + c]);
          cv = to_f(cm[row * a.c_ss + c]);
        }
      }
      Xs[t * LD + c] = xv;
      Bs[t * LD + c] = bv;
      Cs[t * LD + c] = cv;
    }
    if (tid < 32) {  // la = cumsum(dt * A): a warp scan over lanes of K steps
      const int K = (L + 31) / 32;
      float loc[LMAX / 32];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < LMAX / 32; ++k) {
        const int t = tid * K + k;
        if (k < K && t < L) run += Ds[t] * A;
        loc[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int k = 0; k < LMAX / 32; ++k) {
        const int t = tid * K + k;
        if (k < K && t < L) La[t] = excl + loc[k];
      }
      __syncwarp();
      for (int t = tid; t < L; t += 32) Ea[t] = expf(La[t]);
    }
    __syncthreads();

    // decay weights exp(sum_{s < r <= t} dt_r A): thread t sums its row
    // backwards from the diagonal.  Not exp(la_t - la_s): la falls several
    // hundred below zero within a chunk at zamba2-2.7b's decay rates, and
    // the difference would lose 3e-5 to 6e-5 (an f32 ulp there) of each
    // weight.  Row L-1 is also the state update's exp(la_L - la_s).
    if (tid < L) {
      const int t = tid;
      float run = 0.f;
      Ss[t * LS + t] = 1.f;
      if (t == L - 1) We[t] = 1.f;
      for (int sc = t - 1; sc >= 0; --sc) {
        run += Ds[sc + 1] * A;
        const float w = expf(run);
        Ss[t * LS + sc] = w;
        if (t == L - 1) We[sc] = w;
      }
    }

    // scores: rows t = ty + 16 i, columns s = tx + 16 j, tiles j <= i only
    {
      float acc[RI][RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) acc[i][j] = 0.f;
      for (int nn = 0; nn < D; ++nn) {
        float cv[RI], bv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const int r = min(ty + 16 * i, L - 1);
          cv[i] = Cs[r * LD + nn];
          bv[i] = Bs[min(tx + 16 * i, L - 1) * LD + nn];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
      __syncthreads();  // the decay weights are complete
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int t = ty + 16 * i;
        if (t >= L) continue;
#pragma unroll
        for (int j = 0; j <= i; ++j) {
          const int sc = tx + 16 * j;
          if (sc < L)
            Ss[t * LS + sc] = sc <= t ? acc[i][j] * Ss[t * LS + sc] : 0.f;
        }
      }
    }

    // the state's input term, from Xs and Bs only: rows p = ty + 16 i,
    // columns n = tx + 16 j
    float hacc[DJ][DJ];
#pragma unroll
    for (int i = 0; i < DJ; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) hacc[i][j] = 0.f;
    for (int t = 0; t < L; ++t) {
      const float w = We[t];
      float xv[DJ], bv[DJ];
#pragma unroll
      for (int i = 0; i < DJ; ++i) {
        xv[i] = Xs[t * LD + ty + 16 * i] * w;
        bv[i] = Bs[t * LD + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < DJ; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) hacc[i][j] = fmaf(xv[i], bv[j], hacc[i][j]);
    }
    __syncthreads();  // scores are complete

    // y: rows t = ty + 16 i, columns p = tx + 16 j
    {
      float yi[RI][DJ], yo[RI][DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) yi[i][j] = yo[i][j] = 0.f;
      for (int sc = 0; sc < L; ++sc) {
        const int sb = sc >> 4;  // rows of tiles i < sb lie above it
        float xv[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) xv[j] = Xs[sc * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          if (i < sb) continue;
          const float sv = Ss[min(ty + 16 * i, L - 1) * LS + sc];
#pragma unroll
          for (int j = 0; j < DJ; ++j) yi[i][j] = fmaf(sv, xv[j], yi[i][j]);
        }
      }
      for (int nn = 0; nn < D; ++nn) {
        float cv[RI], hv[DJ];
#pragma unroll
        for (int i = 0; i < RI; ++i)
          cv[i] = Cs[min(ty + 16 * i, L - 1) * LD + nn];
#pragma unroll
        for (int j = 0; j < DJ; ++j) hv[j] = Hs[(tx + 16 * j) * LD + nn];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) yo[i][j] = fmaf(cv[i], hv[j], yo[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int t = ty + 16 * i;
        if (t >= nv) continue;
        const float e = Ea[t];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int pc = tx + 16 * j;
          if (pc < a.p)
            y[(long long)(c0 + t) * a.y_ss + pc] =
                from_f<T>(yi[i][j] + yo[i][j] * e);
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    const float decay = expf(La[L - 1]);
#pragma unroll
    for (int i = 0; i < DJ; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        float* hs = &Hs[(ty + 16 * i) * LD + tx + 16 * j];
        *hs = decay * *hs + hacc[i][j];
      }
  }

  __syncthreads();
  for (int i = tid; i < a.p * a.n; i += NT)
    a.hout[hoff + i] = Hs[(i / a.n) * LD + i % a.n];
}

template <typename T, int D>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(a.chunk, D);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.h, b);
  ssd_kernel<T, D><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int b, cudaStream_t stream) {
  const int d = a.p > a.n ? a.p : a.n;
  if (d <= 16) return launch<T, 16>(a, b, stream);
  if (d <= 32) return launch<T, 32>(a, b, stream);
  return launch<T, 64>(a, b, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C and y).  Strides are in
// elements.  Returns the CUDA error of the launch (0 on success); the
// kernel runs asynchronously on `stream`.
extern "C" int repro_ssd_chunked(
    const void* x, const void* dt, const float* A, const void* bm,
    const void* cm, const float* h0, const int* start, void* y, float* hout,
    int dtype, int b, int s, int h, int g, int p, int n, int chunk,
    long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
    long long dt_ss, long long dt_sh, long long b_sb, long long b_ss,
    long long b_sg, long long c_sb, long long c_ss, long long c_sg,
    long long y_sb, long long y_ss, long long y_sh, void* stream) {
  if (p < 1 || p > 64 || n < 1 || n > 64 || g < 1 || h % g != 0 ||
      chunk < 1 || chunk > LMAX)
    return (int)cudaErrorInvalidValue;
  Args a{x,     dt,    A,     bm,    cm,    h0,    start, y,     hout,
         s,     h,     g,     p,     n,     chunk, x_sb,  x_ss,  x_sh,
         dt_sb, dt_ss, dt_sh, b_sb,  b_ss,  b_sg,  c_sb,  c_ss,  c_sg,
         y_sb,  y_ss,  y_sh};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = dtype == 1 ? dispatch_d<__nv_bfloat16>(a, b, st)
                               : dispatch_d<float>(a, b, st);
  return (int)err;
}
