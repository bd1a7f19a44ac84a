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
// Bound on the card: bytes.  The valid K/V rows once, plus q, o (and the
// table), over 3.35 TB/s; the flops (4 G D per key, G <= 8 query heads per
// KV head) are far below any tensor-core tile, so the products are FMAs on
// the CUDA cores.  At the serving shapes the bound is about a microsecond,
// so what the kernel pays is latency: how many loads are in flight, and how
// long a key tile takes from its copy to its last product.  The design:
//
// * Key splits over the SMs.  A row's valid range [lo, hi) is cut into
//   tiles of TILE keys at fixed logical positions lo + j * TILE, and each
//   tile into WARPS slices of SL keys.  Each (kv head, row) gets a cluster
//   of CLUSTER blocks (8, or 2 where G is 1: `cluster_of`); block r takes
//   tiles r, r + CLUSTER, ... and warp w of it slice w of each.  A warp keeps its own running softmax state
//   (m, l, acc), so the tile loop has no block barrier.  The block merges
//   its warps in warp order and stores its state into rank 0's shared
//   memory; rank 0 merges the ranks that held tiles in rank order.  So the
//   blocks and warps that work for a row, and the order in which its
//   partial sums meet, depend only on [lo, hi) and on constants: never on
//   B, on the cache's capacity, on the grid or on which block finishes
//   first.  That keeps a row's bits the same alone or in any batch, and
//   paged or contiguous.  A block with no tile loads nothing, arrives at
//   the cluster barrier and exits.
// * Asynchronous staging.  Each warp copies its slices' K and V rows into
//   shared memory with cp.async (16 bytes a copy where the layout allows
//   it), in a ring of STAGES tiles, K and V as separate groups: a slice's
//   scores start when its K has landed, while its V and the next tile are
//   still in flight.  bf16 stays bf16 in shared memory (f32 stays f32);
//   rows are padded to a stride of 2 mod 4 sixteen-byte units, so the
//   16-byte reads are free of bank conflicts.
// * Paged addressing once per slice.  The paged kernel's warp loads the
//   table entries its slice spans into shared memory once; each copy finds
//   its row's block by a multiply with a reciprocal of the block size made
//   on the host, so no row costs a table load or a divide.  Block sizes
//   that do not divide the slice work.
//
// Inside a slice: two lanes score a key (alternate 16-byte units of its
// row, for all heads of the group), the warp updates (m, l) over its SL
// scores by shuffles, and p.V is split as (8 columns) x (a run of keys) per
// lane, the runs summed in a fixed order once at the end.  Every float
// operation is written out (fmaf, __fadd_rn, ...), so the contiguous and
// paged instantiations of the one body compute the same bits on the same
// logical keys, whatever the compiler would contract.
#include <atomic>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = (float)(-0.7 * 3.4028234663852886e38);
constexpr int NT = 128;             // threads per block
constexpr int WARPS = NT / 32;
constexpr int TILE = 64;            // keys per tile
constexpr int SL = TILE / WARPS;    // keys per warp slice
constexpr int STAGES = 2;           // tiles in flight per block
// Blocks per (kv head, row), one cluster: 8 where a KV head serves a group
// of query heads, 2 where it serves one.  The real reason is the number of
// (kv head, row) pairs there are to fill 132 SMs, for which G stands in:
// the rule is tuned to the two served decode shapes only (5 KV heads at
// G 3, 32 KV heads at G 1).  A model with G 1 and few KV heads would get
// 2-block clusters on a mostly idle card; key this on hkv if one comes.
// A model's group size (like its hkv) is a constant of its calls, so this
// keeps a row's bits independent of the batch.
__host__ __device__ constexpr int cluster_of(int ng) {
  return ng == 1 ? 2 : 8;
}
constexpr int MAXG = 8;             // query heads per KV head
constexpr int TBL = SL + 2;         // table entries a slice can span
static_assert(2 * SL == 32, "two lanes score each key of a slice");

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
  // made by the host launcher
  int vw;               // bytes per copy: 16, 8, 4 or 2
  int cpr_lg;           // log2 of the copies per row, rounded up
  int rs;               // shared-memory row stride in 16-byte units
  unsigned long long magic;  // ceil(2^32 / bs)
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

// One 16-byte unit of shared memory as floats (8 bf16 or 4 f32).
__device__ __forceinline__ void unit_to_f(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void unit_to_f(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  switch (bytes) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                   "l"(src));
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                   "l"(src));
      break;
    default:  // a bf16 row of odd width: a plain copy
      *reinterpret_cast<unsigned short*>(dst) =
          *reinterpret_cast<const unsigned short*>(src);
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}
// The cluster barrier in its two halves (arrive releases, wait acquires),
// so that a block can arrive and leave without waiting for the others.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Key rows of one (row, kv head) in a contiguous cache: a slice's row r is
// logical column c0 + r.
template <typename T>
struct Contig {
  const T* base;
  long long ss;
  struct Slice {
    const T* p;
    long long ss;
    __device__ __forceinline__ const T* row(int r) const {
      return p + (long long)r * ss;
    }
  };
  __device__ __forceinline__ void fetch(int*, int, int) const {}
  __device__ __forceinline__ Slice slice(const int*, int c0) const {
    return Slice{base + (long long)c0 * ss, ss};
  }
};

// Key rows of one (row, kv head) through the row's block table.  `fetch`
// puts the table entries of the slice at c0 into shared memory; `slice`
// then addresses its rows from them with no divide.
template <typename T>
struct Paged {
  const T* base;      // pool, at this kv head
  const int* table;   // this row's table entries
  int bs, tw;
  long long sb, ss;
  unsigned long long magic;
  struct Slice {
    const T* base;
    const int* ents;  // the entries from block c0 / bs on
    int o0, bs;       // c0 % bs
    long long sb, ss;
    unsigned long long magic;
    __device__ __forceinline__ const T* row(int r) const {
      const unsigned pos = (unsigned)(o0 + r);
      const int rel = (int)((pos * magic) >> 32);  // pos / bs
      const int slot = (int)pos - rel * bs;
      return base + (long long)ents[rel] * sb + (long long)slot * ss;
    }
  };
  __device__ __forceinline__ void fetch(int* ents, int c0, int lane) const {
    const int fb = c0 / bs, o0 = c0 - fb * bs;
    const int nb = (int)(((unsigned)(o0 + SL - 1) * magic) >> 32) + 1;
    if (lane < nb) ents[lane] = fb + lane < tw ? __ldg(table + fb + lane) : 0;
  }
  __device__ __forceinline__ Slice slice(const int* ents, int c0) const {
    const int fb = c0 / bs;
    return Slice{base, ents, c0 - fb * bs, bs, sb, ss, magic};
  }
};

// A warp copies rows [0, n) of a slice into `dst` (row stride rs units),
// one copy per lane and step.
template <typename T, class Slice>
__device__ __forceinline__ void copy_slice(const Args& a, const Slice& sl,
                                           T* dst, int n, int lane) {
  const int cpr = a.d * (int)sizeof(T) / a.vw;
  const int mask = (1 << a.cpr_lg) - 1;
  for (int i = lane; i < (n << a.cpr_lg); i += 32) {
    const int r = i >> a.cpr_lg, u = i & mask;
    if (u < cpr)
      cp_async(reinterpret_cast<char*>(dst + r * a.rs * (16 / (int)sizeof(T))) +
                   u * a.vw,
               reinterpret_cast<const char*>(sl.row(r)) + u * a.vw, a.vw);
  }
}

// Shared memory past the K/V ring (which the p.V reduction reuses after the
// loop), in 4-byte words.
__host__ __device__ constexpr int fixed_words(int dp, int g, int c) {
  return MAXG * dp                      // Qs, pre-scaled q
         + WARPS * MAXG * SL            // Pw, each warp's p of its slice
         + 2 * WARPS * MAXG             // Wm, Wl: the warps' (m, l)
         + WARPS * MAXG                 // Wf: their merge weights
         + c * (g * dp + 2 * MAXG)      // Cs: the ranks' states (rank 0)
         + c * MAXG + MAXG              // Cf, Lc: rank 0's merge weights
         + WARPS * STAGES * TBL;        // Tb: table entries (ints)
}

// The shared body: q/o at this (row, kv head), K/V rows by `KV`, keys
// [lo, hi); NG >= G heads are computed.  Every float operation is written
// out, so that the contiguous and paged instantiations compute the same
// bits.  Every thread of every block passes both halves of the two cluster
// barriers.
template <typename T, int DP, int NG, class KV>
__device__ __forceinline__ void dec_body(const Args& a, const T* q, KV k,
                                         KV v, T* o, int lo, int hi,
                                         int region) {
  constexpr int EPU = 16 / sizeof(T);  // elements per 16-byte unit
  constexpr int VPT = 8 / EPU;         // units a lane holds in p.V
  constexpr int NDG = DP / 8;          // 8-column groups of a row
  constexpr int KSW = 32 / NDG;        // key runs of a slice in p.V
  constexpr int KPR = SL / KSW;        // keys per run
  constexpr int CLUSTER = cluster_of(NG);
  static_assert(KSW * KPR == SL, "p.V covers the slice");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31;
  const int g = a.hq / a.hkv;
  const int rse = a.rs * EPU;                       // row stride, elements
  const int ur = (a.d * (int)sizeof(T) + 15) / 16;  // units holding data
  const int cstride = g * DP + 2 * MAXG;            // a rank's state in Cs

  extern __shared__ __align__(16) unsigned char smem[];
  T* Kb = reinterpret_cast<T*>(smem);
  T* Vb = Kb + STAGES * TILE * rse;
  float* Red = reinterpret_cast<float*>(smem);  // after the loop
  float* Qs = reinterpret_cast<float*>(smem + region);
  float* Pw = Qs + MAXG * DP;
  float* Wm = Pw + WARPS * MAXG * SL;
  float* Wl = Wm + WARPS * MAXG;
  float* Wf = Wl + WARPS * MAXG;
  float* Cs = Wf + WARPS * MAXG;
  float* Cf = Cs + CLUSTER * cstride;
  float* Lc = Cf + CLUSTER * MAXG;
  int* Tb = reinterpret_cast<int*>(Lc + MAXG) + w * STAGES * TBL;

  cluster_arrive_relaxed();  // waited on before any store to rank 0

  const int ntiles = hi > lo ? (hi - lo + TILE - 1) / TILE : 0;
  const int nwork = min(CLUSTER, ntiles);  // ranks that hold tiles
  const int mine =
      rank < ntiles ? (ntiles - rank + CLUSTER - 1) / CLUSTER : 0;
  float bm = NEG_INF, bl = 0.f;  // the block's (m, l) of head tid < g

  if (mine > 0) {
    // the unit tail past d is never copied: make it 0 once
    const int tail0 = a.d, tail1 = ur * EPU;
    if (tail1 > tail0)
      for (int i = tid; i < 2 * STAGES * TILE; i += NT)
        for (int c = tail0; c < tail1; ++c)
          Kb[i * rse + c] = from_f<T>(0.f);
    // q's loads go out first; they land while the first copies are issued
    constexpr int QPT = MAXG * DP / NT;
    float qv[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int i = tid + j * NT, hh = i / DP, c = i % DP;
      qv[j] = hh < g && c < a.d ? to_f(q[hh * a.q_sh + c]) : 0.f;
    }
    // this warp's slice of my i-th tile: its first column, its valid keys
    auto cs_of = [&](int i) {
      return lo + (rank + i * CLUSTER) * TILE + w * SL;
    };
    auto n_of = [&](int i) {
      return i < mine ? max(0, min(SL, hi - cs_of(i))) : 0;
    };
    auto issue = [&](int i, int st) {
      const int n = n_of(i);
      const int* ents = Tb + st * TBL;
      if (n)
        copy_slice<T>(a, k.slice(ents, cs_of(i)),
                      Kb + (st * TILE + w * SL) * rse, n, lane);
      cp_commit();
      if (n)
        copy_slice<T>(a, v.slice(ents, cs_of(i)),
                      Vb + (st * TILE + w * SL) * rse, n, lane);
      cp_commit();
    };
#pragma unroll
    for (int i = 0; i < STAGES; ++i)
      if (n_of(i)) k.fetch(Tb + i * TBL, cs_of(i), lane);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < STAGES; ++i) issue(i, i);
#pragma unroll
    for (int j = 0; j < QPT; ++j) Qs[tid + j * NT] = __fmul_rn(qv[j], a.scale);
    __syncthreads();

    float m[NG], l[NG], acc[NG][8];
#pragma unroll
    for (int hh = 0; hh < NG; ++hh) {
      m[hh] = NEG_INF;
      l[hh] = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[hh][c] = 0.f;
    }
    const int key = lane >> 1, half = lane & 1;  // scores
    const int dg = lane % NDG, ks = lane / NDG;  // p.V
    float* pw = Pw + w * MAXG * SL;

    for (int i = 0; i < mine; ++i) {
      const int st = i % STAGES;
      const int n = n_of(i);  // valid keys of this warp's slice
      cp_wait<2 * STAGES - 1>();  // this slice's K
      __syncwarp();
      if (n_of(i + STAGES)) k.fetch(Tb + st * TBL, cs_of(i + STAGES), lane);
      if (n) {
        // scores: two lanes a key, alternate units, every head
        float s[NG];
#pragma unroll
        for (int hh = 0; hh < NG; ++hh) s[hh] = 0.f;
        if (key < n) {
          const T* kr = Kb + (st * TILE + w * SL + key) * rse;
          for (int u = half; u < ur; u += 2) {
            float kx[EPU];
            unit_to_f(kr + u * EPU, kx);
#pragma unroll
            for (int hh = 0; hh < NG; ++hh) {
              const float4* q4 =
                  reinterpret_cast<const float4*>(Qs + hh * DP + u * EPU);
#pragma unroll
              for (int e4 = 0; e4 < EPU / 4; ++e4) {
                const float4 qq = q4[e4];
                s[hh] = fmaf(qq.x, kx[4 * e4], s[hh]);
                s[hh] = fmaf(qq.y, kx[4 * e4 + 1], s[hh]);
                s[hh] = fmaf(qq.z, kx[4 * e4 + 2], s[hh]);
                s[hh] = fmaf(qq.w, kx[4 * e4 + 3], s[hh]);
              }
            }
          }
        }
        // the slice's softmax update, by shuffles over its keys; lanes
        // 2j and 2j + 1 hold key j
#pragma unroll
        for (int hh = 0; hh < NG; ++hh) {
          const float other = __shfl_xor_sync(0xffffffffu, s[hh], 1);
          const float sv = key >= n ? NEG_INF
                           : half  ? __fadd_rn(other, s[hh])
                                   : __fadd_rn(s[hh], other);
          float mx = sv;
#pragma unroll
          for (int off = 2; off < 32; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          // the slice holds a valid key, so m_new is finite and a masked
          // key's p is exp(NEG_INF - m_new) = 0
          const float m_new = fmaxf(m[hh], mx);
          const float p = expf(__fsub_rn(sv, m_new));
          float psum = p;
#pragma unroll
          for (int off = 2; off < 32; off <<= 1)
            psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, off));
          const float alpha = expf(__fsub_rn(m[hh], m_new));
          l[hh] = fmaf(alpha, l[hh], psum);
          m[hh] = m_new;
          if (!half) pw[hh * SL + key] = p;
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[hh][c] = __fmul_rn(acc[hh][c], alpha);
        }
      }
      cp_wait<2 * STAGES - 2>();  // this slice's V
      __syncwarp();
      if (n && dg < ur) {
        // p.V: 8 columns x a run of KPR keys per lane
        const T* vt = Vb + (st * TILE + w * SL) * rse;
#pragma unroll
        for (int j = 0; j < KPR; ++j) {
          const int kk = ks * KPR + j;
          if (kk >= n) break;
          float vx[8];
#pragma unroll
          for (int vv = 0; vv < VPT; ++vv) {
            const int u = dg + vv * NDG;
            if (u < ur) {
              unit_to_f(vt + kk * rse + u * EPU, vx + vv * EPU);
            } else {
#pragma unroll
              for (int e = 0; e < EPU; ++e) vx[vv * EPU + e] = 0.f;
            }
          }
#pragma unroll
          for (int hh = 0; hh < NG; ++hh) {
            const float p = pw[hh * SL + kk];
#pragma unroll
            for (int c = 0; c < 8; ++c)
              acc[hh][c] = fmaf(p, vx[c], acc[hh][c]);
          }
        }
      }
      __syncwarp();  // this slot and pw are rewritten next
      issue(i + STAGES, st);
    }

    // the block's state: its warps merged in warp order, each warp's key
    // runs summed in order
    cp_wait_all();
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < NG; ++hh) {
      if (hh >= g) break;
#pragma unroll
      for (int vv = 0; vv < VPT; ++vv)
#pragma unroll
        for (int e = 0; e < EPU; ++e)
          Red[((w * KSW + ks) * g + hh) * DP + (dg + vv * NDG) * EPU + e] =
              acc[hh][vv * EPU + e];
    }
    if (lane == 0) {
#pragma unroll
      for (int hh = 0; hh < NG; ++hh) {
        if (hh >= g) break;
        Wm[w * MAXG + hh] = m[hh];
        Wl[w * MAXG + hh] = l[hh];
      }
    }
    __syncthreads();
    if (tid < g) {
      for (int ww = 0; ww < WARPS; ++ww) bm = fmaxf(bm, Wm[ww * MAXG + tid]);
      for (int ww = 0; ww < WARPS; ++ww) {
        const float f = expf(__fsub_rn(Wm[ww * MAXG + tid], bm));
        Wf[ww * MAXG + tid] = f;
        bl = fmaf(f, Wl[ww * MAXG + tid], bl);
      }
    }
    __syncthreads();
  }

  // every rank has started, so rank 0's memory may be written
  cluster_wait();
  if (mine > 0) {
    float* dst = cluster.map_shared_rank(Cs, 0) + rank * cstride;
    for (int i = tid; i < g * DP; i += NT) {
      const int hh = i / DP;
      float asum = 0.f;
      for (int ww = 0; ww < WARPS; ++ww) {
        float part = 0.f;
        for (int r = 0; r < KSW; ++r)
          part = __fadd_rn(part, Red[(ww * KSW + r) * g * DP + i]);
        asum = fmaf(Wf[ww * MAXG + hh], part, asum);
      }
      dst[i] = asum;
    }
    if (tid < g) {
      dst[g * DP + tid] = bm;
      dst[g * DP + MAXG + tid] = bl;
    }
  }
  cluster_arrive();
  if (rank != 0) return;
  cluster_wait();  // every rank's state has landed

  // rank 0 merges the ranks that held tiles, in rank order
  if (tid < g) {
    float mx = NEG_INF;
    for (int r = 0; r < nwork; ++r)
      mx = fmaxf(mx, Cs[r * cstride + g * DP + tid]);
    float lsum = 0.f;
    for (int r = 0; r < nwork; ++r) {
      const float f = expf(__fsub_rn(Cs[r * cstride + g * DP + tid], mx));
      Cf[r * MAXG + tid] = f;
      lsum = fmaf(f, Cs[r * cstride + g * DP + MAXG + tid], lsum);
    }
    Lc[tid] = lsum == 0.f ? 1.f : lsum;  // no valid key -> 0
  }
  __syncthreads();
  for (int i = tid; i < g * DP; i += NT) {
    const int hh = i / DP, dc = i % DP;
    if (dc >= a.d) continue;
    float asum = 0.f;
    for (int r = 0; r < nwork; ++r)
      asum = fmaf(Cf[r * MAXG + hh], Cs[r * cstride + i], asum);
    o[hh * a.o_sh + dc] = from_f<T>(__fdiv_rn(asum, Lc[hh]));
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

template <typename T, int DP, int NG>
__global__ void __launch_bounds__(NT) dec_kernel(Args a, int region) {
  const int hk = blockIdx.x / cluster_of(NG), b = blockIdx.y;
  const int g = a.hq / a.hkv;
  const T* q = (const T*)a.q + b * a.q_sb + (long long)hk * g * a.q_sh;
  T* o = (T*)a.o + b * a.o_sb + (long long)hk * g * a.o_sh;
  const Contig<T> k{(const T*)a.k + b * a.k_sb + hk * a.k_sh, a.k_ss};
  const Contig<T> v{(const T*)a.v + b * a.v_sb + hk * a.v_sh, a.v_ss};
  int lo, hi;
  key_range(a, b, &lo, &hi);
  dec_body<T, DP, NG>(a, q, k, v, o, lo, hi, region);
}

template <typename T, int DP, int NG>
__global__ void __launch_bounds__(NT) dec_paged_kernel(Args a, int region) {
  const int hk = blockIdx.x / cluster_of(NG), b = blockIdx.y;
  const int g = a.hq / a.hkv;
  const T* q = (const T*)a.q + b * a.q_sb + (long long)hk * g * a.q_sh;
  T* o = (T*)a.o + b * a.o_sb + (long long)hk * g * a.o_sh;
  const int* trow = a.table + (long long)b * a.tw;
  const Paged<T> k{(const T*)a.k + hk * a.k_sh, trow, a.bs, a.tw,
                   a.k_sb, a.k_ss, a.magic};
  const Paged<T> v{(const T*)a.v + hk * a.v_sh, trow, a.bs, a.tw,
                   a.v_sb, a.v_ss, a.magic};
  int lo, hi;
  key_range(a, b, &lo, &hi);
  dec_body<T, DP, NG>(a, q, k, v, o, lo, hi, region);
}

// 16-byte units per staged K/V row of d elements of es bytes, padded to 2
// mod 4 for conflict-free 16-byte reads.
constexpr int row_units(int d, int es) {
  int rs = (d * es + 15) / 16;
  while (rs % 4 != 2) ++rs;
  return rs;
}

// Bytes of the region that holds the K/V ring, and later every lane's acc
// of g heads for the warps' merge.
constexpr int region_bytes(int rs, int g) {
  const int ring = 2 * STAGES * TILE * rs * 16;
  const int red = 4 * WARPS * 32 * 8 * g;
  return ring > red ? ring : red;
}

// The widest copy (16, 8, 4 or 2 bytes) that every K/V row start and the
// row's length are multiples of.
int copy_width(const Args& a, int es) {
  const long long parts[] = {
      (long long)(uintptr_t)a.k, (long long)(uintptr_t)a.v,
      a.k_sb * es, a.k_ss * es, a.k_sh * es,
      a.v_sb * es, a.v_ss * es, a.v_sh * es, (long long)a.d * es};
  int vw = 16;
  for (long long p : parts)
    while (vw > 2 && p % vw) vw >>= 1;
  return vw;
}

template <typename T, int DP, int NG>
cudaError_t launch(Args a, int b, cudaStream_t stream) {
  constexpr int es = sizeof(T);
  a.vw = copy_width(a, es);
  const int cpr = a.d * es / a.vw;
  a.cpr_lg = 0;
  while ((1 << a.cpr_lg) < cpr) ++a.cpr_lg;
  a.rs = row_units(a.d, es);
  a.magic = a.bs > 0 ? ((1ull << 32) + a.bs - 1) / a.bs : 0;
  const int g = a.hq / a.hkv;
  const int region = region_bytes(a.rs, g);
  const int smem = region + 4 * fixed_words(DP, g, cluster_of(NG));
  const bool paged = a.table != nullptr;
  auto kern = paged ? dec_paged_kernel<T, DP, NG> : dec_kernel<T, DP, NG>;
  // Raise the kernel's shared-memory limit once per device, to the most
  // any call of this instantiation asks for (D = DP, G = NG).
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 32 ? 1ull << (2 * dev + paged) : 0;
  if (!(raised.load() & bit)) {
    constexpr int rs_max = row_units(DP, es);
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        region_bytes(rs_max, NG) + 4 * fixed_words(DP, NG, cluster_of(NG)));
    if (err != cudaSuccess) return err;
    raised.fetch_or(bit);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_of(NG);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.hkv * cluster_of(NG), b);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a, region);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t dispatch_g(const Args& a, int b, cudaStream_t stream) {
  const int g = a.hq / a.hkv;
  if (g == 1) return launch<T, DP, 1>(a, b, stream);
  if (g <= 4) return launch<T, DP, 4>(a, b, stream);
  return launch<T, DP, 8>(a, b, stream);
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int b, cudaStream_t stream) {
  if (a.d <= 32) return dispatch_g<T, 32>(a, b, stream);
  if (a.d <= 64) return dispatch_g<T, 64>(a, b, stream);
  return dispatch_g<T, 128>(a, b, stream);
}

int run(const Args& a, int dtype, int b, void* stream) {
  if (a.d < 1 || a.d > 128 || a.hkv < 1 || a.hq % a.hkv != 0 ||
      a.hq / a.hkv > MAXG || b > 65535 || (a.table && a.bs > 65535))
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
