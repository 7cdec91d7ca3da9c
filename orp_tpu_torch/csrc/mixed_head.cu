// Mixed-date hedge-MLP head: each row runs the forward under its own date's
// params, for sm_90a, in f32 (orp_mixed_head_launch) or in bf16
// (orp_mixed_head_bf16_launch): one kernel template over the element type.
//
// Replaces the TPU kernel orp_tpu/serve/megakernel.py::mixed_head_forward
// (kernel _head_kernel), which computes in the model's dtype: f32, or bf16
// under _eval_core_mixed(precision="bf16"). Plain-PyTorch twin:
// orp_tpu_torch/serve/megakernel.py::mixed_head_plain.
//
// What bounds it on the H100: memory, in principle. A row reads its date
// (4 B) and its features (4 B per feature in f32, 2 B in bf16) and writes
// n_out elements; the forward is ~100 FMAs. At 1M rows of the north-star head
// in f32 that is ~16 MB moved (~5 us at 3.35 TB/s) against ~0.2 GFLOP (~3 us
// at 67 TFLOP/s). In practice the weights bound it: every row needs its
// date's ~100 weights in registers, and shared memory hands a warp at most
// 128 bytes a cycle however many lanes read the same word (a broadcast saves
// bank conflicts, not bandwidth). One row a thread, that is 1M x 106 x 4 B =
// 424 MB through shared memory, ~14 us on 132 SMs, above the bound before any
// arithmetic. With the weights shared by four rows, what is left is
// instruction throughput: the FMAs, bf16's roundings, and the sort's phases
// between barriers
// (PERF.md, Findings).
//
// What the design does about it:
// - the Pallas kernel walks a sequential grid over ALL dates and commits rows
//   by mask (Mosaic has no gathers), doing D times the work. Here each row
//   runs once, under its own date's weights;
// - a thread runs R rows of ONE date together (R = 4, 2 at width 16): each
//   weight is loaded once for R rows, and the R rows' FMA chains are
//   independent work for the scheduler;
// - to find rows that share a date, each tile's rows are count-sorted by
//   date (a shared-atomic histogram over at most 256 date buckets, a block
//   scan, a scatter of row numbers), each bucket padded to a multiple of R
//   with empty slots, so every group of R slots holds one bucket's rows;
// - a warp takes 32 consecutive groups: its lanes span a few neighbouring
//   dates. The params are staged once per block into a padded layout: each
//   layer's weight rows and its bias start on 16 bytes, so a row of weights
//   is read with 16-byte loads (4 f32 or 8 bf16), and one date spans an odd
//   number of 16-byte chunks, so up to 8 consecutive dates fall on distinct
//   banks and a warp's per-lane weight loads do not conflict;
// - a persistent grid (as many blocks as fit on the SMs) walks tiles of up to
//   2,048 rows (fewer where the params leave less room, or where a small
//   request would not fill every block: then down to 256). A tile's dates and
//   features arrive by 16-byte cp.async while the block computes the tile
//   before it (two buffers); each result goes to its row's own place in a
//   shared output tile, stored with coalesced 16-byte stores;
// - dates outside [0, n_dates) go to the last bucket and write NaN rows; with
//   more than 255 dates a bucket holds 2^shift dates, and a group whose rows
//   differ in date runs them one at a time;
// - where the padded params leave no room for even a 32-row tile, the params
//   stay in device memory (read through L1 at their packed layout) and the
//   tile uses all of shared memory;
// - activations stay in registers, and the layer loops are unrolled. The
//   served heads (1-3 features, hidden (8, 8), 2 outputs) have instances with
//   their widths fixed at compile time: no guard, no padded FMA (with the
//   widths read at run time, ptxas kept 3x the FMAs, predicated off; the
//   fixed widths halved the kernel's time, PERF.md). Every other head runs
//   an instance unrolled to a compile-time width W (4, 8 or 16, the smallest
//   that holds every layer) with guards on the runtime widths;
// - HIGHEST-precision semantics: plain f32 FMAs accumulate in input order,
//   then the bias is added, then LeakyReLU; no TF32 and no tensor cores (an
//   mma sums its products in an unspecified order). FMA rounding differs
//   from the reference's separate multiply and add, so results agree at rtol
//   1e-5 / atol 1e-6, not bitwise. Which thread runs a row, beside which
//   others, moves no bit: a row's arithmetic is its own;
// - bf16 follows the JAX package's rounding after every operation: the dot
//   accumulates bf16 operands in f32 (each product is exact in f32, so the
//   FMA chain is the f32 sum of exact products, in input order) and rounds to
//   bf16; the bias is added in f32 and rounded; a negative hidden value is
//   multiplied by the slope rounded to bf16 (passed as its bit pattern) and
//   rounded (two values a conversion, __floats2bfloat162_rn). A rounding
//   separates every multiply from the following add, so nvcc has nothing to
//   contract. It matches mixed_head_plain in bf16 bitwise except where the
//   two sum a dot's f32 partials in another order and the sums round to
//   different bf16 values.
// The launch plan (layouts, tile, buckets, shared-memory offsets) is computed
// by megakernel.head_plan in Python and passed as a Plan, field by field.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxLayers = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;      // the most rows a tile holds (megakernel.TILE_ROWS)
constexpr int kMaxGroup = 4;     // the most rows a thread runs together (megakernel)
constexpr int kStageLoads = 16;  // params loads a thread keeps in flight while staging
constexpr unsigned short kNoRow = 0xffff;  // an empty slot of the sorted tile

// rows a thread runs together at width W: 4, or 2 where 4 would spill
template <int W>
constexpr int kGroupRows = W > 8 ? 2 : kMaxGroup;

// megakernel.head_plan's fields, in this order (megakernel.PLAN_FIELDS)
struct Plan {
  int n_layers;
  int sizes[kMaxLayers + 1];
  int per_date;               // P of the packed (D, P) params
  int src_off[kMaxLayers];    // layer l's weights in a packed row
  int staged;                 // 1: the params are staged in shared memory
  int stride;                 // elements between two dates where the forward reads
  int w_off[kMaxLayers];      // layer l's first weight row there
  int ld[kMaxLayers];         // elements between two of its rows
  int b_off[kMaxLayers];      // its bias
  int tile;                   // rows a tile holds: a multiple of 32, <= kTile
  int shift;                  // a date's bucket is date >> shift
  int n_bins;                 // buckets (<= kThreads); the last holds bad dates
  int o_cnt;                  // byte offsets in dynamic shared memory: bucket
  int o_perm;                 //   counts (kThreads + kWarps ints), sorted slots
  int o_dates;                //   (tile + kThreads * (kMaxGroup - 1) u16), two
  int o_feats;                //   date buffers, two feature buffers, the output
  int o_out;                  //   tile;
  int smem;                   // and the bytes in all
};
constexpr int kPlanInts = (int)(sizeof(Plan) / sizeof(int));

// Layer widths: fixed at compile time for the served heads (1-3 features,
// hidden (8, 8), 2 outputs: north star, Heston, pension), so that no guard and
// no padded FMA is left; read from the plan for every other head, with the
// loops unrolled to the compile-time width W (4, 8 or 16) and guarded.
template <int F0, int H0, int H1, int NO>
struct Fixed {
  static constexpr int kW = (F0 > H0 ? F0 : H0) > H1 ? (F0 > H0 ? F0 : H0) : H1;
  __host__ __device__ static constexpr int layers(const Plan&) { return 3; }
  __host__ __device__ static constexpr int size(const Plan&, int l) {
    return l == 0 ? F0 : l == 1 ? H0 : l == 2 ? H1 : NO;
  }
};

template <int W>
struct Runtime {
  static constexpr int kW = W;
  __device__ static int layers(const Plan& pl) { return pl.n_layers; }
  __device__ static int size(const Plan& pl, int l) { return pl.sizes[l]; }
};

// Element type T in memory, f32 in registers: in() widens, out() narrows for
// the store, rnd() rounds an f32 result to T (the identity in f32).
template <typename T>
struct Num;

template <>
struct Num<float> {
  static constexpr int kVec = 4;  // elements in 16 bytes
  __device__ static float in(float x) { return x; }
  __device__ static float out(float x) { return x; }
  __device__ static float rnd(float x) { return x; }
  __device__ static void rnd2(float&, float&) {}
  __device__ static float nan() { return __int_as_float(0x7fc00000); }
  __device__ static void vec(const float* p, float* w) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
};

template <>
struct Num<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float in(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 out(float x) { return __float2bfloat16_rn(x); }
  __device__ static float rnd(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  // rnd() of two values in one conversion
  __device__ static void rnd2(float& a, float& b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    a = __low2float(h);
    b = __high2float(h);
  }
  __device__ static __nv_bfloat16 nan() { return __ushort_as_bfloat16(0x7fc0); }
  // 8 bf16 widened exactly: element 2i is the low half of word i
  __device__ static void vec(const __nv_bfloat16* p, float* w) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[2 * i] = __uint_as_float(u[i] << 16);
      w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

// Elements [0, n) of a row of weights into w (n <= W): staged rows in 16-byte
// loads (a padded row holds whole vectors), device-memory rows one by one.
template <typename T, int W, bool kStaged>
__device__ __forceinline__ void load_row(const T* p, int n, float (&w)[W]) {
  using N = Num<T>;
  if (kStaged) {
    constexpr int V = N::kVec;
#pragma unroll
    for (int c = 0; c < W; c += V) {
      if (c < n) {
        float t[V];
        N::vec(p + c, t);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (c + e < W) w[c + e] = t[e];
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < n) w[j] = N::in(__ldg(p + j));
    }
  }
}

// The forward of R rows under the params at p, in place on x: each weight is
// loaded once and used by every row (a row's arithmetic is its own).
template <typename T, class D, int R, bool kStaged>
__device__ __forceinline__ void forward(const T* p, const Plan& pl, float slope,
                                        float (&x)[R][D::kW]) {
  using N = Num<T>;
  constexpr int W = D::kW;
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l) {
    if (l < D::layers(pl)) {
      const int fin = D::size(pl, l);
      const int fout = D::size(pl, l + 1);
      const bool hidden = l < D::layers(pl) - 1;
      float acc[R][W] = {};
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (k < fin) {
          float w[W];  // row k of the (fin, fout) weights
          load_row<T, W, kStaged>(p + pl.w_off[l] + k * pl.ld[l], fout, w);
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int j = 0; j < W; ++j) {
              if (j < fout) acc[r][j] = fmaf(x[r][k], w[j], acc[r][j]);
            }
          }
        }
      }
      float b[W] = {};
      load_row<T, W, kStaged>(p + pl.b_off[l], fout, b);
      // v = rnd(rnd(acc) + b), then v >= 0 ? v : rnd(slope * v), two outputs
      // at a time (W is even; a pair's second past fout is computed and dropped)
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int j = 0; j < W; j += 2) {
          float v0 = acc[r][j], v1 = acc[r][j + 1];
          N::rnd2(v0, v1);
          v0 += b[j];
          v1 += b[j + 1];
          N::rnd2(v0, v1);
          if (hidden) {
            float m0 = slope * v0, m1 = slope * v1;
            N::rnd2(m0, m1);
            v0 = v0 >= 0.0f ? v0 : m0;
            v1 = v1 >= 0.0f ? v1 : m1;
          }
          x[r][j] = j < fout ? v0 : 0.0f;
          x[r][j + 1] = j + 1 < fout ? v1 : 0.0f;
        }
      }
    }
  }
}

// Where element e of a packed date row goes in the forward's padded layout.
__device__ __forceinline__ int staged_offset(const Plan& pl, int e) {
  int l = 0;
#pragma unroll
  for (int m = 1; m < kMaxLayers; ++m) {
    if (m < pl.n_layers && e >= pl.src_off[m]) l = m;
  }
  e -= pl.src_off[l];
  const int fin = pl.sizes[l], fout = pl.sizes[l + 1];
  if (e < fin * fout) {
    const int k = e / fout;
    return pl.w_off[l] + k * pl.ld[l] + (e - k * fout);
  }
  return pl.b_off[l] + e - fin * fout;
}

// Every date's params into the padded layout. A thread owns one element e of a
// date row (its place computed once) for every G-th date, G = the date rows
// that fit in the block side by side, and keeps kStageLoads loads in flight.
template <typename T>
__device__ __forceinline__ void stage_params(T* wsm, const T* __restrict__ params,
                                             const Plan& pl, int n_dates) {
  const int per = pl.per_date;
  const int groups = per < kThreads ? kThreads / per : 1;
  const int g = threadIdx.x / per;
  if (g >= groups) return;
  for (int e = threadIdx.x - g * per; e < per; e += kThreads) {
    const int dst = staged_offset(pl, e);
    for (int d0 = g; d0 < n_dates; d0 += groups * kStageLoads) {
      T v[kStageLoads];
#pragma unroll
      for (int u = 0; u < kStageLoads; ++u) {
        const int d = d0 + u * groups;
        if (d < n_dates) v[u] = params[(size_t)d * per + e];
      }
#pragma unroll
      for (int u = 0; u < kStageLoads; ++u) {
        const int d = d0 + u * groups;
        if (d < n_dates) wsm[d * pl.stride + dst] = v[u];
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// n elements from device to shared memory: 16-byte cp.async where both sides
// allow it (vec), the rest one by one.
template <typename E>
__device__ __forceinline__ void load_async(E* dst, const E* src, int n, bool vec) {
  constexpr int V = 16 / sizeof(E);
  const int nv = vec ? n / V : 0;
  for (int c = threadIdx.x; c < nv; c += kThreads) cp_async16(dst + c * V, src + c * V);
  for (int e = nv * V + threadIdx.x; e < n; e += kThreads) dst[e] = src[e];
}

// n elements from shared to device memory: 16-byte stores where vec, the rest one by one.
template <typename E>
__device__ __forceinline__ void store_tile(E* dst, const E* src, int n, bool vec) {
  constexpr int V = 16 / sizeof(E);
  const int nv = vec ? n / V : 0;
  for (int c = threadIdx.x; c < nv; c += kThreads) {
    *reinterpret_cast<uint4*>(dst + c * V) = *reinterpret_cast<const uint4*>(src + c * V);
  }
  for (int e = nv * V + threadIdx.x; e < n; e += kThreads) dst[e] = src[e];
}

// Bucket b's slots start at a multiple of R: in place, cnt[b] becomes the sum
// of cnt[0..b), each rounded up to R, for b < n_bins (<= kThreads), and the
// slots the rounding adds at a bucket's end are marked kNoRow. Returns the
// slots in all.
template <int R>
__device__ __forceinline__ int bucket_starts(int* cnt, int* wsum, unsigned short* perm,
                                             int n_bins) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = t < n_bins ? cnt[t] : 0;
  const int v = (n + R - 1) / R * R;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) wsum[lane] = s;
  }
  __syncthreads();
  const int start = (warp ? wsum[warp - 1] : 0) + inc - v;
  if (t < n_bins) {
    cnt[t] = start;
    for (int e = n; e < v; ++e) perm[start + e] = kNoRow;
  }
  const int total = wsum[kWarps - 1];
  __syncthreads();
  return total;
}

// rows: a tile's rows in this launch (a multiple of 32, <= pl.tile, which sizes
// the buffers); vec bit 0: dates, bit 1: feats, bit 2: out start on 16 bytes
template <typename T, class D, bool kStaged>
__global__ void __launch_bounds__(kThreads, 2)
mixed_head_kernel(const int* __restrict__ dates, const T* __restrict__ feats,
                  const T* __restrict__ params, T* __restrict__ out, long long n_rows,
                  int n_dates, Plan pl, int rows, float slope, int vec) {
  using N = Num<T>;
  constexpr int W = D::kW;
  constexpr int R = kGroupRows<W>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* wsm = reinterpret_cast<T*>(smem);
  int* cnt = reinterpret_cast<int*>(smem + pl.o_cnt);
  int* wsum = cnt + kThreads;
  unsigned short* perm = reinterpret_cast<unsigned short*>(smem + pl.o_perm);
  int* dbuf = reinterpret_cast<int*>(smem + pl.o_dates);
  T* fbuf = reinterpret_cast<T*>(smem + pl.o_feats);
  T* obuf = reinterpret_cast<T*>(smem + pl.o_out);
  const int f0 = D::size(pl, 0);
  const int n_out = D::size(pl, D::layers(pl));
  const long long n_tiles = (n_rows + rows - 1) / rows;
  auto rows_of = [&](long long t) {
    const long long left = n_rows - t * rows;
    return (int)(left < rows ? left : rows);
  };
  auto prefetch = [&](long long t, int b) {
    const long long r0 = t * rows;
    const int n = rows_of(t);
    load_async(dbuf + b * pl.tile, dates + r0, n, vec & 1);
    load_async(fbuf + b * pl.tile * f0, feats + r0 * f0, n * f0, vec & 2);
  };
  auto bucket = [&](int d) {
    return (unsigned)d < (unsigned)n_dates ? d >> pl.shift : pl.n_bins - 1;
  };

  long long tile = blockIdx.x;
  if (tile < n_tiles) prefetch(tile, 0);
  cp_async_commit();
  // the params go to shared memory while the first tile lands
  if (kStaged) stage_params(wsm, params, pl, n_dates);
  for (int b = threadIdx.x; b < pl.n_bins; b += kThreads) cnt[b] = 0;

  for (int buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    if (tile + gridDim.x < n_tiles) prefetch(tile + gridDim.x, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();  // this tile's copies (an empty group stands for the next)
    __syncthreads();
    const int n = rows_of(tile);
    const int* dts = dbuf + buf * pl.tile;
    const T* fts = fbuf + buf * pl.tile * f0;

    // count-sort the tile's rows by date bucket, buckets padded to R slots
    constexpr int kPerThread = kTile / kThreads;
    int rank[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < n) rank[k] = atomicAdd(&cnt[bucket(dts[i])], 1);
    }
    __syncthreads();
    const int n_groups = bucket_starts<R>(cnt, wsum, perm, pl.n_bins) / R;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < n) perm[cnt[bucket(dts[i])] + rank[k]] = (unsigned short)i;
    }
    __syncthreads();

    // the forward, R rows of one bucket a thread; a warp takes 32 neighbouring
    // groups. A group's first slot always holds a row; empty slots copy it.
#pragma unroll 1
    for (int g = threadIdx.x; g < n_groups; g += kThreads) {
      int row[R];
#pragma unroll
      for (int r = 0; r < R; ++r) row[r] = perm[g * R + r];
      const int d = dts[row[0]];
      bool mixed = false;  // only where a bucket holds several dates
#pragma unroll
      for (int r = 1; r < R; ++r) mixed |= row[r] != kNoRow && dts[row[r]] != d;
      // one pass for the group, or one pass a row where its dates differ
      for (int pass = 0; pass < (mixed ? R : 1); ++pass) {
        int own = row[0];  // row[pass], by selects (no indexed local array)
#pragma unroll
        for (int r = 1; r < R; ++r) own = r == pass ? row[r] : own;
        if (own == kNoRow) continue;
        int use[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int q = mixed ? own : row[r];
          use[r] = q == kNoRow ? row[0] : q;
        }
        const int dd = dts[use[0]];
        if ((unsigned)dd >= (unsigned)n_dates) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r == 0 || (!mixed && row[r] != kNoRow)) {
              for (int j = 0; j < n_out; ++j) obuf[use[r] * n_out + j] = N::nan();
            }
          }
          continue;
        }
        const T* p = (kStaged ? wsm : params) + (size_t)dd * pl.stride;
        float x[R][W];
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int j = 0; j < W; ++j) x[r][j] = j < f0 ? N::in(fts[use[r] * f0 + j]) : 0.0f;
        }
        forward<T, D, R, kStaged>(p, pl, slope, x);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r == 0 || (!mixed && row[r] != kNoRow)) {
#pragma unroll
            for (int j = 0; j < W; ++j) {
              if (j < n_out) obuf[use[r] * n_out + j] = N::out(x[r][j]);
            }
          }
        }
      }
    }
    __syncthreads();
    for (int b = threadIdx.x; b < pl.n_bins; b += kThreads) cnt[b] = 0;
    store_tile(out + tile * rows * n_out, obuf, n * n_out, vec & 4);
  }
}

template <typename T, class D, bool kStaged>
int launch(const int* dates, const T* feats, const T* params, T* out, long long n_rows,
           int n_dates, const Plan& pl, float slope, int vec, cudaStream_t stream) {
  auto* kernel = mixed_head_kernel<T, D, kStaged>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       pl.smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 132, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, pl.smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // full tiles where the rows fill every block's slot; fewer rows a tile (down
  // to one a thread) where they do not, so that a small request still spreads
  const long long cap = (long long)per_sm * sms;
  long long rows = (n_rows + cap - 1) / cap;
  rows = rows < kThreads ? kThreads : (rows + 31) / 32 * 32;
  if (rows > pl.tile) rows = pl.tile;
  const long long tiles = (n_rows + rows - 1) / rows;
  const long long blocks = tiles < cap ? tiles : cap;
  kernel<<<(unsigned)blocks, kThreads, pl.smem, stream>>>(dates, feats, params, out, n_rows,
                                                         n_dates, pl, (int)rows, slope, vec);
  return (int)cudaGetLastError();
}

// The served heads' fixed widths where they match; else W, the smallest
// compile-time width (4, 8 or 16) that holds every layer.
template <typename T>
int dispatch(const void* dates, const void* feats, const void* params, void* out,
             long long n_rows, int n_dates, const int* plan, int n_plan, float slope,
             void* stream) {
  if (n_plan != kPlanInts) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return 0;
  Plan pl;
  memcpy(&pl, plan, sizeof pl);
  if (pl.n_layers < 1 || pl.n_layers > kMaxLayers || pl.tile < 32 || pl.tile > kTile ||
      pl.tile % 32 || pl.n_bins < 1 || pl.n_bins > kThreads)
    return (int)cudaErrorInvalidValue;
  int width = 0;
  for (int l = 0; l <= pl.n_layers; ++l) width = pl.sizes[l] > width ? pl.sizes[l] : width;
  // 16-byte tile copies need 16-byte starts; a tile's offset keeps them
  int vec = 0;
  if ((uintptr_t)dates % 16 == 0) vec |= 1;
  if ((uintptr_t)feats % 16 == 0) vec |= 2;
  if ((uintptr_t)out % 16 == 0) vec |= 4;
  const int* d = (const int*)dates;
  const T* f = (const T*)feats;
  const T* p = (const T*)params;
  T* o = (T*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const int* z = pl.sizes;
  if (pl.staged && pl.n_layers == 3 && z[1] == 8 && z[2] == 8 && z[3] == 2) {
    if (z[0] == 1) return launch<T, Fixed<1, 8, 8, 2>, true>(d, f, p, o, n_rows, n_dates, pl,
                                                             slope, vec, s);
    if (z[0] == 2) return launch<T, Fixed<2, 8, 8, 2>, true>(d, f, p, o, n_rows, n_dates, pl,
                                                             slope, vec, s);
    if (z[0] == 3) return launch<T, Fixed<3, 8, 8, 2>, true>(d, f, p, o, n_rows, n_dates, pl,
                                                             slope, vec, s);
  }
#define ORP_HEAD_LAUNCH(W_)                                                               \
  return pl.staged                                                                        \
             ? launch<T, Runtime<W_>, true>(d, f, p, o, n_rows, n_dates, pl, slope, vec, s) \
             : launch<T, Runtime<W_>, false>(d, f, p, o, n_rows, n_dates, pl, slope, vec, s)
  if (width <= 4) ORP_HEAD_LAUNCH(4);
  if (width <= 8) ORP_HEAD_LAUNCH(8);
  if (width <= 16) ORP_HEAD_LAUNCH(16);
#undef ORP_HEAD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// plan: megakernel.head_plan's n_plan ints (the Plan struct's fields in order)
extern "C" int orp_mixed_head_launch(const void* dates, const void* feats,
                                     const void* params, void* out, long long n_rows,
                                     int n_dates, const int* plan, int n_plan, float slope,
                                     void* stream) {
  return dispatch<float>(dates, feats, params, out, n_rows, n_dates, plan, n_plan, slope,
                         stream);
}

// slope_bits: the LeakyReLU slope already rounded to bf16, as its bit pattern
extern "C" int orp_mixed_head_bf16_launch(const void* dates, const void* feats,
                                          const void* params, void* out, long long n_rows,
                                          int n_dates, const int* plan, int n_plan,
                                          unsigned short slope_bits, void* stream) {
  const uint32_t wide = (uint32_t)slope_bits << 16;
  float slope;
  memcpy(&slope, &wide, sizeof slope);
  return dispatch<__nv_bfloat16>(dates, feats, params, out, n_rows, n_dates, plan, n_plan,
                                 slope, stream);
}

extern "C" const char* orp_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
