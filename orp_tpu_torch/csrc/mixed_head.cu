// Mixed-date hedge-MLP head: each row runs the forward under its own date's
// params, for sm_90a, in f32 (orp_mixed_head_launch) or in bf16
// (orp_mixed_head_bf16_launch): one kernel template over the element type.
//
// Replaces the TPU kernel orp_tpu/serve/megakernel.py::mixed_head_forward
// (kernel _head_kernel), which computes in the model's dtype: f32, or bf16
// under _eval_core_mixed(precision="bf16"). Plain-PyTorch twin:
// orp_tpu_torch/serve/megakernel.py::mixed_head_plain.
//
// What bounds it on the H100: memory. A row reads its date (4 B) and its
// features (4 B per feature in f32, 2 B in bf16) and writes n_out elements;
// the forward is ~100 FMAs. At 1M rows in f32 that is ~16 MB moved (~5 us at
// 3.35 TB/s) against ~0.2 GFLOP (~3 us at 67 TFLOP/s). This simple version
// runs ~14x slower than that bound for reasons not yet found: bank conflicts
// between the dates of a warp's rows explain at most a third of it (PERF.md,
// Findings).
//
// What the design does about it:
// - the Pallas kernel walks a sequential grid over ALL dates and commits rows
//   by mask (Mosaic has no gathers), doing D times the work. Here each thread
//   owns one row and gathers its own date's weights: one forward per row;
// - every date's params (52 dates x 106 = 22 KB in f32, 11 KB in bf16, for
//   the north-star head) are staged once per block in shared memory; a
//   grid-stride loop over rows keeps the number of blocks to a few per SM, so
//   the staging is paid a few hundred times, not once per 256 rows;
// - activations stay in registers: the layer loops are unrolled to a compile-
//   time width W (4, 8 or 16, the smallest that holds every layer) with
//   guards on the runtime widths, so every index is a constant;
// - HIGHEST-precision semantics: plain f32 FMAs accumulate in input order,
//   then the bias is added, then LeakyReLU; no TF32 anywhere. FMA rounding
//   differs from the reference's separate multiply and add, so results agree
//   at rtol 1e-5 / atol 1e-6, not bitwise;
// - bf16 follows the JAX package's rounding after every operation: the dot
//   accumulates bf16 operands in f32 (each product is exact in f32, so the
//   FMA chain is the f32 sum of exact products, in input order) and rounds to
//   bf16; the bias is added in f32 and rounded; a negative hidden value is
//   multiplied by the slope rounded to bf16 (passed as its bit pattern) and
//   rounded. A rounding separates every multiply from the following add, so
//   nvcc has nothing to contract. It matches mixed_head_plain in bf16 bitwise
//   except where the two sum a dot's f32 partials in another order and the
//   sums round to different bf16 values.
// A date outside [0, n_dates) writes NaN rows instead of reading out of bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxLayers = 4;

struct HeadShape {
  int n_layers;
  int sizes[kMaxLayers + 1];
  int offs[kMaxLayers];  // offset of layer l's weights inside one date's params
  int per_date;          // elements of params per date
};

// Element type T in memory, f32 in registers: in() widens, out() narrows for
// the store, rnd() rounds an f32 result to T (the identity in f32).
template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float in(float x) { return x; }
  __device__ static float out(float x) { return x; }
  __device__ static float rnd(float x) { return x; }
  __device__ static float nan() { return __int_as_float(0x7fc00000); }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float in(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 out(float x) { return __float2bfloat16_rn(x); }
  __device__ static float rnd(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  __device__ static __nv_bfloat16 nan() { return __ushort_as_bfloat16(0x7fc0); }
};

template <typename T, int W>
__global__ void __launch_bounds__(256)
mixed_head_kernel(const int* __restrict__ dates, const T* __restrict__ feats,
                  const T* __restrict__ params, T* __restrict__ out,
                  long long n_rows, int n_dates, HeadShape sh, float slope) {
  using N = Num<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wsm = reinterpret_cast<T*>(smem_raw);
  const int total = n_dates * sh.per_date;
  for (int i = threadIdx.x; i < total; i += blockDim.x) wsm[i] = params[i];
  __syncthreads();

  const int f0 = sh.sizes[0];
  const int n_out = sh.sizes[sh.n_layers];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n_rows;
       r += stride) {
    const int d = dates[r];
    if (d < 0 || d >= n_dates) {
      for (int j = 0; j < n_out; ++j) out[r * n_out + j] = N::nan();
      continue;
    }
    const T* p = wsm + (size_t)d * sh.per_date;
    float x[W];
#pragma unroll
    for (int k = 0; k < W; ++k) x[k] = k < f0 ? N::in(feats[r * f0 + k]) : 0.0f;
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l) {
      if (l < sh.n_layers) {
        const int fin = sh.sizes[l];
        const int fout = sh.sizes[l + 1];
        const T* w = p + sh.offs[l];  // (fin, fout), row-major
        const T* b = w + fin * fout;
        const bool hidden = l < sh.n_layers - 1;
        float y[W];
#pragma unroll
        for (int j = 0; j < W; ++j) {
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < W; ++k) {
            if (k < fin && j < fout) acc = fmaf(x[k], N::in(w[k * fout + j]), acc);
          }
          float v = j < fout ? N::rnd(N::rnd(acc) + N::in(b[j])) : 0.0f;
          if (hidden) v = v >= 0.0f ? v : N::rnd(slope * v);
          y[j] = v;
        }
#pragma unroll
        for (int j = 0; j < W; ++j) x[j] = y[j];
      }
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < n_out) out[r * n_out + j] = N::out(x[j]);
    }
  }
}

template <typename T, int W>
int launch(const int* dates, const T* feats, const T* params, T* out, long long n_rows,
           int n_dates, const HeadShape& sh, float slope, cudaStream_t stream) {
  const size_t smem = (size_t)n_dates * sh.per_date * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mixed_head_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int threads = 256;
  long long blocks = (n_rows + threads - 1) / threads;
  const long long cap = 4LL * sms;
  if (blocks > cap) blocks = cap;
  mixed_head_kernel<T, W><<<(unsigned)blocks, threads, smem, stream>>>(
      dates, feats, params, out, n_rows, n_dates, sh, slope);
  return (int)cudaGetLastError();
}

// Layer offsets and the widest layer; W is the smallest compile-time width
// (4, 8 or 16) that holds every layer.
template <typename T>
int dispatch(const void* dates, const void* feats, const void* params, void* out,
             long long n_rows, int n_dates, int n_layers, const int* sizes, float slope,
             void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  HeadShape sh;
  sh.n_layers = n_layers;
  int width = 0, off = 0;
  for (int l = 0; l <= kMaxLayers; ++l) sh.sizes[l] = l <= n_layers ? sizes[l] : 0;
  for (int l = 0; l < kMaxLayers; ++l) {
    sh.offs[l] = off;
    if (l < n_layers) off += sh.sizes[l] * sh.sizes[l + 1] + sh.sizes[l + 1];
  }
  sh.per_date = off;
  for (int l = 0; l <= n_layers; ++l) width = sh.sizes[l] > width ? sh.sizes[l] : width;
  const int* d = (const int*)dates;
  const T* f = (const T*)feats;
  const T* p = (const T*)params;
  T* o = (T*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (width <= 4) return launch<T, 4>(d, f, p, o, n_rows, n_dates, sh, slope, s);
  if (width <= 8) return launch<T, 8>(d, f, p, o, n_rows, n_dates, sh, slope, s);
  if (width <= 16) return launch<T, 16>(d, f, p, o, n_rows, n_dates, sh, slope, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int orp_mixed_head_launch(const void* dates, const void* feats,
                                     const void* params, void* out, long long n_rows,
                                     int n_dates, int n_layers, const int* sizes,
                                     float slope, void* stream) {
  return dispatch<float>(dates, feats, params, out, n_rows, n_dates, n_layers, sizes, slope,
                         stream);
}

// slope_bits: the LeakyReLU slope already rounded to bf16, as its bit pattern
extern "C" int orp_mixed_head_bf16_launch(const void* dates, const void* feats,
                                          const void* params, void* out, long long n_rows,
                                          int n_dates, int n_layers, const int* sizes,
                                          unsigned short slope_bits, void* stream) {
  const uint32_t wide = (uint32_t)slope_bits << 16;
  float slope;
  memcpy(&slope, &wide, sizeof slope);
  return dispatch<__nv_bfloat16>(dates, feats, params, out, n_rows, n_dates, n_layers, sizes,
                                 slope, stream);
}

extern "C" const char* orp_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
