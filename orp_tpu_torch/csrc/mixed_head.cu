// Mixed-date hedge-MLP head: each row runs the forward under its own date's
// params, for sm_90a.
//
// Replaces the TPU kernel orp_tpu/serve/megakernel.py::mixed_head_forward
// (kernel _head_kernel). Plain-PyTorch twin:
// orp_tpu_torch/serve/megakernel.py::mixed_head_plain.
//
// What bounds it on the H100: memory. A row reads its date (4 B) and its
// features (4 B per feature) and writes n_out * 4 B; the forward is ~100
// FMAs. At 1M rows that is ~16 MB moved (~5 us at 3.35 TB/s) against ~0.2
// GFLOP (~3 us at 67 TFLOP/s). This simple version runs ~14x slower than
// that bound for reasons not yet found: bank conflicts between the dates of
// a warp's rows explain at most a third of it (PERF.md, Findings).
//
// What the design does about it:
// - the Pallas kernel walks a sequential grid over ALL dates and commits rows
//   by mask (Mosaic has no gathers), doing D times the work. Here each thread
//   owns one row and gathers its own date's weights: one forward per row;
// - every date's params (52 dates x 106 floats = 22 KB for the north-star
//   head) are staged once per block in shared memory; a grid-stride loop over
//   rows keeps the number of blocks to a few per SM, so the staging is paid
//   a few hundred times, not once per 256 rows;
// - activations stay in registers: the layer loops are unrolled to a compile-
//   time width W (4, 8 or 16, the smallest that holds every layer) with
//   guards on the runtime widths, so every index is a constant;
// - HIGHEST-precision semantics: plain f32 FMAs accumulate in input order,
//   then the bias is added, then LeakyReLU; no TF32 anywhere. FMA rounding
//   differs from the reference's separate multiply and add, so results agree
//   at rtol 1e-5 / atol 1e-6, not bitwise.
// A date outside [0, n_dates) writes NaN rows instead of reading out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 4;

struct HeadShape {
  int n_layers;
  int sizes[kMaxLayers + 1];
  int offs[kMaxLayers];  // offset of layer l's weights inside one date's params
  int per_date;          // floats of params per date
};

template <int W>
__global__ void __launch_bounds__(256)
mixed_head_kernel(const int* __restrict__ dates, const float* __restrict__ feats,
                  const float* __restrict__ params, float* __restrict__ out,
                  long long n_rows, int n_dates, HeadShape sh, float slope) {
  extern __shared__ float wsm[];
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
      for (int j = 0; j < n_out; ++j) out[r * n_out + j] = __int_as_float(0x7fc00000);  // NaN
      continue;
    }
    const float* p = wsm + (size_t)d * sh.per_date;
    float x[W];
#pragma unroll
    for (int k = 0; k < W; ++k) x[k] = k < f0 ? feats[r * f0 + k] : 0.0f;
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l) {
      if (l < sh.n_layers) {
        const int fin = sh.sizes[l];
        const int fout = sh.sizes[l + 1];
        const float* w = p + sh.offs[l];  // (fin, fout), row-major
        const float* b = w + fin * fout;
        const bool hidden = l < sh.n_layers - 1;
        float y[W];
#pragma unroll
        for (int j = 0; j < W; ++j) {
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < W; ++k) {
            if (k < fin && j < fout) acc = fmaf(x[k], w[k * fout + j], acc);
          }
          float v = j < fout ? acc + b[j] : 0.0f;
          if (hidden) v = v >= 0.0f ? v : slope * v;
          y[j] = v;
        }
#pragma unroll
        for (int j = 0; j < W; ++j) x[j] = y[j];
      }
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < n_out) out[r * n_out + j] = x[j];
    }
  }
}

template <int W>
int launch(const int* dates, const float* feats, const float* params, float* out,
           long long n_rows, int n_dates, const HeadShape& sh, float slope,
           cudaStream_t stream) {
  const size_t smem = (size_t)n_dates * sh.per_date * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mixed_head_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int threads = 256;
  long long blocks = (n_rows + threads - 1) / threads;
  const long long cap = 4LL * sms;
  if (blocks > cap) blocks = cap;
  mixed_head_kernel<W><<<(unsigned)blocks, threads, smem, stream>>>(
      dates, feats, params, out, n_rows, n_dates, sh, slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int orp_mixed_head_launch(const void* dates, const void* feats,
                                     const void* params, void* out, long long n_rows,
                                     int n_dates, int n_layers, const int* sizes,
                                     float slope, void* stream) {
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
  const float* f = (const float*)feats;
  const float* p = (const float*)params;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (width <= 4) return launch<4>(d, f, p, o, n_rows, n_dates, sh, slope, s);
  if (width <= 8) return launch<8>(d, f, p, o, n_rows, n_dates, sh, slope, s);
  if (width <= 16) return launch<16>(d, f, p, o, n_rows, n_dates, sh, slope, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* orp_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
