// Fused scrambled-Sobol -> AS241 inverse normal -> log-GBM knots, for sm_90a.
//
// Replaces the TPU kernel orp_tpu/qmc/pallas_sobol.py::gbm_log_pallas
// (kernels _gbm_kernel and _gbm_kernel_chunk; helpers _sobol_u, _sobol_z,
// _ndtri_f32). Plain-PyTorch twin: orp_tpu_torch/qmc/fused_gbm.py::gbm_log_plain.
//
// What bounds it on the H100: arithmetic. Per path-step the kernel does a
// 32-term masked XOR, two bit reversals, four multiply-xor hash rounds and an
// f32 rational polynomial (plus log and sqrt on the ~15% of draws in the
// tails), ~150 integer and f32 operations, against 4 bytes stored per path
// per KNOT (one knot every store_every steps). At 1M paths x 364 steps the
// stores are 222 MB (~66 us at 3.35 TB/s) while the operations take
// milliseconds.
//
// What the design does about it:
// - one thread per path; the path's log-state lives in a register for all
//   steps and only knots reach device memory (the TPU kernel's VMEM-resident
//   carry, without its (8, 128) tiling, its power-of-two block rule or its
//   64-knot chunk chain, which exist only for the TPU);
// - the Sobol draw and AS241 are sobol_device.cuh's (shared with
//   fused_mf.cu): the index bits are fixed for the whole path, so their
//   all-ones masks are built once and the XOR is branch-free; the direction
//   row of step t is a warp-wide broadcast __ldg (a 10-year daily grid is
//   467 KB and never needs staging); __brev does each bit reversal in one
//   instruction; only the AS241 branch a draw needs is evaluated (warps
//   diverge on ~15% tail draws);
// - no fast math: logf/sqrtf/expf and the divisions are the IEEE-accurate
//   versions. nvcc still contracts a*b+c into FMA, which the CPU reference
//   does not, so paths agree at rtol 3e-5, not bitwise.
// - knots are stored knot-major, so a warp's stores are coalesced.

#include "sobol_device.cuh"

namespace {

__global__ void __launch_bounds__(256)
fused_gbm_kernel(const uint32_t* __restrict__ dirs, float* __restrict__ out,
                 unsigned long long n_paths, int n_steps, int store_every,
                 uint32_t seed, float c0, float vol_sdt, float s0) {
  const unsigned long long g =
      (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_paths) return;
  uint32_t mask[32];
  orp::index_masks((uint32_t)g, mask);  // the Sobol point index of this path
  float logs = 0.0f;
  out[g] = s0;  // knot 0: s0 * exp(0)
  unsigned long long knot = 1;
  for (int t = 1; t <= n_steps; ++t) {
    const float u = orp::sobol_uniform(dirs, mask, (uint32_t)(t - 1), seed);
    logs = logs + c0 + vol_sdt * orp::ndtri_as241(u);
    if (t % store_every == 0) {
      out[knot * n_paths + g] = s0 * expf(logs);
      ++knot;
    }
  }
}

}  // namespace

extern "C" int orp_fused_gbm_launch(const void* dirs, void* out,
                                    unsigned long long n_paths, int n_steps,
                                    int store_every, uint32_t seed, float c0,
                                    float vol_sdt, float s0, void* stream) {
  const unsigned threads = 256;
  const unsigned long long blocks = (n_paths + threads - 1) / threads;
  fused_gbm_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)dirs, (float*)out, n_paths, n_steps, store_every, seed,
      c0, vol_sdt, s0);
  return (int)cudaGetLastError();
}

extern "C" const char* orp_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
