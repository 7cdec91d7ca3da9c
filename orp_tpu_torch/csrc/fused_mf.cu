// Fused multi-factor scrambled-Sobol path kernels for sm_90a: 2-factor Heston
// under full-truncation Euler and under Andersen QE-M.
//
// Replaces the TPU kernels of orp_tpu/qmc/pallas_mf.py: the generic driver
// _run_mf / _mf_kernel (:106, :49) as the template mf_kernel<Step>, with
// heston_log_pallas (:155) as Step = HestonEuler and heston_qe_pallas (:202)
// as Step = HestonQE. Plain-PyTorch twins: orp_tpu_torch/qmc/fused_mf.py
// (heston_log_plain, heston_qe_plain).
//
// Semantics: at step t (1-based) factor f draws Sobol dimension
// (t-1)*kFactors + f of the path's own index, as the scrambled uniform; the
// step turns it into a normal (AS241) or, for QE's variance factor, also
// uses it raw, so the exponential branch's complement is the exact 1 - u.
// The output slots are stored every store_every steps, knot-major.
//
// What bounds it on the H100: arithmetic. Per path-step: two Sobol words
// (32-term masked XOR, two bit reversals, the Laine-Karras hash each), two
// AS241 evaluations, and for QE about forty f32 operations with four square
// roots and one or two logarithms. Against that the kernel stores 8 bytes per
// path per knot: at 1M paths x 364 steps, 53 knots, 444 MB (~0.13 ms at
// 3.35 TB/s), while the operations take about a millisecond at the card's
// peak rates.
//
// What the design does about it:
// - one thread per path, the whole state in registers for all steps, only
//   knots reach device memory (the TPU kernel's VMEM carry, without its
//   power-of-two block rule, its (rows, 128) tiling or its static/dynamic
//   knot-store split, which exist only for the TPU; any n_paths up to 2^32);
// - the path's index masks are built once and shared by both factors' XORs;
//   the direction rows (728 x 128 B = 93 KB at 364 steps) are warp-wide
//   broadcast __ldg loads (sobol_device.cuh);
// - QE's A <= 0 martingale correction is the template flag kCorrected, not a
//   per-element test, as it is a trace-time branch in JAX; only the selected
//   variance branch (and its log) is evaluated, which leaves the result
//   unchanged;
// - the host-f64 constants (qe_step_constants) arrive as f32 values rounded
//   once, the rule fused_gbm.cu follows; constants in the code are
//   f-suffixed. No fast math; nvcc contracts a*b+c into FMA, so paths agree
//   with the plain version to f32 tolerance, not bitwise.

#include "sobol_device.cuh"

namespace {

constexpr int kMaxSlots = 4;

struct Outs {
  float* p[kMaxSlots];
};

template <class Step>
__global__ void __launch_bounds__(256)
mf_kernel(const uint32_t* __restrict__ dirs, Outs outs, unsigned long long n_paths,
          int n_steps, int store_every, uint32_t seed, Step step) {
  const unsigned long long g =
      (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_paths) return;
  uint32_t mask[32];
  orp::index_masks((uint32_t)g, mask);  // the Sobol point index of this path
  float state[Step::kSlots];
  step.init(state);
#pragma unroll
  for (int j = 0; j < Step::kSlots; ++j) outs.p[j][g] = state[j];
  unsigned long long knot = 1;
  for (int t = 1; t <= n_steps; ++t) {
    float u[Step::kFactors];
#pragma unroll
    for (int f = 0; f < Step::kFactors; ++f) {
      u[f] = orp::sobol_uniform(dirs, mask, (uint32_t)((t - 1) * Step::kFactors + f), seed);
    }
    step.advance(state, u);
    if (t % store_every == 0) {
#pragma unroll
      for (int j = 0; j < Step::kSlots; ++j) outs.p[j][knot * n_paths + g] = state[j];
      ++knot;
    }
  }
}

// state (log-return, variance); factor 0 the asset's own normal, 1 the variance's
struct HestonEuler {
  static constexpr int kFactors = 2;
  static constexpr int kSlots = 2;
  float v0, mu, kappa, theta, xi, rho, rho_c, dt, sdt;

  __device__ void init(float (&s)[kSlots]) const {
    s[0] = 0.0f;
    s[1] = v0;
  }

  __device__ void advance(float (&s)[kSlots], const float (&u)[kFactors]) const {
    const float z0 = orp::ndtri_as241(u[0]);
    const float z1 = orp::ndtri_as241(u[1]);
    const float vp = fmaxf(s[1], 0.0f);
    const float zs = rho * z1 + rho_c * z0;
    const float sv = sqrtf(vp);
    s[0] = s[0] + (mu - 0.5f * vp) * dt + sv * sdt * zs;
    s[1] = s[1] + kappa * (theta - vp) * dt + xi * sv * sdt * z1;
  }
};

// state (log-return, variance); factor 0 the asset's normal, 1 the RAW uniform
template <bool kCorrected>
struct HestonQE {
  static constexpr int kFactors = 2;
  static constexpr int kSlots = 2;
  float v0, theta, E, c1, c2, k1, k2, k3, k4, A, k13, mu_dt, k0, psi_c;

  __device__ void init(float (&s)[kSlots]) const {
    s[0] = 0.0f;
    s[1] = v0;
  }

  __device__ void advance(float (&s)[kSlots], const float (&u)[kFactors]) const {
    const float tiny = 1e-12f;
    const float zs = orp::ndtri_as241(u[0]);
    const float uv = u[1];
    const float v = s[1];
    const float m = theta + (v - theta) * E;  // exact conditional mean
    const float s2 = v * c1 + c2;             // exact conditional variance
    const float psi = s2 / fmaxf(m * m, tiny);
    const float invpsi = 2.0f / fmaxf(psi, tiny);
    const float tq = fmaxf(invpsi - 1.0f, 0.0f);
    const float b2 = tq + sqrtf(invpsi) * sqrtf(tq);
    const float a = m / (1.0f + b2);
    const float p = fminf(fmaxf((psi - 1.0f) / (psi + 1.0f), 0.0f), 1.0f - 1e-6f);
    const float beta = (1.0f - p) / fmaxf(m, tiny);
    float v_next;
    float ln_m = 0.0f;
    if (psi <= psi_c) {  // quadratic branch: v' = a (b + Zv)^2
      const float sb = sqrtf(b2) + orp::ndtri_as241(uv);
      v_next = a * (sb * sb);
      if (kCorrected) {
        const float den_q = fmaxf(1.0f - 2.0f * A * a, 1e-6f);
        ln_m = A * b2 * a / den_q - 0.5f * logf(den_q);
      }
    } else {  // exponential branch: P[v' = 0] = p, else rate beta
      const float u_comp = fmaxf(1.0f - uv, tiny);  // exact complement
      v_next = u_comp >= 1.0f - p ? 0.0f : logf((1.0f - p) / u_comp) / beta;
      if (kCorrected) {
        ln_m = logf(fmaxf(p + beta * (1.0f - p) / fmaxf(beta - A, tiny), tiny));
      }
    }
    const float k0s = kCorrected ? -ln_m - k13 * v : k0;
    const float gauss = sqrtf(fmaxf(k3 * v + k4 * v_next, 0.0f)) * zs;
    s[0] = s[0] + mu_dt + k0s + k1 * v + k2 * v_next + gauss;
    s[1] = v_next;
  }
};

template <class Step>
int launch(const Step& step, const void* dirs, void* out_logs, void* out_v,
           unsigned long long n_paths, int n_steps, int store_every, uint32_t seed,
           void* stream) {
  Outs outs{};
  outs.p[0] = static_cast<float*>(out_logs);
  outs.p[1] = static_cast<float*>(out_v);
  const unsigned threads = 256;
  const unsigned long long blocks = (n_paths + threads - 1) / threads;
  mf_kernel<Step><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(dirs), outs, n_paths, n_steps, store_every, seed, step);
  return (int)cudaGetLastError();
}

}  // namespace

// c: v0, mu, kappa, theta, xi, rho, rho_c, dt, sdt
extern "C" int orp_heston_euler_launch(const void* dirs, void* out_logs, void* out_v,
                                       unsigned long long n_paths, int n_steps,
                                       int store_every, uint32_t seed, const float* c,
                                       void* stream) {
  const HestonEuler step{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8]};
  return launch(step, dirs, out_logs, out_v, n_paths, n_steps, store_every, seed, stream);
}

// c: v0, theta, E, c1, c2, k1, k2, k3, k4, A, k1 + k3/2, mu*dt, k0, psi_c
extern "C" int orp_heston_qe_launch(const void* dirs, void* out_logs, void* out_v,
                                    unsigned long long n_paths, int n_steps,
                                    int store_every, uint32_t seed, const float* c,
                                    int corrected, void* stream) {
  if (corrected) {
    const HestonQE<true> step{c[0], c[1], c[2], c[3], c[4], c[5], c[6],
                              c[7], c[8], c[9], c[10], c[11], c[12], c[13]};
    return launch(step, dirs, out_logs, out_v, n_paths, n_steps, store_every, seed, stream);
  }
  const HestonQE<false> step{c[0], c[1], c[2], c[3], c[4], c[5], c[6],
                             c[7], c[8], c[9], c[10], c[11], c[12], c[13]};
  return launch(step, dirs, out_logs, out_v, n_paths, n_steps, store_every, seed, stream);
}

extern "C" const char* orp_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
