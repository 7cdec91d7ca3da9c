// Fused scrambled-Sobol path kernels for sm_90a: log-GBM, 2-factor Heston
// under full-truncation Euler and under Andersen QE-M, and the 4-factor
// coupled pension system, as steps of one kernel template.
//
// Replaces the TPU kernels of orp_tpu/qmc/pallas_sobol.py, gbm_log_pallas
// (_gbm_kernel :138 and its dense-grid chain _gbm_kernel_chunk :163) as
// Step = GbmLog, and of orp_tpu/qmc/pallas_mf.py: the generic driver _run_mf /
// _mf_kernel (:106, :49) as the template mf_kernel<Step>, with
// heston_log_pallas (:155) as Step = HestonEuler, heston_qe_pallas (:202) as
// Step = HestonQE and pension_pallas (:294) as Step = Pension<kSV, kInversion>.
// Plain-PyTorch twins: orp_tpu_torch/qmc/fused_gbm.py (gbm_log_plain) and
// orp_tpu_torch/qmc/fused_mf.py (heston_log_plain, heston_qe_plain,
// pension_plain).
//
// Semantics: at step t (1-based) factor f draws Sobol dimension
// (t-1)*kFactors + f of the path's own index, as the scrambled uniform; the
// step turns it into a normal (AS241) or uses it raw (QE's variance factor,
// the pension's inversion sampler). Only the factors in Step::kUsed are drawn
// (constant-vol pension skips factor 2 of its 4-factor layout). Every
// store_every steps the kernel stores Step::knot(state, j) for each of the
// kSlots outputs, knot-major: s0 * expf(log-return) for the GBM and for
// Heston's S (so no exp pass over the knots follows the launch), the state
// itself otherwise.
//
// What bounds it on the H100: instruction issue. The knots are few bytes
// (GBM at 1M paths x 364 steps, 53 knots: 222 MB, ~0.07 ms at 3.35 TB/s;
// Heston 444 MB, ~0.13 ms; the pension at 1M x 1,000 steps, 41 knots, 3
// slots: 516 MB, ~0.15 ms), while every path-step issues a few hundred SIMT
// instructions: a Sobol word per used factor, an AS241 per normal, the step
// (QE about forty f32 operations with four square roots and a log or two; the
// pension an exp and its population draw) and, for the pension's inversion
// sampler, the CDF walk.
//
// What the design does about it:
// - one thread per path, the whole state in registers for all steps, only
//   knots reach device memory (the TPU kernels' VMEM carry, without their
//   power-of-two block rule, their (rows, 128) tiling, the GBM's 64-knot
//   chunk chain or the static/dynamic knot-store split, which exist only for
//   the TPU; any n_paths up to 2^32, any knot count in one launch);
// - warp-shared Sobol words in shared memory: the 32 lanes of a warp hold 32
//   consecutive path indices, so index bits 5-31 are the same on every lane.
//   Every 32 dimensions (32 GBM steps, 16 Heston steps, 8 pension steps)
//   lane j forms the warp part of dimension base + j (the 27 terms of those
//   bits), XORs in each lane's 5 terms in Gray-code order and writes the 32
//   words as row j of the warp's window (sobol_word_row), and forms the
//   scramble key hash(seed, dim); each draw is one shared-memory read of its
//   own word and one __shfl_sync of the key. By XOR linearity the word is
//   bitwise the one of the 32-term XOR. A lane past n_paths runs the loop
//   without storing, so that every row is written and every shuffle has all
//   32 lanes. The window costs 4,224 bytes a warp (33,792 a block);
// - the knots are stored by a countdown, not a modulo per step;
// - AS241 runs its central and near-tail branches as one straight-line Horner
//   pair with per-lane coefficients and one division, since every warp has
//   lanes in both, and leaves out the far tail, which the bucket-centred
//   uniforms never reach: in the GBM and Heston steps contracted
//   (ndtri_as241, bitwise the branching form that nvcc contracts) with its
//   coefficients loaded from a table, in the pension's rounded per operation
//   (ndtri_as241_rn) with immediates. Timed on an H100 against the branching
//   form (PERF.md, Findings): a select per coefficient took 1-2.4% off the GBM
//   and Heston kernels, the table 5-6% more, every output bitwise;
// - QE's A <= 0 martingale correction and the pension's fund (constant vol or
//   SV) and population sampler are template flags, not per-element tests, as
//   they are trace-time branches in JAX; only the selected QE variance branch
//   (and its log) is evaluated, which leaves the result unchanged;
// - the pension's CDF walk stops at the first k with cdf >= u (cdf never
//   falls, so JAX's remaining fixed trips change no count), and at the first
//   trip that leaves a cdf below u unchanged while the next multiplier is at
//   most 1/2 (no later trip can move it: the walk ends at 128, the plain
//   version's stuck rule); it runs only where the mean death count is <= 45,
//   the CLT draw and its AS241 only where it is above;
// - the host-f64 constants arrive as f32 values rounded once; constants in
//   the code are f-suffixed. No fast math; nvcc contracts a*b+c into FMA, so
//   the GBM and Heston paths agree with the plain version to f32 tolerance,
//   not bitwise. The pension step writes its arithmetic, its AS241 draws
//   included, with __fmul_rn / __fadd_rn / __fdiv_rn, which are never
//   contracted, because its roundings decide integers (the survivors N):
//   round-half-even rintf as jnp.round / torch.round, the plain version's
//   operation order, IEEE division. One ulp of lambda moves q = 1 - p by up
//   to 4e-4 relative, which moves where the reference's f32 CDF walk
//   saturates (its cdf plateaus up to ~2e-4 below 1, and a uniform above the
//   plateau takes all 128 trips).
//
// The divergence that remains is inherent to the bitwise contract. Sobol
// points on 32 consecutive indices are stratified (one per 1/32 of (0, 1) in
// every dimension), so every warp-draw has lanes in both AS241 branches, and
// no lane map changes that: the straight-line AS241 pays for a log and a
// square root on every lane instead. A warp walks the CDF as long as its lane
// with the most deaths (about 4.6 trips per warp-step at dt = 0.01 against
// 1.4 per lane); the walk's count is the integer the reference draws, so it
// cannot be replaced by a table or a closed form that would round elsewhere.

#include "sobol_device.cuh"

namespace {

constexpr int kMaxSlots = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Outs {
  float* p[kMaxSlots];
};

template <class Step>
__global__ void __launch_bounds__(kThreads)
mf_kernel(const uint32_t* __restrict__ dirs, Outs outs, unsigned long long n_paths,
          int n_steps, int store_every, uint32_t seed, Step step) {
  static_assert(32 % Step::kFactors == 0, "a refill covers whole steps");
  constexpr int kStepsPerRefill = 32 / Step::kFactors;
  const unsigned long long g =
      (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
  // the window's rows and __shfl_sync need every lane: only a warp wholly past
  // n_paths leaves, the others' lanes past it compute and store nothing
  if ((g & ~31ull) >= n_paths) return;
  const bool live = g < n_paths;
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t hi = (uint32_t)g & ~31u;  // index bits 5-31, the same on the whole warp
  // the warp's words of dimensions base .. base + 31: words[warp][dim - base][lane],
  // a row padded to 33 so that a lane's row writes and a step's reads hit 32 banks
  __shared__ uint32_t words[kWarps][32][33];
  uint32_t(*tab)[33] = words[threadIdx.x >> 5];
  const uint32_t n_dims = (uint32_t)n_steps * Step::kFactors;
  float state[Step::kSlots];
  step.init(state);
  unsigned long long at = g;  // this path's element of the current knot
  if (live) {
#pragma unroll
    for (int j = 0; j < Step::kSlots; ++j) outs.p[j][at] = step.knot(state, j);
  }
  // lane j fills row j of the window and holds the scramble key of dimension base + j
  uint32_t key = 0u, base = 0u;
  int off = 0;  // the current step's first dimension, relative to base
  int refill_in = 0, store_in = store_every;
  for (int t = 1; t <= n_steps; ++t) {
    if (refill_in == 0) {  // every kStepsPerRefill steps: dimensions base .. base + 31
      if (t > 1) base += 32u;
      const uint32_t dim = base + lane;
      __syncwarp();  // every lane has read the last window
      if (dim < n_dims) orp::sobol_word_row(dirs, dim, hi, tab[lane]);
      __syncwarp();
      key = orp::hash_combine(seed, dim);
      refill_in = kStepsPerRefill;
      off = 0;
    }
    float u[Step::kFactors];
#pragma unroll
    for (int f = 0; f < Step::kFactors; ++f) {
      if ((Step::kUsed >> f) & 1u) {
        u[f] = orp::scrambled_uniform(tab[off + f][lane],
                                      __shfl_sync(0xFFFFFFFFu, key, off + f));
      }
    }
    step.advance(state, u);
    off += Step::kFactors;
    --refill_in;
    if (--store_in == 0) {
      at += n_paths;
      if (live) {
#pragma unroll
        for (int j = 0; j < Step::kSlots; ++j) outs.p[j][at] = step.knot(state, j);
      }
      store_in = store_every;
    }
  }
}

// state the log-return; the knot is S = s0 exp(log-return)
struct GbmLog {
  static constexpr int kFactors = 1;
  static constexpr int kSlots = 1;
  static constexpr unsigned kUsed = 0x1u;
  float c0, vol_sdt, s0;

  __device__ void init(float (&s)[kSlots]) const { s[0] = 0.0f; }

  __device__ void advance(float (&s)[kSlots], const float (&u)[kFactors]) const {
    s[0] = s[0] + c0 + vol_sdt * orp::ndtri_as241(u[0]);
  }

  __device__ float knot(const float (&s)[kSlots], int) const { return s0 * expf(s[0]); }
};

// state (log-return, variance); factor 0 the asset's own normal, 1 the variance's;
// the knots are S = s0 exp(log-return) and v
struct HestonEuler {
  static constexpr int kFactors = 2;
  static constexpr int kSlots = 2;
  static constexpr unsigned kUsed = 0x3u;
  float v0, mu, kappa, theta, xi, rho, rho_c, dt, sdt, s0;

  __device__ void init(float (&s)[kSlots]) const {
    s[0] = 0.0f;
    s[1] = v0;
  }

  __device__ float knot(const float (&s)[kSlots], int j) const {
    return j == 0 ? s0 * expf(s[0]) : s[j];
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

// state (log-return, variance); factor 0 the asset's normal, 1 the RAW uniform;
// the knots are S = s0 exp(log-return) and v
template <bool kCorrected>
struct HestonQE {
  static constexpr int kFactors = 2;
  static constexpr int kSlots = 2;
  static constexpr unsigned kUsed = 0x3u;
  float v0, theta, E, c1, c2, k1, k2, k3, k4, A, k13, mu_dt, k0, psi_c, s0;

  __device__ void init(float (&s)[kSlots]) const {
    s[0] = 0.0f;
    s[1] = v0;
  }

  __device__ float knot(const float (&s)[kSlots], int j) const {
    return j == 0 ? s0 * expf(s[0]) : s[j];
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

// state (y, lam, N), or (log-return, v, lam, N) when kSV; factor 0 the fund's
// normal, 1 the mortality's, 2 the CIR vol's (kSV only), 3 the population's:
// its AS241 normal, or the raw uniform of the CDF inversion when kInversion
template <bool kSV, bool kInversion>
struct Pension {
  static constexpr int kFactors = 4;
  static constexpr int kSlots = kSV ? 4 : 3;
  static constexpr unsigned kUsed = kSV ? 0xFu : 0xBu;
  static constexpr int kWalk = 128;        // sde/kernels.py _INVERSION_K
  static constexpr float kMeanMax = 45.0f;  // _INVERSION_MEAN_MAX
  // fund_a = 1 + mu dt, fund_b = sigma sqrt(dt), eta_sdt = eta sqrt(dt) (host f64)
  float y0, v0, l0, n0, fund_a, fund_b, mu, sdt, cir_a, cir_b, cir_c, drift_scale, mort_c,
      dt, eta_sdt;

  __device__ void init(float (&s)[kSlots]) const {
    if constexpr (kSV) {
      s[0] = 0.0f;  // log-return accumulator: Y = y0 exp(.) on the host side
      s[1] = v0;
      s[2] = l0;
      s[3] = n0;
    } else {
      s[0] = y0;
      s[1] = l0;
      s[2] = n0;
    }
  }

  __device__ float knot(const float (&s)[kSlots], int j) const { return s[j]; }

  // D ~ Binomial(pop, q) by the CDF walk, or the CLT draw past kMeanMax
  __device__ float deaths_inversion(float pop, float lam, float p, float u) const {
    const float q = __fsub_rn(1.0f, p);
    const float mean_d = __fmul_rn(pop, q);
    if (mean_d <= kMeanMax) {
      const float ratio = __fdiv_rn(q, fmaxf(__fsub_rn(1.0f, q), 1e-30f));
      float pmf = expf(__fmul_rn(__fmul_rn(-pop, lam), dt));  // pmf(0) = p^pop
      float cdf = pmf;
      float d = 0.0f;
      for (int k = 1; k <= kWalk && cdf < u; ++k) {
        const float kf = (float)k;
        pmf = fmaxf(__fmul_rn(__fdiv_rn(__fmul_rn(pmf, __fsub_rn(pop, kf - 1.0f)), kf), ratio),
                    0.0f);
        d = kf;
        const float moved = __fadd_rn(cdf, pmf);
        // stuck: this trip left cdf (< u) as it was and every later pmf is at
        // most half the last, so no later trip moves it either and the fixed
        // 128-trip walk ends at 128 (sde/kernels.binomial_inversion_deaths)
        if (moved == cdf &&
            __fmul_rn(__fdiv_rn(__fsub_rn(pop, kf), kf + 1.0f), ratio) <= 0.5f) {
          return (float)kWalk;
        }
        cdf = moved;
      }
      return d;
    }
    const float sd = sqrtf(fmaxf(__fmul_rn(__fmul_rn(pop, q), __fsub_rn(1.0f, q)), 0.0f));
    const float draw = rintf(__fadd_rn(mean_d, __fmul_rn(sd, orp::ndtri_as241_rn(u))));
    return fminf(fmaxf(draw, 0.0f), pop);
  }

  __device__ void advance(float (&s)[kSlots], const float (&u)[kFactors]) const {
    constexpr int L = kSV ? 2 : 1;  // slots of lam and N
    constexpr int N = L + 1;
    const float z0 = orp::ndtri_as241_rn(u[0]);
    if constexpr (kSV) {
      const float v = s[1];
      const float zv = orp::ndtri_as241_rn(u[2]);
      const float drift = __fmul_rn(__fmul_rn(cir_a, __fsub_rn(cir_b, v)), drift_scale);
      const float shock = __fmul_rn(__fmul_rn(cir_c, sqrtf(fmaxf(__fmul_rn(v, dt), 0.0f))), zv);
      const float vn = __fadd_rn(__fadd_rn(v, drift), shock);
      const float ito = __fmul_rn(__fsub_rn(mu, __fmul_rn(__fmul_rn(0.5f, vn), vn)), dt);
      s[0] = __fadd_rn(__fadd_rn(s[0], ito), __fmul_rn(__fmul_rn(vn, sdt), z0));
      s[1] = vn;
    } else {
      s[0] = __fmul_rn(s[0], __fadd_rn(fund_a, __fmul_rn(fund_b, z0)));
    }
    float lam = s[L];
    lam = __fadd_rn(__fadd_rn(lam, __fmul_rn(__fmul_rn(mort_c, lam), dt)),
                    __fmul_rn(eta_sdt, orp::ndtri_as241_rn(u[1])));
    const float p = expf(__fmul_rn(-lam, dt));
    const float pop = s[N];
    if constexpr (kInversion) {
      s[N] = fmaxf(__fsub_rn(pop, deaths_inversion(pop, lam, p, u[3])), 0.0f);
    } else {
      const float mean = __fmul_rn(pop, p);
      const float var = __fmul_rn(__fmul_rn(pop, p), __fsub_rn(1.0f, p));
      const float draw =
          rintf(__fadd_rn(mean, __fmul_rn(sqrtf(fmaxf(var, 0.0f)), orp::ndtri_as241_rn(u[3]))));
      s[N] = fminf(fmaxf(draw, 0.0f), pop);
    }
    s[L] = lam;
  }
};

template <class Step>
int launch(const Step& step, const void* dirs, const Outs& outs, unsigned long long n_paths,
           int n_steps, int store_every, uint32_t seed, void* stream) {
  const unsigned long long blocks = (n_paths + kThreads - 1) / kThreads;
  mf_kernel<Step><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(dirs), outs, n_paths, n_steps, store_every, seed, step);
  return (int)cudaGetLastError();
}

Outs two_slots(void* out0, void* out1) {
  Outs outs{};
  outs.p[0] = static_cast<float*>(out0);
  outs.p[1] = static_cast<float*>(out1);
  return outs;
}

template <bool kSV, bool kInversion>
int launch_pension(const float* c, const void* dirs, const Outs& outs,
                   unsigned long long n_paths, int n_steps, int store_every, uint32_t seed,
                   void* stream) {
  const Pension<kSV, kInversion> step{c[0], c[1], c[2],  c[3],  c[4],  c[5],  c[6], c[7],
                                      c[8], c[9], c[10], c[11], c[12], c[13], c[14]};
  return launch(step, dirs, outs, n_paths, n_steps, store_every, seed, stream);
}

}  // namespace

// out: (n_knots, n_paths) f32 knots s0 exp(log-return)
extern "C" int orp_fused_gbm_launch(const void* dirs, void* out, unsigned long long n_paths,
                                    int n_steps, int store_every, uint32_t seed, float c0,
                                    float vol_sdt, float s0, void* stream) {
  Outs outs{};
  outs.p[0] = static_cast<float*>(out);
  return launch(GbmLog{c0, vol_sdt, s0}, dirs, outs, n_paths, n_steps, store_every, seed,
                stream);
}

// c: v0, mu, kappa, theta, xi, rho, rho_c, dt, sdt, s0
extern "C" int orp_heston_euler_launch(const void* dirs, void* out_s, void* out_v,
                                       unsigned long long n_paths, int n_steps,
                                       int store_every, uint32_t seed, const float* c,
                                       void* stream) {
  const HestonEuler step{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], c[9]};
  return launch(step, dirs, two_slots(out_s, out_v), n_paths, n_steps, store_every, seed,
                stream);
}

// c: v0, theta, E, c1, c2, k1, k2, k3, k4, A, k1 + k3/2, mu*dt, k0, psi_c, s0
extern "C" int orp_heston_qe_launch(const void* dirs, void* out_s, void* out_v,
                                    unsigned long long n_paths, int n_steps,
                                    int store_every, uint32_t seed, const float* c,
                                    int corrected, void* stream) {
  if (corrected) {
    const HestonQE<true> step{c[0], c[1], c[2],  c[3],  c[4],  c[5],  c[6], c[7],
                              c[8], c[9], c[10], c[11], c[12], c[13], c[14]};
    return launch(step, dirs, two_slots(out_s, out_v), n_paths, n_steps, store_every, seed,
                  stream);
  }
  const HestonQE<false> step{c[0], c[1], c[2],  c[3],  c[4],  c[5],  c[6], c[7],
                             c[8], c[9], c[10], c[11], c[12], c[13], c[14]};
  return launch(step, dirs, two_slots(out_s, out_v), n_paths, n_steps, store_every, seed,
                stream);
}

// c: y0, v0, l0, n0, 1 + mu dt, sigma sqrt(dt), mu, sqrt(dt), cir_a, cir_b, cir_c,
//    drift scale (dt or 1), mort_c, dt, eta sqrt(dt); out: kSlots knot-major
//    (n_knots, n_paths) f32 arrays, (y, lam, N) or (log-return, v, lam, N)
extern "C" int orp_pension_launch(const void* dirs, void* out0, void* out1, void* out2,
                                  void* out3, unsigned long long n_paths, int n_steps,
                                  int store_every, uint32_t seed, const float* c, int sv,
                                  int inversion, void* stream) {
  Outs outs{};
  outs.p[0] = static_cast<float*>(out0);
  outs.p[1] = static_cast<float*>(out1);
  outs.p[2] = static_cast<float*>(out2);
  outs.p[3] = static_cast<float*>(out3);
  if (sv) {
    return inversion
               ? launch_pension<true, true>(c, dirs, outs, n_paths, n_steps, store_every, seed,
                                            stream)
               : launch_pension<true, false>(c, dirs, outs, n_paths, n_steps, store_every, seed,
                                             stream);
  }
  return inversion
             ? launch_pension<false, true>(c, dirs, outs, n_paths, n_steps, store_every, seed,
                                           stream)
             : launch_pension<false, false>(c, dirs, outs, n_paths, n_steps, store_every, seed,
                                            stream);
}

extern "C" const char* orp_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
