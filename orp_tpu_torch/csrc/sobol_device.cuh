// Device helpers of the fused path kernels (fused_mf.cu): the Owen-scrambled
// Sobol draw and the AS241 inverse normal, bit for bit the chain of
// orp_tpu/qmc/pallas_sobol.py (_sobol_u, _sobol_z, _ndtri_f32).
//
// A path's Sobol word is split by XOR linearity: with 32 consecutive path
// indices on the 32 lanes of a warp, index bits 5-31 are the same on every
// lane, so their 27 terms (sobol_warp_part) are formed once per warp and
// dimension, and the 5 terms of the lane bits (words 0..4 of the direction
// row) differ by lane only. sobol_word_row forms one dimension's 32 words,
// warp part XOR each lane's part, with one XOR each in Gray-code order. Every
// word is bitwise the 32-term masked XOR of the direction row that the
// reference forms per path (index_masks and sobol_uniform, which formed it
// that way, went with the last kernel that called them).
//
// AS241's constants are f-suffixed so the polynomials stay in f32 (a double
// literal would promote them and change the bits). No fast math: logf/sqrtf
// and the divisions are the IEEE-accurate versions. Both forms run the
// central and near-tail branches as one straight-line Horner pair, each lane
// taking its branch's coefficients, on the bucket-centred uniforms that
// reach them (the far tail lies outside them). ndtri_as241 is contracted
// (fmaf, as nvcc contracts AS241's branching form: the same bits) and loads
// its coefficients from a table; ndtri_as241_rn rounds every multiply and add
// on its own, the plain PyTorch version's rounding
// (qmc/fused_gbm.ndtri_as241), for steps whose roundings decide integers
// (the pension's survivors), and selects immediates.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace orp {

__device__ __forceinline__ uint32_t hash_combine(uint32_t a, uint32_t b) {
  uint32_t x = a ^ (b + 0x9E3779B9u + (a << 6) + (a >> 2));
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t laine_karras(uint32_t x, uint32_t seed) {
  x += seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return x;
}

// The all-ones/all-zeros mask of bit k of i
__device__ __forceinline__ uint32_t bit_mask(uint32_t i, int k) { return 0u - ((i >> k) & 1u); }

// The uniform of the unscrambled word x: Owen scramble keyed by
// hash_combine(seed, dim) between bit reversals, centre of one of 2^23 buckets.
__device__ __forceinline__ float scrambled_uniform(uint32_t x, uint32_t key) {
  x = __brev(laine_karras(__brev(x), key));
  return ((float)(x >> 9) + 0.5f) * 1.1920928955078125e-7f;  // 2^-23
}

// The warp's part of the word of dimension `dim`: the XOR of direction row
// words 5..31 selected by the bits of `hi`, the index with its lane bits 0-4
// cleared (words 0..4 carry the lane part; word 4's mask is 0 since hi's bit
// 4 is clear, so its 16-byte load is shared with words 5..7).
__device__ __forceinline__ uint32_t sobol_warp_part(const uint32_t* __restrict__ dirs,
                                                    uint32_t dim, uint32_t hi) {
  const uint4* row = reinterpret_cast<const uint4*>(dirs + (size_t)dim * 32);
  uint32_t x = 0u;
#pragma unroll
  for (int w = 1; w < 8; ++w) {
    const uint4 v = __ldg(row + w);
    x ^= v.x & bit_mask(hi, 4 * w + 0);
    x ^= v.y & bit_mask(hi, 4 * w + 1);
    x ^= v.z & bit_mask(hi, 4 * w + 2);
    x ^= v.w & bit_mask(hi, 4 * w + 3);
  }
  return x;
}

__host__ __device__ constexpr int low_bit(int k) { return (k & 1) ? 0 : 1 + low_bit(k >> 1); }

// row[l] = the unscrambled word of dimension `dim` for the path index hi + l,
// l = 0..31 (hi's bits 0-4 clear): the warp part XOR the lane part of lane l.
// The 32 lane parts are formed in Gray-code order, one XOR of direction row
// words 0..4 each (one 16-byte and one 4-byte load, the row the lane's own).
__device__ __forceinline__ void sobol_word_row(const uint32_t* __restrict__ dirs, uint32_t dim,
                                               uint32_t hi, uint32_t* row) {
  const uint32_t* d = dirs + (size_t)dim * 32;
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(d));
  const uint32_t v[5] = {a.x, a.y, a.z, a.w, __ldg(d + 4)};
  uint32_t x = sobol_warp_part(dirs, dim, hi);
  row[0] = x;
#pragma unroll
  for (int k = 1; k < 32; ++k) {
    x ^= v[low_bit(k)];  // Gray codes k - 1 and k differ in bit low_bit(k)
    row[k ^ (k >> 1)] = x;
  }
}

// AS241's Horner coefficients, row 0 the near tail, row 1 the central branch:
// numerator 0-3 and 4-7, then denominator 0-3 and 4-7 (ndtri_as241_rn keeps
// the same values as immediates)
__device__ float4 kAs241Coef[2][4] = {
    {{7.74545014278341407640e-4f, 2.27238449892691845833e-2f, 2.41780725177450611770e-1f,
      1.27045825245236838258e0f},
     {3.64784832476320460504e0f, 5.76949722146069140550e0f, 4.63033784615654529590e0f,
      1.42343711074968357734e0f},
     {1.05075007164441684324e-9f, 5.47593808499534494600e-4f, 1.51986665636164571966e-2f,
      1.48103976427480074590e-1f},
     {6.89767334985100004550e-1f, 1.67638483018380384940e0f, 2.05319162663775882187e0f,
      1.0f}},
    {{2.5090809287301226727e3f, 3.3430575583588128105e4f, 6.7265770927008700853e4f,
      4.5921953931549871457e4f},
     {1.3731693765509461125e4f, 1.9715909503065514427e3f, 1.3314166789178437745e2f,
      3.3871328727963666080e0f},
     {5.2264952788528545610e3f, 2.8729085735721942674e4f, 3.9307895800092710610e4f,
      2.1213794301586595867e4f},
     {5.3941960214247511077e3f, 6.8718700749205790830e2f, 4.2313330701600911252e1f,
      1.0f}}};

// AS241's central and near-tail branches as one straight-line Horner pair,
// each lane loading its branch's coefficients (four 16-byte loads from
// kAs241Coef, two distinct addresses a warp): Sobol points on 32 consecutive
// lanes fill every 1/32 of (0, 1), so every warp would run both branches, and
// a step's draws become branch-free code that the compiler can interleave.
// Each Horner step is the fmaf that nvcc contracts the branching form's
// a * r + b into, and the central r the fmaf of 0.180625f - q * q, so each
// lane gets the bits of its branch of the branching form. Domain:
// bucket-centred 23-bit uniforms, u in [2^-24, 1 - 2^-24], so p >= 2^-24 and
// rt <= 4.08; AS241's far tail (rt > 5) is never reached there and is left out.
__device__ __forceinline__ float ndtri_as241(float u) {
  const float q = u - 0.5f;
  const bool central = fabsf(q) <= 0.425f;
  const float p = fminf(u, 1.0f - u);
  const float rt = sqrtf(-logf(fmaxf(p, 1e-38f)));
  const float r = central ? fmaf(-q, q, 0.180625f) : rt - 1.6f;
  const float4* c = kAs241Coef[central ? 1 : 0];
  const float4 n0 = __ldg(c), n1 = __ldg(c + 1), d0 = __ldg(c + 2), d1 = __ldg(c + 3);
  float num = fmaf(fmaf(fmaf(n0.x, r, n0.y), r, n0.z), r, n0.w);
  num = fmaf(fmaf(fmaf(fmaf(num, r, n1.x), r, n1.y), r, n1.z), r, n1.w);
  float den = fmaf(fmaf(fmaf(d0.x, r, d0.y), r, d0.z), r, d0.w);
  den = fmaf(fmaf(fmaf(fmaf(den, r, d1.x), r, d1.y), r, d1.z), r, d1.w);
  const float t = (central ? q * num : num) / den;
  return !central && q < 0.0f ? -t : t;
}

__device__ __forceinline__ float ndtri_as241_rn(float u) {
  // The central and the near-tail branch as one Horner pair, each lane taking
  // its branch's coefficients: Sobol points on 32 consecutive lanes fill every
  // 1/32 of (0, 1), so every warp would run both branches. Every operation is
  // rounded on its own, so the bits do not move. Domain: bucket-centred 23-bit
  // uniforms, u in [2^-24, 1 - 2^-24], so p >= 2^-24 and rt <= 4.08; AS241's
  // far tail (rt > 5) is never reached there and is left out.
  const float q = __fsub_rn(u, 0.5f);
  const bool central = fabsf(q) <= 0.425f;
  const float p = fminf(u, __fsub_rn(1.0f, u));
  const float rt = sqrtf(-logf(fmaxf(p, 1e-38f)));
  const float r = central ? __fsub_rn(0.180625f, __fmul_rn(q, q)) : __fsub_rn(rt, 1.6f);
  const float cn[8] = {2.5090809287301226727e3f, 3.3430575583588128105e4f,
                       6.7265770927008700853e4f, 4.5921953931549871457e4f,
                       1.3731693765509461125e4f, 1.9715909503065514427e3f,
                       1.3314166789178437745e2f, 3.3871328727963666080e0f};
  const float cd[8] = {5.2264952788528545610e3f, 2.8729085735721942674e4f,
                       3.9307895800092710610e4f, 2.1213794301586595867e4f,
                       5.3941960214247511077e3f, 6.8718700749205790830e2f,
                       4.2313330701600911252e1f, 1.0f};
  const float tn[8] = {7.74545014278341407640e-4f, 2.27238449892691845833e-2f,
                       2.41780725177450611770e-1f, 1.27045825245236838258e0f,
                       3.64784832476320460504e0f, 5.76949722146069140550e0f,
                       4.63033784615654529590e0f, 1.42343711074968357734e0f};
  const float td[8] = {1.05075007164441684324e-9f, 5.47593808499534494600e-4f,
                       1.51986665636164571966e-2f, 1.48103976427480074590e-1f,
                       6.89767334985100004550e-1f, 1.67638483018380384940e0f,
                       2.05319162663775882187e0f, 1.0f};
  float num = central ? cn[0] : tn[0];
  float den = central ? cd[0] : td[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    num = __fadd_rn(__fmul_rn(num, r), central ? cn[i] : tn[i]);
    den = __fadd_rn(__fmul_rn(den, r), central ? cd[i] : td[i]);
  }
  const float t = __fdiv_rn(central ? __fmul_rn(q, num) : num, den);
  return !central && q < 0.0f ? -t : t;
}

}  // namespace orp
