// Device helpers shared by the fused path kernels (fused_gbm.cu, fused_mf.cu):
// the Owen-scrambled Sobol draw and the AS241 inverse normal, bit for bit the
// chain of orp_tpu/qmc/pallas_sobol.py (_sobol_u, _sobol_z, _ndtri_f32).
//
// Two ways to form a path's Sobol word. fused_gbm.cu builds the 32
// all-ones/all-zeros masks of the path's index bits once (index_masks) and
// every word is a branch-free masked XOR of one direction row, read by every
// thread of the warp as eight 16-byte broadcast __ldg loads (sobol_uniform).
// fused_mf.cu splits the word by XOR linearity (sobol_warp_part,
// sobol_lane_part): with 32 consecutive path indices on the 32 lanes of a
// warp, index bits 5-31 are the same on every lane, so their 27 terms are
// formed once per warp and dimension and handed round with __shfl_sync, and
// each lane XORs in only the 5 terms of its lane bits. The word, and so every
// draw, is bitwise the same either way.
//
// AS241's constants are f-suffixed so the polynomials stay in f32 (a double
// literal would promote them and change the bits). No fast math: logf/sqrtf
// and the divisions are the IEEE-accurate versions. ndtri_as241 lets nvcc
// contract the Horner steps into FMAs and evaluates only the branch a draw
// needs; ndtri_as241_rn rounds every multiply and add on its own, the plain
// PyTorch version's rounding (qmc/fused_gbm.ndtri_as241), for steps whose
// roundings decide integers (the pension's survivors), and runs its central
// and near-tail branches as one Horner pair on the bucket-centred uniforms
// that reach it (the far tail lies outside them).

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

__device__ __forceinline__ void index_masks(uint32_t i, uint32_t (&mask)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) mask[k] = bit_mask(i, k);
}

// The uniform of the unscrambled word x: Owen scramble keyed by
// hash_combine(seed, dim) between bit reversals, centre of one of 2^23 buckets.
__device__ __forceinline__ float scrambled_uniform(uint32_t x, uint32_t key) {
  x = __brev(laine_karras(__brev(x), key));
  return ((float)(x >> 9) + 0.5f) * 1.1920928955078125e-7f;  // 2^-23
}

// Scrambled-Sobol uniform of dimension `dim` for the path whose index masks
// are `mask`: XOR of the direction row, Owen scramble keyed by
// hash(seed, dim) between bit reversals, centre of one of 2^23 buckets.
__device__ __forceinline__ float sobol_uniform(const uint32_t* __restrict__ dirs,
                                               const uint32_t (&mask)[32], uint32_t dim,
                                               uint32_t seed) {
  const uint4* row = reinterpret_cast<const uint4*>(dirs + (size_t)dim * 32);
  uint32_t x = 0u;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const uint4 v = __ldg(row + w);
    x ^= v.x & mask[4 * w + 0];
    x ^= v.y & mask[4 * w + 1];
    x ^= v.z & mask[4 * w + 2];
    x ^= v.w & mask[4 * w + 3];
  }
  return scrambled_uniform(x, hash_combine(seed, dim));
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

// The lane's part of the word of dimension `dim`: direction row words 0..4
// under the masks of the lane's bits 0-4 (one 16-byte and one 4-byte
// broadcast load; the row is the same on every lane).
__device__ __forceinline__ uint32_t sobol_lane_part(const uint32_t* __restrict__ dirs,
                                                    uint32_t dim, const uint32_t (&lane_mask)[5]) {
  const uint32_t* row = dirs + (size_t)dim * 32;
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(row));
  const uint32_t v4 = __ldg(row + 4);
  return (v.x & lane_mask[0]) ^ (v.y & lane_mask[1]) ^ (v.z & lane_mask[2]) ^
         (v.w & lane_mask[3]) ^ (v4 & lane_mask[4]);
}

__device__ __forceinline__ float ndtri_as241(float u) {
  const float q = u - 0.5f;
  if (fabsf(q) <= 0.425f) {
    const float r = 0.180625f - q * q;
    float num = ((2.5090809287301226727e3f * r + 3.3430575583588128105e4f) * r
                 + 6.7265770927008700853e4f) * r + 4.5921953931549871457e4f;
    num = (num * r + 1.3731693765509461125e4f) * r + 1.9715909503065514427e3f;
    num = (num * r + 1.3314166789178437745e2f) * r + 3.3871328727963666080e0f;
    float den = ((5.2264952788528545610e3f * r + 2.8729085735721942674e4f) * r
                 + 3.9307895800092710610e4f) * r + 2.1213794301586595867e4f;
    den = (den * r + 5.3941960214247511077e3f) * r + 6.8718700749205790830e2f;
    den = (den * r + 4.2313330701600911252e1f) * r + 1.0f;
    return q * num / den;
  }
  const float p = fminf(u, 1.0f - u);
  const float rt = sqrtf(-logf(fmaxf(p, 1e-38f)));
  float t;
  if (rt <= 5.0f) {
    const float r = rt - 1.6f;
    float num = ((7.74545014278341407640e-4f * r + 2.27238449892691845833e-2f) * r
                 + 2.41780725177450611770e-1f) * r + 1.27045825245236838258e0f;
    num = (num * r + 3.64784832476320460504e0f) * r + 5.76949722146069140550e0f;
    num = (num * r + 4.63033784615654529590e0f) * r + 1.42343711074968357734e0f;
    float den = ((1.05075007164441684324e-9f * r + 5.47593808499534494600e-4f) * r
                 + 1.51986665636164571966e-2f) * r + 1.48103976427480074590e-1f;
    den = (den * r + 6.89767334985100004550e-1f) * r + 1.67638483018380384940e0f;
    den = (den * r + 2.05319162663775882187e0f) * r + 1.0f;
    t = num / den;
  } else {
    const float r = rt - 5.0f;
    float num = ((2.01033439929228813265e-7f * r + 2.71155556874348757815e-5f) * r
                 + 1.24266094738807843860e-3f) * r + 2.65321895265761230930e-2f;
    num = (num * r + 2.96560571828504891230e-1f) * r + 1.78482653991729133580e0f;
    num = (num * r + 5.46378491116411436990e0f) * r + 6.65790464350110377720e0f;
    float den = ((2.04426310338993978564e-15f * r + 1.42151175831644588870e-7f) * r
                 + 1.84631831751005468180e-5f) * r + 7.86869131145613259100e-4f;
    den = (den * r + 1.48753612908506148525e-2f) * r + 1.36929880922735805310e-1f;
    den = (den * r + 5.99832206555887937690e-1f) * r + 1.0f;
    t = num / den;
  }
  return q < 0.0f ? -t : t;
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
