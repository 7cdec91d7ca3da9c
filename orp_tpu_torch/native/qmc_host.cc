// Host-side QMC engine: scrambled Sobol + inverse-normal in C++.
//
// The card generates Sobol draws on the device (orp_tpu_torch/qmc/sobol.py);
// this library is the native *runtime-side* counterpart — the equivalent of the
// reference's compiled SciPy Sobol dependency (Replicating_Portfolio.py:55) —
// used for (a) host-side data feeding/validation and (b) cross-language
// bitwise verification of the device kernel: identical direction numbers, the
// same Laine–Karras/Burley hash-based Owen scramble, and the same
// bucket-centred uint32 -> (0,1) mapping, so host and device uniforms agree
// bit-for-bit in float64.
//
// Build: orp_tpu_torch/native/__init__.py compiles this with g++ -O2 -shared -fPIC
// on first use; no external dependencies beyond libm.

#include <cstdint>
#include <cmath>

namespace {

constexpr int kNBits = 32;

inline uint32_t hash_combine(uint32_t a, uint32_t b) {
  uint32_t x = a ^ (b + 0x9E3779B9u + (a << 6) + (a >> 2));
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

inline uint32_t reverse_bits32(uint32_t x) {
  x = ((x & 0x55555555u) << 1) | ((x >> 1) & 0x55555555u);
  x = ((x & 0x33333333u) << 2) | ((x >> 2) & 0x33333333u);
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x >> 4) & 0x0F0F0F0Fu);
  x = ((x & 0x00FF00FFu) << 8) | ((x >> 8) & 0x00FF00FFu);
  return (x << 16) | (x >> 16);
}

inline uint32_t laine_karras_permutation(uint32_t x, uint32_t seed) {
  x += seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return x;
}

inline uint32_t owen_scramble(uint32_t x, uint32_t dim_seed) {
  return reverse_bits32(laine_karras_permutation(reverse_bits32(x), dim_seed));
}

inline uint32_t sobol_uint32(uint32_t index, const uint32_t* dirs_row) {
  uint32_t acc = 0;
  for (int k = 0; k < kNBits; ++k) {
    if ((index >> k) & 1u) acc ^= dirs_row[k];
  }
  return acc;
}

// bucket-centred map matching orp_tpu_torch.qmc.sobol._to_unit_interval for f64
// (bits = 31): u = ((x >> 1) + 0.5) * 2^-31
inline double to_unit_interval(uint32_t x) {
  return (static_cast<double>(x >> 1) + 0.5) * 0x1p-31;
}

// Wichura's AS241 (PPND16): inverse normal CDF to ~1e-16 relative accuracy.
double ndtri_impl(double p) {
  const double q = p - 0.5;
  double r;
  if (std::fabs(q) <= 0.425) {
    r = 0.180625 - q * q;
    return q *
           (((((((2.5090809287301226727e3 * r + 3.3430575583588128105e4) * r +
                 6.7265770927008700853e4) * r + 4.5921953931549871457e4) * r +
               1.3731693765509461125e4) * r + 1.9715909503065514427e3) * r +
             1.3314166789178437745e2) * r + 3.3871328727963666080e0) /
           (((((((5.2264952788528545610e3 * r + 2.8729085735721942674e4) * r +
                 3.9307895800092710610e4) * r + 2.1213794301586595867e4) * r +
               5.3941960214247511077e3) * r + 6.8718700749205790830e2) * r +
             4.2313330701600911252e1) * r + 1.0);
  }
  r = (q < 0.0) ? p : 1.0 - p;
  r = std::sqrt(-std::log(r));
  double val;
  if (r <= 5.0) {
    r -= 1.6;
    val = (((((((7.74545014278341407640e-4 * r + 2.27238449892691845833e-2) * r +
                2.41780725177450611770e-1) * r + 1.27045825245236838258e0) * r +
              3.64784832476320460504e0) * r + 5.76949722146069140550e0) * r +
            4.63033784615654529590e0) * r + 1.42343711074968357734e0) /
          (((((((1.05075007164441684324e-9 * r + 5.47593808499534494600e-4) * r +
                1.51986665636164571966e-2) * r + 1.48103976427480074590e-1) * r +
              6.89767334985100004550e-1) * r + 1.67638483018380384940e0) * r +
            2.05319162663775882187e0) * r + 1.0);
  } else {
    r -= 5.0;
    val = (((((((2.01033439929228813265e-7 * r + 2.71155556874348757815e-5) * r +
                1.24266094738807843860e-3) * r + 2.65321895265761230930e-2) * r +
              2.96560571828504891230e-1) * r + 1.78482653991729133580e0) * r +
            5.46378491116411436990e0) * r + 6.65790464350110377720e0) /
          (((((((2.04426310338993978564e-15 * r + 1.42151175831644588870e-7) * r +
                1.84631831751005468180e-5) * r + 7.86869131145613259100e-4) * r +
              1.48753612908506148525e-2) * r + 1.36929880922735805310e-1) * r +
            5.99832206555887937690e-1) * r + 1.0);
  }
  return (q < 0.0) ? -val : val;
}

}  // namespace

extern "C" {

// uniforms[n * d]: scrambled Sobol points for (indices x dims).
// scramble_mode: 0 = none, 1 = Owen (hash-based), 2 = digital shift.
void sobol_uniform_host(const uint32_t* directions,  // [n_table_dims * 32]
                        const uint32_t* indices, uint64_t n,
                        const uint32_t* dims, uint64_t d,
                        uint32_t seed, int scramble_mode, double* out) {
  for (uint64_t j = 0; j < d; ++j) {
    const uint32_t* row = directions + static_cast<uint64_t>(dims[j]) * kNBits;
    const uint32_t dim_seed = hash_combine(seed, dims[j]);
    for (uint64_t i = 0; i < n; ++i) {
      uint32_t x = sobol_uint32(indices[i], row);
      if (scramble_mode == 1) x = owen_scramble(x, dim_seed);
      else if (scramble_mode == 2) x ^= dim_seed;
      out[i * d + j] = to_unit_interval(x);
    }
  }
}

void ndtri_host(const double* u, uint64_t n, double* out) {
  for (uint64_t i = 0; i < n; ++i) out[i] = ndtri_impl(u[i]);
}

// Fused convenience: scrambled Sobol -> N(0,1), the host analogue of
// orp_tpu_torch.qmc.sobol_normal (and of the reference's sobol_norm, RP.py:54-57).
void sobol_normal_host(const uint32_t* directions, const uint32_t* indices,
                       uint64_t n, const uint32_t* dims, uint64_t d,
                       uint32_t seed, int scramble_mode, double* out) {
  sobol_uniform_host(directions, indices, n, dims, d, seed, scramble_mode, out);
  ndtri_host(out, n * d, out);
}

}  // extern "C"
