// Shared device code of the advance (K1) and auto-dt (K3) kernels: the
// analytic wind samplers and the 2D particle RHS, split into the terms that
// depend on the wind alone (`wind_terms_at`) and the rest (`rhs_state`).
//
// Replaces the closures that the JAX package's Pallas kernels inline:
// picles_tpu/ops/rhs.py `rhs_core_2d` and the wind samplers of
// picles_tpu/forcing/winds.py (`constant_winds`, `half_domain_winds`,
// `time_cosine_winds`).  A CUDA kernel cannot take a Python closure, so the
// wind is a kind plus float parameters (picles_torch/forcing/winds.py
// `WindKernel` builds them).
//
// Numerics: every operation is float32 in the order the JAX package and the
// plain PyTorch version (picles_torch/ops/rhs.py) use, squares as products,
// precise expf/logf/tanhf/sqrtf/cosf (no fast-math intrinsics).  Every
// literal carries the `f` suffix, and the build asks ptxas to warn on any
// double-precision use.  Constants that the JAX package forms in float64
// (such as r_g * r_g) arrive precomputed from Python, rounded once.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace picles {

// max/min that propagate NaN like jnp.maximum and torch.maximum (fmaxf and
// fminf return the other operand), so a NaN lane stays NaN for the guards.
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// isfinite without a detour through double (the C++ overloads may widen)
__device__ __forceinline__ bool finitef(float a) {
  return fabsf(a) < __int_as_float(0x7f800000);
}

enum WindKind : int { WIND_CONSTANT = 0, WIND_HALF_DOMAIN = 1, WIND_TIME_COSINE = 2 };

struct WindParams {
  int kind;
  int has_t_off;
  float u0, v0;        // U10, V10
  float x_split;       // half-domain switch position
  float background;    // half-domain value beyond x_split
  float two_pi;        // float32(2 pi)
  float period;        // time-cosine period
  float t_off;         // time-cosine cut-off
};

// Packed wind parameters (picles_torch/ops/advance_cuda.py wind_params):
// floats u0, v0, x_split, background, two_pi, period, t_off; ints kind,
// has_t_off.
constexpr int N_WIND_F = 7;

inline void unpack_wind(const float* g, const int* iv, WindParams& w) {
  w.kind = iv[0];
  w.has_t_off = iv[1];
  w.u0 = g[0]; w.v0 = g[1]; w.x_split = g[2]; w.background = g[3];
  w.two_pi = g[4]; w.period = g[5]; w.t_off = g[6];
}

// Term flags (picles_torch/ops/rhs.py TermFlags)
enum : int {
  TERM_PROPAGATION = 1, TERM_INPUT = 2, TERM_DISSIPATION = 4,
  TERM_PEAK_SHIFT = 8, TERM_DIRECTION = 16
};

struct RHSParams {
  float r_g, C_alpha, C_e, C_varphi, g, p, n, e_T;
  float rg2;                       // r_g * r_g, formed in float64
  float m00, m01, m10, m11, pc;    // uniform projection + great-circle coef.
  int flags;
};

// u, v at a node of x-coordinate xn and time t (no family varies in y).
__device__ __forceinline__ void wind_uv(const WindParams& w, float xn, float t,
                                        float& u, float& v) {
  if (w.kind == WIND_CONSTANT) {
    u = w.u0;
    v = w.v0;
  } else if (w.kind == WIND_HALF_DOMAIN) {
    const bool in = xn < w.x_split;
    u = in ? w.u0 : w.background;
    v = in ? w.v0 : w.background;
  } else {
    float a = cosf(w.two_pi * t / w.period);
    if (w.has_t_off && t > w.t_off) a = 0.0f;
    u = w.u0 * a + 0.0f * xn;
    v = w.v0 * a + 0.0f * xn;
  }
}

// The terms of rhs_core_2d that depend on the wind alone: a lane whose wind
// does not vary in t (the constant and half-domain families) forms them
// once per model step.
struct WindTerms {
  float u, v;
  float u2;  // u * u + v * v
  float uv;  // u * v
  float dv;  // 2 (v * v) - u2
};

__device__ __forceinline__ WindTerms wind_terms_at(const WindParams& p,
                                                   float xn, float t) {
  WindTerms w;
  wind_uv(p, xn, t, w.u, w.v);
  w.u2 = w.u * w.u + w.v * w.v;
  w.uv = w.u * w.v;
  w.dv = 2.0f * (w.v * w.v) - w.u2;
  return w;
}

// picles_tpu/ops/rhs.py rhs_core_2d, one lane: the part that depends on the
// state, given the wind's terms.
__device__ __forceinline__ void rhs_state(const RHSParams& c, float lne,
                                          float cg_x, float cg_y,
                                          const WindTerms& w, float out[5]) {
  const float u = w.u, v = w.v, u2 = w.u2;
  const float c2 = cg_x * cg_x + cg_y * cg_y;
  const float cgp2_raw = c2 / c.rg2;

  const float k_p = c.g / (4.0f * jmax(cgp2_raw, 1e-2f));
  const float omega_p = c.g / (2.0f * jmax(sqrtf(c2) / c.r_g, 0.1f));
  const float c_gp_x = cg_x / c.r_g;
  const float c_gp_y = cg_y / c.r_g;

  const float ar = u2 / (4.0f * cgp2_raw);
  const float alpha2 = ar > 250000.0f ? 250000.0f : ar;
  const float a_p = (u * c_gp_x + v * c_gp_y) / (2.0f * jmax(cgp2_raw, 1e-8f));
  const float H_p = 0.5f * (1.0f + tanhf(c.p * (a_p - 0.85f)));
  const float ax = fabsf(10.0f * (a_p - 0.85f));
  const float ex = expf(-ax);
  const float sech = 2.0f * ex / (1.0f + ex * ex);
  const float Delta_p = 1.0f - 1.25f * (sech * sech);

  const float I_t = (c.flags & TERM_INPUT) ? c.C_e * H_p * alpha2 : 0.0f;
  const float D_t = (c.flags & TERM_DISSIPATION)
                        ? expf(c.n * (lne + 2.0f * logf(k_p / c.e_T)))
                        : 0.0f;
  float S_cg_t = 0.0f;
  if (c.flags & TERM_PEAK_SHIFT) {
    const float k_p2 = k_p * k_p;
    S_cg_t = c.C_alpha * Delta_p * (k_p2 * k_p2) * expf(2.0f * lne);
  }
  float S_dir_t = 0.0f;
  if (c.flags & TERM_DIRECTION) {
    const float prod = u2 * cgp2_raw;
    const float safe = prod == 0.0f ? 1.0f : prod;
    const float val = (2.0f / safe) *
                      (w.uv * (2.0f * (c_gp_y * c_gp_y) - cgp2_raw) -
                       c_gp_x * c_gp_y * w.dv);
    const float sin2 = prod == 0.0f ? 0.0f : val;
    S_dir_t = alpha2 * c.C_varphi * H_p * sin2;
  }
  const float S_sphere_t = c.pc * cg_x;

  out[0] = omega_p * c.r_g * S_cg_t + omega_p * (I_t - D_t);
  out[1] = -cg_x * omega_p * c.r_g * S_cg_t + cg_y * S_dir_t + cg_y * S_sphere_t;
  out[2] = -cg_y * omega_p * c.r_g * S_cg_t - cg_x * S_dir_t - cg_x * S_sphere_t;
  if (c.flags & TERM_PROPAGATION) {
    out[3] = c.m00 * cg_x + c.m01 * cg_y;
    out[4] = c.m10 * cg_x + c.m11 * cg_y;
  } else {
    out[3] = 0.0f;
    out[4] = 0.0f;
  }
}

// The RHS at a node of x-coordinate xn, time t, state (lne, cg_x, cg_y): the
// wind's terms, then the state's part, in a row (K3, and K1's `_simple`
// baseline, evaluate it so at every stage).
__device__ __forceinline__ void rhs_at(const RHSParams& c, const WindParams& w,
                                       float xn, float t, float lne,
                                       float cg_x, float cg_y, float out[5]) {
  rhs_state(c, lne, cg_x, cg_y, wind_terms_at(w, xn, t), out);
}

}  // namespace picles
