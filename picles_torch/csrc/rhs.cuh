// Shared device code of the advance (K1) and auto-dt (K3) kernels: the
// wind samplers and the 2D particle RHS, split into the terms that depend
// on the wind alone (`wind_terms_at`) and the rest (`rhs_state`).
//
// Replaces the closures that the JAX package's Pallas kernels inline:
// picles_tpu/ops/rhs.py `rhs_core_2d` and the wind samplers of
// picles_tpu/forcing/winds.py (`constant_winds`, `half_domain_winds`,
// `time_cosine_winds`, `gridded_pallas_samplers`).  A CUDA kernel cannot
// take a Python closure, so the wind is a kind plus float parameters
// (picles_torch/forcing/winds.py `WindKernel` builds them) and, for gridded
// winds, the per-node planes of one model step (`GriddedWind`).
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

// The layers one launch takes (its gridDim.y), as
// picles_torch/ops/cuda_build.py MAX_LAYERS; the C entry points refuse any
// other count.
constexpr long long MAX_LAYERS = 65535;
inline bool bad_layers(long long layers) {
  return layers < 1 || layers > MAX_LAYERS;
}

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

enum WindKind : int {
  WIND_CONSTANT = 0, WIND_HALF_DOMAIN = 1, WIND_TIME_COSINE = 2,
  WIND_GRIDDED = 3
};

struct WindParams {
  int kind;
  int has_t_off;
  float u0, v0;        // U10, V10
  float x_split;       // half-domain switch position
  float background;    // half-domain value beyond x_split
  float two_pi;        // float32(2 pi)
  float period;        // time-cosine period
  float t_off;         // time-cosine cut-off
  int n_break;         // gridded: breakpoints B (4 + 3B planes), else 0
  const float* wf;     // gridded: plane 0 (a_u) of the launch's planes
  long long wf_stride; // gridded: floats from one plane to the next
};

// Packed wind parameters (picles_torch/ops/advance_cuda.py wind_params):
// floats u0, v0, x_split, background, two_pi, period, t_off; ints kind,
// has_t_off, n_wf (the count of gridded planes, 4 + 3B, else 0).  The
// planes themselves follow each kernel's own pointers (`attach_planes`).
constexpr int N_WIND_F = 7;
constexpr int N_WIND_I = 3;

inline void unpack_wind(const float* g, const int* iv, WindParams& w) {
  w.kind = iv[0];
  w.has_t_off = iv[1];
  w.n_break = iv[2] >= 4 ? (iv[2] - 4) / 3 : 0;
  w.u0 = g[0]; w.v0 = g[1]; w.x_split = g[2]; w.background = g[3];
  w.two_pi = g[4]; w.period = g[5]; w.t_off = g[6];
  w.wf = nullptr;
  w.wf_stride = 0;
}

// The gridded planes of a launch: n_wf pointers, one plane after the other
// at one stride (the wrapper passes views of one [n_wf, ...] tensor).
// Returns false (the launch is refused) for a count that is not 4 + 3B or
// planes that are not evenly spaced.
inline bool attach_planes(WindParams& w, int n_wf, void* const* planes) {
  if (w.kind != WIND_GRIDDED) return n_wf == 0;
  if (n_wf < 7 || (n_wf - 4) % 3 != 0) return false;
  const float* base = (const float*)planes[0];
  const long long stride = (const float*)planes[1] - base;
  for (int k = 2; k < n_wf; ++k)
    if ((const float*)planes[k] - base != k * stride) return false;
  w.wf = base;
  w.wf_stride = stride;
  return true;
}

// Term flags (picles_torch/ops/rhs.py TermFlags)
enum : int {
  TERM_PROPAGATION = 1, TERM_INPUT = 2, TERM_DISSIPATION = 4,
  TERM_PEAK_SHIFT = 8, TERM_DIRECTION = 16
};

struct RHSParams {
  float r_g, C_alpha, C_e, C_varphi, g, p, n, e_T;
  float rg2;                       // r_g * r_g, formed in float64
  // projection M and great-circle coefficient: the launch's uniform
  // scalars, or a lane's own node values (advance.cu `load_projection`)
  float m00, m01, m10, m11, pc;
  int flags;
};

// u, v of an analytic wind at a node of x-coordinate xn and time t (no
// family varies in y).
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

// Gridded winds (picles_torch/forcing/winds.py GriddedWinds2D
// .pallas_pwl_fields): over one model step the wind at a node is
//   u(t) = a_u + t s_u + sum_k ds_u_k max(t - b_k, 0)   (v alike),
// planes a_u, s_u, a_v, s_v, then ds_u_k, ds_v_k, b_k for k < B.  A lane
// loads its values once: the first GRID_REG_B breakpoints' into registers
// (B = 1 on a DT that the record's cadence covers, 2 for one up to twice
// the cadence); the planes of any further breakpoint are read at each
// evaluation, so every B runs.
constexpr int GRID_REG_B = 2;

struct GriddedWind {
  float a_u, s_u, a_v, s_v;
  float ds_u[GRID_REG_B], ds_v[GRID_REG_B], b[GRID_REG_B];
  int nb;
  const float* far;  // plane 4 + 3 GRID_REG_B at the node (B > GRID_REG_B)
  long long stride;
};

__device__ __forceinline__ GriddedWind load_gridded(const WindParams& w,
                                                    long long i) {
  GriddedWind g;
  const long long s = w.wf_stride;
  const float* p = w.wf + i;
  g.a_u = p[0];
  g.s_u = p[s];
  g.a_v = p[2 * s];
  g.s_v = p[3 * s];
  g.nb = w.n_break;
#pragma unroll
  for (int k = 0; k < GRID_REG_B; ++k) {
    const bool in = k < g.nb;
    g.ds_u[k] = in ? p[(4 + 3 * k) * s] : 0.0f;
    g.ds_v[k] = in ? p[(5 + 3 * k) * s] : 0.0f;
    g.b[k] = in ? p[(6 + 3 * k) * s] : 0.0f;
  }
  g.far = p + (4 + 3 * GRID_REG_B) * s;
  g.stride = s;
  return g;
}

// gridded_samplers' operations: a + t s, then + ds_k max(t - b_k, 0) in k
// order, the max propagating NaN (jmax).  -fmad=false keeps each product
// and sum apart.
__device__ __forceinline__ void gridded_uv(const GriddedWind& g, float t,
                                           float& u, float& v) {
  u = g.a_u + t * g.s_u;
  v = g.a_v + t * g.s_v;
#pragma unroll
  for (int k = 0; k < GRID_REG_B; ++k) {
    if (k < g.nb) {
      const float r = jmax(t - g.b[k], 0.0f);
      u = u + g.ds_u[k] * r;
      v = v + g.ds_v[k] * r;
    }
  }
  for (int k = GRID_REG_B; k < g.nb; ++k) {
    const float* q = g.far + 3 * (k - GRID_REG_B) * g.stride;
    const float r = jmax(t - q[2 * g.stride], 0.0f);
    u = u + q[0] * r;
    v = v + q[g.stride] * r;
  }
}

// u, v of any kind at node i (x-coordinate xn) and time t: the remesh's
// sampler, which reads a gridded node's planes directly.
__device__ __forceinline__ void wind_uv_node(const WindParams& w, long long i,
                                             float xn, float t, float& u,
                                             float& v) {
  if (w.kind == WIND_GRIDDED)
    gridded_uv(load_gridded(w, i), t, u, v);
  else
    wind_uv(w, xn, t, u, v);
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

__device__ __forceinline__ WindTerms terms_of(float u, float v) {
  WindTerms w;
  w.u = u;
  w.v = v;
  w.u2 = u * u + v * v;
  w.uv = u * v;
  w.dv = 2.0f * (v * v) - w.u2;
  return w;
}

__device__ __forceinline__ WindTerms wind_terms_at(const WindParams& p,
                                                   float xn, float t) {
  float u, v;
  wind_uv(p, xn, t, u, v);
  return terms_of(u, v);
}

__device__ __forceinline__ WindTerms gridded_terms(const GriddedWind& g,
                                                   float t) {
  float u, v;
  gridded_uv(g, t, u, v);
  return terms_of(u, v);
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
