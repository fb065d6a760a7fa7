// The remesh branch table of one node: shared device code of K5 (remesh.cu)
// and K6 (pic_gather.cu).
//
// Replaces picles_tpu/ops/remesh_pallas.py `remesh_core`, which the JAX
// package inlines into both of its kernels (_remesh_kernel and
// pic_pallas._accum_remesh_kernel).  Plain PyTorch version:
// picles_torch/ops/remesh.py remesh_core.
//
// Per node: gather the deposited node state, or reseed (windsea or fixed
// defaults), or switch off; zero the positions of gathered and reseeded
// particles; clip the carried dt into [dtmin, DT] unless the solver runs
// fixed substeps; write the `on` flag and the branch bitfield.  The winds
// are sampled at the model clock with the K1 samplers (rhs.cuh
// wind_uv_node: a gridded wind from the node's own planes).
//
// Numerics: float32, op for op as PyTorch evaluates the plain version on a
// card.  PyTorch computes `c / x` for a Python scalar c as reciprocal(x) * c,
// and `x / c` on a card as x * (1 / c); the windsea below is written so.  Its
// constants come from the host (picles_torch/ops/remesh_cuda.py), rounded
// once from the Python values, as PyTorch rounds them; precise powf/logf
// (no fast math) and no FMA contraction (-fmad=false).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "rhs.cuh"

namespace picles {

enum : int { GATHER_BIT = 1, RESEED_BIT = 2, OFF_BIT = 4 };
enum : int { SEED_WINDSEA = 0, SEED_FIXED = 1, SEED_SAME = 2 };

// picles_torch/core/fetch_relations.py get_initial_windsea, its constants
struct WindseaConsts {
  float g;            // G_GRAVITY
  float time_scale;   // |timestep|
  float min_amp;      // wind-speed floor 0.1
  float tau_den;      // DULOV_A * DULOV_XI_0X
  float x_exp;        // 1 / (1 - DULOV_Q_X)
  float fgp;          // 3.5
  float fm_exp;       // -0.33
  float alpha_c;      // 0.033
  float alpha_exp;    // 0.67
  float e_c;          // 0.31 * G_GRAVITY ** 2
  float two;          // 2.0
  float pi;           // pi
  float e_exp;        // -4.0
  float t_c;          // 0.9
  float four_pi;      // 4 pi
};
constexpr int N_WINDSEA_F = 15;

struct RemeshParams {
  WindParams wind;
  WindseaConsts ws;
  float seed[3];    // fixed (lne, cgx, cgy) when seed_kind == SEED_FIXED
  float bseed[3];   // boundary nodes' fixed values when bseed_kind == SEED_FIXED
  float minimal_e, minimal_m2, wind_min_squared, dtmin, timestep;
  int seed_kind;    // SEED_WINDSEA | SEED_FIXED
  int bseed_kind;   // SEED_WINDSEA | SEED_FIXED | SEED_SAME (as the interior)
  int boundary_source;
  int clip_dt;
};

// Packed layout, shared with picles_torch/ops/remesh_cuda.py remesh_params.
// floats: wind (7) | windsea (15) | seed (3) | bseed (3) | minimal_e,
//         minimal_m2, wind_min_squared, dtmin, timestep;
// ints:   wind kind, has_t_off, n_wf | seed_kind, bseed_kind,
//         boundary_source, clip_dt.
constexpr int N_REMESH_F = N_WIND_F + N_WINDSEA_F + 11;
constexpr int N_REMESH_I = N_WIND_I + 4;

inline void unpack_remesh(const float* f, const int* iv, RemeshParams& r) {
  unpack_wind(f, iv, r.wind);
  f += N_WIND_F;
  r.ws = WindseaConsts{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7],
                       f[8], f[9], f[10], f[11], f[12], f[13], f[14]};
  f += N_WINDSEA_F;
  for (int k = 0; k < 3; ++k) r.seed[k] = f[k];
  for (int k = 0; k < 3; ++k) r.bseed[k] = f[3 + k];
  r.minimal_e = f[6]; r.minimal_m2 = f[7]; r.wind_min_squared = f[8];
  r.dtmin = f[9]; r.timestep = f[10];
  iv += N_WIND_I;
  r.seed_kind = iv[0]; r.bseed_kind = iv[1];
  r.boundary_source = iv[2]; r.clip_dt = iv[3];
}

// get_initial_windsea(u, v, timestep) -> (lne, cg_bar_x, cg_bar_y)
__device__ __forceinline__ void windsea(const WindseaConsts& c, float u,
                                        float v, float& lne, float& cgx,
                                        float& cgy) {
  float amp = sqrtf(u * u + v * v);
  amp = amp < c.min_amp ? c.min_amp : amp;
  const float tau = (c.g * c.time_scale) / amp;
  const float xt = powf(tau * (1.0f / c.tau_den), c.x_exp);
  const float f_m = (((1.0f / amp) * c.g) * c.fgp) * powf(xt, c.fm_exp);
  const float alpha = powf((f_m * amp) * (1.0f / c.g), c.alpha_exp) * c.alpha_c;
  const float e = (alpha * c.e_c) * powf((f_m * c.two) * c.pi, c.e_exp);
  const float f_peak = (f_m * c.g) / amp;
  const float t_bar = (1.0f / f_peak) * c.t_c;
  const float cg_amp = (t_bar * c.g) * (1.0f / c.four_pi);
  cgx = (cg_amp * u) / amp;
  cgy = (cg_amp * v) / amp;
  lne = logf(e);
}

struct RemeshOut {
  float lne, cgx, cgy, px, py, dt;
  bool on;
  int branch;
};

// One node, index i in the planes every layer shares (a gridded wind's):
// (e_n, mx_n, my_n) is its deposited state, the rest its particle and
// masks; `clock` the model time at which the winds are sampled.
__device__ __forceinline__ RemeshOut remesh_node(
    const RemeshParams& r, float clock, long long i, float e_n, float mx_n,
    float my_n, float lne, float cgx, float cgy, float px, float py,
    float dt, bool on, bool active, bool boundary, float xn) {
  float u, v;
  wind_uv_node(r.wind, i, xn, clock, u, v);
  const float wind2 = u * u + v * v;
  const float m2_n = mx_n * mx_n + my_n * my_n;
  const bool part = r.boundary_source ? (active || boundary) : active;
  const bool gather = part && !boundary && e_n >= r.minimal_e &&
                      m2_n >= r.minimal_m2;
  const bool reseed = part && !gather && wind2 >= r.wind_min_squared;
  const bool off = part && !gather && !reseed;

  RemeshOut o{lne, cgx, cgy, px, py, dt, on, 0};
  if (gather) {
    // transforms.node_to_particle, with its 1e-30 floors
    const float m2 = jmax(m2_n, 1e-30f);
    const float e_safe = jmax(e_n, 1e-30f);
    o.cgx = (mx_n * e_safe) / (2.0f * m2);
    o.cgy = (my_n * e_safe) / (2.0f * m2);
    o.lne = logf(e_safe);
  } else if (reseed) {
    const bool own = boundary && r.bseed_kind != SEED_SAME;
    const int kind = own ? r.bseed_kind : r.seed_kind;
    const float* fixed = own ? r.bseed : r.seed;
    if (kind == SEED_WINDSEA) {
      windsea(r.ws, u, v, o.lne, o.cgx, o.cgy);
    } else {
      o.lne = fixed[0];
      o.cgx = fixed[1];
      o.cgy = fixed[2];
    }
  }
  if (gather || reseed) {
    o.px = 0.0f;
    o.py = 0.0f;
  }
  // torch.clamp(dt, dtmin, timestep): NaN stays NaN
  if (r.clip_dt) o.dt = jmin(jmax(dt, r.dtmin), r.timestep);
  if (part) o.on = gather || reseed;
  o.branch = (gather ? GATHER_BIT : 0) + (reseed ? RESEED_BIT : 0) +
             (off ? OFF_BIT : 0);
  return o;
}

}  // namespace picles
