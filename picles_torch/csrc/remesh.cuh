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
// K1's epilogue (advance.cu) reseeds its re-lit and guarded lanes with the
// same `windsea`, so the port holds one copy of the fetch relations; the
// counters of both epilogues are laid out and reduced here (`N_COUNTERS`,
// `block_counts`).
//
// Numerics: the lanes' scalar type T (float, or double in the float64
// library), op for op as PyTorch evaluates the plain version on a card.
// PyTorch computes `c / x` for a Python scalar c as reciprocal(x) * c, and
// `x / c` on a card as x * (1 / c), the reciprocal formed in T; the windsea
// below is written so.  Its constants come from the host
// (picles_torch/ops/remesh_cuda.py), rounded once from the Python values to
// T, as PyTorch rounds them; precise pow and log of T (no fast math) and no
// FMA contraction (-fmad=false).  The windsea is the fetch relations'
// arithmetic in T (picles_torch/core/fetch_relations.py computes in the
// model's dtype, as the JAX package does with x64 on).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "rhs.cuh"

namespace picles {

enum : int { GATHER_BIT = 1, RESEED_BIT = 2, OFF_BIT = 4 };
enum : int { SEED_WINDSEA = 0, SEED_FIXED = 1, SEED_SAME = 2 };

// The step's counters as K1's and K6's epilogues fill them: one int32 row
// of N_COUNTERS a layer, in picles_torch/models/state.py StepMetrics order
// (the model reads the row as its StepMetrics).  K1 adds the first six,
// n_clamped and the max of substeps_max; K6 adds the remesh's three.
enum : int {
  C_ACTIVE = 0, C_FAILED, C_NAN_RESET, C_INF_RESET, C_EMAX_CLAMP, C_RELIGHT,
  C_GATHER, C_RESEED, C_OFF, C_CLAMPED, C_SUBSTEPS_MAX, N_COUNTERS
};

// Add the block's counts to `row`: value c of every thread to slot
// slot(c), the last one as a max when MAX_LAST.  Each warp reduces its
// lanes' values, the block's warps meet in shared memory, and one thread a
// slot adds (or maxes) the block's total with one integer atomic: integer
// sums do not depend on their order, so the counters are the same on every
// run.  Every thread of the block calls it (blocks of whole warps).
constexpr int COUNT_WARPS_MAX = 32;
template <int N, bool MAX_LAST, class Slot>
__device__ __forceinline__ void block_counts(int* row, const int (&v)[N],
                                             Slot slot) {
  __shared__ int part[COUNT_WARPS_MAX][N];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int warp = tid >> 5;
  const int warps = (blockDim.x * blockDim.y) >> 5;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const int r = MAX_LAST && c == N - 1 ? __reduce_max_sync(0xffffffffu, v[c])
                                         : __reduce_add_sync(0xffffffffu, v[c]);
    if ((tid & 31) == 0) part[warp][c] = r;
  }
  __syncthreads();
  if (tid < N) {
    const bool mx = MAX_LAST && tid == N - 1;
    int s = part[0][tid];
    for (int w = 1; w < warps; ++w)
      s = mx ? max(s, part[w][tid]) : s + part[w][tid];
    if (mx && s > 0) atomicMax(row + slot(tid), s);
    else if (!mx && s != 0) atomicAdd(row + slot(tid), s);
  }
}

// picles_torch/core/fetch_relations.py get_initial_windsea, its constants
template <class T>
struct WindseaConsts {
  T g;            // G_GRAVITY
  T time_scale;   // |timestep|
  T min_amp;      // wind-speed floor 0.1
  T tau_den;      // DULOV_A * DULOV_XI_0X
  T x_exp;        // 1 / (1 - DULOV_Q_X)
  T fgp;          // 3.5
  T fm_exp;       // -0.33
  T alpha_c;      // 0.033
  T alpha_exp;    // 0.67
  T e_c;          // 0.31 * G_GRAVITY ** 2
  T two;          // 2.0
  T pi;           // pi
  T e_exp;        // -4.0
  T t_c;          // 0.9
  T four_pi;      // 4 pi
};
constexpr int N_WINDSEA_F = 15;

template <class T>
struct RemeshParams {
  WindParams<T> wind;
  WindseaConsts<T> ws;
  T seed[3];    // fixed (lne, cgx, cgy) when seed_kind == SEED_FIXED
  T bseed[3];   // boundary nodes' fixed values when bseed_kind == SEED_FIXED
  T minimal_e, minimal_m2, wind_min_squared, dtmin, timestep;
  int seed_kind;    // SEED_WINDSEA | SEED_FIXED
  int bseed_kind;   // SEED_WINDSEA | SEED_FIXED | SEED_SAME (as the interior)
  int boundary_source;
  int clip_dt;
};

// Packed layout, shared with picles_torch/ops/remesh_cuda.py remesh_params.
// floats (T): wind (7) | windsea (15) | seed (3) | bseed (3) | minimal_e,
//         minimal_m2, wind_min_squared, dtmin, timestep;
// ints:   wind kind, has_t_off, n_wf | seed_kind, bseed_kind,
//         boundary_source, clip_dt.
constexpr int N_REMESH_F = N_WIND_F + N_WINDSEA_F + 11;
constexpr int N_REMESH_I = N_WIND_I + 4;

template <class T>
inline void unpack_remesh(const T* f, const int* iv, RemeshParams<T>& r) {
  unpack_wind(f, iv, r.wind);
  f += N_WIND_F;
  r.ws = WindseaConsts<T>{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7],
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
template <class T>
__device__ __forceinline__ void windsea(const WindseaConsts<T>& c, T u, T v,
                                        T& lne, T& cgx, T& cgy) {
  T amp = xsqrt(u * u + v * v);
  amp = amp < c.min_amp ? c.min_amp : amp;
  const T tau = (c.g * c.time_scale) / amp;
  const T xt = xpow(tau * (T(1) / c.tau_den), c.x_exp);
  const T f_m = (((T(1) / amp) * c.g) * c.fgp) * xpow(xt, c.fm_exp);
  const T alpha = xpow((f_m * amp) * (T(1) / c.g), c.alpha_exp) * c.alpha_c;
  const T e = (alpha * c.e_c) * xpow((f_m * c.two) * c.pi, c.e_exp);
  const T f_peak = (f_m * c.g) / amp;
  const T t_bar = (T(1) / f_peak) * c.t_c;
  const T cg_amp = (t_bar * c.g) * (T(1) / c.four_pi);
  cgx = (cg_amp * u) / amp;
  cgy = (cg_amp * v) / amp;
  lne = xlog(e);
}

template <class T>
struct RemeshOut {
  T lne, cgx, cgy, px, py, dt;
  bool on;
  int branch;
};

// One node, index i in the planes every layer shares (a gridded wind's):
// (e_n, mx_n, my_n) is its deposited state, the rest its particle and
// masks; `clock` the model time at which the winds are sampled.
template <class T>
__device__ __forceinline__ RemeshOut<T> remesh_node(
    const RemeshParams<T>& r, T clock, long long i, T e_n, T mx_n, T my_n,
    T lne, T cgx, T cgy, T px, T py, T dt, bool on, bool active,
    bool boundary, T xn) {
  T u, v;
  wind_uv_node(r.wind, i, xn, clock, u, v);
  const T wind2 = u * u + v * v;
  const T m2_n = mx_n * mx_n + my_n * my_n;
  const bool part = r.boundary_source ? (active || boundary) : active;
  const bool gather = part && !boundary && e_n >= r.minimal_e &&
                      m2_n >= r.minimal_m2;
  const bool reseed = part && !gather && wind2 >= r.wind_min_squared;
  const bool off = part && !gather && !reseed;

  RemeshOut<T> o{lne, cgx, cgy, px, py, dt, on, 0};
  if (gather) {
    // transforms.node_to_particle, with its 1e-30 floors
    const T m2 = jmax(m2_n, T(1e-30));
    const T e_safe = jmax(e_n, T(1e-30));
    o.cgx = (mx_n * e_safe) / (T(2) * m2);
    o.cgy = (my_n * e_safe) / (T(2) * m2);
    o.lne = xlog(e_safe);
  } else if (reseed) {
    const bool own = boundary && r.bseed_kind != SEED_SAME;
    const int kind = own ? r.bseed_kind : r.seed_kind;
    const T* fixed = own ? r.bseed : r.seed;
    if (kind == SEED_WINDSEA) {
      windsea(r.ws, u, v, o.lne, o.cgx, o.cgy);
    } else {
      o.lne = fixed[0];
      o.cgx = fixed[1];
      o.cgy = fixed[2];
    }
  }
  if (gather || reseed) {
    o.px = T(0);
    o.py = T(0);
  }
  // torch.clamp(dt, dtmin, timestep): NaN stays NaN
  if (r.clip_dt) o.dt = jmin(jmax(dt, r.dtmin), r.timestep);
  if (part) o.on = gather || reseed;
  o.branch = (gather ? GATHER_BIT : 0) + (reseed ? RESEED_BIT : 0) +
             (off ? OFF_BIT : 0);
  return o;
}

}  // namespace picles
