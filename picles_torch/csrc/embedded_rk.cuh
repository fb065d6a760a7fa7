// The embedded Runge-Kutta substep of one lane, shared by the advance
// kernels: K1 (advance.cu, the 2D particle's 5 components) and K7
// (advance_1d.cu, the 1D particle's 3).  It is the loop body of
// picles_torch/ops/tsit5.py integrate_to, operation for operation:
//
// - the substep window: the spacing-aware floor dtmin_eff = max(dtmin,
//   4 eps max(|t|, |t_end|)) and dt_try = min(max(dt, dtmin_eff),
//   max(t_end - t, dtmin_eff)), which lands on t_end;
// - the stages of the compiled tableau M (tableaux.cuh: c, a, b, bt as
//   compile-time constants, so the zero terms vanish), with FSAL: k[0] holds
//   the RHS of (t, z) on entry and is replaced by the new one on accept;
// - adaptive: the scaled RMS norm of the error over the D components,
//   summed in order and divided by D (tsit5.py `_rms`), accept at norm <= 1
//   (or at dtmin_eff under force_dtmin), the I-controller with safety 0.9
//   clipped to [0.2, 10] (to [0.2, 1] after a reject, floored at
//   dtmin_eff); fixed substeps: every substep accepted, dt carried;
// - the lane is done once its clock reaches t_end - 1e-9 or it failed at
//   dtmin_eff.
//
// The right-hand side is the caller's: a functor `rhs(t, z, out)` of the
// stage time and the D stage components.  The two literals of the JAX
// package that are float32 identities appear as such:
// `dtmin_eff * (1.0 + 1e-8)` is `dtmin_eff`, `t_end - 1e-9` is
// `t_end - 1e-9f`.  -fmad=false keeps every product and sum apart.

#pragma once

#include <cfloat>
#include <math.h>

#include "rhs.cuh"

namespace picles {

// One lane in flight: its D components, the S + 1 stage vectors (k[0] the
// FSAL stage of (t, z), k[S] the new one), clock, step and flags.
template <int D, int S>
struct RKLane {
  float z[D];
  float k[S + 1][D];
  float t, t_end, dt;
  bool active, done, failed;
  int nacc, iters;
};

struct RKControl {
  float dtmin, abstol, reltol, neg_inv_order;  // -1 / order
  bool force_dtmin;
};

template <class M, int D, bool ADAPTIVE, class RHS>
__device__ __forceinline__ void rk_substep(const RKControl& cp,
                                           RKLane<D, M::S>& L,
                                           const RHS& rhs) {
  constexpr int S = M::S;
  const float t = L.t, t_end = L.t_end;
  const float remaining = t_end - t;
  const float dtmin_eff =
      jmax(cp.dtmin, 4.0f * FLT_EPSILON * jmax(fabsf(t), fabsf(t_end)));
  const float dt_try = jmin(jmax(L.dt, dtmin_eff), jmax(remaining, dtmin_eff));
  const bool at_dtmin = dt_try <= dtmin_eff;

#pragma unroll
  for (int s = 1; s < S; ++s) {
    float acc[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      acc[c] = L.z[c];
#pragma unroll
      for (int j = 0; j < s; ++j)
        if (M::a(s - 1, j) != 0.0f)
          acc[c] = acc[c] + dt_try * M::a(s - 1, j) * L.k[j][c];
    }
    rhs(t + M::c(s - 1) * dt_try, acc, L.k[s]);
  }
  float zn[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    zn[c] = L.z[c];
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (M::b(j) != 0.0f) zn[c] = zn[c] + dt_try * M::b(j) * L.k[j][c];
  }
  rhs(t + dt_try, zn, L.k[S]);

  bool accept = true;
  bool newly_failed = false;
  float dt_next = L.dt;
  if (ADAPTIVE) {
    float err_sq = 0.0f;
    bool finite = true;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float e = 0.0f;
#pragma unroll
      for (int j = 0; j <= S; ++j)
        if (M::bt(j) != 0.0f) e = e + M::bt(j) * L.k[j][c];
      e = dt_try * e;
      const float sc =
          cp.abstol + cp.reltol * jmax(fabsf(L.z[c]), fabsf(zn[c]));
      const float r = e / sc;
      err_sq = err_sq + r * r;
      finite = finite && finitef(zn[c]);
    }
    const float enorm = sqrtf(err_sq / (float)D);
    finite = finite && finitef(enorm);
    accept = enorm <= 1.0f && finite;
    if (cp.force_dtmin) accept = accept || at_dtmin;
    newly_failed = at_dtmin && !accept;
    const float enorm_safe = jmax(enorm, 1e-10f);
    float q = 0.9f * powf(enorm_safe, cp.neg_inv_order);
    if (!finite) q = 0.2f;
    const float factor = jmin(jmax(q, 0.2f), 10.0f);
    dt_next = accept ? dt_try * factor
                     : jmax(dt_try * jmin(jmax(q, 0.2f), 1.0f), dtmin_eff);
  }
  if (accept) {
    L.t = t + dt_try;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      L.z[c] = zn[c];
      L.k[0][c] = L.k[S][c];
    }
    ++L.nacc;
  }
  L.dt = dt_next;
  L.done = L.t >= t_end - 1e-9f || newly_failed;
  L.failed = L.failed || newly_failed;
  ++L.iters;
}

// integrate_to's ending: a lane still live after maxiters failed.
template <int D, int S>
__device__ __forceinline__ bool rk_failed(const RKLane<D, S>& L) {
  return L.failed || (!L.done && L.active);
}

// The clock a finished lane stores: snapped onto t_end unless it failed.
template <int D, int S>
__device__ __forceinline__ float rk_clock(const RKLane<D, S>& L, bool failed) {
  return (L.active && !failed) ? L.t_end : L.t;
}

}  // namespace picles
