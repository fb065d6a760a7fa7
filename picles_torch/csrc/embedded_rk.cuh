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
// stage time and the D stage components.  Every quantity is of the lanes'
// scalar type T (float for K7 and K1's float instances, double for K1's
// double ones): the tableau's coefficients as T (`coef`: the header's
// float32 values, or for double the exact float64 ones of METHODS), the
// floor's eps T's own, every literal T(...), as the JAX package's weak
// Python constants take the lanes' dtype.  `dtmin_eff * (1.0 + 1e-8)` and
// `t_end - 1e-9` are written as the JAX package writes them; in float32 the
// first is dtmin_eff itself.  -fmad=false keeps every product and sum
// apart.

#pragma once

#include <cfloat>
#include <math.h>

#include <type_traits>

#include "rhs.cuh"

namespace picles {

// Tableau M's coefficients as T: tableaux.cuh's float32 values for float,
// its float64 ones (the `...64` functions, METHODS' exact values) for
// double.  Every index is a constant in the unrolled loops, so each folds.
template <class M, class T>
struct Coef {
  __device__ static __forceinline__ T c(int i) {
    if constexpr (std::is_same<T, float>::value) return M::c(i);
    else return M::c64(i);
  }
  __device__ static __forceinline__ T a(int i, int j) {
    if constexpr (std::is_same<T, float>::value) return M::a(i, j);
    else return M::a64(i, j);
  }
  __device__ static __forceinline__ T b(int i) {
    if constexpr (std::is_same<T, float>::value) return M::b(i);
    else return M::b64(i);
  }
  __device__ static __forceinline__ T bt(int i) {
    if constexpr (std::is_same<T, float>::value) return M::bt(i);
    else return M::bt64(i);
  }
};

// One lane in flight: its D components, the S + 1 stage vectors (k[0] the
// FSAL stage of (t, z), k[S] the new one), clock, step and flags.
template <class T, int D, int S>
struct RKLane {
  T z[D];
  T k[S + 1][D];
  T t, t_end, dt;
  bool active, done, failed;
  int nacc, iters;
};

template <class T>
struct RKControl {
  T dtmin, abstol, reltol, neg_inv_order;  // -1 / order
  bool force_dtmin;
};

template <class M, class T, int D, bool ADAPTIVE, class RHS>
__device__ __forceinline__ void rk_substep(const RKControl<T>& cp,
                                           RKLane<T, D, M::S>& L,
                                           const RHS& rhs) {
  constexpr int S = M::S;
  using K = Coef<M, T>;
  const T t = L.t, t_end = L.t_end;
  const T remaining = t_end - t;
  const T dtmin_eff =
      jmax(cp.dtmin, T(4) * eps_of<T>() * jmax(xabs(t), xabs(t_end)));
  const T dt_try = jmin(jmax(L.dt, dtmin_eff), jmax(remaining, dtmin_eff));
  const bool at_dtmin = dt_try <= dtmin_eff * T(1.0 + 1e-8);

#pragma unroll
  for (int s = 1; s < S; ++s) {
    T acc[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      acc[c] = L.z[c];
#pragma unroll
      for (int j = 0; j < s; ++j)
        if (K::a(s - 1, j) != T(0))
          acc[c] = acc[c] + dt_try * K::a(s - 1, j) * L.k[j][c];
    }
    rhs(t + K::c(s - 1) * dt_try, acc, L.k[s]);
  }
  T zn[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    zn[c] = L.z[c];
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (K::b(j) != T(0)) zn[c] = zn[c] + dt_try * K::b(j) * L.k[j][c];
  }
  rhs(t + dt_try, zn, L.k[S]);

  bool accept = true;
  bool newly_failed = false;
  T dt_next = L.dt;
  if (ADAPTIVE) {
    T err_sq = T(0);
    bool finite = true;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      T e = T(0);
#pragma unroll
      for (int j = 0; j <= S; ++j)
        if (K::bt(j) != T(0)) e = e + K::bt(j) * L.k[j][c];
      e = dt_try * e;
      const T sc = cp.abstol + cp.reltol * jmax(xabs(L.z[c]), xabs(zn[c]));
      const T r = e / sc;
      err_sq = err_sq + r * r;
      finite = finite && finitef(zn[c]);
    }
    const T enorm = xsqrt(err_sq / T(D));
    finite = finite && finitef(enorm);
    accept = enorm <= T(1) && finite;
    if (cp.force_dtmin) accept = accept || at_dtmin;
    newly_failed = at_dtmin && !accept;
    const T enorm_safe = jmax(enorm, T(1e-10));
    T q = T(0.9) * xpow(enorm_safe, cp.neg_inv_order);
    if (!finite) q = T(0.2);
    const T factor = jmin(jmax(q, T(0.2)), T(10));
    dt_next = accept ? dt_try * factor
                     : jmax(dt_try * jmin(jmax(q, T(0.2)), T(1)), dtmin_eff);
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
  L.done = L.t >= t_end - T(1e-9) || newly_failed;
  L.failed = L.failed || newly_failed;
  ++L.iters;
}

// integrate_to's ending: a lane still live after maxiters failed.
template <class T, int D, int S>
__device__ __forceinline__ bool rk_failed(const RKLane<T, D, S>& L) {
  return L.failed || (!L.done && L.active);
}

// The clock a finished lane stores: snapped onto t_end unless it failed.
template <class T, int D, int S>
__device__ __forceinline__ T rk_clock(const RKLane<T, D, S>& L, bool failed) {
  return (L.active && !failed) ? L.t_end : L.t;
}

}  // namespace picles
