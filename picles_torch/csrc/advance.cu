// K1 advance and K3 auto-dt: the whole adaptive embedded-RK loop of one
// model step, and the dt reset to Hairer's initial-dt estimate, one thread
// per particle.
//
// Replaces (TPU kernels):
//   K1  picles_tpu/ops/advance_pallas.py  _advance_kernel  (launcher advance_pallas)
//   K3  picles_tpu/ops/advance_pallas.py  _auto_dt_kernel  (launcher auto_dt_pallas)
// Plain PyTorch versions: picles_torch/ops/tsit5.py integrate_to and
// picles_torch/ops/advance_cuda.py auto_dt_reset (over tsit5.py auto_dt).
//
// What bounds them on an H100.  Per particle K1 reads 7 float planes, a
// mask and the node x (33 bytes) and writes 7 planes plus two flags (33
// bytes); each substep costs 3 (bosh3) or 6 (tsit5) RHS evaluations of
// about 100 float operations (12 IEEE divisions and 6 precise
// transcendentals among them) plus the stage sums and the controller.  At
// one substep per model step (the flagship's steady state) the 66 bytes
// dominate the bound; with several substeps (tsit5 from a fresh seed) the
// operations do.  Either way the kernel runs at its instruction rate: the
// SASS of one substep's loop times the warps, over 132 SMs x 4 schedulers
// at the SM clock, is the measured time per substep (root PERF.md §6).  The
// precise divisions and transcendentals that the parity contracts rest on
// are most of those instructions; fewer instructions is the only lever,
// and more warps or interleaved lanes are none.
//
// The design (`advance_kernel`): one thread per particle keeps the state,
// the FSAL stage vector and the controller in registers (no shared memory,
// no intermediate device-memory traffic), threads along y, the contiguous
// axis, so loads and stores coalesce; and
// - the bosh3 and tsit5 tableaux are compile-time constants (tableaux.cuh,
//   which the build writes from picles_torch/ops/tsit5.py METHODS), one
//   template instance per method: every coefficient folds into its
//   instruction and the zero terms, with their run-time tests, vanish;
// - the wind and its wind-only terms (rhs.cuh `WindTerms`) are formed once
//   per lane for winds that do not vary in t (constant, half-domain); the
//   time-cosine family samples them per stage;
// - gridded winds (the JAX kernel's `wind_fields`) are their own template
//   instances: a lane loads its 4 + 3B plane values once (rhs.cuh
//   `GriddedWind`) and forms the wind's terms per stage from them, in the
//   operation order of forcing/winds.py `gridded_samplers`.  They add the
//   planes' bytes, 4 (4 + 3B) a particle, read once: 28 at B = 1, which
//   takes the bytes a particle moves from 66 to 94;
// - the projection (M and the great-circle coefficient pc) is either the
//   5 uniform scalars of a regular Cartesian grid or, on spherical and
//   tripolar grids, 5 per-node planes (the JAX kernel's `uniform is None`
//   branch).  The choice is made at run time in the lane's prologue (a null
//   planes pointer means the scalars): a lane reads its own node's 5 values
//   once, at its home node as the TPU kernel does, into its copy of the RHS
//   constants (`load_projection`), so no template instance is added.  The
//   planes add 20 bytes a particle, read once;
// - layers (several wave systems on one grid) are the launch's second grid
//   dimension: blockIdx.y is the layer, and a lane's own planes are read and
//   written at layer * n + node, while the planes every layer shares (the
//   node x, the projection planes, the gridded wind planes) are read at the
//   node.  So a layered step launches once, each layer's lanes run the
//   single-layer arithmetic, and nothing shared is copied per layer;
// - launch bounds from ptxas's registers: 6 blocks of 128 threads an SM, 5
//   for adaptive tsit5, with no spills; the gridded tsit5 instances, whose
//   lane holds its plane values too, one block less.
// A lane's substep count depends on its state and a warp runs until its
// slowest lane is done.  A refill of finished lanes from a per-warp run of
// particles (the same arithmetic per particle) was measured slower on every
// state, uniform or not: a refill (a load and the first RHS) runs while the
// warp's other lanes wait (root PERF.md §6), so there is none.
// The previous one-particle-per-thread kernel stays compiled as
// `advance_simple_kernel`, the baseline chip_smoke.py and the card tests
// hold this one to bit for bit.
//
// K3 (`auto_dt_kernel`) is the model step's Hairer dt reset, fused: per lane
// `reset ? clamp(estimate, dtmin, DT) : dt`, where the TPU kernel wrote the
// bare estimate and the step clamped and selected it in two more passes.
// Per reset lane it reads 21-29 bytes (the mask, the 5 components, the node
// x and t only where the wind reads them) and writes 4; a lane that is not
// reset reads its mask and dt and writes dt, and evaluates no RHS.  The
// estimate is 2 RHS evaluations and 15 IEEE divisions of the norms, a few
// hundred float operations: on the card it runs at its instruction rate,
// as K1 does (SASS count against the measured time, root PERF.md §6), so
// the design cuts instructions and bytes, never bits: the wind's kind and
// the default term flags compiled in (one instance per wind family, a
// generic one for any other flag set), the wind's terms formed once for
// winds constant in t, no load of a plane the wind does not read, and the
// clamp and select in the same pass.  The previous kernel stays compiled as
// `auto_dt_simple_kernel`, the baseline that, followed by PyTorch's clamp and
// select, the new kernel equals bit for bit.

// Numerics follow the plain version op for op in float32 (see rhs.cuh).
// Two literals of the JAX package are float32 identities and appear here as
// such: `dtmin_eff * (1.0 + 1e-8)` is `dtmin_eff`, and `t_end - 1e-9` is
// `t_end - 1e-9f`.  The build disables FMA contraction (-fmad=false) so a
// product-then-sum rounds twice, as it does in the plain version.

#include <cfloat>
#include <cuda_runtime.h>

#include "rhs.cuh"
#include "tableaux.cuh"

namespace picles {

struct Tableau {
  float c[5];
  float a[5][5];
  float b[6];
  float bt[7];
};

struct AdvanceConfig {
  RHSParams rc;
  WindParams wind;
  Tableau tab;  // read by the `_simple` baseline only
  float DT, abstol, reltol, dtmin, neg_inv_order;
  int maxiters;
  int force_dtmin;
};

struct AutoDtConfig {
  RHSParams rc;
  WindParams wind;
  float abstol, reltol, inv_order_p1, max_dt;
  float dtmin, DT;  // the reset's clamp (not read by the `_simple` baseline)
};

// Packed parameter layout, shared with picles_torch/ops/advance_cuda.py.
// floats: RHS (14) | wind (7) | ...;  ints: flags | wind kind | has_t_off | ...
constexpr int N_RHS_F = 14;

static void unpack_rhs_wind(const float* f, const int* iv, RHSParams& rc,
                            WindParams& w) {
  rc.r_g = f[0]; rc.C_alpha = f[1]; rc.C_e = f[2]; rc.C_varphi = f[3];
  rc.g = f[4]; rc.p = f[5]; rc.n = f[6]; rc.e_T = f[7]; rc.rg2 = f[8];
  rc.m00 = f[9]; rc.m01 = f[10]; rc.m10 = f[11]; rc.m11 = f[12];
  rc.pc = f[13];
  rc.flags = iv[0];
  unpack_wind(f + N_RHS_F, iv + 1, w);
}

// K1's launch shape: 128 threads a block, and the blocks an SM must hold:
// 6 (at most 85 registers), as the baseline's registers allowed, but 5 for
// adaptive tsit5, which spills at 85 (ptxas, root PERF.md §6).  A gridded
// lane holds its plane values too: ptxas gives the bosh3 instances 78 and
// 80 registers (6 blocks still), tsit5's 96 (5 blocks, at most 102) and
// adaptive tsit5's 107 (4 blocks, at most 128), none spilling; the
// projection's run-time choice costs 0-4 registers an instance.
constexpr int K1_THREADS = 128;
template <class M, bool ADAPTIVE, bool GRIDDED>
constexpr int K1_MIN_BLOCKS =
    M::S != 6 ? 6 : (ADAPTIVE ? 5 : 6) - (GRIDDED ? 1 : 0);

// The state of one particle in flight.
template <int S>
struct Lane {
  float z[5];
  float k[S + 1][5];
  float t, t_end, dt, xn;
  bool active, done, failed;
  int nacc, iters;
  WindTerms w0;    // the wind's terms at the start, for winds constant in t
  GriddedWind g;   // a gridded wind's values at the node (gridded instances)
};

struct AdvancePlanes {
  const float *lne, *cgx, *cgy, *x, *y, *t, *dt;
  const unsigned char* act;
  const float* xn;
  float *lne_o, *cgx_o, *cgy_o, *x_o, *y_o, *t_o, *dt_o;
  unsigned char* fail_o;
  int* nacc_o;
  const float* proj;  // per-node m00, m01, m10, m11, pc planes, or null
};

// Node i's projection from the per-node planes (m00, m01, m10, m11, pc, one
// after the other n floats apart) into a lane's copy of the RHS constants.
__device__ __forceinline__ void load_projection(RHSParams& rc,
                                                const float* proj,
                                                long long n, long long i) {
  rc.m00 = proj[i];
  rc.m01 = proj[n + i];
  rc.m10 = proj[2 * n + i];
  rc.m11 = proj[3 * n + i];
  rc.pc = proj[4 * n + i];
}

// The wind's terms of lane L at time t: from its gridded planes, or from
// the analytic wind at its node.
template <bool GRIDDED, int S>
__device__ __forceinline__ WindTerms lane_terms(const AdvanceConfig& cfg,
                                                const Lane<S>& L, float t) {
  return GRIDDED ? gridded_terms(L.g, t) : wind_terms_at(cfg.wind, L.xn, t);
}

// Load lane k, the particle of node i (of n) in its layer, its node's
// projection where the launch has per-node planes, and evaluate its first
// stage (the FSAL vector).
template <int S, bool GRIDDED>
__device__ __forceinline__ void load_lane(const AdvanceConfig& cfg,
                                          RHSParams& rc,
                                          const AdvancePlanes& P, long long n,
                                          long long i, long long k,
                                          Lane<S>& L) {
  L.z[0] = P.lne[k]; L.z[1] = P.cgx[k]; L.z[2] = P.cgy[k];
  L.z[3] = P.x[k]; L.z[4] = P.y[k];
  const float t0 = P.t[k];
  L.active = P.act[k] != 0;
  L.xn = GRIDDED ? 0.0f : P.xn[i];
  L.t_end = t0 + cfg.DT;
  L.t = t0;
  L.dt = jmax(P.dt[k], cfg.dtmin);
  L.done = !L.active || t0 >= L.t_end;
  L.failed = false;
  L.nacc = 0;
  L.iters = 0;
  if (!L.done) {
    if (P.proj) load_projection(rc, P.proj, n, i);
    if (GRIDDED) L.g = load_gridded(cfg.wind, i);
    L.w0 = lane_terms<GRIDDED>(cfg, L, L.t);
    rhs_state(rc, L.z[0], L.z[1], L.z[2], L.w0, L.k[0]);
  }
}

// One substep of the per-lane loop (`advance_simple_kernel`'s loop body).
template <class M, bool ADAPTIVE, bool GRIDDED>
__device__ __forceinline__ void substep(const AdvanceConfig& cfg,
                                        const RHSParams& rc, bool t_free,
                                        Lane<M::S>& L) {
  constexpr int S = M::S;
  const float t = L.t, t_end = L.t_end;
  const float remaining = t_end - t;
  const float dtmin_eff =
      jmax(cfg.dtmin, 4.0f * FLT_EPSILON * jmax(fabsf(t), fabsf(t_end)));
  const float dt_try = jmin(jmax(L.dt, dtmin_eff), jmax(remaining, dtmin_eff));
  const bool at_dtmin = dt_try <= dtmin_eff;

#pragma unroll
  for (int s = 1; s < S; ++s) {
    float acc[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      acc[c] = L.z[c];
#pragma unroll
      for (int j = 0; j < s; ++j)
        if (M::a(s - 1, j) != 0.0f)
          acc[c] = acc[c] + dt_try * M::a(s - 1, j) * L.k[j][c];
    }
    const WindTerms w =
        t_free ? L.w0 : lane_terms<GRIDDED>(cfg, L, t + M::c(s - 1) * dt_try);
    rhs_state(rc, acc[0], acc[1], acc[2], w, L.k[s]);
  }
  float zn[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    zn[c] = L.z[c];
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (M::b(j) != 0.0f) zn[c] = zn[c] + dt_try * M::b(j) * L.k[j][c];
  }
  const WindTerms wf = t_free ? L.w0 : lane_terms<GRIDDED>(cfg, L, t + dt_try);
  rhs_state(rc, zn[0], zn[1], zn[2], wf, L.k[S]);

  bool accept = true;
  bool newly_failed = false;
  float dt_next = L.dt;
  if (ADAPTIVE) {
    float err_sq = 0.0f;
    bool finite = true;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      float e = 0.0f;
#pragma unroll
      for (int j = 0; j <= S; ++j)
        if (M::bt(j) != 0.0f) e = e + M::bt(j) * L.k[j][c];
      e = dt_try * e;
      const float sc = cfg.abstol + cfg.reltol * jmax(fabsf(L.z[c]), fabsf(zn[c]));
      const float r = e / sc;
      err_sq = err_sq + r * r;
      finite = finite && finitef(zn[c]);
    }
    const float enorm = sqrtf(err_sq / 5.0f);
    finite = finite && finitef(enorm);
    accept = enorm <= 1.0f && finite;
    if (cfg.force_dtmin) accept = accept || at_dtmin;
    newly_failed = at_dtmin && !accept;
    const float enorm_safe = jmax(enorm, 1e-10f);
    float q = 0.9f * powf(enorm_safe, cfg.neg_inv_order);
    if (!finite) q = 0.2f;
    const float factor = jmin(jmax(q, 0.2f), 10.0f);
    dt_next = accept ? dt_try * factor
                     : jmax(dt_try * jmin(jmax(q, 0.2f), 1.0f), dtmin_eff);
  }
  if (accept) {
    L.t = t + dt_try;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
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

template <int S>
__device__ __forceinline__ void store_lane(const AdvancePlanes& P, long long i,
                                           const Lane<S>& L) {
  const bool failed = L.failed || (!L.done && L.active);
  P.lne_o[i] = L.z[0];
  P.cgx_o[i] = L.z[1];
  P.cgy_o[i] = L.z[2];
  P.x_o[i] = L.z[3];
  P.y_o[i] = L.z[4];
  P.t_o[i] = (L.active && !failed) ? L.t_end : L.t;
  P.dt_o[i] = L.dt;
  P.fail_o[i] = failed ? 1 : 0;
  P.nacc_o[i] = L.nacc;
}

// K1: one particle per thread; node i of layer blockIdx.y.
template <class M, bool ADAPTIVE, bool GRIDDED>
__global__ void __launch_bounds__(K1_THREADS,
                                  (K1_MIN_BLOCKS<M, ADAPTIVE, GRIDDED>))
advance_kernel(const AdvanceConfig cfg, long long n, const AdvancePlanes P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long k = (long long)blockIdx.y * n + i;
  const bool t_free = !GRIDDED && cfg.wind.kind != WIND_TIME_COSINE;
  RHSParams rc = cfg.rc;
  Lane<M::S> L;
  load_lane<M::S, GRIDDED>(cfg, rc, P, n, i, k, L);
  while (!L.done && L.iters < cfg.maxiters)
    substep<M, ADAPTIVE, GRIDDED>(cfg, rc, t_free, L);
  store_lane(P, k, L);
}

// The baseline (`_simple`): the previous kernel, one particle per thread,
// the tableau a run-time parameter.
template <int S, bool ADAPTIVE, bool FORCE_DTMIN>
__global__ void __launch_bounds__(128)
advance_simple_kernel(const AdvanceConfig cfg, long long n,
               const float* __restrict__ lne_in, const float* __restrict__ cgx_in,
               const float* __restrict__ cgy_in, const float* __restrict__ x_in,
               const float* __restrict__ y_in, const float* __restrict__ t_in,
               const float* __restrict__ dt_in,
               const unsigned char* __restrict__ act_in,
               const float* __restrict__ xn_in,
               float* __restrict__ lne_o, float* __restrict__ cgx_o,
               float* __restrict__ cgy_o, float* __restrict__ x_o,
               float* __restrict__ y_o, float* __restrict__ t_o,
               float* __restrict__ dt_o, unsigned char* __restrict__ fail_o,
               int* __restrict__ nacc_o) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Tableau& tb = cfg.tab;
  float z[5] = {lne_in[i], cgx_in[i], cgy_in[i], x_in[i], y_in[i]};
  const float t0 = t_in[i];
  const bool active = act_in[i] != 0;
  const float xn = xn_in[i];
  const float t_end = t0 + cfg.DT;
  float t = t0;
  float dt = jmax(dt_in[i], cfg.dtmin);
  bool done = !active || t0 >= t_end;
  bool failed = false;
  int nacc = 0;

  if (!done) {
    float k[S + 1][5];
    rhs_at(cfg.rc, cfg.wind, xn, t, z[0], z[1], z[2], k[0]);
    for (int iters = 0; !done && iters < cfg.maxiters; ++iters) {
      const float remaining = t_end - t;
      const float dtmin_eff =
          jmax(cfg.dtmin, 4.0f * FLT_EPSILON * jmax(fabsf(t), fabsf(t_end)));
      const float dt_try = jmin(jmax(dt, dtmin_eff), jmax(remaining, dtmin_eff));
      const bool at_dtmin = dt_try <= dtmin_eff;

#pragma unroll
      for (int s = 1; s < S; ++s) {
        float acc[5];
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          acc[c] = z[c];
#pragma unroll
          for (int j = 0; j < s; ++j)
            if (tb.a[s - 1][j] != 0.0f) acc[c] = acc[c] + dt_try * tb.a[s - 1][j] * k[j][c];
        }
        rhs_at(cfg.rc, cfg.wind, xn, t + tb.c[s - 1] * dt_try, acc[0], acc[1],
               acc[2], k[s]);
      }
      float zn[5];
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        zn[c] = z[c];
#pragma unroll
        for (int j = 0; j < S; ++j)
          if (tb.b[j] != 0.0f) zn[c] = zn[c] + dt_try * tb.b[j] * k[j][c];
      }
      rhs_at(cfg.rc, cfg.wind, xn, t + dt_try, zn[0], zn[1], zn[2], k[S]);

      bool accept = true;
      bool newly_failed = false;
      float dt_next = dt;
      if (ADAPTIVE) {
        float err_sq = 0.0f;
        bool finite = true;
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          float e = 0.0f;
#pragma unroll
          for (int j = 0; j <= S; ++j)
            if (tb.bt[j] != 0.0f) e = e + tb.bt[j] * k[j][c];
          e = dt_try * e;
          const float sc = cfg.abstol + cfg.reltol * jmax(fabsf(z[c]), fabsf(zn[c]));
          const float r = e / sc;
          err_sq = err_sq + r * r;
          finite = finite && finitef(zn[c]);
        }
        const float enorm = sqrtf(err_sq / 5.0f);
        finite = finite && finitef(enorm);
        accept = enorm <= 1.0f && finite;
        if (FORCE_DTMIN) accept = accept || at_dtmin;
        newly_failed = at_dtmin && !accept;
        const float enorm_safe = jmax(enorm, 1e-10f);
        float q = 0.9f * powf(enorm_safe, cfg.neg_inv_order);
        if (!finite) q = 0.2f;
        const float factor = jmin(jmax(q, 0.2f), 10.0f);
        dt_next = accept ? dt_try * factor
                         : jmax(dt_try * jmin(jmax(q, 0.2f), 1.0f), dtmin_eff);
      }
      if (accept) {
        t = t + dt_try;
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          z[c] = zn[c];
          k[0][c] = k[S][c];
        }
        ++nacc;
      }
      dt = dt_next;
      done = t >= t_end - 1e-9f || newly_failed;
      failed = failed || newly_failed;
    }
  }
  failed = failed || (!done && active);
  lne_o[i] = z[0];
  cgx_o[i] = z[1];
  cgy_o[i] = z[2];
  x_o[i] = z[3];
  y_o[i] = z[4];
  t_o[i] = (active && !failed) ? t_end : t;
  dt_o[i] = dt;
  fail_o[i] = failed ? 1 : 0;
  nacc_o[i] = nacc;
}

__device__ __forceinline__ float rms5(const float v[5], const float sc[5]) {
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float r = v[c] / sc[c];
    s = s + r * r;
  }
  return sqrtf(s / 5.0f);
}

struct AutoDtPlanes {
  const float *lne, *cgx, *cgy, *x, *y, *t, *xn, *dt;
  const unsigned char* reset;
  float* out;
  const float* proj;  // per-node m00, m01, m10, m11, pc planes, or null
};

// K3's compiled instances: a wind kind and a term-flag set, or RUNTIME for
// the value in AutoDtConfig.  The main instances compile in every term
// (`TermFlags()`, the set of every configuration chip_smoke.py drives) and
// one wind family each; any other flag set runs a generic instance, the
// gridded kind its own (in the analytic one its lane values would spill).
constexpr int RUNTIME = -1;
constexpr int K3_FLAGS = TERM_PROPAGATION | TERM_INPUT | TERM_DISSIPATION |
                         TERM_PEAK_SHIFT | TERM_DIRECTION;
// K3's launch shape: 128 threads a block and 10 blocks an SM (at most 48
// registers a thread; ptxas gives the analytic instances 46-48 with the
// projection's run-time choice, no spills).  K3 issues one instruction a
// cycle per scheduler already (root PERF.md §6), so more warps in flight
// would not shorten it.  A gridded lane holds its plane values too, and
// spilled 64-68 bytes at 48 registers: its instances take 8 blocks (at
// most 64 registers).
constexpr int K3_THREADS = 128;
template <int KIND>
constexpr int K3_MIN_BLOCKS = KIND == WIND_GRIDDED ? 8 : 10;

// Hairer's estimate of lane k: the `_simple` kernel's arithmetic, operation
// for operation.  With the kind compiled in, a plane the wind does not read
// is not loaded (t for winds constant in t, the node x for constant and
// gridded winds), and the wind's terms of a wind constant in t are formed
// once and serve both RHS evaluations; with the flags compiled in, each
// term's test folds.  A gridded lane loads its plane values once and forms
// the terms at both times from them.  Lane k is the particle of node i (of
// n) in its layer: its own planes are read at k, the node x and the
// per-node projection and wind planes at i, once.
template <int KIND, int FLAGS>
__device__ __forceinline__ float hairer_estimate(const AutoDtConfig& cfg,
                                                 const AutoDtPlanes& P,
                                                 long long n, long long i,
                                                 long long k) {
  RHSParams rc = cfg.rc;
  WindParams wp = cfg.wind;
  if (FLAGS != RUNTIME) rc.flags = FLAGS;
  if (P.proj) load_projection(rc, P.proj, n, i);
  if (KIND != RUNTIME) wp.kind = KIND;
  const bool gridded = KIND == WIND_GRIDDED;
  const bool t_free = wp.kind != WIND_TIME_COSINE && !gridded;
  const float tiny = 1e-10f;
  const float z[5] = {P.lne[k], P.cgx[k], P.cgy[k], P.x[k], P.y[k]};
  const float t = t_free ? 0.0f : P.t[k];
  const float xn =
      wp.kind == WIND_CONSTANT || gridded ? 0.0f : P.xn[i];
  GriddedWind g;
  if (gridded) g = load_gridded(wp, i);
  float sc[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) sc[c] = cfg.abstol + fabsf(z[c]) * cfg.reltol;
  const WindTerms w0 = gridded ? gridded_terms(g, t) : wind_terms_at(wp, xn, t);
  float f0[5];
  rhs_state(rc, z[0], z[1], z[2], w0, f0);
  const float d0 = rms5(z, sc);
  const float d1 = rms5(f0, sc);
  const float h0 = (d0 < 1e-5f || d1 < 1e-5f) ? 1e-6f : 0.01f * d0 / jmax(d1, tiny);

  float z1[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) z1[c] = z[c] + h0 * f0[c];
  const WindTerms w1 = t_free    ? w0
                       : gridded ? gridded_terms(g, t + h0)
                                 : wind_terms_at(wp, xn, t + h0);
  float f1[5];
  rhs_state(rc, z1[0], z1[1], z1[2], w1, f1);
  float df[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) df[c] = f1[c] - f0[c];
  const float d2 = rms5(df, sc) / jmax(h0, tiny);

  const float dmax = jmax(d1, d2);
  const float h1 = dmax <= 1e-15f ? jmax(h0 * 1e-3f, 1e-6f)
                                  : powf(0.01f / jmax(dmax, tiny), cfg.inv_order_p1);
  return jmin(jmin(100.0f * h0, h1), cfg.max_dt);
}

// K3: the Hairer dt reset of one lane per thread,
//   out = reset ? clamp(estimate, dtmin, DT) : dt.
// A lane that is not reset only copies its dt.  The clamp is torch.clamp's
// on the card (ATen's clamp_scalar kernel): a NaN passes with its own bits,
// anything else is min(max(v, dtmin), DT).  Node i of layer blockIdx.y.
template <int KIND, int FLAGS>
__global__ void __launch_bounds__(K3_THREADS, K3_MIN_BLOCKS<KIND>)
auto_dt_kernel(const AutoDtConfig cfg, long long n, const AutoDtPlanes P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long k = (long long)blockIdx.y * n + i;
  float dt;
  if (P.reset[k]) {
    const float est = hairer_estimate<KIND, FLAGS>(cfg, P, n, i, k);
    dt = est != est ? est : fminf(fmaxf(est, cfg.dtmin), cfg.DT);
  } else {
    dt = P.dt[k];
  }
  P.out[k] = dt;
}

// The baseline (`_simple`): the previous kernel, the bare estimate of every lane,
// the wind's kind and the term flags tested at run time.
__global__ void __launch_bounds__(128)
auto_dt_simple_kernel(const AutoDtConfig cfg, long long n,
               const float* __restrict__ lne_in, const float* __restrict__ cgx_in,
               const float* __restrict__ cgy_in, const float* __restrict__ x_in,
               const float* __restrict__ y_in, const float* __restrict__ t_in,
               const float* __restrict__ xn_in, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tiny = 1e-10f;
  const float z[5] = {lne_in[i], cgx_in[i], cgy_in[i], x_in[i], y_in[i]};
  const float t = t_in[i];
  const float xn = xn_in[i];
  float sc[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) sc[c] = cfg.abstol + fabsf(z[c]) * cfg.reltol;
  float f0[5];
  rhs_at(cfg.rc, cfg.wind, xn, t, z[0], z[1], z[2], f0);
  const float d0 = rms5(z, sc);
  const float d1 = rms5(f0, sc);
  const float h0 = (d0 < 1e-5f || d1 < 1e-5f) ? 1e-6f : 0.01f * d0 / jmax(d1, tiny);

  float z1[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) z1[c] = z[c] + h0 * f0[c];
  float f1[5];
  rhs_at(cfg.rc, cfg.wind, xn, t + h0, z1[0], z1[1], z1[2], f1);
  float df[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) df[c] = f1[c] - f0[c];
  const float d2 = rms5(df, sc) / jmax(h0, tiny);

  const float dmax = jmax(d1, d2);
  const float h1 = dmax <= 1e-15f ? jmax(h0 * 1e-3f, 1e-6f)
                                  : powf(0.01f / jmax(dmax, tiny), cfg.inv_order_p1);
  out[i] = jmin(jmin(100.0f * h0, h1), cfg.max_dt);
}

template <int S, bool ADAPTIVE, bool FORCE_DTMIN>
static void launch_advance_simple(const AdvanceConfig& cfg, long long n, void** p,
                           cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  advance_simple_kernel<S, ADAPTIVE, FORCE_DTMIN><<<blocks, threads, 0, stream>>>(
      cfg, n, (const float*)p[0], (const float*)p[1], (const float*)p[2],
      (const float*)p[3], (const float*)p[4], (const float*)p[5],
      (const float*)p[6], (const unsigned char*)p[7], (const float*)p[8],
      (float*)p[9], (float*)p[10], (float*)p[11], (float*)p[12],
      (float*)p[13], (float*)p[14], (float*)p[15], (unsigned char*)p[16],
      (int*)p[17]);
}

template <int S>
static void dispatch_simple(const AdvanceConfig& cfg, bool adaptive,
                            bool force, long long n, void** p,
                            cudaStream_t stream) {
  if (adaptive && force) launch_advance_simple<S, true, true>(cfg, n, p, stream);
  else if (adaptive) launch_advance_simple<S, true, false>(cfg, n, p, stream);
  else if (force) launch_advance_simple<S, false, true>(cfg, n, p, stream);
  else launch_advance_simple<S, false, false>(cfg, n, p, stream);
}

template <class M, bool ADAPTIVE, bool GRIDDED>
static void launch_advance(const AdvanceConfig& cfg, long long n,
                           unsigned layers, void** p, cudaStream_t stream) {
  AdvancePlanes P;
  P.lne = (const float*)p[0]; P.cgx = (const float*)p[1];
  P.cgy = (const float*)p[2]; P.x = (const float*)p[3];
  P.y = (const float*)p[4]; P.t = (const float*)p[5];
  P.dt = (const float*)p[6]; P.act = (const unsigned char*)p[7];
  P.xn = (const float*)p[8];
  P.lne_o = (float*)p[9]; P.cgx_o = (float*)p[10]; P.cgy_o = (float*)p[11];
  P.x_o = (float*)p[12]; P.y_o = (float*)p[13]; P.t_o = (float*)p[14];
  P.dt_o = (float*)p[15]; P.fail_o = (unsigned char*)p[16];
  P.nacc_o = (int*)p[17];
  P.proj = (const float*)p[18];
  const unsigned blocks = (unsigned)((n + K1_THREADS - 1) / K1_THREADS);
  advance_kernel<M, ADAPTIVE, GRIDDED>
      <<<dim3(blocks, layers), K1_THREADS, 0, stream>>>(cfg, n, P);
}

template <class M>
static void dispatch(const AdvanceConfig& cfg, bool adaptive, long long n,
                     unsigned layers, void** p, cudaStream_t stream) {
  const bool gridded = cfg.wind.kind == WIND_GRIDDED;
  if (adaptive && gridded)
    launch_advance<M, true, true>(cfg, n, layers, p, stream);
  else if (adaptive)
    launch_advance<M, true, false>(cfg, n, layers, p, stream);
  else if (gridded)
    launch_advance<M, false, true>(cfg, n, layers, p, stream);
  else
    launch_advance<M, false, false>(cfg, n, layers, p, stream);
}

// The advance's own ints after the RHS flags and the wind's ints.
constexpr int K1_I = 1 + N_WIND_I;

// Unpack the advance's parameters (layout below); returns the stage count.
static int unpack_advance(const float* fparams, const int* iparams,
                          AdvanceConfig& cfg) {
  unpack_rhs_wind(fparams, iparams, cfg.rc, cfg.wind);
  const float* f = fparams + N_RHS_F + N_WIND_F;
  cfg.DT = f[0]; cfg.abstol = f[1]; cfg.reltol = f[2]; cfg.dtmin = f[3];
  cfg.neg_inv_order = f[4];
  f += 5;
  for (int s = 0; s < 5; ++s) cfg.tab.c[s] = f[s];
  f += 5;
  for (int s = 0; s < 5; ++s)
    for (int j = 0; j < 5; ++j) cfg.tab.a[s][j] = f[5 * s + j];
  f += 25;
  for (int s = 0; s < 6; ++s) cfg.tab.b[s] = f[s];
  f += 6;
  for (int s = 0; s < 7; ++s) cfg.tab.bt[s] = f[s];
  cfg.force_dtmin = iparams[K1_I + 2] != 0;
  cfg.maxiters = iparams[K1_I + 3];
  return iparams[K1_I];
}

}  // namespace picles

using namespace picles;

// fparams: RHS (14) | wind (7) | DT, abstol, reltol, dtmin, neg_inv_order |
//          tableau c[5], a[5][5], b[6], bt[7]
// iparams: flags, wind kind, has_t_off, n_wf, stages (3 or 6), adaptive,
//          force_dtmin, maxiters
// ptrs:    lne, cgx, cgy, x, y, t, dt, active(u8), node x  (inputs)
//          lne, cgx, cgy, x, y, t, dt, failed(u8), naccept(i32)  (outputs)
//          the per-node projection planes [5, n] (input; null: the RHS's
//          uniform scalars) | the n_wf gridded wind planes (inputs; none
//          for analytic winds)
// n:       nodes; layers: the particle planes are [layers, n] (layer-major)
//          and the node x, projection and wind planes [n], shared
// Runs the compiled tableau of the stage count (3: bosh3, 6: tsit5: the
// wrapper passes only those methods) and ignores the tableau floats, which
// the `_simple` baseline below reads.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another
// stage count, planes that `attach_planes` refuses or a layer count outside
// [1, MAX_LAYERS]).
constexpr int K1_PTRS = 19;

extern "C" int picles_advance(const float* fparams, const int* iparams,
                              void** ptrs, long long n, long long layers,
                              void* stream) {
  AdvanceConfig cfg;
  const int stages = unpack_advance(fparams, iparams, cfg);
  const bool adaptive = iparams[K1_I + 1] != 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (!attach_planes(cfg.wind, iparams[3], ptrs + K1_PTRS) ||
      bad_layers(layers))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const unsigned ly = (unsigned)layers;
  if (stages == Bosh3::S) dispatch<Bosh3>(cfg, adaptive, n, ly, ptrs, st);
  else if (stages == Tsit5::S) dispatch<Tsit5>(cfg, adaptive, n, ly, ptrs, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The `_simple` baseline (the previous kernel), picles_advance's layout;
// analytic winds and uniform projections only (cudaErrorInvalidValue for a
// gridded wind or projection planes).
extern "C" int picles_advance_simple(const float* fparams, const int* iparams,
                                     void** ptrs, long long n, void* stream) {
  AdvanceConfig cfg;
  const int stages = unpack_advance(fparams, iparams, cfg);
  const bool adaptive = iparams[K1_I + 1] != 0;
  const bool force = cfg.force_dtmin != 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (cfg.wind.kind == WIND_GRIDDED || ptrs[18] != nullptr)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  if (stages == 3) dispatch_simple<3>(cfg, adaptive, force, n, ptrs, st);
  else if (stages == 6) dispatch_simple<6>(cfg, adaptive, force, n, ptrs, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

static void unpack_auto_dt(const float* fparams, const int* iparams,
                           void** ptrs, AutoDtConfig& cfg, AutoDtPlanes& P) {
  unpack_rhs_wind(fparams, iparams, cfg.rc, cfg.wind);
  const float* f = fparams + N_RHS_F + N_WIND_F;
  cfg.abstol = f[0]; cfg.reltol = f[1]; cfg.inv_order_p1 = f[2];
  cfg.max_dt = f[3]; cfg.dtmin = f[4]; cfg.DT = f[5];
  P.lne = (const float*)ptrs[0]; P.cgx = (const float*)ptrs[1];
  P.cgy = (const float*)ptrs[2]; P.x = (const float*)ptrs[3];
  P.y = (const float*)ptrs[4]; P.t = (const float*)ptrs[5];
  P.xn = (const float*)ptrs[6]; P.dt = (const float*)ptrs[7];
  P.reset = (const unsigned char*)ptrs[8]; P.out = (float*)ptrs[9];
  P.proj = (const float*)ptrs[10];
}

template <int KIND, int FLAGS>
static void launch_auto_dt(const AutoDtConfig& cfg, long long n,
                           unsigned layers, const AutoDtPlanes& P,
                           cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + K3_THREADS - 1) / K3_THREADS);
  auto_dt_kernel<KIND, FLAGS>
      <<<dim3(blocks, layers), K3_THREADS, 0, stream>>>(cfg, n, P);
}

// fparams: RHS (14) | wind (7) | abstol, reltol, 1/(order+1), max_dt,
//          dtmin, DT
// iparams: flags, wind kind, has_t_off, n_wf
// ptrs:    lne, cgx, cgy, x, y, t, node x, dt, was_reset(u8) (inputs) |
//          dt (output) | the per-node projection planes [5, n] (input;
//          null: the uniform scalars) | the n_wf gridded wind planes
//          (inputs)
// n, layers: as picles_advance's (dt, was_reset and the output are lane
// planes, the node x and the projection and wind planes shared).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// planes that `attach_planes` refuses or a layer count outside
// [1, MAX_LAYERS]).
constexpr int K3_PTRS = 11;

extern "C" int picles_auto_dt(const float* fparams, const int* iparams,
                              void** ptrs, long long n, long long layers,
                              void* stream) {
  AutoDtConfig cfg;
  AutoDtPlanes P;
  unpack_auto_dt(fparams, iparams, ptrs, cfg, P);
  cudaStream_t st = (cudaStream_t)stream;
  if (!attach_planes(cfg.wind, iparams[3], ptrs + K3_PTRS) ||
      bad_layers(layers))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const unsigned ly = (unsigned)layers;
  if (cfg.rc.flags != K3_FLAGS && cfg.wind.kind == WIND_GRIDDED)
    launch_auto_dt<WIND_GRIDDED, RUNTIME>(cfg, n, ly, P, st);
  else if (cfg.rc.flags != K3_FLAGS)
    launch_auto_dt<RUNTIME, RUNTIME>(cfg, n, ly, P, st);
  else if (cfg.wind.kind == WIND_CONSTANT)
    launch_auto_dt<WIND_CONSTANT, K3_FLAGS>(cfg, n, ly, P, st);
  else if (cfg.wind.kind == WIND_HALF_DOMAIN)
    launch_auto_dt<WIND_HALF_DOMAIN, K3_FLAGS>(cfg, n, ly, P, st);
  else if (cfg.wind.kind == WIND_GRIDDED)
    launch_auto_dt<WIND_GRIDDED, K3_FLAGS>(cfg, n, ly, P, st);
  else
    launch_auto_dt<WIND_TIME_COSINE, K3_FLAGS>(cfg, n, ly, P, st);
  return (int)cudaGetLastError();
}

// The `_simple` baseline, picles_auto_dt's layout: writes the bare estimate
// of every lane to the output (dtmin, DT, dt and was_reset are not read);
// analytic winds and uniform projections only (cudaErrorInvalidValue for a
// gridded wind or projection planes).
extern "C" int picles_auto_dt_simple(const float* fparams, const int* iparams,
                                     void** ptrs, long long n, void* stream) {
  AutoDtConfig cfg;
  AutoDtPlanes P;
  unpack_auto_dt(fparams, iparams, ptrs, cfg, P);
  if (cfg.wind.kind == WIND_GRIDDED || P.proj != nullptr)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  auto_dt_simple_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      cfg, n, P.lne, P.cgx, P.cgy, P.x, P.y, P.t, P.xn, P.out);
  return (int)cudaGetLastError();
}
