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
//   per lane for winds that do not vary in t (constant, half-domain, and a
//   steady closure given as its two node planes, `WIND_NODE`: a lane loads
//   its node's pair once, 8 bytes a particle, and not the node x, chosen at
//   run time in the lane's prologue, so no template instance is added); the
//   time-cosine
//   family samples them per stage;
// - a traced wind (a closure that reads its time, rhs.cuh `WIND_TRACED`)
//   is compiled into a library of its own (PICLES_TRACED_WIND), which holds
//   only its instances: a lane loads its node's x and y once (the y plane is
//   the launch's one wind plane, 4 more bytes a particle) and calls the
//   emitted `traced_wind` at every stage time, as the JAX kernel calls the
//   closure; its instances take one block an SM less, as the gridded ones;
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
//   lane holds its plane values too, one block less;
// - the step's glue in the epilogue (`guard_lane`, the model's fused path):
//   where the step runs K1 and then K6 (a wind other than gridded), each
//   lane applies the step's selects, re-light, NaN and Inf guards,
//   log-energy clamp, deposit mask and channels itself, and each block adds
//   the step's counts to one int32 row a layer, so the step no longer runs
//   dozens of PyTorch passes over the planes between the two kernels.  It
//   runs after the loop, when the stage registers are dead; the re-light
//   reseeds with remesh.cuh's `windsea`, the fetch relations K5 and K6
//   reseed with.
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
// generic one for any other flag set; the node kind, a steady closure's
// two node planes, runs in the constant instance, chosen at run time), the
// wind's terms formed once for winds constant in t, no load of a plane the
// wind does not read, and the clamp and select in the same pass.  The previous kernel stays compiled as
// `auto_dt_simple_kernel`, the baseline that, followed by PyTorch's clamp and
// select, the new kernel equals bit for bit.

// Numerics follow the plain version op for op in the lanes' scalar type
// (see rhs.cuh): float32 in the kernels' own library, float64 in the float64
// library (PICLES_F64), whose instances are these same templates with T =
// double.  `dtmin_eff * (1.0 + 1e-8)` and `t_end - 1e-9` are written as the
// JAX package writes them (embedded_rk.cuh).  The build disables FMA
// contraction (-fmad=false) so a product-then-sum rounds twice, as it does
// in the plain version.
//
// The double instances: the same arithmetic with every lane value, packed
// parameter and literal a double, the gridded wind planes read as float32
// and widened, and the node planes, the projection planes, the node x and
// y and the clock read as doubles, as JAX's float64 kernel has them; a
// float64 traced wind's (PICLES_F64 and PICLES_TRACED_WIND) call its
// emitted double function, as JAX's float64 kernel calls the closure on the
// lanes' float64 arrays.  A lane holds twice the registers, so their
// launch bounds ask fewer blocks an SM (`K1_MIN_BLOCKS`, `K3_MIN_BLOCKS`);
// the `_simple` baselines have no double instance.

#include <cfloat>
#include <cuda_runtime.h>

#include <type_traits>

#include "embedded_rk.cuh"
#include "remesh.cuh"
#include "rhs.cuh"
#include "tableaux.cuh"

namespace picles {
PICLES_KERNELS_BEGIN

struct Tableau {
  float c[5];
  float a[5][5];
  float b[6];
  float bt[7];
};

// The step's guards that K1's epilogue applies (`guard_lane`): the reseed
// of re-lit and guarded lanes (remesh.cuh's windsea, or fixed values), the
// re-light's wind floor, the log-energy maximum and the deposit's clamp
// bounds of the declared halo, each rounded once to T as the step's
// PyTorch glue rounds its Python scalars.
template <class T>
struct GuardConfig {
  WindseaConsts<T> ws;
  T seed[3];  // fixed (lne, cgx, cgy) when seed_kind == SEED_FIXED
  T wind_min_squared, lemax, x_lo, x_hi, y_lo, y_hi;
  int seed_kind;        // SEED_WINDSEA | SEED_FIXED
  int boundary_source;  // boundary nodes deposit (open-boundary inflow)
};

template <class T>
struct AdvanceConfig {
  RHSParams<T> rc;
  WindParams<T> wind;
  Tableau tab;  // read by the `_simple` baseline only
  T DT, abstol, reltol, dtmin, neg_inv_order;
  int maxiters;
  int force_dtmin;
  GuardConfig<T> guard;  // read by the epilogue only
};

template <class T>
struct AutoDtConfig {
  RHSParams<T> rc;
  WindParams<T> wind;
  T abstol, reltol, inv_order_p1, max_dt;
  T dtmin, DT;  // the reset's clamp (not read by the `_simple` baseline)
};

// Packed parameter layout, shared with picles_torch/ops/advance_cuda.py, of
// T each (float32 or float64 by the library).
// floats: RHS (14) | wind (7) | ...;  ints: flags | wind kind | has_t_off | ...
constexpr int N_RHS_F = 14;

template <class T>
static void unpack_rhs_wind(const T* f, const int* iv, RHSParams<T>& rc,
                            WindParams<T>& w) {
  rc.r_g = f[0]; rc.C_alpha = f[1]; rc.C_e = f[2]; rc.C_varphi = f[3];
  rc.g = f[4]; rc.p = f[5]; rc.n = f[6]; rc.e_T = f[7]; rc.rg2 = f[8];
  rc.m00 = f[9]; rc.m01 = f[10]; rc.m10 = f[11]; rc.m11 = f[12];
  rc.pc = f[13];
  rc.flags = iv[0];
  unpack_wind(f + N_RHS_F, iv + 1, w);
}

// K1's launch shape: 128 threads a block, and the blocks an SM must hold.
// float: 6 (at most 85 registers), as the baseline's registers allowed, but
// 5 for adaptive tsit5, which spills at 85 (ptxas, root PERF.md §6).  A
// gridded lane holds its plane values too: ptxas gives the bosh3 instances
// 78 and 80 registers (6 blocks still), tsit5's 96 (5 blocks, at most 102)
// and adaptive tsit5's 107 (4 blocks, at most 128), none spilling; the
// projection's run-time choice costs 0-4 registers an instance.  double: a
// lane's state, stages and controller take twice the registers: bosh3 4
// blocks (at most 128), 3 gridded; tsit5 3 (at most 168), 2 adaptive or
// gridded (at most 255).  ptxas gives bosh3 126 and 128 (adaptive, which
// spills 4 bytes), gridded 136 and 152; tsit5 162 and 182, gridded 172
// and 190 (chip_smoke.py phase "build" prints them, root PERF.md §6); a
// traced lane holds its node x and y and the callable's temporaries: the
// gridded kind's bounds.
constexpr int K1_THREADS = 128;
template <class T, class M, bool ADAPTIVE, bool GRIDDED>
constexpr int K1_MIN_BLOCKS =
    std::is_same<T, float>::value
        ? (M::S != 6 ? 6 : (ADAPTIVE ? 5 : 6) - (GRIDDED || TRACED_LIB ? 1 : 0))
        : (M::S != 6 ? (GRIDDED || TRACED_LIB ? 3 : 4)
                     : (ADAPTIVE || GRIDDED || TRACED_LIB ? 2 : 3));

// The state of one particle in flight: the embedded-RK lane of its 5
// components (embedded_rk.cuh) and its wind.
template <class T, int S>
struct Lane : RKLane<T, 5, S> {
  T xn;
  T yn;              // the node y (a traced wind's lanes)
  WindTerms<T> w0;   // the wind's terms at the start, for winds constant in t
  GriddedWind<T> g;  // a gridded wind's values at the node (gridded instances)
};

template <class T>
struct AdvancePlanes {
  const T *lne, *cgx, *cgy, *x, *y, *t, *dt;
  const unsigned char* act;  // the lanes advanced (null with the epilogue)
  const T* xn;
  T *lne_o, *cgx_o, *cgy_o, *x_o, *y_o, *t_o, *dt_o;
  unsigned char* fail_o;  // the raw advance's flags and substeps (null with
  int* nacc_o;            // the epilogue)
  const T* proj;  // per-node m00, m01, m10, m11, pc planes, or null
  // the epilogue's planes (`guard_lane`), all null without it: the lanes'
  // flags before the step, the active and boundary nodes (shared by the
  // layers) in; the flags after the re-light, the deposit's mask, its
  // channels (E, m_x, m_y) and the step's counters [layers, N_COUNTERS]
  // out
  const unsigned char *on, *nact, *bnd;
  unsigned char *on_o, *sact_o;
  T *e_o, *mx_o, *my_o;
  int* counts;
};

// Node i's projection from the per-node planes (m00, m01, m10, m11, pc, one
// after the other n values apart) into a lane's copy of the RHS constants.
template <class T>
__device__ __forceinline__ void load_projection(RHSParams<T>& rc,
                                                const T* proj, long long n,
                                                long long i) {
  rc.m00 = proj[i];
  rc.m01 = proj[n + i];
  rc.m10 = proj[2 * n + i];
  rc.m11 = proj[3 * n + i];
  rc.pc = proj[4 * n + i];
}

// The wind's terms of lane L at time t: the traced wind at its node, or
// from its gridded planes, or from the analytic wind at its node.
template <bool GRIDDED, class T, int S>
__device__ __forceinline__ WindTerms<T> lane_terms(const AdvanceConfig<T>& cfg,
                                                   const Lane<T, S>& L, T t) {
  if constexpr (TRACED_LIB) return traced_terms(L.xn, L.yn, t);
  else if constexpr (GRIDDED) return gridded_terms(L.g, t);
  else return wind_terms_at(cfg.wind, L.xn, t);
}

// Load lane k, the particle of node i (of n) in its layer, its node's
// projection where the launch has per-node planes, and evaluate its first
// stage (the FSAL vector).
template <class T, int S, bool GRIDDED>
__device__ __forceinline__ void load_lane(const AdvanceConfig<T>& cfg,
                                          RHSParams<T>& rc,
                                          const AdvancePlanes<T>& P,
                                          long long n, long long i,
                                          long long k, Lane<T, S>& L) {
  L.z[0] = P.lne[k]; L.z[1] = P.cgx[k]; L.z[2] = P.cgy[k];
  L.z[3] = P.x[k]; L.z[4] = P.y[k];
  const T t0 = P.t[k];
  L.active = P.act ? P.act[k] != 0 : (P.on[k] != 0 && P.nact[i] != 0);
  L.xn = GRIDDED || cfg.wind.kind == WIND_NODE ? T(0) : P.xn[i];
  L.yn = TRACED_LIB ? cfg.wind.wn[i] : T(0);
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
    L.w0 = !GRIDDED && cfg.wind.kind == WIND_NODE
               ? node_terms(cfg.wind, i)
               : lane_terms<GRIDDED>(cfg, L, L.t);
    rhs_state(rc, L.z[0], L.z[1], L.z[2], L.w0, L.k[0]);
  }
}

// One substep of the per-lane loop (`advance_simple_kernel`'s loop body):
// embedded_rk.cuh's substep over the 2D RHS, whose wind's terms come from
// the lane's start where they do not vary in t (`t_free`).
template <class M, bool ADAPTIVE, bool GRIDDED, class T>
__device__ __forceinline__ void substep(const AdvanceConfig<T>& cfg,
                                        const RHSParams<T>& rc, bool t_free,
                                        Lane<T, M::S>& L) {
  const RKControl<T> cp{cfg.dtmin, cfg.abstol, cfg.reltol, cfg.neg_inv_order,
                        cfg.force_dtmin != 0};
  rk_substep<M, T, 5, ADAPTIVE>(
      cp, L, [&](T t, const T* z, T* out) {
        const WindTerms<T> w = t_free ? L.w0 : lane_terms<GRIDDED>(cfg, L, t);
        rhs_state(rc, z[0], z[1], z[2], w, out);
      });
}

template <class T, int S>
__device__ __forceinline__ void store_lane(const AdvancePlanes<T>& P,
                                           long long i, const Lane<T, S>& L) {
  const bool failed = rk_failed(L);
  P.lne_o[i] = L.z[0];
  P.cgx_o[i] = L.z[1];
  P.cgy_o[i] = L.z[2];
  P.x_o[i] = L.z[3];
  P.y_o[i] = L.z[4];
  P.t_o[i] = rk_clock(L, failed);
  P.dt_o[i] = L.dt;
  P.fail_o[i] = failed ? 1 : 0;
  P.nacc_o[i] = L.nacc;
}

// K1's epilogue, after lane k's (node i's) loop: the step's guards as the
// PyTorch glue of models/wave_growth_2d.py `_step_glue` computes them, in
// its order and roundings.  The selects (a lane not advanced keeps its
// inputs: its state and clock are the loaded ones, its dt is reloaded, as
// the loop floors it), the off lane's re-light under the wind at its node
// at t + DT, the NaN and then the Inf guard on (lne, cg_x, cg_y) of the
// lanes that did not fail, both resetting to the reseed at positions
// (0, 0), the log-energy clamp, the deposit's mask and channels
// (transforms.particle_to_node) and its clamp test against the declared
// halo.  `cnt` gets the lane's counts in `block_counts`' order of K1.
constexpr int K1_COUNTS = 8;
template <class T, int S>
__device__ __forceinline__ void guard_lane(const AdvanceConfig<T>& cfg,
                                           const AdvancePlanes<T>& P,
                                           long long i, long long k,
                                           const Lane<T, S>& L,
                                           int (&cnt)[K1_COUNTS]) {
  const GuardConfig<T>& g = cfg.guard;
  const bool on = P.on[k] != 0, active = P.nact[i] != 0;
  const bool failed = rk_failed(L);  // never on a lane not advanced
  T lne = L.z[0], cgx = L.z[1], cgy = L.z[2], px = L.z[3], py = L.z[4];
  const T t = rk_clock(L, failed);
  const T dt = L.active ? L.dt : P.dt[k];
  // the wind at the node at the lane's t + DT (its t_end), where it is read
  T u = T(0), v = T(0);
  const bool off = !on && active;
  if (off) wind_uv_node(cfg.wind, i, L.xn, L.t_end, u, v);
  const bool relight = off && u * u + v * v >= g.wind_min_squared;
  const bool guardable = active && !failed;
  const bool nan_reset =
      guardable && (lne != lne || cgx != cgx || cgy != cgy);
  const T inf = inf_of(lne);
  const bool infinite =
      xabs(lne) == inf || xabs(cgx) == inf || xabs(cgy) == inf;
  const bool bad = nan_reset || (guardable && infinite);
  if (relight || bad) {
    if (!off) wind_uv_node(cfg.wind, i, L.xn, L.t_end, u, v);
    if (g.seed_kind == SEED_WINDSEA) {
      windsea(g.ws, u, v, lne, cgx, cgy);
    } else {
      lne = g.seed[0];
      cgx = g.seed[1];
      cgy = g.seed[2];
    }
    px = T(0);
    py = T(0);
  }
  const bool on_o = on || relight;
  const bool emax = guardable && !bad && lne > g.lemax;
  if (emax) lne = g.lemax;
  const bool sact = (on_o && active && !failed) ||
                    (on_o && g.boundary_source && P.bnd[i] != 0);
  // transforms.particle_to_node: E = exp(lne), m = cg E / max(|cg|^2,
  // 1e-30) / 2 (a division by 2.0 is a product with 0.5 on a card)
  const T e = xexp(lne);
  T c2 = cgx * cgx + cgy * cgy;
  c2 = c2 != c2 ? c2 : xfmax(c2, T(1e-30));
  P.lne_o[k] = lne;
  P.cgx_o[k] = cgx;
  P.cgy_o[k] = cgy;
  P.x_o[k] = px;
  P.y_o[k] = py;
  P.t_o[k] = t;
  P.dt_o[k] = dt;
  P.on_o[k] = on_o ? 1 : 0;
  P.sact_o[k] = sact ? 1 : 0;
  P.e_o[k] = e;
  P.mx_o[k] = ((cgx * e) / c2) * T(0.5);
  P.my_o[k] = ((cgy * e) / c2) * T(0.5);
  cnt[0] = L.active;
  cnt[1] = failed;
  cnt[2] = nan_reset;
  cnt[3] = bad && !nan_reset;
  cnt[4] = emax;
  cnt[5] = relight;
  cnt[6] = sact && (px < g.x_lo || px > g.x_hi || py < g.y_lo || py > g.y_hi);
  cnt[7] = L.nacc;
}

// K1: one particle per thread; node i of layer blockIdx.y.  With the
// epilogue's planes (P.counts, never on a gridded instance) each lane runs
// `guard_lane` in place of `store_lane`, and the block adds its counts to
// its layer's row.
template <class T, class M, bool ADAPTIVE, bool GRIDDED>
__global__ void __launch_bounds__(K1_THREADS,
                                  (K1_MIN_BLOCKS<T, M, ADAPTIVE, GRIDDED>))
advance_kernel(const AdvanceConfig<T> cfg, long long n,
               const AdvancePlanes<T> P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long k = (long long)blockIdx.y * n + i;
  const bool guards = !GRIDDED && P.counts != nullptr;
  int cnt[K1_COUNTS] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (i < n) {
    const bool t_free =
        !TRACED_LIB && !GRIDDED && cfg.wind.kind != WIND_TIME_COSINE;
    RHSParams<T> rc = cfg.rc;
    Lane<T, M::S> L;
    load_lane<T, M::S, GRIDDED>(cfg, rc, P, n, i, k, L);
    while (!L.done && L.iters < cfg.maxiters)
      substep<M, ADAPTIVE, GRIDDED>(cfg, rc, t_free, L);
    if (guards) guard_lane(cfg, P, i, k, L, cnt);
    else store_lane(P, k, L);
  }
  // the counters: slots 0-5, then n_clamped and the substeps' max
  if (guards)
    block_counts<K1_COUNTS, true>(
        P.counts + (long long)blockIdx.y * N_COUNTERS, cnt,
        [](int c) { return c < 6 ? c : c + (C_CLAMPED - 6); });
}

#ifdef PICLES_MAIN_LIB
// The baseline (`_simple`): the previous kernel, one particle per thread,
// the tableau a run-time parameter; float only.
template <int S, bool ADAPTIVE, bool FORCE_DTMIN>
__global__ void __launch_bounds__(128)
advance_simple_kernel(const AdvanceConfig<float> cfg, long long n,
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
#endif  // PICLES_MAIN_LIB

template <class T>
__device__ __forceinline__ T rms5(const T v[5], const T sc[5]) {
  T s = T(0);
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const T r = v[c] / sc[c];
    s = s + r * r;
  }
  return xsqrt(s / T(5));
}

template <class T>
struct AutoDtPlanes {
  const T *lne, *cgx, *cgy, *x, *y, *t, *xn, *dt;
  const unsigned char* reset;
  T* out;
  const T* proj;  // per-node m00, m01, m10, m11, pc planes, or null
};

// K3's compiled instances: a wind kind and a term-flag set, or RUNTIME for
// the value in AutoDtConfig.  The main instances compile in every term
// (`TermFlags()`, the set of every configuration chip_smoke.py drives) and
// one wind family each; any other flag set runs a generic instance, the
// gridded kind its own (in the analytic one its lane values would spill).
// A traced library compiles only the traced kind's two (its flags and a
// generic set), which read the node x and y and t of each reset lane.
constexpr int RUNTIME = -1;
constexpr int K3_FLAGS = TERM_PROPAGATION | TERM_INPUT | TERM_DISSIPATION |
                         TERM_PEAK_SHIFT | TERM_DIRECTION;
// K3's launch shape: 128 threads a block and, in float, 10 blocks an SM (at
// most 48 registers a thread; ptxas gives the analytic instances 46-48 with
// the projection's run-time choice, no spills).  K3 issues one instruction a
// cycle per scheduler already (root PERF.md §6), so more warps in flight
// would not shorten it.  A gridded lane holds its plane values too, and
// spilled 64-68 bytes at 48 registers: its instances take 8 blocks (at
// most 64 registers).  double: twice the registers, 5 blocks (at most
// 102; ptxas gives 92-98), 4 gridded or traced (at most 128; 100).
constexpr int K3_THREADS = 128;
template <class T, int KIND>
constexpr int K3_MIN_BLOCKS =
    std::is_same<T, float>::value
        ? (KIND == WIND_GRIDDED || KIND == WIND_TRACED ? 8 : 10)
        : (KIND == WIND_GRIDDED || KIND == WIND_TRACED ? 4 : 5);

// Hairer's estimate of lane k: the `_simple` kernel's arithmetic, operation
// for operation.  With the kind compiled in, a plane the wind does not read
// is not loaded (t for winds constant in t, the node x for constant, node
// and gridded winds), and the wind's terms of a wind constant in t are
// formed once and serve both RHS evaluations; with the flags compiled in,
// each term's test folds.  A gridded lane loads its plane values once and
// forms the terms at both times from them; a node-kind lane (in the
// constant and generic instances, a run-time choice) loads its node's pair
// once.  Lane k is the particle of node i (of
// n) in its layer: its own planes are read at k, the node x and the
// per-node projection and wind planes at i, once.
template <class T, int KIND, int FLAGS>
__device__ __forceinline__ T hairer_estimate(const AutoDtConfig<T>& cfg,
                                             const AutoDtPlanes<T>& P,
                                             long long n, long long i,
                                             long long k) {
  RHSParams<T> rc = cfg.rc;
  WindParams<T> wp = cfg.wind;
  if (FLAGS != RUNTIME) rc.flags = FLAGS;
  if (P.proj) load_projection(rc, P.proj, n, i);
  const bool node = (KIND == RUNTIME || KIND == WIND_CONSTANT) &&
                    cfg.wind.kind == WIND_NODE;
  if (KIND != RUNTIME) wp.kind = KIND;
  constexpr bool gridded = KIND == WIND_GRIDDED;
  constexpr bool traced = KIND == WIND_TRACED;
  const bool t_free =
      node || (wp.kind != WIND_TIME_COSINE && !gridded && !traced);
  const T tiny = T(1e-10);
  const T z[5] = {P.lne[k], P.cgx[k], P.cgy[k], P.x[k], P.y[k]};
  const T t = t_free ? T(0) : P.t[k];
  const T xn =
      wp.kind == WIND_CONSTANT || gridded || node ? T(0) : P.xn[i];
  const T yn = traced ? wp.wn[i] : T(0);
  GriddedWind<T> g;
  if (gridded) g = load_gridded(wp, i);
  T sc[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) sc[c] = cfg.abstol + xabs(z[c]) * cfg.reltol;
  WindTerms<T> w0;
  if constexpr (traced) w0 = traced_terms(xn, yn, t);
  else if constexpr (gridded) w0 = gridded_terms(g, t);
  else w0 = node ? node_terms(wp, i) : wind_terms_at(wp, xn, t);
  T f0[5];
  rhs_state(rc, z[0], z[1], z[2], w0, f0);
  const T d0 = rms5(z, sc);
  const T d1 = rms5(f0, sc);
  const T h0 = (d0 < T(1e-5) || d1 < T(1e-5)) ? T(1e-6)
                                              : T(0.01) * d0 / jmax(d1, tiny);

  T z1[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) z1[c] = z[c] + h0 * f0[c];
  WindTerms<T> w1 = w0;
  if (!t_free) {
    if constexpr (traced) w1 = traced_terms(xn, yn, t + h0);
    else if constexpr (gridded) w1 = gridded_terms(g, t + h0);
    else w1 = wind_terms_at(wp, xn, t + h0);
  }
  T f1[5];
  rhs_state(rc, z1[0], z1[1], z1[2], w1, f1);
  T df[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) df[c] = f1[c] - f0[c];
  const T d2 = rms5(df, sc) / jmax(h0, tiny);

  const T dmax = jmax(d1, d2);
  const T h1 = dmax <= T(1e-15) ? jmax(h0 * T(1e-3), T(1e-6))
                                : xpow(T(0.01) / jmax(dmax, tiny),
                                       cfg.inv_order_p1);
  return jmin(jmin(T(100) * h0, h1), cfg.max_dt);
}

// K3: the Hairer dt reset of one lane per thread,
//   out = reset ? clamp(estimate, dtmin, DT) : dt.
// A lane that is not reset only copies its dt.  The clamp is torch.clamp's
// on the card (ATen's clamp_scalar kernel): a NaN passes with its own bits,
// anything else is min(max(v, dtmin), DT).  Node i of layer blockIdx.y.
template <class T, int KIND, int FLAGS>
__global__ void __launch_bounds__(K3_THREADS, (K3_MIN_BLOCKS<T, KIND>))
auto_dt_kernel(const AutoDtConfig<T> cfg, long long n,
               const AutoDtPlanes<T> P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long k = (long long)blockIdx.y * n + i;
  T dt;
  if (P.reset[k]) {
    const T est = hairer_estimate<T, KIND, FLAGS>(cfg, P, n, i, k);
    dt = est != est ? est : xfmin(xfmax(est, cfg.dtmin), cfg.DT);
  } else {
    dt = P.dt[k];
  }
  P.out[k] = dt;
}

#ifdef PICLES_MAIN_LIB
// The baseline (`_simple`): the previous kernel, the bare estimate of every lane,
// the wind's kind and the term flags tested at run time; float only.
__global__ void __launch_bounds__(128)
auto_dt_simple_kernel(const AutoDtConfig<float> cfg, long long n,
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
static void launch_advance_simple(const AdvanceConfig<float>& cfg, long long n,
                                  void** p, cudaStream_t stream) {
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
static void dispatch_simple(const AdvanceConfig<float>& cfg, bool adaptive,
                            bool force, long long n, void** p,
                            cudaStream_t stream) {
  if (adaptive && force) launch_advance_simple<S, true, true>(cfg, n, p, stream);
  else if (adaptive) launch_advance_simple<S, true, false>(cfg, n, p, stream);
  else if (force) launch_advance_simple<S, false, true>(cfg, n, p, stream);
  else launch_advance_simple<S, false, false>(cfg, n, p, stream);
}
#endif  // PICLES_MAIN_LIB

template <class M, bool ADAPTIVE, bool GRIDDED, class T>
static void launch_advance(const AdvanceConfig<T>& cfg, long long n,
                           unsigned layers, void** p, cudaStream_t stream) {
  AdvancePlanes<T> P;
  P.lne = (const T*)p[0]; P.cgx = (const T*)p[1];
  P.cgy = (const T*)p[2]; P.x = (const T*)p[3];
  P.y = (const T*)p[4]; P.t = (const T*)p[5];
  P.dt = (const T*)p[6]; P.act = (const unsigned char*)p[7];
  P.xn = (const T*)p[8];
  P.lne_o = (T*)p[9]; P.cgx_o = (T*)p[10]; P.cgy_o = (T*)p[11];
  P.x_o = (T*)p[12]; P.y_o = (T*)p[13]; P.t_o = (T*)p[14];
  P.dt_o = (T*)p[15]; P.fail_o = (unsigned char*)p[16];
  P.nacc_o = (int*)p[17];
  P.proj = (const T*)p[18];
  P.on = (const unsigned char*)p[19];
  P.nact = (const unsigned char*)p[20];
  P.bnd = (const unsigned char*)p[21];
  P.on_o = (unsigned char*)p[22];
  P.sact_o = (unsigned char*)p[23];
  P.e_o = (T*)p[24];
  P.mx_o = (T*)p[25];
  P.my_o = (T*)p[26];
  P.counts = (int*)p[27];
  const unsigned blocks = (unsigned)((n + K1_THREADS - 1) / K1_THREADS);
  advance_kernel<T, M, ADAPTIVE, GRIDDED>
      <<<dim3(blocks, layers), K1_THREADS, 0, stream>>>(cfg, n, P);
}

template <class M, class T>
static void dispatch(const AdvanceConfig<T>& cfg, bool adaptive, long long n,
                     unsigned layers, void** p, cudaStream_t stream) {
  const bool gridded = cfg.wind.kind == WIND_GRIDDED;
  if constexpr (TRACED_LIB) {
    if (adaptive)
      launch_advance<M, true, false>(cfg, n, layers, p, stream);
    else
      launch_advance<M, false, false>(cfg, n, layers, p, stream);
  } else if (adaptive && gridded)
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
template <class T>
static int unpack_advance(const T* fparams, const int* iparams,
                          AdvanceConfig<T>& cfg) {
  unpack_rhs_wind(fparams, iparams, cfg.rc, cfg.wind);
  const T* f = fparams + N_RHS_F + N_WIND_F;
  cfg.DT = f[0]; cfg.abstol = f[1]; cfg.reltol = f[2]; cfg.dtmin = f[3];
  cfg.neg_inv_order = f[4];
  f += 5;
  for (int s = 0; s < 5; ++s) cfg.tab.c[s] = (float)f[s];
  f += 5;
  for (int s = 0; s < 5; ++s)
    for (int j = 0; j < 5; ++j) cfg.tab.a[s][j] = (float)f[5 * s + j];
  f += 25;
  for (int s = 0; s < 6; ++s) cfg.tab.b[s] = (float)f[s];
  f += 6;
  for (int s = 0; s < 7; ++s) cfg.tab.bt[s] = (float)f[s];
  f += 7;
  GuardConfig<T>& g = cfg.guard;
  g.ws = WindseaConsts<T>{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7],
                          f[8], f[9], f[10], f[11], f[12], f[13], f[14]};
  f += N_WINDSEA_F;
  for (int c = 0; c < 3; ++c) g.seed[c] = f[c];
  g.wind_min_squared = f[3]; g.lemax = f[4];
  g.x_lo = f[5]; g.x_hi = f[6]; g.y_lo = f[7]; g.y_hi = f[8];
  cfg.force_dtmin = iparams[K1_I + 2] != 0;
  cfg.maxiters = iparams[K1_I + 3];
  g.seed_kind = iparams[K1_I + 4];
  g.boundary_source = iparams[K1_I + 5];
  return iparams[K1_I];
}

PICLES_KERNELS_END
}  // namespace picles

using namespace picles;
PICLES_USING_KERNELS

// fparams: RHS (14) | wind (7) | DT, abstol, reltol, dtmin, neg_inv_order |
//          tableau c[5], a[5][5], b[6], bt[7] | the epilogue's: windsea
//          (15, remesh.cuh's layout), seed (3), wind_min_squared,
//          log_energy_maximum, x_lo, x_hi, y_lo, y_hi  (real_t: float, or
//          double in the float64 library)
// iparams: flags, wind kind, has_t_off, n_wf, stages (3 or 6), adaptive,
//          force_dtmin, maxiters, seed_kind, boundary_source
// ptrs:    lane planes unless named: lne, cgx, cgy, x, y, t, dt, active(u8),
//          node x [n]  (inputs)
//          lne, cgx, cgy, x, y, t, dt, failed(u8), naccept(i32)  (outputs)
//          the per-node projection planes [5, n] (input; null: the RHS's
//          uniform scalars) |
//          the epilogue's (all null: the raw advance): on(u8), active(u8)
//          [n], boundary(u8) [n] (inputs), on(u8), the deposit's mask(u8),
//          e, m_x, m_y, counters (i32 [layers, N_COUNTERS], zeroed; added
//          to) (outputs); with them active, failed and naccept are null
//          and the outputs are the guarded ones |
//          the n_wf wind planes (inputs: float32 4 + 3B gridded, real_t u
//          and v of the node kind, the real_t node y of the traced kind,
//          none for analytic winds); every other plane real_t
// n:       nodes; layers: the particle planes are [layers, n] (layer-major)
//          and the node x, projection and wind planes [n], shared
// Runs the compiled tableau of the stage count (3: bosh3, 6: tsit5: the
// wrapper passes only those methods) and ignores the tableau floats, which
// the `_simple` baseline below reads.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another
// stage count, planes that `attach_planes` refuses or a layer count outside
// [1, MAX_LAYERS], or the epilogue with a gridded wind).  A traced
// library's entry point is `picles_advance_traced`, the float64 library's
// `picles_advance_f64`, a float64 traced library's
// `picles_advance_traced_f64`, the same layout.
constexpr int K1_PTRS = 28;

extern "C" int PICLES_ENTRY(picles_advance)(const real_t* fparams,
                                            const int* iparams, void** ptrs,
                                            long long n, long long layers,
                                            void* stream) {
  AdvanceConfig<real_t> cfg;
  const int stages = unpack_advance(fparams, iparams, cfg);
  const bool adaptive = iparams[K1_I + 1] != 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (!attach_planes(cfg.wind, iparams[3], ptrs + K1_PTRS) ||
      bad_layers(layers) ||
      (ptrs[27] != nullptr && cfg.wind.kind == WIND_GRIDDED))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const unsigned ly = (unsigned)layers;
  if (stages == Bosh3::S) dispatch<Bosh3>(cfg, adaptive, n, ly, ptrs, st);
  else if (stages == Tsit5::S) dispatch<Tsit5>(cfg, adaptive, n, ly, ptrs, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

#ifdef PICLES_MAIN_LIB
// The `_simple` baseline (the previous kernel), picles_advance's layout;
// analytic winds and uniform projections only (cudaErrorInvalidValue for a
// gridded, node or traced wind or projection planes).
extern "C" int picles_advance_simple(const float* fparams, const int* iparams,
                                     void** ptrs, long long n, void* stream) {
  AdvanceConfig<float> cfg;
  const int stages = unpack_advance(fparams, iparams, cfg);
  const bool adaptive = iparams[K1_I + 1] != 0;
  const bool force = cfg.force_dtmin != 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (planar_wind(cfg.wind.kind) ||
      cfg.wind.kind == WIND_TRACED || ptrs[18] != nullptr)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  if (stages == 3) dispatch_simple<3>(cfg, adaptive, force, n, ptrs, st);
  else if (stages == 6) dispatch_simple<6>(cfg, adaptive, force, n, ptrs, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
#endif  // PICLES_MAIN_LIB

template <class T>
static void unpack_auto_dt(const T* fparams, const int* iparams, void** ptrs,
                           AutoDtConfig<T>& cfg, AutoDtPlanes<T>& P) {
  unpack_rhs_wind(fparams, iparams, cfg.rc, cfg.wind);
  const T* f = fparams + N_RHS_F + N_WIND_F;
  cfg.abstol = f[0]; cfg.reltol = f[1]; cfg.inv_order_p1 = f[2];
  cfg.max_dt = f[3]; cfg.dtmin = f[4]; cfg.DT = f[5];
  P.lne = (const T*)ptrs[0]; P.cgx = (const T*)ptrs[1];
  P.cgy = (const T*)ptrs[2]; P.x = (const T*)ptrs[3];
  P.y = (const T*)ptrs[4]; P.t = (const T*)ptrs[5];
  P.xn = (const T*)ptrs[6]; P.dt = (const T*)ptrs[7];
  P.reset = (const unsigned char*)ptrs[8]; P.out = (T*)ptrs[9];
  P.proj = (const T*)ptrs[10];
}

template <int KIND, int FLAGS, class T>
static void launch_auto_dt(const AutoDtConfig<T>& cfg, long long n,
                           unsigned layers, const AutoDtPlanes<T>& P,
                           cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + K3_THREADS - 1) / K3_THREADS);
  auto_dt_kernel<T, KIND, FLAGS>
      <<<dim3(blocks, layers), K3_THREADS, 0, stream>>>(cfg, n, P);
}

// fparams: RHS (14) | wind (7) | abstol, reltol, 1/(order+1), max_dt,
//          dtmin, DT  (real_t)
// iparams: flags, wind kind, has_t_off, n_wf
// ptrs:    lne, cgx, cgy, x, y, t, node x, dt, was_reset(u8) (inputs) |
//          dt (output) | the per-node projection planes [5, n] (input;
//          null: the uniform scalars) | the n_wf wind planes (inputs:
//          float32 gridded, real_t node, or the real_t node y of the
//          traced kind)
// n, layers: as picles_advance's (dt, was_reset and the output are lane
// planes, the node x and the projection and wind planes shared).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// planes that `attach_planes` refuses or a layer count outside
// [1, MAX_LAYERS]).  A traced library's entry point is
// `picles_auto_dt_traced`, the float64 library's `picles_auto_dt_f64`, a
// float64 traced library's `picles_auto_dt_traced_f64`, the same layout.
constexpr int K3_PTRS = 11;

extern "C" int PICLES_ENTRY(picles_auto_dt)(const real_t* fparams,
                                            const int* iparams, void** ptrs,
                                            long long n, long long layers,
                                            void* stream) {
  AutoDtConfig<real_t> cfg;
  AutoDtPlanes<real_t> P;
  unpack_auto_dt(fparams, iparams, ptrs, cfg, P);
  cudaStream_t st = (cudaStream_t)stream;
  if (!attach_planes(cfg.wind, iparams[3], ptrs + K3_PTRS) ||
      bad_layers(layers))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const unsigned ly = (unsigned)layers;
#ifdef PICLES_TRACED_WIND
  if (cfg.rc.flags != K3_FLAGS)
    launch_auto_dt<WIND_TRACED, RUNTIME>(cfg, n, ly, P, st);
  else
    launch_auto_dt<WIND_TRACED, K3_FLAGS>(cfg, n, ly, P, st);
#else
  if (cfg.rc.flags != K3_FLAGS && cfg.wind.kind == WIND_GRIDDED)
    launch_auto_dt<WIND_GRIDDED, RUNTIME>(cfg, n, ly, P, st);
  else if (cfg.rc.flags != K3_FLAGS)
    launch_auto_dt<RUNTIME, RUNTIME>(cfg, n, ly, P, st);
  else if (cfg.wind.kind == WIND_CONSTANT || cfg.wind.kind == WIND_NODE)
    launch_auto_dt<WIND_CONSTANT, K3_FLAGS>(cfg, n, ly, P, st);
  else if (cfg.wind.kind == WIND_HALF_DOMAIN)
    launch_auto_dt<WIND_HALF_DOMAIN, K3_FLAGS>(cfg, n, ly, P, st);
  else if (cfg.wind.kind == WIND_GRIDDED)
    launch_auto_dt<WIND_GRIDDED, K3_FLAGS>(cfg, n, ly, P, st);
  else
    launch_auto_dt<WIND_TIME_COSINE, K3_FLAGS>(cfg, n, ly, P, st);
#endif
  return (int)cudaGetLastError();
}

// The `_simple` baseline, picles_auto_dt's layout: writes the bare estimate
// of every lane to the output (dtmin, DT, dt and was_reset are not read);
// analytic winds and uniform projections only (cudaErrorInvalidValue for a
// gridded, node or traced wind or projection planes).
#ifdef PICLES_MAIN_LIB
extern "C" int picles_auto_dt_simple(const float* fparams, const int* iparams,
                                     void** ptrs, long long n, void* stream) {
  AutoDtConfig<float> cfg;
  AutoDtPlanes<float> P;
  unpack_auto_dt(fparams, iparams, ptrs, cfg, P);
  if (planar_wind(cfg.wind.kind) ||
      cfg.wind.kind == WIND_TRACED || P.proj != nullptr)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  auto_dt_simple_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      cfg, n, P.lne, P.cgx, P.cgy, P.x, P.y, P.t, P.xn, P.out);
  return (int)cudaGetLastError();
}
#endif  // PICLES_MAIN_LIB
