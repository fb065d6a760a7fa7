// K7, the 1D advance: the whole adaptive embedded-RK loop of one model step
// of the 1D growth model, one thread per particle.
//
// The port's own kernel; no pl.pallas_call.  The JAX package runs this loop
// as a device-side lax.while_loop outside Pallas
// (picles_tpu/ops/tsit5.py:184-280 integrate_to, called by
// picles_tpu/models/wave_growth_1d.py under jax.jit).  Plain PyTorch
// version: picles_torch/ops/tsit5.py integrate_to with
// picles_torch/ops/rhs.py particle_equations_1d, which tests on the host
// once an iteration whether every lane is done; this kernel never leaves
// the device, so the 1D step can be captured in a CUDA graph.
//
// A lane is a particle (lne, cg_x, x) at its node (z [n, 3], row-major),
// with its clock t, step dt and `active` flag.  It runs embedded_rk.cuh's
// substep (the loop body of integrate_to, operation for operation: both
// tableaux with FSAL, the scaled RMS norm over the 3 components summed in
// order, safety 0.9 and the clip to [0.2, 10], the dtmin_eff floor at 4
// ulp of max(|t|, |t_end|), force_dtmin, maxiters, fixed substeps) over the
// 1D RHS (rhs.cuh `rhs_1d`, every TermFlags bit honoured).  Its wind is
// read at the lane's node at each stage's time, of one of three kinds:
// - node: one [n] float32 plane, a steady callable's values at the nodes
//   (forcing/winds.py `steady_node_plane_1d`; constant_winds_1d is one),
//   loaded once;
// - gridded: the GriddedWinds1D record u_data [nx_w, nt_w] with its x0, dx,
//   t0, dt and edge modes (rhs.cuh `gridded_u_1d`), read at the node x;
// - traced: a callable that reads its time, traced into the device
//   function `traced_wind_1d(x, t)` (forcing/wind_trace.py
//   `trace_winds_1d`) and called at the node x at every stage time, as the
//   JAX loop calls u(x, t).  Its instances live in a library of that
//   callable's own (ops/cuda_build.py `traced_library_1d`: this file
//   compiled with PICLES_TRACED_WIND and PICLES_TRACED_WIND_1D, entry point
//   `picles_advance_1d_traced`); the kernels' library refuses the kind, and
//   a traced library every other kind.
// Outputs: z [n, 3], t, dt, failed (u8) and naccept (int32), as
// integrate_to returns them (inactive lanes pass through; a finished lane's
// clock is snapped onto t + DT).
//
// What bounds it on an H100.  Per particle it reads 25 bytes (z, t, dt,
// active, and the node's wind or its x) and writes 25; each substep is 3
// (bosh3) or 6 (tsit5) RHS evaluations of about 60 float operations (5
// IEEE divisions, tanhf, 3 expf and a powf among them) plus the
// controller, and the gridded kind adds one bilinear read of the record an
// evaluation, the traced kind the callable's operations.  At 11 substeps a
// lane (the 2^20-lane probe) the operations bound it ten times over the
// bytes, and the kernel runs at its instruction rate, as K1 does
// (advance.cu): a fixed tsit5 substep takes the time its SASS loop takes
// to issue, 1614 instructions x the warps over 132 SMs x 4 schedulers at
// the SM clock (root PERF.md §6).  The precise divisions and
// transcendentals the parity with the plain version rests on are most of
// those instructions (precise powf alone about 95 an evaluation), and a
// warp runs until its slowest lane is done: on the probe it runs 1.36
// times its lanes' mean substeps, on B01 at 2^16 nodes 2.32 times.
//
// The design (`advance_1d_kernel`): the state, the stage vectors and the
// controller in registers, 128 threads a block, the tableaux compile-time
// constants (tableaux.cuh), one template instance per method, mode and wind
// kind; and, to issue fewer instructions for the same bits,
// - the default term flags compiled in (`K7_FLAGS`: every term, as
//   TermFlags() gives them), so the RHS's run-time flag tests and their
//   branches fold and the compiler schedules each evaluation as one block:
//   the adaptive tsit5 substep loses 92 of 1979 instructions and 8% of its
//   time; any other flag set runs a generic instance that reads them
//   (`K7_RUNTIME`), as K3 does;
// - the launch's constants out of the RHS: 1 / r_g and 1 / e_T arrive as
//   float32 quotients formed on the host (rhs.cuh `RHS1DParams`); the
//   previous kernel's source divided at every evaluation, but the compiler
//   had already hoisted those two divisions out of the substep loop, so
//   this saves a lane's prologue only;
// - launch bounds from ptxas's registers for each method, mode and wind
//   kind (`K7_MIN_BLOCKS`).
// Divergence is not acted on: K1's refill of finished lanes was slower on
// every state (advance.cu).  The previous kernel stays compiled as
// `advance_1d_simple_kernel` (with the traced kind added, in a traced
// library), the baseline chip_smoke.py and the card tests hold this one to
// bit for bit; only `advance_1d(..., simple=True)` launches it.
// Numerics: the lanes' scalar type T in the plain version's order
// (-fmad=false, precise math); the controller amplifies last-ulp
// differences, so the adaptive loop agrees with its plain version by share
// of lanes, fixed substeps to a few ulps.
//
// The double instances (T = double, the float64 library PICLES_F64 and a
// float64 traced wind's, `picles_advance_1d_f64` and
// `picles_advance_1d_traced_f64`) are the same template for every method,
// mode and wind kind, as JAX jits its 1D loop under x64: the state, the
// clock, the controller, the packed parameters and the node x in double;
// the node kind's plane in double (the callable's values cast to the
// model's dtype); the gridded record's float32 samples weighed in double
// and their sum rounded to float32, as map_coordinates returns the
// record's dtype (rhs.cuh `gridded_u_1d`); the traced kind's emitted
// double function.  A lane holds about twice the registers
// (`K7_MIN_BLOCKS`); the `_simple` baseline has no double instance.

#include <cfloat>
#include <cuda_runtime.h>

#include <type_traits>

#include "embedded_rk.cuh"
#include "rhs.cuh"
#include "tableaux.cuh"

namespace picles {
PICLES_KERNELS_BEGIN

template <class T>
struct Advance1DConfig {
  RHS1DParams<T> rc;
  RKControl<T> ctl;
  Gridded1D<T> grid;   // the gridded kind's record (data set per launch)
  T DT;
  int maxiters;
};

template <class T>
struct Advance1DPlanes {
  const T *z, *t, *dt;
  const unsigned char* act;
  const T* xn;
  T *z_o, *t_o, *dt_o;
  unsigned char* fail_o;
  int* nacc_o;
  const T* wind;  // node: the [n] plane (the record's u_data: grid.data)
};

constexpr int K7_THREADS = 128;
// K7's compiled term set (rhs.cuh TERMS_1D) and the generic instances'
// marker: the flags read from the launch's parameters.
constexpr int K7_FLAGS = TERMS_1D;
constexpr int K7_RUNTIME = -1;

// The blocks of 128 threads an SM must hold, from ptxas's registers of
// each compiled-flags instance (root PERF.md §6), none spilling: node
// kind, bosh3 38 (fixed) and 46 (adaptive) registers, tsit5 47 and 55; a
// gridded lane holds the record's parameters too: bosh3 56 and 64, tsit5
// 64 and 70 (tsit5's fixed instance spills 4 bytes at 64 registers with or
// without a bound, as the previous kernel does); a traced lane its node x
// and the callable's temporaries (under the storm of chip_smoke.py, 40-56),
// the gridded kind's bounds.  double: a lane's state, stages and
// controller take about twice the registers: the node kind 5 blocks (at
// most 102) for bosh3, 4 (at most 128) for tsit5; the gridded and traced
// kinds 4 for bosh3, 3 (at most 168) for tsit5.  The generic instances
// (K7_RUNTIME) take no minimum.
template <class T, class M, bool ADAPTIVE, int WIND, int FLAGS>
constexpr int K7_MIN_BLOCKS =
    FLAGS == K7_RUNTIME ? 1
    : !std::is_same<T, float>::value
        ? (WIND == WIND_NODE ? (M::S == 6 ? 4 : 5) : (M::S == 6 ? 3 : 4))
    : WIND == WIND_NODE
        ? (M::S == 6 ? (ADAPTIVE ? 9 : 10) : (ADAPTIVE ? 10 : 12))
        : (M::S == 6 ? (ADAPTIVE ? 7 : 8) : (ADAPTIVE ? 8 : 9));

// One lane's loop: load, the first stage, the substeps, store.  `rhs_of`
// builds the lane's RHS functor from its node x and node wind value.
template <class M, bool ADAPTIVE, class T, class RHSOF>
__device__ __forceinline__ void run_lane_1d(const Advance1DConfig<T>& cfg,
                                            const Advance1DPlanes<T>& P,
                                            long long i, bool reads_x,
                                            bool reads_plane,
                                            const RHSOF& rhs_of) {
  RKLane<T, 3, M::S> L;
#pragma unroll
  for (int c = 0; c < 3; ++c) L.z[c] = P.z[3 * i + c];
  const T t0 = P.t[i];
  L.active = P.act[i] != 0;
  L.t_end = t0 + cfg.DT;
  L.t = t0;
  L.dt = jmax(P.dt[i], cfg.ctl.dtmin);
  L.done = !L.active || t0 >= L.t_end;
  L.failed = false;
  L.nacc = 0;
  L.iters = 0;
  if (!L.done) {
    const T xn = reads_x ? P.xn[i] : T(0);
    const T u0 = reads_plane ? P.wind[i] : T(0);
    const auto rhs = rhs_of(xn, u0);
    rhs(t0, L.z, L.k[0]);
    while (!L.done && L.iters < cfg.maxiters)
      rk_substep<M, T, 3, ADAPTIVE>(cfg.ctl, L, rhs);
  }
  const bool failed = rk_failed(L);
#pragma unroll
  for (int c = 0; c < 3; ++c) P.z_o[3 * i + c] = L.z[c];
  P.t_o[i] = rk_clock(L, failed);
  P.dt_o[i] = L.dt;
  P.fail_o[i] = failed ? 1 : 0;
  P.nacc_o[i] = L.nacc;
}

// The wind of kind WIND at the lane's node (x xn, node value u0) at time t.
template <int WIND, class T>
__device__ __forceinline__ T wind_1d(const Advance1DConfig<T>& cfg, T xn,
                                     T u0, T t) {
  if constexpr (WIND == WIND_GRIDDED)
    return gridded_u_1d(cfg.grid, xn, t);
  else if constexpr (WIND == WIND_TRACED)
    return traced_wind_1d(xn, t);
  else
    return u0;
}

// K7: one particle per thread.
template <class T, class M, bool ADAPTIVE, int WIND, int FLAGS>
__global__ void __launch_bounds__(K7_THREADS,
                                  (K7_MIN_BLOCKS<T, M, ADAPTIVE, WIND, FLAGS>))
advance_1d_kernel(const Advance1DConfig<T> cfg, long long n,
                  const Advance1DPlanes<T> P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int flags = FLAGS == K7_RUNTIME ? cfg.rc.flags : FLAGS;
  run_lane_1d<M, ADAPTIVE>(
      cfg, P, i, WIND != WIND_NODE, WIND == WIND_NODE,
      [&](T xn, T u0) {
        return [&cfg, flags, xn, u0](T t, const T* z, T* out) {
          rhs_1d(cfg.rc, flags, z[0], z[1], wind_1d<WIND>(cfg, xn, u0, t),
                 out);
        };
      });
}

#ifndef PICLES_F64
// The baseline's RHS: rhs.cuh `rhs_1d` as the previous kernel evaluated
// it, the reciprocals of r_g and e_T divided and the term flags tested at
// every evaluation; float only.
__device__ __forceinline__ void rhs_1d_simple(const RHS1DParams<float>& c,
                                              float lne, float cg_x, float u,
                                              float out[3]) {
  const float c_gp = fabsf(cg_x) * (1.0f / c.r_g);
  const float k_p = (1.0f / (4.0f * jmax(c_gp * c_gp, 1e-2f))) * c.g;
  const float omega_p = (1.0f / (2.0f * jmax(fabsf(c_gp), 0.1f))) * c.g;
  const float a = fabsf(u) / (2.0f * c_gp);
  const float alpha = a > 500.0f ? 500.0f : a;
  const float H_p = 0.5f * (1.0f + tanhf((alpha - 0.85f) * c.p));
  const float ax = fabsf((alpha - 0.85f) * 10.0f);
  const float ex = expf(-ax);
  const float sech = (2.0f * ex) / (1.0f + ex * ex);
  const float Delta_p = 1.0f - 1.25f * (sech * sech);

  const float I_t = (c.flags & TERM_INPUT) ? (H_p * c.C_e) * (alpha * alpha)
                                           : 0.0f;
  const float D_t = (c.flags & TERM_DISSIPATION)
                        ? expf(lne * c.n) * powf(k_p * (1.0f / c.e_T), c.two_n)
                        : 0.0f;
  float S_cg_t = 0.0f;
  if (c.flags & TERM_PEAK_SHIFT) {
    const float k_p2 = k_p * k_p;
    S_cg_t = ((Delta_p * c.C_alpha) * (k_p2 * k_p2)) * expf(lne * 2.0f);
  }
  out[0] = (omega_p * c.r_g) * S_cg_t + omega_p * (I_t - D_t);
  out[1] = ((-cg_x * omega_p) * c.r_g) * S_cg_t;
  out[2] = (c.flags & TERM_PROPAGATION) ? cg_x : 0.0f;
}

// The baseline (`_simple`): the previous kernel, 128 threads a block with
// no minimum, the same loop over `rhs_1d_simple`; float only.
template <class M, bool ADAPTIVE, int WIND>
__global__ void __launch_bounds__(K7_THREADS)
advance_1d_simple_kernel(const Advance1DConfig<float> cfg, long long n,
                         const Advance1DPlanes<float> P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  run_lane_1d<M, ADAPTIVE>(
      cfg, P, i, WIND != WIND_NODE, WIND == WIND_NODE,
      [&](float xn, float u0) {
        return [&cfg, xn, u0](float t, const float* z, float* out) {
          rhs_1d_simple(cfg.rc, z[0], z[1], wind_1d<WIND>(cfg, xn, u0, t),
                        out);
        };
      });
}
#endif  // PICLES_F64

template <class M, bool ADAPTIVE, int WIND, class T>
static void launch_advance_1d(const Advance1DConfig<T>& cfg, long long n,
                              const Advance1DPlanes<T>& P, bool simple,
                              cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + K7_THREADS - 1) / K7_THREADS);
#ifndef PICLES_F64
  if (simple) {
    advance_1d_simple_kernel<M, ADAPTIVE, WIND>
        <<<blocks, K7_THREADS, 0, stream>>>(cfg, n, P);
    return;
  }
#endif
  if ((cfg.rc.flags & TERMS_1D) == K7_FLAGS)
    advance_1d_kernel<T, M, ADAPTIVE, WIND, K7_FLAGS>
        <<<blocks, K7_THREADS, 0, stream>>>(cfg, n, P);
  else
    advance_1d_kernel<T, M, ADAPTIVE, WIND, K7_RUNTIME>
        <<<blocks, K7_THREADS, 0, stream>>>(cfg, n, P);
}

// The library's wind kinds: the traced one in a traced library, node and
// gridded in the kernels' own.
template <class M, bool ADAPTIVE, class T>
static void dispatch_wind_1d(const Advance1DConfig<T>& cfg, int kind,
                             long long n, const Advance1DPlanes<T>& P,
                             bool simple, cudaStream_t stream) {
  if constexpr (TRACED_LIB)
    launch_advance_1d<M, ADAPTIVE, WIND_TRACED>(cfg, n, P, simple, stream);
  else if (kind == WIND_GRIDDED)
    launch_advance_1d<M, ADAPTIVE, WIND_GRIDDED>(cfg, n, P, simple, stream);
  else
    launch_advance_1d<M, ADAPTIVE, WIND_NODE>(cfg, n, P, simple, stream);
}

template <class M, class T>
static void dispatch_1d(const Advance1DConfig<T>& cfg, bool adaptive,
                        int kind, long long n, const Advance1DPlanes<T>& P,
                        bool simple, cudaStream_t stream) {
  if (adaptive)
    dispatch_wind_1d<M, true>(cfg, kind, n, P, simple, stream);
  else
    dispatch_wind_1d<M, false>(cfg, kind, n, P, simple, stream);
}

// fparams: r_g, C_alpha, C_e, g, p, n, e_T, 2n | DT, abstol, reltol, dtmin,
//          -1/order | the record's x0, dx, t0, dt (gridded; else unread) |
//          1/r_g, 1/e_T (quotients in real_t); real_t each (float, or
//          double in a float64 library)
// iparams: flags, wind kind (WIND_NODE, WIND_GRIDDED or, in a traced
//          library, WIND_TRACED), nx_w, nt_w, wrap_x, wrap_t, stages (3:
//          bosh3, 6: tsit5), adaptive, force_dtmin, maxiters
// ptrs:    z [n, 3], t, dt, active (u8), node x (inputs) | z [n, 3], t, dt,
//          failed (u8), naccept (i32) (outputs) | the wind: the node plane
//          [n] (real_t), or the record's u_data [nx_w, nt_w] (float32)
//          (input; null for the traced kind); every other plane real_t
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// kind the library does not hold, another stage count, a missing wind, or
// an empty record).
static int advance_1d_entry(const real_t* f, const int* iv, void** ptrs,
                            long long n, bool simple, void* stream) {
  using T = real_t;
  Advance1DConfig<T> cfg;
  cfg.rc = RHS1DParams<T>{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7],
                          f[17], f[18], iv[0]};
  cfg.DT = f[8];
  cfg.ctl = RKControl<T>{f[11], f[9], f[10], f[12], iv[8] != 0};
  cfg.maxiters = iv[9];
  const int kind = iv[1];
  Advance1DPlanes<T> P;
  P.z = (const T*)ptrs[0];
  P.t = (const T*)ptrs[1];
  P.dt = (const T*)ptrs[2];
  P.act = (const unsigned char*)ptrs[3];
  P.xn = (const T*)ptrs[4];
  P.z_o = (T*)ptrs[5];
  P.t_o = (T*)ptrs[6];
  P.dt_o = (T*)ptrs[7];
  P.fail_o = (unsigned char*)ptrs[8];
  P.nacc_o = (int*)ptrs[9];
  P.wind = (const T*)ptrs[10];
  cfg.grid = Gridded1D<T>{(const float*)ptrs[10], iv[2], iv[3], f[13],
                          f[14], f[15], f[16], iv[4] != 0, iv[5] != 0};
  const bool ok =
      TRACED_LIB ? kind == WIND_TRACED
                 : (kind == WIND_NODE && P.wind != nullptr) ||
                       (kind == WIND_GRIDDED && P.wind != nullptr &&
                        cfg.grid.nx >= 1 && cfg.grid.nt >= 1);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const bool adaptive = iv[7] != 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (iv[6] == Bosh3::S)
    dispatch_1d<Bosh3>(cfg, adaptive, kind, n, P, simple, st);
  else if (iv[6] == Tsit5::S)
    dispatch_1d<Tsit5>(cfg, adaptive, kind, n, P, simple, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

#ifdef PICLES_TRACED_WIND_1D
__global__ void __launch_bounds__(256)
traced_probe_1d_kernel(long long n, const real_t* __restrict__ x,
                       const real_t* __restrict__ t, real_t* __restrict__ u) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u[i] = traced_wind_1d(x[i], t[i]);
}
#endif

PICLES_KERNELS_END
}  // namespace picles

using namespace picles;
PICLES_USING_KERNELS

// K7 (layout above); a traced library's entry point is
// `picles_advance_1d_traced`, the same layout, its wind the traced kind;
// the float64 libraries' `picles_advance_1d_f64` and
// `picles_advance_1d_traced_f64`.
extern "C" int PICLES_ENTRY(picles_advance_1d)(const real_t* f, const int* iv,
                                               void** ptrs, long long n,
                                               void* stream) {
  return advance_1d_entry(f, iv, ptrs, n, false, stream);
}

#ifndef PICLES_F64
// The `_simple` baseline (the previous kernel), the same layout and kinds.
extern "C" int PICLES_ENTRY(picles_advance_1d_simple)(const float* f,
                                                      const int* iv,
                                                      void** ptrs,
                                                      long long n,
                                                      void* stream) {
  return advance_1d_entry(f, iv, ptrs, n, true, stream);
}
#endif

#ifdef PICLES_TRACED_WIND_1D
// The traced 1D wind alone: u[i] = traced_wind_1d(x[i], t[i]) for i < n,
// every pointer a real_t array on the card (the check of the emitted
// function against the callable; `picles_traced_probe_1d_f64` in a
// float64 traced library).  Returns cudaGetLastError().
extern "C" int PICLES_PROBE(picles_traced_probe_1d)(const real_t* x,
                                                    const real_t* t,
                                                    real_t* u, long long n,
                                                    void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  traced_probe_1d_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(n, x, t,
                                                                   u);
  return (int)cudaGetLastError();
}
#endif
