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
// read at the lane's node at each stage's time, of one of two kinds:
// - node: one [n] float32 plane, a steady callable's values at the nodes
//   (forcing/winds.py `steady_node_plane_1d`; constant_winds_1d is one);
// - gridded: the GriddedWinds1D record u_data [nx_w, nt_w] with its x0, dx,
//   t0, dt and edge modes (rhs.cuh `gridded_u_1d`), read at the node x.
// Outputs: z [n, 3], t, dt, failed (u8) and naccept (int32), as
// integrate_to returns them (inactive lanes pass through; a finished lane's
// clock is snapped onto t + DT).
//
// A simple kernel: the state, the stage vectors and the controller in
// registers, 128 threads a block, nothing tuned.  Per particle it reads 25
// bytes (z, t, dt, active, and the node's wind or its x) and writes 25; each
// substep is 3 (bosh3) or 6 (tsit5) RHS evaluations of about 40 float
// operations (5 IEEE divisions, tanhf, 2-3 expf and a powf among them), and
// the gridded kind adds one bilinear read of the record per evaluation.
// Numerics: float32 in the plain version's order (-fmad=false, precise
// math); the controller amplifies last-ulp differences, so the adaptive
// loop agrees with its plain version by share of lanes, fixed substeps to
// a few ulps.

#include <cfloat>
#include <cuda_runtime.h>

#include "embedded_rk.cuh"
#include "rhs.cuh"
#include "tableaux.cuh"

namespace picles {

struct Advance1DConfig {
  RHS1DParams rc;
  RKControl ctl;
  Gridded1D grid;   // the gridded kind's record (data set per launch)
  float DT;
  int maxiters;
};

struct Advance1DPlanes {
  const float *z, *t, *dt;
  const unsigned char* act;
  const float* xn;
  float *z_o, *t_o, *dt_o;
  unsigned char* fail_o;
  int* nacc_o;
  const float* wind;  // node: the [n] plane; gridded: u_data [nx_w, nt_w]
};

constexpr int K7_THREADS = 128;

template <class M, bool ADAPTIVE, bool GRIDDED>
__global__ void __launch_bounds__(K7_THREADS)
advance_1d_kernel(const Advance1DConfig cfg, long long n,
                  const Advance1DPlanes P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  RKLane<3, M::S> L;
#pragma unroll
  for (int c = 0; c < 3; ++c) L.z[c] = P.z[3 * i + c];
  const float t0 = P.t[i];
  L.active = P.act[i] != 0;
  L.t_end = t0 + cfg.DT;
  L.t = t0;
  L.dt = jmax(P.dt[i], cfg.ctl.dtmin);
  L.done = !L.active || t0 >= L.t_end;
  L.failed = false;
  L.nacc = 0;
  L.iters = 0;
  if (!L.done) {
    const float xn = GRIDDED ? P.xn[i] : 0.0f;
    const float u0 = GRIDDED ? 0.0f : P.wind[i];
    const auto rhs = [&](float t, const float* z, float* out) {
      const float u = GRIDDED ? gridded_u_1d(cfg.grid, xn, t) : u0;
      rhs_1d(cfg.rc, z[0], z[1], u, out);
    };
    rhs(t0, L.z, L.k[0]);
    while (!L.done && L.iters < cfg.maxiters)
      rk_substep<M, 3, ADAPTIVE>(cfg.ctl, L, rhs);
  }
  const bool failed = rk_failed(L);
#pragma unroll
  for (int c = 0; c < 3; ++c) P.z_o[3 * i + c] = L.z[c];
  P.t_o[i] = rk_clock(L, failed);
  P.dt_o[i] = L.dt;
  P.fail_o[i] = failed ? 1 : 0;
  P.nacc_o[i] = L.nacc;
}

template <class M, bool ADAPTIVE, bool GRIDDED>
static void launch_advance_1d(const Advance1DConfig& cfg, long long n,
                              const Advance1DPlanes& P, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + K7_THREADS - 1) / K7_THREADS);
  advance_1d_kernel<M, ADAPTIVE, GRIDDED>
      <<<blocks, K7_THREADS, 0, stream>>>(cfg, n, P);
}

template <class M>
static void dispatch_1d(const Advance1DConfig& cfg, bool adaptive,
                        bool gridded, long long n, const Advance1DPlanes& P,
                        cudaStream_t stream) {
  if (adaptive && gridded)
    launch_advance_1d<M, true, true>(cfg, n, P, stream);
  else if (adaptive)
    launch_advance_1d<M, true, false>(cfg, n, P, stream);
  else if (gridded)
    launch_advance_1d<M, false, true>(cfg, n, P, stream);
  else
    launch_advance_1d<M, false, false>(cfg, n, P, stream);
}

}  // namespace picles

using namespace picles;

// fparams: r_g, C_alpha, C_e, g, p, n, e_T, 2n | DT, abstol, reltol, dtmin,
//          -1/order | the record's x0, dx, t0, dt (gridded; else unread)
// iparams: flags, wind kind (WIND_NODE or WIND_GRIDDED), nx_w, nt_w,
//          wrap_x, wrap_t, stages (3: bosh3, 6: tsit5), adaptive,
//          force_dtmin, maxiters
// ptrs:    z [n, 3], t, dt, active (u8), node x (inputs) | z [n, 3], t, dt,
//          failed (u8), naccept (i32) (outputs) | the wind: the node plane
//          [n], or the record's u_data [nx_w, nt_w] (input)
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// another wind kind or stage count, a missing wind, or an empty record).
extern "C" int picles_advance_1d(const float* f, const int* iv, void** ptrs,
                                 long long n, void* stream) {
  Advance1DConfig cfg;
  cfg.rc = RHS1DParams{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], iv[0]};
  cfg.DT = f[8];
  cfg.ctl = RKControl{f[11], f[9], f[10], f[12], iv[8] != 0};
  cfg.maxiters = iv[9];
  const bool gridded = iv[1] == WIND_GRIDDED;
  Advance1DPlanes P;
  P.z = (const float*)ptrs[0];
  P.t = (const float*)ptrs[1];
  P.dt = (const float*)ptrs[2];
  P.act = (const unsigned char*)ptrs[3];
  P.xn = (const float*)ptrs[4];
  P.z_o = (float*)ptrs[5];
  P.t_o = (float*)ptrs[6];
  P.dt_o = (float*)ptrs[7];
  P.fail_o = (unsigned char*)ptrs[8];
  P.nacc_o = (int*)ptrs[9];
  P.wind = (const float*)ptrs[10];
  cfg.grid = Gridded1D{P.wind, iv[2], iv[3], f[13], f[14], f[15], f[16],
                       iv[4] != 0, iv[5] != 0};
  if ((iv[1] != WIND_NODE && !gridded) || P.wind == nullptr ||
      (gridded && (cfg.grid.nx < 1 || cfg.grid.nt < 1)))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const bool adaptive = iv[7] != 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (iv[6] == Bosh3::S)
    dispatch_1d<Bosh3>(cfg, adaptive, gridded, n, P, st);
  else if (iv[6] == Tsit5::S)
    dispatch_1d<Tsit5>(cfg, adaptive, gridded, n, P, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
