// K1 advance and K3 auto-dt: the whole adaptive embedded-RK loop of one
// model step, and Hairer's initial-dt estimate, one thread per particle.
//
// Replaces (TPU kernels):
//   K1  picles_tpu/ops/advance_pallas.py  _advance_kernel  (launcher advance_pallas)
//   K3  picles_tpu/ops/advance_pallas.py  _auto_dt_kernel  (launcher auto_dt_pallas)
// Plain PyTorch versions: picles_torch/ops/tsit5.py integrate_to / auto_dt.
//
// What bounds them on an H100.  Per particle K1 reads 7 float planes, a
// mask and the node x (33 bytes) and writes 7 planes plus two flags (33
// bytes); each substep costs 3 (bosh3) or 6 (tsit5) RHS evaluations of ~40
// float operations and 5 transcendentals.  At one substep per model step
// (the flagship's steady state) the 66 bytes and the launch dominate; with
// several substeps (a fresh seed, tsit5) the arithmetic does.  K3 runs 2
// RHS evaluations per 36 bytes.  The design follows: one thread per particle
// keeps the whole state, the FSAL stage vector and the controller in
// registers (no shared memory, no intermediate device-memory traffic), with
// threads running along y, the contiguous axis, so the few loads and stores
// coalesce.  Each thread loops `while (!done && iters < maxiters)` on its
// own: a live lane of the TPU kernel's tile loop executes every tile
// iteration too, so the counts are equal, and a quiet lane stops early.
// Warps whose lanes need different substep counts diverge; that is the
// cost a later PR can attack (sorting lanes by expected work).
//
// Numerics follow the plain version op for op in float32 (see rhs.cuh).
// Two literals of the JAX package are float32 identities and appear here as
// such: `dtmin_eff * (1.0 + 1e-8)` is `dtmin_eff`, and `t_end - 1e-9` is
// `t_end - 1e-9f`.  The build disables FMA contraction (-fmad=false) so a
// product-then-sum rounds twice, as it does in the plain version.

#include <cfloat>
#include <cuda_runtime.h>

#include "rhs.cuh"

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
  Tableau tab;
  float DT, abstol, reltol, dtmin, neg_inv_order;
  int maxiters;
};

struct AutoDtConfig {
  RHSParams rc;
  WindParams wind;
  float abstol, reltol, inv_order_p1, max_dt;
};

// Packed parameter layout, shared with picles_torch/ops/advance_cuda.py.
// floats: RHS (14) | wind (7) | ...;  ints: flags | wind kind | has_t_off | ...
constexpr int N_RHS_F = 14;
constexpr int N_WIND_F = 7;

static void unpack_rhs_wind(const float* f, const int* iv, RHSParams& rc,
                            WindParams& w) {
  rc.r_g = f[0]; rc.C_alpha = f[1]; rc.C_e = f[2]; rc.C_varphi = f[3];
  rc.g = f[4]; rc.p = f[5]; rc.n = f[6]; rc.e_T = f[7]; rc.rg2 = f[8];
  rc.m00 = f[9]; rc.m01 = f[10]; rc.m10 = f[11]; rc.m11 = f[12];
  rc.pc = f[13];
  rc.flags = iv[0];
  const float* g = f + N_RHS_F;
  w.kind = iv[1];
  w.has_t_off = iv[2];
  w.u0 = g[0]; w.v0 = g[1]; w.x_split = g[2]; w.background = g[3];
  w.two_pi = g[4]; w.period = g[5]; w.t_off = g[6];
}

template <int S, bool ADAPTIVE, bool FORCE_DTMIN>
__global__ void __launch_bounds__(128)
advance_kernel(const AdvanceConfig cfg, long long n,
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

__global__ void __launch_bounds__(128)
auto_dt_kernel(const AutoDtConfig cfg, long long n,
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
static void launch_advance(const AdvanceConfig& cfg, long long n, void** p,
                           cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  advance_kernel<S, ADAPTIVE, FORCE_DTMIN><<<blocks, threads, 0, stream>>>(
      cfg, n, (const float*)p[0], (const float*)p[1], (const float*)p[2],
      (const float*)p[3], (const float*)p[4], (const float*)p[5],
      (const float*)p[6], (const unsigned char*)p[7], (const float*)p[8],
      (float*)p[9], (float*)p[10], (float*)p[11], (float*)p[12],
      (float*)p[13], (float*)p[14], (float*)p[15], (unsigned char*)p[16],
      (int*)p[17]);
}

template <int S>
static void dispatch_flags(const AdvanceConfig& cfg, bool adaptive, bool force,
                           long long n, void** p, cudaStream_t stream) {
  if (adaptive && force) launch_advance<S, true, true>(cfg, n, p, stream);
  else if (adaptive) launch_advance<S, true, false>(cfg, n, p, stream);
  else if (force) launch_advance<S, false, true>(cfg, n, p, stream);
  else launch_advance<S, false, false>(cfg, n, p, stream);
}

}  // namespace picles

using namespace picles;

// fparams: RHS (14) | wind (7) | DT, abstol, reltol, dtmin, neg_inv_order |
//          tableau c[5], a[5][5], b[6], bt[7]
// iparams: flags, wind kind, has_t_off, stages (3 or 6), adaptive,
//          force_dtmin, maxiters
// ptrs:    lne, cgx, cgy, x, y, t, dt, active(u8), node x  (inputs)
//          lne, cgx, cgy, x, y, t, dt, failed(u8), naccept(i32)  (outputs)
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported stage count).
extern "C" int picles_advance(const float* fparams, const int* iparams,
                              void** ptrs, long long n, void* stream) {
  AdvanceConfig cfg;
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
  const int stages = iparams[3];
  const bool adaptive = iparams[4] != 0;
  const bool force = iparams[5] != 0;
  cfg.maxiters = iparams[6];
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (stages == 3) dispatch_flags<3>(cfg, adaptive, force, n, ptrs, st);
  else if (stages == 6) dispatch_flags<6>(cfg, adaptive, force, n, ptrs, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// fparams: RHS (14) | wind (7) | abstol, reltol, 1/(order+1), max_dt
// iparams: flags, wind kind, has_t_off
// ptrs:    lne, cgx, cgy, x, y, t, node x (inputs) | dt estimate (output)
extern "C" int picles_auto_dt(const float* fparams, const int* iparams,
                              void** ptrs, long long n, void* stream) {
  AutoDtConfig cfg;
  unpack_rhs_wind(fparams, iparams, cfg.rc, cfg.wind);
  const float* f = fparams + N_RHS_F + N_WIND_F;
  cfg.abstol = f[0]; cfg.reltol = f[1]; cfg.inv_order_p1 = f[2];
  cfg.max_dt = f[3];
  if (n <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  auto_dt_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      cfg, n, (const float*)ptrs[0], (const float*)ptrs[1],
      (const float*)ptrs[2], (const float*)ptrs[3], (const float*)ptrs[4],
      (const float*)ptrs[5], (const float*)ptrs[6], (float*)ptrs[7]);
  return (int)cudaGetLastError();
}
