// K2: the CIC deposit of (E, m_x, m_y) written as a gather, one thread per
// output node, no atomics.
//
// Replaces (TPU kernel): picles_tpu/ops/pic_pallas.py _accum_kernel ->
// _gather_accumulate (launcher scatter_core_channels_pallas, inputs from
// _gather_setup).  Plain PyTorch version: picles_torch/ops/pic.py
// scatter_dense.
//
// Each output node (i, j) sums the contributions of the source particles
// (i - dx, j - dy) for dx in [-xl, xh], dy in [-yl, yh]: a particle clamped
// into the halo deposits on its floor and ceil nodes, so it reaches node
// (i, j) exactly when its floor offset is dx or dx - 1 (and likewise in y).
// Floor and weights are recomputed here from the clamped positions, as the
// TPU kernel does, and every term is formed and summed in the TPU kernel's
// order (sum over dx of wx * (wy * c), then over dy), so the deposit is
// deterministic and the same bit for bit on every run.
//
// Boundary: design (b).  The kernel indexes the source with a wrap (periodic
// axis) or skips it (open axis) directly, instead of reading the extended
// input planes that _gather_setup builds; that reads fewer bytes and needs
// no set-up pass.  A skipped source is exactly the TPU kernel's zero slab:
// it would add a zero.  The tripolar seam (mirrored ghost particles) is not
// handled here; the wrapper refuses it.
//
// What bounds it on an H100: memory.  Per node it computes ~10 operations
// per window cell and reads 5 planes plus the mask (21 bytes) per source;
// neighbouring threads read neighbouring sources, so the (xl+xh+1)(yl+yh+1)
// re-reads of each source are served by L1/L2, and device memory sees about
// one pass over the 6 inputs and one over the 3 outputs (36 bytes a node).
// Threads run along y, the contiguous axis, so loads and stores coalesce.
// Staging a tile of the sources in shared memory is left to a later PR.
//
// K4: the same deposit into the padded accumulator, no fold.
//
// Replaces (TPU kernel): picles_tpu/ops/pic_pallas.py _accum_kernel via
// scatter_padded_channels_pallas (stacked by
// scatter_accumulate_padded_pallas), the local deposit of every shard of the
// sharded step.  Plain PyTorch version: picles_torch/ops/pic.py
// scatter_accumulate_padded.  Padded node (pi, pj) of the
// [nx+xl+xh, ny+yl+yh] output is core node (pi - xl, pj - yl), which lies
// up to xl (yl) nodes before and xh (yh) nodes past the block.  With both
// axes open, K2's `gather_node` sums exactly that node's window: a source
// outside [0, nx) x [0, ny) is skipped, as the accumulator has no particle
// there.  So K4 is `gather_node` with periodic_x = periodic_y = 0 over the
// larger output range; the halo slabs it leaves are what the sharded step
// exchanges with the neighbouring blocks.  One thread per padded node, no
// atomics: deterministic.  Memory-bound like K2: about 21 bytes of sources
// (through L1/L2) and 12 bytes of output a node.
//
// K6: the same deposit with the remesh fused into its output pass.
//
// Replaces (TPU kernel): picles_tpu/ops/pic_pallas.py _accum_remesh_kernel
// (launcher scatter_remesh_fused).  Plain PyTorch version: pic.py
// scatter_dense, then remesh.py remesh_core.  Each thread sums its node's
// window with K2's own device function (`gather_node`, so the node planes
// equal K2's bit for bit) and feeds the three sums straight into the remesh
// branch table (remesh.cuh `remesh_node`, K5's).  It writes the 3 node
// planes and the 8 remesh outputs and never reads the node planes back: the
// separate K5 pass would read them again (12 bytes a node) and launch once
// more.

#include <cuda_runtime.h>
#include <math.h>

#include "remesh.cuh"

namespace {

struct GatherConfig {
  int nx, ny;
  int xl, xh, yl, yh;
  int periodic_x, periodic_y;
  float x_lo, x_hi, y_lo, y_hi;  // clamp bounds, float32 as the JAX package forms them
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  // jnp.clip: min(max(v, lo), hi), NaN propagating
  if (v != v) return v;
  return fminf(fmaxf(v, lo), hi);
}

// The deposit at output node (i, j): the sum over its window of sources.
__device__ __forceinline__ void gather_node(
    const GatherConfig& g, int i, int j, const float* __restrict__ xr,
    const float* __restrict__ yr, const float* __restrict__ c0,
    const float* __restrict__ c1, const float* __restrict__ c2,
    const unsigned char* __restrict__ act, float& acc0, float& acc1,
    float& acc2) {
  acc0 = 0.0f;
  acc1 = 0.0f;
  acc2 = 0.0f;
  for (int dy = -g.yl; dy <= g.yh; ++dy) {
    int sj = j - dy;
    if (sj < 0 || sj >= g.ny) {
      if (!g.periodic_y) continue;
      sj = sj < 0 ? sj + g.ny : sj - g.ny;
    }
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    for (int dx = -g.xl; dx <= g.xh; ++dx) {
      int si = i - dx;
      if (si < 0 || si >= g.nx) {
        if (!g.periodic_x) continue;
        si = si < 0 ? si + g.nx : si - g.nx;
      }
      const long long s = (long long)si * g.ny + sj;
      const float px = clampf(xr[s], g.x_lo, g.x_hi);
      const float fxf = floorf(px);
      const int fx = (int)fxf;
      const float wxc = px - fxf;
      const float wxf = 1.0f - wxc;
      const float py = clampf(yr[s], g.y_lo, g.y_hi);
      const float fyf = floorf(py);
      const int fy = (int)fyf;
      const float wyc = py - fyf;
      const float wyf = 1.0f - wyc;
      const float wx = (fx == dx ? wxf : 0.0f) + (fx == dx - 1 ? wxc : 0.0f);
      const float wy = (fy == dy ? wyf : 0.0f) + (fy == dy - 1 ? wyc : 0.0f);
      const float m = act[s] ? 1.0f : 0.0f;
      a0 = a0 + wx * (wy * (c0[s] * m));
      a1 = a1 + wx * (wy * (c1[s] * m));
      a2 = a2 + wx * (wy * (c2[s] * m));
    }
    acc0 = acc0 + a0;
    acc1 = acc1 + a1;
    acc2 = acc2 + a2;
  }
}

__global__ void __launch_bounds__(256)
pic_gather_kernel(const GatherConfig g, const float* __restrict__ xr,
                  const float* __restrict__ yr, const float* __restrict__ c0,
                  const float* __restrict__ c1, const float* __restrict__ c2,
                  const unsigned char* __restrict__ act,
                  float* __restrict__ o0, float* __restrict__ o1,
                  float* __restrict__ o2) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)g.nx * g.ny;
  if (idx >= n) return;
  const int i = (int)(idx / g.ny);
  const int j = (int)(idx - (long long)i * g.ny);
  float acc0, acc1, acc2;
  gather_node(g, i, j, xr, yr, c0, c1, c2, act, acc0, acc1, acc2);
  o0[idx] = acc0;
  o1[idx] = acc1;
  o2[idx] = acc2;
}

// g.nx, g.ny are the block's (source) extents; the output is padded.
__global__ void __launch_bounds__(256)
pic_gather_padded_kernel(const GatherConfig g, const float* __restrict__ xr,
                         const float* __restrict__ yr,
                         const float* __restrict__ c0,
                         const float* __restrict__ c1,
                         const float* __restrict__ c2,
                         const unsigned char* __restrict__ act,
                         float* __restrict__ o0, float* __restrict__ o1,
                         float* __restrict__ o2) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int npy = g.ny + g.yl + g.yh;
  const long long n = (long long)(g.nx + g.xl + g.xh) * npy;
  if (idx >= n) return;
  const int pi = (int)(idx / npy);
  const int pj = (int)(idx - (long long)pi * npy);
  float acc0, acc1, acc2;
  gather_node(g, pi - g.xl, pj - g.yl, xr, yr, c0, c1, c2, act, acc0, acc1,
              acc2);
  o0[idx] = acc0;
  o1[idx] = acc1;
  o2[idx] = acc2;
}

// Particle planes and masks of K6's remesh half, core-aligned [nx, ny].
struct RemeshPlanes {
  const float* clock;
  const float *lne, *cgx, *cgy, *px, *py, *dt;
  const unsigned char *on, *act, *bnd;
  const float* xn;
  float *lne_o, *cgx_o, *cgy_o, *px_o, *py_o, *dt_o;
  unsigned char* on_o;
  int* br_o;
};

__global__ void __launch_bounds__(256)
pic_gather_remesh_kernel(const GatherConfig g, const picles::RemeshParams r,
                         const float* __restrict__ xr,
                         const float* __restrict__ yr,
                         const float* __restrict__ c0,
                         const float* __restrict__ c1,
                         const float* __restrict__ c2,
                         const unsigned char* __restrict__ sact,
                         const RemeshPlanes q, float* __restrict__ o0,
                         float* __restrict__ o1, float* __restrict__ o2) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)g.nx * g.ny;
  if (idx >= n) return;
  const int i = (int)(idx / g.ny);
  const int j = (int)(idx - (long long)i * g.ny);
  float acc0, acc1, acc2;
  gather_node(g, i, j, xr, yr, c0, c1, c2, sact, acc0, acc1, acc2);
  o0[idx] = acc0;
  o1[idx] = acc1;
  o2[idx] = acc2;
  const picles::RemeshOut o = picles::remesh_node(
      r, *q.clock, acc0, acc1, acc2, q.lne[idx], q.cgx[idx], q.cgy[idx],
      q.px[idx], q.py[idx], q.dt[idx], q.on[idx] != 0, q.act[idx] != 0,
      q.bnd[idx] != 0, q.xn[idx]);
  q.lne_o[idx] = o.lne;
  q.cgx_o[idx] = o.cgx;
  q.cgy_o[idx] = o.cgy;
  q.px_o[idx] = o.px;
  q.py_o[idx] = o.py;
  q.dt_o[idx] = o.dt;
  q.on_o[idx] = o.on ? 1 : 0;
  q.br_o[idx] = o.branch;
}

GatherConfig unpack_gather(const float* fparams, const int* iparams) {
  GatherConfig g;
  g.nx = iparams[0]; g.ny = iparams[1];
  g.xl = iparams[2]; g.xh = iparams[3]; g.yl = iparams[4]; g.yh = iparams[5];
  g.periodic_x = iparams[6]; g.periodic_y = iparams[7];
  g.x_lo = fparams[0]; g.x_hi = fparams[1];
  g.y_lo = fparams[2]; g.y_hi = fparams[3];
  return g;
}

constexpr int N_GATHER_F = 4;
constexpr int N_GATHER_I = 8;
constexpr int THREADS = 256;

}  // namespace

// iparams: nx, ny, xl, xh, yl, yh, periodic_x, periodic_y
// fparams: x_lo, x_hi, y_lo, y_hi
// ptrs:    xrel, yrel, c0, c1, c2, active(u8) (inputs) | o0, o1, o2 (outputs)
// Returns cudaGetLastError() after the launch.
extern "C" int picles_pic_gather(const float* fparams, const int* iparams,
                                 void** ptrs, void* stream) {
  const GatherConfig g = unpack_gather(fparams, iparams);
  const long long n = (long long)g.nx * g.ny;
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  pic_gather_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      g, (const float*)ptrs[0], (const float*)ptrs[1], (const float*)ptrs[2],
      (const float*)ptrs[3], (const float*)ptrs[4],
      (const unsigned char*)ptrs[5], (float*)ptrs[6], (float*)ptrs[7],
      (float*)ptrs[8]);
  return (int)cudaGetLastError();
}

// K4.  iparams and fparams as picles_pic_gather's, the periodic flags
// ignored (both axes open); nx, ny are the block's.
// ptrs:    xrel, yrel, c0, c1, c2, active(u8) ([nx, ny], inputs) |
//          o0, o1, o2 ([nx+xl+xh, ny+yl+yh], outputs)
// Returns cudaGetLastError() after the launch.
extern "C" int picles_pic_gather_padded(const float* fparams,
                                        const int* iparams, void** ptrs,
                                        void* stream) {
  GatherConfig g = unpack_gather(fparams, iparams);
  g.periodic_x = 0;
  g.periodic_y = 0;
  const long long n =
      (long long)(g.nx + g.xl + g.xh) * (g.ny + g.yl + g.yh);
  if (g.nx <= 0 || g.ny <= 0) return 0;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  pic_gather_padded_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      g, (const float*)ptrs[0], (const float*)ptrs[1], (const float*)ptrs[2],
      (const float*)ptrs[3], (const float*)ptrs[4],
      (const unsigned char*)ptrs[5], (float*)ptrs[6], (float*)ptrs[7],
      (float*)ptrs[8]);
  return (int)cudaGetLastError();
}

// fparams: the gather's (4) | the remesh.cuh layout
// iparams: the gather's (8) | the remesh.cuh layout
// ptrs:    xrel, yrel, c0, c1, c2, scatter_active(u8) | clock, lne, cgx, cgy,
//          px, py, dt, on(u8), active(u8), boundary(u8), xn (inputs) |
//          o0, o1, o2 | lne, cgx, cgy, px, py, dt, on(u8), branch(i32)
//          (outputs)
// Returns cudaGetLastError() after the launch.
extern "C" int picles_pic_gather_remesh(const float* fparams,
                                        const int* iparams, void** ptrs,
                                        void* stream) {
  const GatherConfig g = unpack_gather(fparams, iparams);
  picles::RemeshParams r;
  picles::unpack_remesh(fparams + N_GATHER_F, iparams + N_GATHER_I, r);
  const long long n = (long long)g.nx * g.ny;
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  RemeshPlanes q;
  q.clock = (const float*)ptrs[6];
  q.lne = (const float*)ptrs[7];
  q.cgx = (const float*)ptrs[8];
  q.cgy = (const float*)ptrs[9];
  q.px = (const float*)ptrs[10];
  q.py = (const float*)ptrs[11];
  q.dt = (const float*)ptrs[12];
  q.on = (const unsigned char*)ptrs[13];
  q.act = (const unsigned char*)ptrs[14];
  q.bnd = (const unsigned char*)ptrs[15];
  q.xn = (const float*)ptrs[16];
  q.lne_o = (float*)ptrs[20];
  q.cgx_o = (float*)ptrs[21];
  q.cgy_o = (float*)ptrs[22];
  q.px_o = (float*)ptrs[23];
  q.py_o = (float*)ptrs[24];
  q.dt_o = (float*)ptrs[25];
  q.on_o = (unsigned char*)ptrs[26];
  q.br_o = (int*)ptrs[27];
  pic_gather_remesh_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      g, r, (const float*)ptrs[0], (const float*)ptrs[1],
      (const float*)ptrs[2], (const float*)ptrs[3], (const float*)ptrs[4],
      (const unsigned char*)ptrs[5], q, (float*)ptrs[17], (float*)ptrs[18],
      (float*)ptrs[19]);
  return (int)cudaGetLastError();
}
