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

#include <cuda_runtime.h>
#include <math.h>

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

  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
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
  o0[idx] = acc0;
  o1[idx] = acc1;
  o2[idx] = acc2;
}

}  // namespace

// iparams: nx, ny, xl, xh, yl, yh, periodic_x, periodic_y
// fparams: x_lo, x_hi, y_lo, y_hi
// ptrs:    xrel, yrel, c0, c1, c2, active(u8) (inputs) | o0, o1, o2 (outputs)
// Returns cudaGetLastError() after the launch.
extern "C" int picles_pic_gather(const float* fparams, const int* iparams,
                                 void** ptrs, void* stream) {
  GatherConfig g;
  g.nx = iparams[0]; g.ny = iparams[1];
  g.xl = iparams[2]; g.xh = iparams[3]; g.yl = iparams[4]; g.yh = iparams[5];
  g.periodic_x = iparams[6]; g.periodic_y = iparams[7];
  g.x_lo = fparams[0]; g.x_hi = fparams[1];
  g.y_lo = fparams[2]; g.y_hi = fparams[3];
  const long long n = (long long)g.nx * g.ny;
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  pic_gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      g, (const float*)ptrs[0], (const float*)ptrs[1], (const float*)ptrs[2],
      (const float*)ptrs[3], (const float*)ptrs[4],
      (const unsigned char*)ptrs[5], (float*)ptrs[6], (float*)ptrs[7],
      (float*)ptrs[8]);
  return (int)cudaGetLastError();
}
