// K5: the remesh branch table as one kernel, one thread per node.
//
// Replaces (TPU kernel): picles_tpu/ops/remesh_pallas.py _remesh_kernel,
// body remesh_core (launcher remesh_pallas).  Plain PyTorch version:
// picles_torch/ops/remesh.py remesh_core.  The branch table itself is
// remesh.cuh `remesh_node`, which K6 (pic_gather.cu) runs too.
//
// What bounds it on an H100: memory.  Per node it reads the 3 node planes,
// 6 particle planes, 3 masks and the node x (43 bytes) and writes 6 planes,
// the flag and the bitfield (29 bytes): 72 bytes, 170 MB at 1536^2, about
// 51 us at 3.35 TB/s; a gridded wind adds its 4 + 3B planes (28 bytes at
// B = 1; the node x is then not needed).  The arithmetic is a few dozen
// operations, plus the windsea (4 powf, 1 logf) on reseeded lanes only.
// The design follows: one pass, one thread per node along y (the
// contiguous axis, so loads and stores coalesce), nothing staged.  The
// model clock is read from device memory by every thread, so the host
// never reads it back.  Layers are the launch's second grid dimension
// (blockIdx.y): a node's particle and deposit planes are read and written
// at layer * n + node, the masks, the node x and a gridded wind's planes,
// which every layer shares, at the node.

#include <cuda_runtime.h>

#include "remesh.cuh"

namespace {

__global__ void __launch_bounds__(256)
remesh_kernel(const picles::RemeshParams r, long long n,
              const float* __restrict__ clock, const float* __restrict__ e_n,
              const float* __restrict__ mx_n, const float* __restrict__ my_n,
              const float* __restrict__ lne, const float* __restrict__ cgx,
              const float* __restrict__ cgy, const float* __restrict__ px,
              const float* __restrict__ py, const float* __restrict__ dt,
              const unsigned char* __restrict__ on,
              const unsigned char* __restrict__ act,
              const unsigned char* __restrict__ bnd,
              const float* __restrict__ xn, float* __restrict__ lne_o,
              float* __restrict__ cgx_o, float* __restrict__ cgy_o,
              float* __restrict__ px_o, float* __restrict__ py_o,
              float* __restrict__ dt_o, unsigned char* __restrict__ on_o,
              int* __restrict__ br_o) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long k = (long long)blockIdx.y * n + i;
  const picles::RemeshOut o = picles::remesh_node(
      r, *clock, i, e_n[k], mx_n[k], my_n[k], lne[k], cgx[k], cgy[k], px[k],
      py[k], dt[k], on[k] != 0, act[i] != 0, bnd[i] != 0,
      r.wind.kind == picles::WIND_GRIDDED ? 0.0f : xn[i]);
  lne_o[k] = o.lne;
  cgx_o[k] = o.cgx;
  cgy_o[k] = o.cgy;
  px_o[k] = o.px;
  py_o[k] = o.py;
  dt_o[k] = o.dt;
  on_o[k] = o.on ? 1 : 0;
  br_o[k] = o.branch;
}

}  // namespace

// fparams/iparams: the remesh.cuh layout (unpack_remesh)
// ptrs: clock (1 float) | e_n, mx_n, my_n, lne, cgx, cgy, px, py, dt, on(u8),
//       active(u8), boundary(u8), xn (inputs) | lne, cgx, cgy, px, py, dt,
//       on(u8), branch(i32) (outputs) | the n_wf gridded wind planes
//       (inputs; none for analytic winds)
// n:    nodes; layers: the node state, particle and output planes are
//       [layers, n] (layer-major), active, boundary, xn and the wind
//       planes [n], shared
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// planes that `attach_planes` refuses or a layer count outside
// [1, MAX_LAYERS]).
extern "C" int picles_remesh(const float* fparams, const int* iparams,
                             void** ptrs, long long n, long long layers,
                             void* stream) {
  picles::RemeshParams r;
  picles::unpack_remesh(fparams, iparams, r);
  if (!picles::attach_planes(r.wind, iparams[2], ptrs + 22) ||
      picles::bad_layers(layers))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const float* const* in = (const float* const*)ptrs;
  remesh_kernel<<<dim3(blocks, (unsigned)layers), threads, 0,
                  (cudaStream_t)stream>>>(
      r, n, in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8],
      in[9], (const unsigned char*)ptrs[10], (const unsigned char*)ptrs[11],
      (const unsigned char*)ptrs[12], in[13], (float*)ptrs[14],
      (float*)ptrs[15], (float*)ptrs[16], (float*)ptrs[17], (float*)ptrs[18],
      (float*)ptrs[19], (unsigned char*)ptrs[20], (int*)ptrs[21]);
  return (int)cudaGetLastError();
}
