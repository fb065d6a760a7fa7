// K5: the remesh branch table as one kernel, one thread per node.
//
// Replaces (TPU kernel): picles_tpu/ops/remesh_pallas.py _remesh_kernel,
// body remesh_core (launcher remesh_pallas).  Plain PyTorch version:
// picles_torch/ops/remesh.py remesh_core.  The branch table itself is
// remesh.cuh `remesh_node`, which K6 (pic_gather.cu) runs too.
//
// The same template runs in float64 (the float64 library, PICLES_F64, and a
// float64 traced wind's, with PICLES_TRACED_WIND too): each plane but the
// masks, the branch and the float32 gridded wind planes twice the bytes.
//
// What bounds it on an H100: memory.  Per node it reads the 3 node planes,
// 6 particle planes, 3 masks and the node x (43 bytes) and writes 6 planes,
// the flag and the bitfield (29 bytes): 72 bytes, 170 MB at 1536^2, about
// 51 us at 3.35 TB/s; a gridded wind adds its 4 + 3B planes (28 bytes at
// B = 1; the node x is then not needed), the node kind (a steady closure)
// its two node planes (8 bytes, the node x not needed either).  The arithmetic is a few dozen
// operations, plus the windsea (4 powf, 1 logf) on reseeded lanes only.
// The design follows: one pass, one thread per node along y (the
// contiguous axis, so loads and stores coalesce), nothing staged.  The
// model clock is read from device memory by every thread, so the host
// never reads it back.  Layers are the launch's second grid dimension
// (blockIdx.y): a node's particle and deposit planes are read and written
// at layer * n + node, the masks, the node x and a gridded wind's planes,
// which every layer shares, at the node.  A traced wind (rhs.cuh
// `WIND_TRACED`) is compiled into a library of its own (PICLES_TRACED_WIND):
// its remesh reads the node x and the node y plane (4 more bytes a node)
// and calls the emitted `traced_wind` at the clock; that library also holds
// `picles_traced_probe`, the emitted function alone over arrays of points.

#include <cuda_runtime.h>

#include "remesh.cuh"

namespace {
PICLES_KERNELS_BEGIN

// One node a thread; T the lanes' scalar type (float, or double in the
// float64 libraries: every plane but the masks, the branch and the float32
// gridded wind planes is then double).
template <class T>
__global__ void __launch_bounds__(256)
remesh_kernel(const picles::RemeshParams<T> r, long long n,
              const T* __restrict__ clock, const T* __restrict__ e_n,
              const T* __restrict__ mx_n, const T* __restrict__ my_n,
              const T* __restrict__ lne, const T* __restrict__ cgx,
              const T* __restrict__ cgy, const T* __restrict__ px,
              const T* __restrict__ py, const T* __restrict__ dt,
              const unsigned char* __restrict__ on,
              const unsigned char* __restrict__ act,
              const unsigned char* __restrict__ bnd,
              const T* __restrict__ xn, T* __restrict__ lne_o,
              T* __restrict__ cgx_o, T* __restrict__ cgy_o,
              T* __restrict__ px_o, T* __restrict__ py_o,
              T* __restrict__ dt_o, unsigned char* __restrict__ on_o,
              int* __restrict__ br_o) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long k = (long long)blockIdx.y * n + i;
  const picles::RemeshOut<T> o = picles::remesh_node(
      r, *clock, i, e_n[k], mx_n[k], my_n[k], lne[k], cgx[k], cgy[k], px[k],
      py[k], dt[k], on[k] != 0, act[i] != 0, bnd[i] != 0,
      !picles::planar_wind(r.wind.kind) ? xn[i] : T(0));
  lne_o[k] = o.lne;
  cgx_o[k] = o.cgx;
  cgy_o[k] = o.cgy;
  px_o[k] = o.px;
  py_o[k] = o.py;
  dt_o[k] = o.dt;
  on_o[k] = o.on ? 1 : 0;
  br_o[k] = o.branch;
}

PICLES_KERNELS_END
}  // namespace

PICLES_USING_KERNELS

// fparams/iparams: the remesh.cuh layout (unpack_remesh; real_t)
// ptrs: clock (1 value) | e_n, mx_n, my_n, lne, cgx, cgy, px, py, dt, on(u8),
//       active(u8), boundary(u8), xn (inputs) | lne, cgx, cgy, px, py, dt,
//       on(u8), branch(i32) (outputs) | the n_wf wind planes (inputs:
//       float32 4 + 3B gridded, real_t u and v of the node kind, the
//       real_t node y of the traced kind, none for analytic winds); every
//       other plane real_t
// n:    nodes; layers: the node state, particle and output planes are
//       [layers, n] (layer-major), active, boundary, xn and the wind
//       planes [n], shared
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// planes that `attach_planes` refuses or a layer count outside
// [1, MAX_LAYERS]).  A traced library's entry point is
// `picles_remesh_traced`, the float64 library's `picles_remesh_f64`, a
// float64 traced library's `picles_remesh_traced_f64`, the same layout.
extern "C" int PICLES_ENTRY(picles_remesh)(const picles::real_t* fparams,
                                           const int* iparams, void** ptrs,
                                           long long n, long long layers,
                                           void* stream) {
  using T = picles::real_t;
  picles::RemeshParams<T> r;
  picles::unpack_remesh(fparams, iparams, r);
  if (!picles::attach_planes(r.wind, iparams[2], ptrs + 22) ||
      picles::bad_layers(layers))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const T* const* in = (const T* const*)ptrs;
  remesh_kernel<T><<<dim3(blocks, (unsigned)layers), threads, 0,
                     (cudaStream_t)stream>>>(
      r, n, in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8],
      in[9], (const unsigned char*)ptrs[10], (const unsigned char*)ptrs[11],
      (const unsigned char*)ptrs[12], in[13], (T*)ptrs[14],
      (T*)ptrs[15], (T*)ptrs[16], (T*)ptrs[17], (T*)ptrs[18],
      (T*)ptrs[19], (unsigned char*)ptrs[20], (int*)ptrs[21]);
  return (int)cudaGetLastError();
}

#ifdef PICLES_TRACED_WIND
namespace {
PICLES_KERNELS_BEGIN

__global__ void __launch_bounds__(256)
traced_probe_kernel(long long n, const picles::real_t* __restrict__ x,
                    const picles::real_t* __restrict__ y,
                    const picles::real_t* __restrict__ t,
                    picles::real_t* __restrict__ u,
                    picles::real_t* __restrict__ v) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  picles::traced_wind(x[i], y[i], t[i], u[i], v[i]);
}

PICLES_KERNELS_END
}  // namespace

// The traced wind alone: u[i], v[i] = traced_wind(x[i], y[i], t[i]) for
// i < n, every pointer a real_t array on the card (the check of the
// emitted function against the callable; `picles_traced_probe_f64` in a
// float64 traced library).  Returns cudaGetLastError().
extern "C" int PICLES_PROBE(picles_traced_probe)(
    const picles::real_t* x, const picles::real_t* y,
    const picles::real_t* t, picles::real_t* u, picles::real_t* v,
    long long n, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  traced_probe_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(n, x, y, t,
                                                                u, v);
  return (int)cudaGetLastError();
}
#endif
