// K2: the CIC deposit of (E, m_x, m_y) written as a gather, no atomics.
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
// axis) or leaves it out (open axis) directly, instead of reading the
// extended input planes that _gather_setup builds; that reads fewer bytes
// and needs no set-up pass.  A source left out is exactly the TPU kernel's
// zero slab: it adds a zero.  The tripolar north seam is indexed the same
// way: a source column sj >= ny on a TRIPOLAR_NORTH y axis is a ghost of
// node ((nx - 2 - si) mod nx, 2 ny - 1 - sj), the x index taken after the x
// wrap (so the corners wrap too), its offsets negated and its channels as
// they are (_gather_setup's mirrored ghost slabs, pic_pallas.py:346-365).
// As there, a ghost's offsets are clamped to the declared halo first, then
// negated, and the window is widened to the symmetric max(lo, hi) on each
// axis (the wrapper widens it), so a ghost's deposits lie in it.  The TPU
// kernel clips every offset to that window once more; the only offset it
// moves is a ghost's of a particle clamped at -lo on an axis whose lo is the
// wider side (-lo negates to +lo, clipped to lo - 1e-5), whose deposit would
// then differ from the pad-and-fold deposit by 1e-5 of its weight.  Here
// there is no second clip: the ghost deposits with weight 1 on +lo, as the
// fold of pic.py scatter_dense does.  A real source's offsets are clamped to
// the declared halo once, as in both.
//
// What bounds it on an H100, and the design.  Device memory sees one pass
// over 5 input planes and the mask and one over the 3 outputs: 33 bytes a
// node, 23 us at 1536^2 and 3.35 TB/s.  The one-thread-per-node version
// (`gather_node`, kept as the `_simple` kernels) is far above that, bound
// by instructions: every thread recomputed the clamp, floor, int conversion
// and CIC weights of each window cell's source (about 45 instructions a
// cell, 16 or 49 cells) and read 6 planes a cell through L1.  The tiled
// window sum below forms each source's terms once per block:
// - a block owns a TX x 32 tile of output nodes (threads along y, the
//   contiguous axis; each thread R nodes along x) and stages the tile's
//   sources, (TX+xl+xh) x (32+yl+yh), in shared memory: `cp.async` copies
//   the planes in (zero-filled where a source lies off an open axis, which
//   adds +0.0 to a sum that started at +0.0, the same bits as leaving it
//   out), then each source's clamp, floor offsets, weights and c_k * m are
//   computed once (`stage_chunk`);
// - after a barrier each thread walks its source rows once per dy, from
//   high to low, forms wy * (c_k * m) once per source and adds wx * (that)
//   to each of its R nodes whose window holds the source (`sum_chunk`).  For
//   every node the terms arrive in the per-node loop's order (dy ascending
//   outermost, dx ascending), with the same roundings; zero-weight terms
//   are added too, so a non-finite source still reaches its whole window;
// - no 64-bit division and no 64-bit product per cell: 32-bit tile
//   coordinates, one 64-bit offset per staged source and per output node;
// - a halo too large for one tile's shared memory is staged in strips of
//   dy (the sum's outer loop) and, when one dy still does not fit, in chunks
//   of source rows walked from high to low, so every halo the wrapper
//   accepts runs.
// The width of the window in x is compiled in for the main path's halos (4
// for the flagship's ((0,3),(0,3)), 7 for halo 3): the walk unrolls and its
// window tests fold away.  The block's shared memory (32 bytes a source)
// and registers set the occupancy; TX = 32 (R = 4 nodes a thread, 8 warps)
// and a 64 KB budget, compiled in, were chosen by a sweep on the card (root
// PERF.md §6).
// The same templates run in float64 (the float64 library, PICLES_F64, T =
// double): a staged source is then 64 bytes (two 32-byte quads of doubles,
// `Quad<T>`), its planes copied with 8-byte `cp.async`, the floor offsets
// kept in a double's low word, and the sums and the remesh in double.  The
// float32 budget of 64 KB would cut the main path's windows into strips of
// one dy, restaging each source once a dy, so the double instances take a
// budget of their own (`SMEM_BUDGET_F64`, up to the card's 227 KB a block),
// in which those windows stage in one piece; the order of every sum is the
// float instances' and does not depend on the plan.
// Layers (several wave systems on one grid) are the launch's second grid
// dimension: blockIdx.y is the layer, whose sources are read at layer * nx
// * ny + node and whose outputs are written at layer * ox * oy + node.  The
// staging, the seam's ghosts and the order of the sums do not depend on the
// layer, so each layer's deposit is its single-layer deposit bit for bit,
// from one launch.
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
// axes open, K2's window sum adds exactly that node's window: a source
// outside [0, nx) x [0, ny) adds nothing, as the accumulator has no
// particle there.  So K4 is K2's tiled window sum with both axes open over
// the larger output range; the halo slabs it leaves are what the sharded
// step exchanges with the neighbouring blocks.  Deterministic, no atomics.
//
// K6: the same deposit with the remesh fused into its output pass.
//
// Replaces (TPU kernel): picles_tpu/ops/pic_pallas.py _accum_remesh_kernel
// (launcher scatter_remesh_fused).  Plain PyTorch version: pic.py
// scatter_dense, then remesh.py remesh_core.  Each block sums its tile with
// K2's window sum (so the node planes equal K2's bit for bit) and feeds the
// three sums of each node straight into the remesh branch table
// (remesh.cuh `remesh_node`, K5's).  It writes the 3 node planes and the 8
// remesh outputs and never reads the node planes back: the separate K5 pass
// would read them again (12 bytes a node) and launch once more.  A gridded
// wind's planes are read at each output node by the thread that remeshes
// it (28 bytes a node at B = 1), not staged with the sources: only the
// node's own values are needed.  A layer's particle planes are offset as
// its sources are; the masks, the node x and the wind planes are shared.
// Where the model's step runs K1's epilogue before it (its fused path), K6
// writes the node state straight into the model's [..., nx, ny, 3] layout,
// leaves the branch plane out, and adds the remesh's counts (gathered,
// reseeded, switched off) to the step's counters, one integer atomic a
// slot a block (remesh.cuh `block_counts`).
// A traced wind's K6 (PICLES_TRACED_WIND: its library compiles only this
// entry point of the file, `picles_pic_gather_remesh_traced`, or
// `picles_pic_gather_remesh_traced_f64` of a float64 wind, whose double
// instance also takes the double budget) reads the node y plane there too
// (4 bytes a node, 8 in double) and calls the emitted `traced_wind` at the
// clock.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "remesh.cuh"

namespace {
PICLES_KERNELS_BEGIN

using picles::xfloor;
using picles::xfmax;
using picles::xfmin;

template <class T>
struct GatherConfig {
  int nx, ny;
  int xl, xh, yl, yh;            // the window (widened on a tripolar grid)
  int periodic_x, periodic_y;
  int tripolar;                  // the y axis is TRIPOLAR_NORTH
  int layers;                    // layers of the source and output planes
  T x_lo, x_hi, y_lo, y_hi;      // clamp bounds of the declared halo, in T
                                 // as the JAX package forms them
};

template <class T>
__device__ __forceinline__ T clampf(T v, T lo, T hi) {
  // jnp.clip: min(max(v, lo), hi), NaN propagating
  if (v != v) return v;
  return xfmin(xfmax(v, lo), hi);
}

// ---------------------------------------------------------------------------
// The tiled window sum (K2, K4, K6)
// ---------------------------------------------------------------------------

constexpr int TY = 32;           // tile columns: one warp along y
constexpr int R = 4;             // tile rows a thread (output nodes along x)
constexpr int WARPS = 8;         // warps a block, along x
constexpr int TX = R * WARPS;    // tile rows
constexpr int SMEM_BUDGET = 64 * 1024;  // bytes of shared memory a block may take
// the double instances' budget (see the head of this file); the float64
// library's `picles_gather_budget_f64` sets another for a measurement
constexpr int SMEM_BUDGET_F64 = 128 * 1024;
constexpr int SMEM_MAX = 227 * 1024;    // the card's most a block may take

// Four staged values of one source: float4 (16 bytes), or for double a
// 32-byte quad of doubles.
struct alignas(16) DoubleQuad {
  double x, y, z, w;
};
template <class T>
using Quad = typename std::conditional<std::is_same<T, float>::value, float4,
                                       DoubleQuad>::type;
__device__ __forceinline__ float4 make_quad(float a, float b, float c,
                                            float d) {
  return make_float4(a, b, c, d);
}
__device__ __forceinline__ DoubleQuad make_quad(double a, double b, double c,
                                                double d) {
  return DoubleQuad{a, b, c, d};
}
// An int kept in a staged value's bits (its low word for a double).
__device__ __forceinline__ float int_in(float, int i) {
  return __int_as_float(i);
}
__device__ __forceinline__ double int_in(double, int i) {
  return __hiloint2double(0, i);
}
__device__ __forceinline__ int int_of(float v) { return __float_as_int(v); }
__device__ __forceinline__ int int_of(double v) { return __double2loint(v); }

// How a launch cuts the output into tiles and the window into staged
// pieces; chosen on the host (plan_sum).
struct SumPlan {
  int d;              // dy values one strip stages (yl+yh+1: the whole window)
  int ux;             // source rows one chunk stages (TX+xl+xh: all of them)
  int v;              // staged columns, TY + d - 1 (row stride)
  int ox, oy;         // output extent
  int off_x, off_y;   // output node (p, q) is grid node (p - off_x, q - off_y)
  int tiles_y;        // tiles along y
};

template <class T>
struct Sources {
  const T *xr, *yr, *c0, *c1, *c2;
  const unsigned char* act;
};

// One cp.async of a T (4 or 8 bytes), zero-filled when `valid` is false
// (src-size 0).
template <class T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool valid) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 4 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 8 : 0));
#else
  *dst = valid ? *src : T(0);
#endif
}

__device__ __forceinline__ void copy_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// Stage the sources of tile-local rows [lo, hi) (row u is grid row
// i0 - xh + u) and of w columns (column c is grid column j0 - dy1 + c: the
// sources the tile's nodes reach with the strip's dy), of the layer whose
// planes start `base` values in, into shared memory:
//   a[e] = (wxc, wyc, c0 * m, c1 * m),  b[e] = (c2 * m, fx, fy, -),
// e = (u - lo) * p.v + c.  Each thread computes the sources it copied; the
// copy pass marks a tripolar ghost in b[e].y, which the compute pass reads
// and overwrites.
template <class T>
__device__ __forceinline__ void stage_chunk(const GatherConfig<T>& g,
                                           const SumPlan& p, int i0, int j0,
                                           int lo, int hi, int dy1, int w,
                                           const Sources<T>& src,
                                           long long base, Quad<T>* sa,
                                           Quad<T>* sb) {
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int count = (hi - lo) * w;
  for (int pass = 0; pass < 2; ++pass) {
    for (int k = tid; k < count; k += nthreads) {
      const int row = k / w, c = k - row * w;
      const int e = row * p.v + c;
      T* a = reinterpret_cast<T*>(sa + e);
      T* b = reinterpret_cast<T*>(sb + e);
      if (pass == 0) {
        int si = i0 - g.xh + lo + row;
        if (g.periodic_x) si = si < 0 ? si + g.nx : (si >= g.nx ? si - g.nx : si);
        int sj = j0 - dy1 + c;
        if (g.periodic_y) sj = sj < 0 ? sj + g.ny : (sj >= g.ny ? sj - g.ny : sj);
        const bool ghost = g.tripolar && sj >= g.ny;
        if (ghost) {  // mirrored through the north seam
          sj = 2 * g.ny - 1 - sj;
          if (si >= 0 && si < g.nx) si = si <= g.nx - 2 ? g.nx - 2 - si : g.nx - 1;
        }
        const bool ok = si >= 0 && si < g.nx && sj >= 0 && sj < g.ny;
        const long long s = ok ? base + (long long)si * g.ny + sj : 0;
        copy_async(a + 0, src.xr + s, ok);
        copy_async(a + 1, src.yr + s, ok);
        copy_async(a + 2, src.c0 + s, ok);
        copy_async(a + 3, src.c1 + s, ok);
        copy_async(b + 0, src.c2 + s, ok);
        b[1] = ghost ? T(1) : T(0);
        b[3] = (ok && src.act[s]) ? T(1) : T(0);
      } else {
        // the per-node loop's arithmetic, once per source
        T px = clampf(a[0], g.x_lo, g.x_hi);
        T py = clampf(a[1], g.y_lo, g.y_hi);
        if (b[1] != T(0)) {  // a ghost deposits in mirrored directions
          px = -px;
          py = -py;
        }
        const T fxf = xfloor(px);
        const T fyf = xfloor(py);
        const T m = b[3];
        sa[e] = make_quad(px - fxf, py - fyf, a[2] * m, a[3] * m);
        sb[e] = make_quad(b[0] * m, int_in(m, (int)fxf), int_in(m, (int)fyf),
                          T(0));
      }
    }
    if (pass == 0) copy_async_wait_all();  // this thread's own copies
  }
}

// Add one staged source's terms for one dy to the thread's R partial sums:
// walked as row `st` of the thread's rows (node r's dx = st + r + 1 - R - xl),
// so node r's window holds it when R-1-r <= st <= R-2-r+W (`all`: every
// node's does).  The per-node loop's weight `(f == d ? wf : 0) + (f == d - 1
// ? wc : 0)` is formed by selects: the weights are never -0 and a NaN weight
// comes out of an arithmetic operation (canonical), so adding +0.0 changes
// no bit and is left out.
template <class T>
__device__ __forceinline__ void add_source(int st, int W, int xl, int dy,
                                           const Quad<T>& va,
                                           const Quad<T>& vb, bool all,
                                           T a[R][3]) {
  const T wxc = va.x, wxf = T(1) - wxc;
  const T wyc = va.y, wyf = T(1) - wyc;
  const int fy = int_of(vb.z);
  const T wy = fy == dy ? wyf : (fy == dy - 1 ? wyc : T(0));
  const T q0 = wy * va.z, q1 = wy * va.w, q2 = wy * vb.x;
  const int ex = int_of(vb.y) - (st + 1 - R - xl);  // fx - dx(r = 0)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (all || (st >= R - 1 - r && st <= R - 2 - r + W)) {
      const T wx = ex == r ? wxf : (ex == r - 1 ? wxc : T(0));
      a[r][0] = a[r][0] + wx * q0;
      a[r][1] = a[r][1] + wx * q1;
      a[r][2] = a[r][2] + wx * q2;
    }
  }
}

// Walk the staged rows [lo, hi) for each dy of the strip [dy0, dy1]: thread
// (threadIdx.x, threadIdx.y) owns the R nodes of tile rows R*threadIdx.y + r
// at tile column threadIdx.x and walks its rows from high to low.  `a` holds
// a dy's partial sums (reset on the first chunk, added to `acc` on the
// last).  WX > 0 compiles the window's width xl + xh + 1 in: the walk is
// unrolled and every window test folds away.
template <int WX, class T>
__device__ __forceinline__ void sum_chunk(const GatherConfig<T>& g,
                                          const SumPlan& p, int lo, int hi,
                                          int dy0, int dy1, bool first,
                                          bool last, const Quad<T>* sa,
                                          const Quad<T>* sb, T a[R][3],
                                          T acc[R][3]) {
  const int W = WX ? WX : g.xl + g.xh + 1;
  const int base = R * threadIdx.y;
  const int top = base + R + W - 2;  // the thread's highest row
  for (int dy = dy0; dy <= dy1; ++dy) {
    if (first) {
#pragma unroll
      for (int r = 0; r < R; ++r) a[r][0] = a[r][1] = a[r][2] = T(0);
    }
    const int col = threadIdx.x - dy + dy1;
    if (WX) {
#pragma unroll
      for (int st = 0; st < R + WX - 1; ++st) {
        const int u = top - st;
        if (u >= lo && u < hi) {
          const int e = (u - lo) * p.v + col;
          add_source<T>(st, WX, g.xl, dy, sa[e], sb[e], false, a);
        }
      }
    } else {
      const int u_hi = min(hi - 1, top), u_lo = max(lo, base);
      for (int u = u_hi; u >= u_lo; --u) {
        const int st = top - u;
        const int e = (u - lo) * p.v + col;
        add_source<T>(st, W, g.xl, dy, sa[e], sb[e],
                      st >= R - 1 && st <= W - 1, a);
      }
    }
    if (last) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r][0] = acc[r][0] + a[r][0];
        acc[r][1] = acc[r][1] + a[r][1];
        acc[r][2] = acc[r][2] + a[r][2];
      }
    }
  }
}

// The window sums of the block's tile, whose first node is grid node
// (i0, j0), over the sources of the layer at `base`: strips of dy
// ascending, chunks of source rows from high to low.
template <int WX, class T>
__device__ __forceinline__ void window_sum(const GatherConfig<T>& g,
                                           const SumPlan& p, int i0, int j0,
                                           const Sources<T>& src,
                                           long long base, Quad<T>* sa,
                                           Quad<T>* sb, T acc[R][3]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = T(0);
  T a[R][3];
  const int rows = TX + g.xl + g.xh;
  for (int dy0 = -g.yl; dy0 <= g.yh; dy0 += p.d) {
    const int dy1 = min(dy0 + p.d - 1, g.yh);
    for (int hi = rows; hi > 0; hi -= p.ux) {
      const int lo = max(hi - p.ux, 0);
      __syncthreads();  // the previous piece is no longer read
      stage_chunk(g, p, i0, j0, lo, hi, dy1, TY + dy1 - dy0, src, base, sa,
                  sb);
      __syncthreads();
      sum_chunk<WX>(g, p, lo, hi, dy0, dy1, hi == rows, lo == 0, sa, sb,
                    a, acc);
    }
  }
}

// The block's dynamic shared memory: the plan's two arrays of quads.
extern __shared__ __align__(16) unsigned char smem_raw[];

// The block's tile (first output node (p0, q0)) and its layer: the
// offsets of the layer's sources (nx * ny a layer) and outputs (ox * oy).
template <class T>
__device__ __forceinline__ void tile_origin(const GatherConfig<T>& g,
                                            const SumPlan& p, int& p0,
                                            int& q0, long long& src_off,
                                            long long& out_off) {
  const int t = blockIdx.x;
  p0 = (t / p.tiles_y) * TX;
  q0 = (t % p.tiles_y) * TY;
  src_off = (long long)blockIdx.y * g.nx * g.ny;
  out_off = (long long)blockIdx.y * p.ox * p.oy;
}

// K2 (off = 0, output [nx, ny]) and K4 (off = (xl, yl), the padded output).
template <int WX, class T>
__global__ void __launch_bounds__(TY * WARPS)
pic_gather_tiled_kernel(const GatherConfig<T> g, const SumPlan p,
                        const Sources<T> src, T* __restrict__ o0,
                        T* __restrict__ o1, T* __restrict__ o2) {
  Quad<T>* smem = reinterpret_cast<Quad<T>*>(smem_raw);
  int p0, q0;
  long long src_off, out_off;
  tile_origin(g, p, p0, q0, src_off, out_off);
  T acc[R][3];
  window_sum<WX>(g, p, p0 - p.off_x, q0 - p.off_y, src, src_off, smem,
                 smem + p.ux * p.v, acc);
  const int q = q0 + threadIdx.x;
  if (q >= p.oy) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int pi = p0 + R * threadIdx.y + r;
    if (pi < p.ox) {
      const long long o = out_off + (long long)pi * p.oy + q;
      o0[o] = acc[r][0];
      o1[o] = acc[r][1];
      o2[o] = acc[r][2];
    }
  }
}

// Particle planes and masks of K6's remesh half, core-aligned [nx, ny]
// (the particle planes [layers, nx, ny]).
template <class T>
struct RemeshPlanes {
  const T* clock;
  const T *lne, *cgx, *cgy, *px, *py, *dt;
  const unsigned char *on, *act, *bnd;
  const T* xn;
  T *lne_o, *cgx_o, *cgy_o, *px_o, *py_o, *dt_o;
  unsigned char* on_o;
  int* br_o;       // null: not written (the model's fused path)
  T* state_o;      // the node state [layers, nx, ny, 3], or null: the planes
  int* counts;     // the step's counters [layers, N_COUNTERS], or null
};

// The node x the remesh's wind reads: none for a gridded or node wind,
// whose node values come from its own planes (rhs.cuh wind_uv_node), read
// at the node directly and never staged with the deposit's sources.
template <class T>
__device__ __forceinline__ T node_x(const picles::RemeshParams<T>& r,
                                    const RemeshPlanes<T>& q, long long idx) {
  return !picles::planar_wind(r.wind.kind) ? q.xn[idx] : T(0);
}

template <int WX, class T>
__global__ void __launch_bounds__(TY * WARPS)
pic_gather_remesh_tiled_kernel(const GatherConfig<T> g, const SumPlan p,
                               const picles::RemeshParams<T> rp,
                               const Sources<T> src, const RemeshPlanes<T> q,
                               T* __restrict__ o0, T* __restrict__ o1,
                               T* __restrict__ o2) {
  Quad<T>* smem = reinterpret_cast<Quad<T>*>(smem_raw);
  int p0, q0;
  long long lo, out_off;
  tile_origin(g, p, p0, q0, lo, out_off);
  T acc[R][3];
  window_sum<WX>(g, p, p0, q0, src, lo, smem, smem + p.ux * p.v, acc);
  const int j = q0 + threadIdx.x;
  int cnt[3] = {0, 0, 0};  // gathered, reseeded, switched off
  // one copy of the branch table, the node's sums picked by selects
#pragma unroll 1
  for (int r = 0; r < R && j < g.ny; ++r) {
    const int i = p0 + R * threadIdx.y + r;
    if (i >= g.nx) break;
    T s0 = acc[0][0], s1 = acc[0][1], s2 = acc[0][2];
#pragma unroll
    for (int k = 1; k < R; ++k) {
      if (r == k) {
        s0 = acc[k][0];
        s1 = acc[k][1];
        s2 = acc[k][2];
      }
    }
    const long long idx = (long long)i * g.ny + j;  // the node
    const long long k = lo + idx;                    // its layer's particle
    if (q.state_o) {
      T* s = q.state_o + 3 * k;
      s[0] = s0;
      s[1] = s1;
      s[2] = s2;
    } else {
      o0[k] = s0;
      o1[k] = s1;
      o2[k] = s2;
    }
    const bool on = q.on[k] != 0;
    const picles::RemeshOut<T> o = picles::remesh_node(
        rp, *q.clock, idx, s0, s1, s2, q.lne[k], q.cgx[k], q.cgy[k], q.px[k],
        q.py[k], q.dt[k], on, q.act[idx] != 0, q.bnd[idx] != 0,
        node_x(rp, q, idx));
    q.lne_o[k] = o.lne;
    q.cgx_o[k] = o.cgx;
    q.cgy_o[k] = o.cgy;
    q.px_o[k] = o.px;
    q.py_o[k] = o.py;
    q.dt_o[k] = o.dt;
    q.on_o[k] = o.on ? 1 : 0;
    if (q.br_o) q.br_o[k] = o.branch;
    cnt[0] += (o.branch & picles::GATHER_BIT) != 0;
    cnt[1] += (o.branch & picles::RESEED_BIT) != 0;
    // on -> off transitions: `on` is the flag before the remesh
    cnt[2] += (o.branch & picles::OFF_BIT) != 0 && on;
  }
  if (q.counts)
    picles::block_counts<3, false>(
        q.counts + (long long)blockIdx.y * picles::N_COUNTERS, cnt,
        [](int c) { return picles::C_GATHER + c; });
}

#ifdef PICLES_MAIN_LIB
// ---------------------------------------------------------------------------
// The previous one-thread-per-node kernels, kept as baselines (`_simple`):
// chip_smoke.py and the card tests hold the tiled kernels to them bit for
// bit and time both in turns.  No path of the package launches them; float
// only.
// ---------------------------------------------------------------------------

// The deposit at output node (i, j): the sum over its window of sources.
__device__ __forceinline__ void gather_node(
    const GatherConfig<float>& g, int i, int j, const float* __restrict__ xr,
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
pic_gather_simple_kernel(const GatherConfig<float> g, const float* __restrict__ xr,
                         const float* __restrict__ yr,
                         const float* __restrict__ c0,
                         const float* __restrict__ c1,
                         const float* __restrict__ c2,
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
pic_gather_padded_simple_kernel(const GatherConfig<float> g,
                                const float* __restrict__ xr,
                                const float* __restrict__ yr,
                                const float* __restrict__ c0,
                                const float* __restrict__ c1,
                                const float* __restrict__ c2,
                                const unsigned char* __restrict__ act,
                                float* __restrict__ o0,
                                float* __restrict__ o1,
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

__global__ void __launch_bounds__(256)
pic_gather_remesh_simple_kernel(const GatherConfig<float> g,
                                const picles::RemeshParams<float> r,
                                const float* __restrict__ xr,
                                const float* __restrict__ yr,
                                const float* __restrict__ c0,
                                const float* __restrict__ c1,
                                const float* __restrict__ c2,
                                const unsigned char* __restrict__ sact,
                                const RemeshPlanes<float> q,
                                float* __restrict__ o0,
                                float* __restrict__ o1,
                                float* __restrict__ o2) {
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
  const picles::RemeshOut<float> o = picles::remesh_node(
      r, *q.clock, idx, acc0, acc1, acc2, q.lne[idx], q.cgx[idx], q.cgy[idx],
      q.px[idx], q.py[idx], q.dt[idx], q.on[idx] != 0, q.act[idx] != 0,
      q.bnd[idx] != 0, node_x(r, q, idx));
  q.lne_o[idx] = o.lne;
  q.cgx_o[idx] = o.cgx;
  q.cgy_o[idx] = o.cgy;
  q.px_o[idx] = o.px;
  q.py_o[idx] = o.py;
  q.dt_o[idx] = o.dt;
  q.on_o[idx] = o.on ? 1 : 0;
  q.br_o[idx] = o.branch;
}
#endif  // PICLES_MAIN_LIB

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <class T>
GatherConfig<T> unpack_gather(const T* fparams, const int* iparams) {
  GatherConfig<T> g;
  g.nx = iparams[0]; g.ny = iparams[1];
  g.xl = iparams[2]; g.xh = iparams[3]; g.yl = iparams[4]; g.yh = iparams[5];
  g.periodic_x = iparams[6]; g.periodic_y = iparams[7];
  g.tripolar = iparams[8];
  g.layers = iparams[9];
  g.x_lo = fparams[0]; g.x_hi = fparams[1];
  g.y_lo = fparams[2]; g.y_hi = fparams[3];
  return g;
}

constexpr int N_GATHER_F = 4;
constexpr int N_GATHER_I = 10;
constexpr int THREADS = 256;

// The shared memory a plan of T may take: SMEM_BUDGET for float,
// `budget_f64` (SMEM_BUDGET_F64 unless `picles_gather_budget_f64` set
// another) for double.
int budget_f64 = SMEM_BUDGET_F64;
template <class T>
int smem_budget() {
  return std::is_same<T, float>::value ? SMEM_BUDGET : budget_f64;
}

// The tiling over an [ox, oy] output: the whole window in one piece when it
// fits the budget, else strips of dy, else chunks of source rows with one dy
// a strip.
template <class T>
SumPlan plan_sum(const GatherConfig<T>& g, int ox, int oy, int off_x,
                 int off_y) {
  SumPlan p;
  const long long cap =
      smem_budget<T>() / (long long)(2 * sizeof(Quad<T>));  // sources
  const int rows = TX + g.xl + g.xh;
  const int dys = g.yl + g.yh + 1;
  if ((long long)rows * (TY + dys - 1) <= cap) {
    p.d = dys;
    p.ux = rows;
  } else if ((long long)rows * TY <= cap) {
    p.d = (int)(cap / rows - TY + 1);
    p.ux = rows;
  } else {
    p.d = 1;
    p.ux = (int)(cap / TY);
  }
  p.v = TY + p.d - 1;
  p.ox = ox;
  p.oy = oy;
  p.off_x = off_x;
  p.off_y = off_y;
  p.tiles_y = (oy + TY - 1) / TY;
  return p;
}

template <class T>
size_t plan_bytes(const SumPlan& p) {
  return (size_t)p.ux * p.v * 2 * sizeof(Quad<T>);
}

unsigned plan_blocks(const SumPlan& p) {
  return (unsigned)(((p.ox + TX - 1) / TX) * (long long)p.tiles_y);
}

// Launch one tiled kernel instance of T, the plan's tiles times `layers`
// blocks: sets the dynamic shared-memory limit when the plan takes more than
// the default 48 KB, and returns the first CUDA error of the attribute or
// the launch.
template <class T, typename Kernel, typename... Args>
int launch_tiled(Kernel kernel, const SumPlan& p, int layers, cudaStream_t st,
                 Args... args) {
  const size_t bytes = plan_bytes<T>(p);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(plan_blocks(p), (unsigned)layers), dim3(TY, WARPS), bytes,
           st>>>(args...);
  return (int)cudaGetLastError();
}

template <class T>
Sources<T> sources(void** ptrs) {
  Sources<T> s;
  s.xr = (const T*)ptrs[0];
  s.yr = (const T*)ptrs[1];
  s.c0 = (const T*)ptrs[2];
  s.c1 = (const T*)ptrs[3];
  s.c2 = (const T*)ptrs[4];
  s.act = (const unsigned char*)ptrs[5];
  return s;
}

#ifndef PICLES_TRACED_WIND
template <int WX, class T>
int gather_tiled(const GatherConfig<T>& g, const SumPlan& p, void** ptrs,
                 cudaStream_t st) {
  return launch_tiled<T>(pic_gather_tiled_kernel<WX, T>, p, g.layers, st, g,
                         p, sources<T>(ptrs), (T*)ptrs[6], (T*)ptrs[7],
                         (T*)ptrs[8]);
}

// The instances compiled: the window widths of the main path's halos
// compiled in (4: the flagship's ((0,3),(0,3)); 7: the default halo 3), and
// any other width.
template <class T>
int gather_dispatch(const GatherConfig<T>& g, const SumPlan& p, void** ptrs,
                    cudaStream_t st) {
  const int W = g.xl + g.xh + 1;
  if (W == 4) return gather_tiled<4>(g, p, ptrs, st);
  if (W == 7) return gather_tiled<7>(g, p, ptrs, st);
  return gather_tiled<0>(g, p, ptrs, st);
}
#endif  // PICLES_TRACED_WIND

template <class T>
RemeshPlanes<T> remesh_planes(void** ptrs) {
  RemeshPlanes<T> q;
  q.clock = (const T*)ptrs[6];
  q.lne = (const T*)ptrs[7];
  q.cgx = (const T*)ptrs[8];
  q.cgy = (const T*)ptrs[9];
  q.px = (const T*)ptrs[10];
  q.py = (const T*)ptrs[11];
  q.dt = (const T*)ptrs[12];
  q.on = (const unsigned char*)ptrs[13];
  q.act = (const unsigned char*)ptrs[14];
  q.bnd = (const unsigned char*)ptrs[15];
  q.xn = (const T*)ptrs[16];
  q.lne_o = (T*)ptrs[20];
  q.cgx_o = (T*)ptrs[21];
  q.cgy_o = (T*)ptrs[22];
  q.px_o = (T*)ptrs[23];
  q.py_o = (T*)ptrs[24];
  q.dt_o = (T*)ptrs[25];
  q.on_o = (unsigned char*)ptrs[26];
  q.br_o = (int*)ptrs[27];
  q.state_o = (T*)ptrs[28];
  q.counts = (int*)ptrs[29];
  return q;
}

template <int WX, class T>
int gather_remesh_tiled(const GatherConfig<T>& g, const SumPlan& p,
                        const picles::RemeshParams<T>& r, void** ptrs,
                        cudaStream_t st) {
  return launch_tiled<T>(pic_gather_remesh_tiled_kernel<WX, T>, p, g.layers,
                         st, g, p, r, sources<T>(ptrs),
                         remesh_planes<T>(ptrs), (T*)ptrs[17], (T*)ptrs[18],
                         (T*)ptrs[19]);
}

PICLES_KERNELS_END
}  // namespace

PICLES_USING_KERNELS

#ifndef PICLES_TRACED_WIND
// iparams: nx, ny, xl, xh, yl, yh (the window), periodic_x, periodic_y,
//          tripolar (the y axis folds at the north seam), layers
// fparams: x_lo, x_hi, y_lo, y_hi (the declared halo's clamp; real_t)
// ptrs:    xrel, yrel, c0, c1, c2, active(u8) (inputs) | o0, o1, o2 (outputs),
//          each [layers, nx, ny], real_t
// Returns the first CUDA error of the launch (cudaErrorInvalidValue for a
// layer count outside [1, MAX_LAYERS]).  The float64 library's entry point
// is `picles_pic_gather_f64`, the same layout.
extern "C" int PICLES_ENTRY(picles_pic_gather)(
    const picles::real_t* fparams, const int* iparams, void** ptrs,
    void* stream) {
  const GatherConfig<picles::real_t> g = unpack_gather(fparams, iparams);
  if (picles::bad_layers(g.layers)) return (int)cudaErrorInvalidValue;
  if (g.nx <= 0 || g.ny <= 0) return 0;
  const SumPlan p = plan_sum(g, g.nx, g.ny, 0, 0);
  return gather_dispatch(g, p, ptrs, (cudaStream_t)stream);
}

// K4.  iparams and fparams as picles_pic_gather's, the periodic and
// tripolar flags ignored (both axes open, the seam folded after it); nx, ny
// are the block's.
// ptrs:    xrel, yrel, c0, c1, c2, active(u8) ([layers, nx, ny], inputs) |
//          o0, o1, o2 ([layers, nx+xl+xh, ny+yl+yh], outputs)
// The float64 library's entry point is `picles_pic_gather_padded_f64`.
extern "C" int PICLES_ENTRY(picles_pic_gather_padded)(
    const picles::real_t* fparams, const int* iparams, void** ptrs,
    void* stream) {
  GatherConfig<picles::real_t> g = unpack_gather(fparams, iparams);
  g.periodic_x = 0;
  g.periodic_y = 0;
  g.tripolar = 0;
  if (picles::bad_layers(g.layers)) return (int)cudaErrorInvalidValue;
  if (g.nx <= 0 || g.ny <= 0) return 0;
  const SumPlan p = plan_sum(g, g.nx + g.xl + g.xh, g.ny + g.yl + g.yh, g.xl,
                             g.yl);
  return gather_dispatch(g, p, ptrs, (cudaStream_t)stream);
}
#endif  // PICLES_TRACED_WIND

#if defined(PICLES_F64) && !defined(PICLES_TRACED_WIND)
// The shared memory a double plan may take, in bytes (the window sums of
// K2, K4 and K6 in this library; at least one staged row of 32 sources, at
// most the card's 227 KB a block), for a measurement of the budget's
// choice; 0 keeps it.  Returns the budget before the call.  The sums'
// order, and so their bits, does not depend on it.
extern "C" int picles_gather_budget_f64(int bytes) {
  const int before = budget_f64;
  if (bytes >= TY * 2 * (int)sizeof(Quad<double>) && bytes <= SMEM_MAX)
    budget_f64 = bytes;
  return before;
}
#endif

// fparams: the gather's (4) | the remesh.cuh layout (real_t)
// iparams: the gather's (10) | the remesh.cuh layout
// ptrs:    xrel, yrel, c0, c1, c2, scatter_active(u8) | clock, lne, cgx, cgy,
//          px, py, dt, on(u8), active(u8), boundary(u8), xn (inputs) |
//          o0, o1, o2 | lne, cgx, cgy, px, py, dt, on(u8), branch(i32)
//          (outputs) | the epilogue's (the model's fused path): the node
//          state [layers, nx, ny, 3] (output; o0, o1 and o2 then null),
//          the counters (i32 [layers, N_COUNTERS]: n_gather, n_reseed and
//          n_off added to; the branch may then be null), each null
//          without it | the n_wf wind planes (inputs: float32 4 + 3B
//          gridded, real_t u and v of the node kind, the real_t node y of
//          the traced kind, none for analytic winds).  The deposit's
//          planes and the particle planes are [layers, nx, ny]; active,
//          boundary, xn and the wind planes [nx, ny], shared; every plane
//          but the masks, the branch and the gridded wind planes real_t.
// cudaErrorInvalidValue for planes that `attach_planes` refuses or a layer
// count outside [1, MAX_LAYERS].  A traced library's entry point is
// `picles_pic_gather_remesh_traced`, the float64 library's
// `picles_pic_gather_remesh_f64`, a float64 traced library's
// `picles_pic_gather_remesh_traced_f64`, the same layout.
constexpr int K6_PTRS = 30;

extern "C" int PICLES_ENTRY(picles_pic_gather_remesh)(
    const picles::real_t* fparams, const int* iparams, void** ptrs,
    void* stream) {
  using T = picles::real_t;
  const GatherConfig<T> g = unpack_gather(fparams, iparams);
  picles::RemeshParams<T> r;
  picles::unpack_remesh(fparams + N_GATHER_F, iparams + N_GATHER_I, r);
  if (!picles::attach_planes(r.wind, iparams[N_GATHER_I + 2],
                             ptrs + K6_PTRS) || picles::bad_layers(g.layers))
    return (int)cudaErrorInvalidValue;
  if (g.nx <= 0 || g.ny <= 0) return 0;
  const SumPlan p = plan_sum(g, g.nx, g.ny, 0, 0);
  const cudaStream_t st = (cudaStream_t)stream;
  const int W = g.xl + g.xh + 1;
  if (W == 4) return gather_remesh_tiled<4>(g, p, r, ptrs, st);
  if (W == 7) return gather_remesh_tiled<7>(g, p, r, ptrs, st);
  return gather_remesh_tiled<0>(g, p, r, ptrs, st);
}

#ifdef PICLES_MAIN_LIB
// The `_simple` baselines: the entry points above with the same parameter
// layouts, one thread per output node; analytic winds only (no gridded,
// node or traced wind), one layer, no tripolar seam
// (cudaErrorInvalidValue).
extern "C" int picles_pic_gather_simple(const float* fparams,
                                        const int* iparams, void** ptrs,
                                        void* stream) {
  const GatherConfig<float> g = unpack_gather(fparams, iparams);
  if (g.tripolar || g.layers != 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)g.nx * g.ny;
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  pic_gather_simple_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      g, (const float*)ptrs[0], (const float*)ptrs[1], (const float*)ptrs[2],
      (const float*)ptrs[3], (const float*)ptrs[4],
      (const unsigned char*)ptrs[5], (float*)ptrs[6], (float*)ptrs[7],
      (float*)ptrs[8]);
  return (int)cudaGetLastError();
}

extern "C" int picles_pic_gather_padded_simple(const float* fparams,
                                               const int* iparams,
                                               void** ptrs, void* stream) {
  GatherConfig<float> g = unpack_gather(fparams, iparams);
  g.periodic_x = 0;
  g.periodic_y = 0;
  if (g.layers != 1) return (int)cudaErrorInvalidValue;
  const long long n =
      (long long)(g.nx + g.xl + g.xh) * (g.ny + g.yl + g.yh);
  if (g.nx <= 0 || g.ny <= 0) return 0;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  pic_gather_padded_simple_kernel<<<blocks, THREADS, 0,
                                    (cudaStream_t)stream>>>(
      g, (const float*)ptrs[0], (const float*)ptrs[1], (const float*)ptrs[2],
      (const float*)ptrs[3], (const float*)ptrs[4],
      (const unsigned char*)ptrs[5], (float*)ptrs[6], (float*)ptrs[7],
      (float*)ptrs[8]);
  return (int)cudaGetLastError();
}

extern "C" int picles_pic_gather_remesh_simple(const float* fparams,
                                               const int* iparams,
                                               void** ptrs, void* stream) {
  const GatherConfig<float> g = unpack_gather(fparams, iparams);
  picles::RemeshParams<float> r;
  picles::unpack_remesh(fparams + N_GATHER_F, iparams + N_GATHER_I, r);
  if (picles::planar_wind(r.wind.kind) ||
      r.wind.kind == picles::WIND_TRACED || g.tripolar || g.layers != 1)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)g.nx * g.ny;
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  pic_gather_remesh_simple_kernel<<<blocks, THREADS, 0,
                                    (cudaStream_t)stream>>>(
      g, r, (const float*)ptrs[0], (const float*)ptrs[1],
      (const float*)ptrs[2], (const float*)ptrs[3], (const float*)ptrs[4],
      (const unsigned char*)ptrs[5], remesh_planes<float>(ptrs),
      (float*)ptrs[17], (float*)ptrs[18], (float*)ptrs[19]);
  return (int)cudaGetLastError();
}
#endif  // PICLES_MAIN_LIB
