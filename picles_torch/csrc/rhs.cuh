// Shared device code of the advance (K1) and auto-dt (K3) kernels: the
// wind samplers and the 2D particle RHS, split into the terms that depend
// on the wind alone (`wind_terms_at`) and the rest (`rhs_state`).
//
// Replaces the closures that the JAX package's Pallas kernels inline:
// picles_tpu/ops/rhs.py `rhs_core_2d` and the wind samplers of
// picles_tpu/forcing/winds.py (`constant_winds`, `half_domain_winds`,
// `time_cosine_winds`, `gridded_pallas_samplers`, and any other closure
// that is steady in t).  A CUDA kernel cannot take a Python closure, so the
// wind is a kind plus float parameters (picles_torch/forcing/winds.py
// `WindKernel` builds them) and, for gridded winds, the per-node planes of
// one model step (`GriddedWind`); a steady closure, which the kernels read
// at the node only, is its two node planes (`WIND_NODE`, `node_uv`); a
// closure that reads its time is traced into a device function,
// `traced_wind(x, y, t, u, v)` (picles_torch/forcing/wind_trace.py), which
// a library of its own compiles (`WIND_TRACED`, below).
//
// Numerics: every operation is in the lanes' scalar type T (float or
// double, below) in the order the JAX package and the plain PyTorch version
// (picles_torch/ops/rhs.py) use, squares as products, precise exp, log,
// tanh, sqrt and pow of T (no fast-math intrinsics): the overloads `xexp`
// ... `xpow` call expf ... powf for float and exp ... pow for double, and a
// call that mixes the two types does not compile.  Every
// literal is written T(...), a double literal rounded once to T (for float
// the same bits as the `f` literal), and the build asks ptxas to warn on
// any double-precision use.  Constants that the JAX package forms in
// float64 (such as r_g * r_g) arrive precomputed from Python, rounded once
// to T.  The winds' own values are what the samplers give, cast to T
// where JAX's kernel casts them to the lanes' dtype: the gridded planes are
// float32 (the record's) and the double instances widen them; a steady
// callable's node planes arrive in T (a float64 model's hold the callable's
// float64 values); the time-cosine amplitude is float32 arithmetic on
// float32(t) in both packages; a traced callable's emitted function
// computes each value in the dtype its graph has.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <cfloat>
#include <type_traits>

#ifdef PICLES_TRACED_WIND
// picles::traced_wind of one callable, or under PICLES_TRACED_WIND_1D
// picles::traced_wind_1d of one 1D callable
#include "traced_wind.cuh"
#endif

namespace picles {

// The layers one launch takes (its gridDim.y), as
// picles_torch/ops/cuda_build.py MAX_LAYERS; the C entry points refuse any
// other count.
constexpr long long MAX_LAYERS = 65535;
inline bool bad_layers(long long layers) {
  return layers < 1 || layers > MAX_LAYERS;
}

// ---------------------------------------------------------------------------
// The scalar type.  K1-K7 are templates over their lanes' scalar type T,
// float or double.  A library compiles one: the kernels' own library and a
// float32 traced wind's `float`, the float64 library (PICLES_F64,
// picles_torch/ops/cuda_build.py `library_f64`) and a float64 traced
// wind's (PICLES_F64 and PICLES_TRACED_WIND) `double`, entry points
// suffixed `_f64` and `_traced_f64` and kernels in a namespace `f64` and
// `traced64` (PICLES_KERNELS_BEGIN below), so a profiler trace tells them
// apart.
// ---------------------------------------------------------------------------
#ifdef PICLES_F64
using real_t = double;
#else
using real_t = float;
#endif
// The kernels' own library: the only one that compiles the `_simple`
// baselines
#if !defined(PICLES_F64) && !defined(PICLES_TRACED_WIND)
#define PICLES_MAIN_LIB 1
#endif

// The precise math of each type: float calls the float32 functions, double
// the float64 ones.  The generic templates are deleted, so a call with
// another type or with the two types mixed (a float literal beside a double,
// which would widen silently) does not compile.
#define PICLES_MATH1(name, f32, f64)                                      \
  __device__ __forceinline__ float name(float a) { return f32(a); }      \
  __device__ __forceinline__ double name(double a) { return f64(a); }    \
  template <class A> A name(A) = delete;
#define PICLES_MATH2(name, f32, f64)                                      \
  __device__ __forceinline__ float name(float a, float b) {              \
    return f32(a, b);                                                     \
  }                                                                       \
  __device__ __forceinline__ double name(double a, double b) {           \
    return f64(a, b);                                                     \
  }                                                                       \
  template <class A, class B> A name(A, B) = delete;
PICLES_MATH1(xexp, expf, exp)
PICLES_MATH1(xlog, logf, log)
PICLES_MATH1(xtanh, tanhf, tanh)
PICLES_MATH1(xsqrt, sqrtf, sqrt)
PICLES_MATH1(xabs, fabsf, fabs)
PICLES_MATH1(xfloor, floorf, floor)
PICLES_MATH2(xpow, powf, pow)
PICLES_MATH2(xfmod, fmodf, fmod)
PICLES_MATH2(xfmax, fmaxf, fmax)
PICLES_MATH2(xfmin, fminf, fmin)
#undef PICLES_MATH1
#undef PICLES_MATH2

// The canonical quiet NaN and the infinity of each type.
__device__ __forceinline__ float qnan_of(float) {
  return __int_as_float(0x7fc00000);
}
__device__ __forceinline__ double qnan_of(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}
__device__ __forceinline__ float inf_of(float) {
  return __int_as_float(0x7f800000);
}
__device__ __forceinline__ double inf_of(double) {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// The machine epsilon of T (the dt floor's 4 eps)
template <class T>
__host__ __device__ constexpr T eps_of() {
  return std::is_same<T, float>::value ? T(FLT_EPSILON) : T(DBL_EPSILON);
}

// max/min that propagate NaN like jnp.maximum and torch.maximum (fmaxf and
// fminf return the other operand), so a NaN lane stays NaN for the guards.
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? qnan_of(a) : fmaxf(a, b);
}
__device__ __forceinline__ double jmax(double a, double b) {
  return (a != a || b != b) ? qnan_of(a) : fmax(a, b);
}
template <class A, class B> A jmax(A, B) = delete;
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? qnan_of(a) : fminf(a, b);
}
__device__ __forceinline__ double jmin(double a, double b) {
  return (a != a || b != b) ? qnan_of(a) : fmin(a, b);
}
template <class A, class B> A jmin(A, B) = delete;

// isfinite without a detour through another type (the C++ overloads may
// widen)
__device__ __forceinline__ bool finitef(float a) {
  return fabsf(a) < inf_of(a);
}
__device__ __forceinline__ bool finitef(double a) {
  return fabs(a) < inf_of(a);
}
template <class A> bool finitef(A) = delete;

enum WindKind : int {
  WIND_CONSTANT = 0, WIND_HALF_DOMAIN = 1, WIND_TIME_COSINE = 2,
  WIND_GRIDDED = 3, WIND_NODE = 4, WIND_TRACED = 5
};

// The traced wind.  picles_torch/ops/cuda_build.py `traced_library`
// compiles advance.cu, remesh.cu and pic_gather.cu once more for each traced
// callable, with PICLES_TRACED_WIND defined and the emitted
// `traced_wind.cuh` on the include path: that library holds only the traced
// instances of K1, K3, K5 and K6 (entry points `..._traced`), whose lanes
// read the node x and y and call `traced_wind` at every stage time.  A 1D
// callable's library (`traced_library_1d`) compiles advance_1d.cu alone
// with PICLES_TRACED_WIND_1D defined too: K7's traced instances, whose
// lanes call `traced_wind_1d(xn, t)`.  A callable traced for a float64
// model is emitted in double and compiled with PICLES_F64 as well: the
// double instances of the same kernels (entry points `..._traced_f64`).
// The kernels' own library compiles no traced code: there `traced_wind`
// and `traced_wind_1d` are stubs that no kernel calls (every call sits in
// a branch that `TRACED_LIB` or a template's wind kind folds away), and
// `attach_planes` and K7's entry point refuse the kind.
//
// A traced library's kernels sit in a namespace `traced` (`traced64` in
// double) inside their file's own (PICLES_KERNELS_BEGIN / _END around a
// file's kernels, PICLES_USING_KERNELS before its entry points), so a
// profiler trace tells them from the kernels' own library:
// picles::traced::advance_kernel<...> against picles::advance_kernel<...>.
#if defined(PICLES_TRACED_WIND) && defined(PICLES_F64)
constexpr bool TRACED_LIB = true;
#define PICLES_ENTRY(name) name##_traced_f64
#define PICLES_KERNELS_BEGIN namespace traced64 {
#define PICLES_KERNELS_END }
#define PICLES_USING_KERNELS using namespace traced64;
#elif defined(PICLES_TRACED_WIND)
constexpr bool TRACED_LIB = true;
#define PICLES_ENTRY(name) name##_traced
#define PICLES_KERNELS_BEGIN namespace traced {
#define PICLES_KERNELS_END }
#define PICLES_USING_KERNELS using namespace traced;
#elif defined(PICLES_F64)
#define PICLES_ENTRY(name) name##_f64
#define PICLES_KERNELS_BEGIN namespace f64 {
#define PICLES_KERNELS_END }
#define PICLES_USING_KERNELS using namespace f64;
constexpr bool TRACED_LIB = false;
#else
#define PICLES_ENTRY(name) name
#define PICLES_KERNELS_BEGIN
#define PICLES_KERNELS_END
#define PICLES_USING_KERNELS
constexpr bool TRACED_LIB = false;
#endif
#if !defined(PICLES_TRACED_WIND) || defined(PICLES_TRACED_WIND_1D)
__device__ __forceinline__ void traced_wind(real_t, real_t, real_t,
                                            real_t& u, real_t& v) {
  u = real_t(0);
  v = real_t(0);
}
#endif
#ifndef PICLES_TRACED_WIND_1D
__device__ __forceinline__ real_t traced_wind_1d(real_t, real_t) {
  return real_t(0);
}
#endif
// The traced probe's entry point of a library (the emitted function alone):
// `picles_traced_probe` and `picles_traced_probe_1d`, `..._f64` in double.
#ifdef PICLES_F64
#define PICLES_PROBE(name) name##_f64
#else
#define PICLES_PROBE(name) name
#endif

// Whether the wind's values arrive as planes (gridded, node): the
// `_simple` baselines do not take them, and no kernel reads the node x.
__host__ __device__ inline bool planar_wind(int kind) {
  return kind == WIND_GRIDDED || kind == WIND_NODE;
}

template <class T>
struct WindParams {
  int kind;
  int has_t_off;
  T u0, v0;            // U10, V10 as the samplers give them (float32 values)
  T x_split;           // half-domain switch position
  T background;        // half-domain value beyond x_split (a float32 value)
  T t_off;             // time-cosine cut-off, against the unnarrowed clock
  float two_pi;        // float32(2 pi)
  float period;        // time-cosine period, float32
  float u0f, v0f;      // U10, V10 as the time-cosine's float32 operands
  int n_break;         // gridded: breakpoints B (4 + 3B planes), else 0
  const float* wf;     // gridded: plane 0 (a_u) of the launch's planes
  const T* wn;         // node: the u plane; traced: the node y plane
  long long wf_stride; // values from one plane to the next (gridded, node)
};

// Packed wind parameters (picles_torch/ops/advance_cuda.py wind_params), T
// each: u0, v0, x_split, background, two_pi, period, t_off; ints kind,
// has_t_off, n_wf (the count of planes: 4 + 3B gridded, 2 node, 1 traced
// (the node y), else 0).
// The planes themselves follow each kernel's own pointers
// (`attach_planes`).
constexpr int N_WIND_F = 7;
constexpr int N_WIND_I = 3;

template <class T>
inline void unpack_wind(const T* g, const int* iv, WindParams<T>& w) {
  w.kind = iv[0];
  w.has_t_off = iv[1];
  w.n_break = iv[2] >= 4 ? (iv[2] - 4) / 3 : 0;
  w.u0 = g[0]; w.v0 = g[1]; w.x_split = g[2]; w.background = g[3];
  w.t_off = g[6];
  // the time-cosine's float32 operands, narrowed here on the host (the
  // wrapper packs them as float32 values)
  w.two_pi = (float)g[4]; w.period = (float)g[5];
  w.u0f = (float)g[0]; w.v0f = (float)g[1];
  w.wf = nullptr;
  w.wn = nullptr;
  w.wf_stride = 0;
}

// The wind planes of a launch: n_wf pointers, one plane after the other
// at one stride (the wrapper passes views of one [n_wf, ...] tensor),
// float32 (gridded) or T (node, and the traced kind's node y).
// Returns false (the launch is refused) for a count that is not 4 + 3B
// (gridded), 2 (node) or 1 (traced), planes that are not evenly spaced, the
// traced kind in the kernels' library or another kind in a traced one.
template <class T>
inline bool attach_planes(WindParams<T>& w, int n_wf, void* const* planes) {
  if ((w.kind == WIND_TRACED) != TRACED_LIB) return false;
  if (w.kind == WIND_TRACED) {
    if (n_wf != 1) return false;
    w.wn = (const T*)planes[0];
    return true;
  }
  if (w.kind == WIND_NODE) {
    if (n_wf != 2) return false;
    w.wn = (const T*)planes[0];
    w.wf_stride = (const T*)planes[1] - w.wn;
    return w.wf_stride != 0;
  }
  if (w.kind != WIND_GRIDDED) return n_wf == 0;
  if (n_wf < 7 || (n_wf - 4) % 3 != 0) return false;
  const float* base = (const float*)planes[0];
  const long long stride = (const float*)planes[1] - base;
  for (int k = 2; k < n_wf; ++k)
    if ((const float*)planes[k] - base != k * stride) return false;
  w.wf = base;
  w.wf_stride = stride;
  return true;
}

// Term flags (picles_torch/ops/rhs.py TermFlags)
enum : int {
  TERM_PROPAGATION = 1, TERM_INPUT = 2, TERM_DISSIPATION = 4,
  TERM_PEAK_SHIFT = 8, TERM_DIRECTION = 16
};

template <class T>
struct RHSParams {
  T r_g, C_alpha, C_e, C_varphi, g, p, n, e_T;
  T rg2;                           // r_g * r_g, formed in float64
  // projection M and great-circle coefficient: the launch's uniform
  // scalars, or a lane's own node values (advance.cu `load_projection`)
  T m00, m01, m10, m11, pc;
  int flags;
};

// The time-cosine amplitude, cos(2 pi t / period) in float32 on float32(t)
// as both packages' samplers compute it.  A double instance calls it out of
// line (`cosine_amplitude_f64`): the narrowing of its clock and cosf's own
// float64 argument reduction then sit in that one PTX function, which the
// build's check of the double instances (cuda_build.narrowing_summary) passes
// over by name (beside libdevice's double tanh, whose exponent estimate
// rounds in float32).
__device__ __forceinline__ float cosine_amplitude(float two_pi, float period,
                                                  float t) {
  return cosf(two_pi * t / period);
}
static __device__ __noinline__ float cosine_amplitude_f64(float two_pi,
                                                          float period,
                                                          double t) {
  return cosine_amplitude(two_pi, period, (float)t);
}

// u, v of an analytic wind at a node of x-coordinate xn and time t (no
// family varies in y).  The time-cosine family is float32 arithmetic (its
// sampler narrows t), widened to T at the end as JAX casts the sampler's
// value to the lanes' dtype; its cut-off compares the clock itself.
template <class T>
__device__ __forceinline__ void wind_uv(const WindParams<T>& w, T xn, T t,
                                        T& u, T& v) {
  if (w.kind == WIND_CONSTANT) {
    u = w.u0;
    v = w.v0;
  } else if (w.kind == WIND_HALF_DOMAIN) {
    const bool in = xn < w.x_split;
    u = in ? w.u0 : w.background;
    v = in ? w.v0 : w.background;
  } else {
    float a;
    if constexpr (std::is_same<T, float>::value)
      a = cosine_amplitude(w.two_pi, w.period, t);
    else
      a = cosine_amplitude_f64(w.two_pi, w.period, t);
    if (w.has_t_off && t > w.t_off) a = 0.0f;
    u = T(w.u0f * a) + T(0) * xn;
    v = T(w.v0f * a) + T(0) * xn;
  }
}

// Gridded winds (picles_torch/forcing/winds.py GriddedWinds2D
// .pallas_pwl_fields): over one model step the wind at a node is
//   u(t) = a_u + t s_u + sum_k ds_u_k max(t - b_k, 0)   (v alike),
// planes a_u, s_u, a_v, s_v, then ds_u_k, ds_v_k, b_k for k < B, float32.
// A lane loads its values once, widened to T (JAX's kernel casts the planes
// to the lanes' dtype): the first GRID_REG_B breakpoints' into registers
// (B = 1 on a DT that the record's cadence covers, 2 for one up to twice
// the cadence); the planes of any further breakpoint are read at each
// evaluation, so every B runs.
constexpr int GRID_REG_B = 2;

template <class T>
struct GriddedWind {
  T a_u, s_u, a_v, s_v;
  T ds_u[GRID_REG_B], ds_v[GRID_REG_B], b[GRID_REG_B];
  int nb;
  const float* far;  // plane 4 + 3 GRID_REG_B at the node (B > GRID_REG_B)
  long long stride;
};

template <class T>
__device__ __forceinline__ GriddedWind<T> load_gridded(const WindParams<T>& w,
                                                       long long i) {
  GriddedWind<T> g;
  const long long s = w.wf_stride;
  const float* p = w.wf + i;
  g.a_u = T(p[0]);
  g.s_u = T(p[s]);
  g.a_v = T(p[2 * s]);
  g.s_v = T(p[3 * s]);
  g.nb = w.n_break;
#pragma unroll
  for (int k = 0; k < GRID_REG_B; ++k) {
    const bool in = k < g.nb;
    g.ds_u[k] = in ? T(p[(4 + 3 * k) * s]) : T(0);
    g.ds_v[k] = in ? T(p[(5 + 3 * k) * s]) : T(0);
    g.b[k] = in ? T(p[(6 + 3 * k) * s]) : T(0);
  }
  g.far = p + (4 + 3 * GRID_REG_B) * s;
  g.stride = s;
  return g;
}

// gridded_samplers' operations: a + t s, then + ds_k max(t - b_k, 0) in k
// order, the max propagating NaN (jmax).  -fmad=false keeps each product
// and sum apart.
template <class T>
__device__ __forceinline__ void gridded_uv(const GriddedWind<T>& g, T t, T& u,
                                           T& v) {
  u = g.a_u + t * g.s_u;
  v = g.a_v + t * g.s_v;
#pragma unroll
  for (int k = 0; k < GRID_REG_B; ++k) {
    if (k < g.nb) {
      const T r = jmax(t - g.b[k], T(0));
      u = u + g.ds_u[k] * r;
      v = v + g.ds_v[k] * r;
    }
  }
  for (int k = GRID_REG_B; k < g.nb; ++k) {
    const float* q = g.far + 3 * (k - GRID_REG_B) * g.stride;
    const T r = jmax(t - T(q[2 * g.stride]), T(0));
    u = u + T(q[0]) * r;
    v = v + T(q[g.stride]) * r;
  }
}

// A steady wind given as its node planes (forcing/winds.py
// `node_plane_winds`, in T): the pair (u, v) of node i, whatever the time.
template <class T>
__device__ __forceinline__ void node_uv(const WindParams<T>& w, long long i,
                                        T& u, T& v) {
  u = w.wn[i];
  v = w.wn[i + w.wf_stride];
}

// The traced wind at the node (xn, yn) and time t: the emitted function of
// the library's scalar type.
template <class T>
__device__ __forceinline__ void traced_uv(T xn, T yn, T t, T& u, T& v) {
  static_assert(std::is_same<T, real_t>::value,
                "a traced library compiles its own scalar type's instances");
  traced_wind(xn, yn, t, u, v);
}

// u, v of any kind at node i (x-coordinate xn) and time t: the remesh's
// sampler, which reads a gridded or node wind's planes directly (in a traced
// library, the traced wind at the node's x and y).
template <class T>
__device__ __forceinline__ void wind_uv_node(const WindParams<T>& w,
                                             long long i, T xn, T t, T& u,
                                             T& v) {
  if constexpr (TRACED_LIB)
    traced_uv(xn, w.wn[i], t, u, v);
  else if (w.kind == WIND_GRIDDED)
    gridded_uv(load_gridded(w, i), t, u, v);
  else if (w.kind == WIND_NODE)
    node_uv(w, i, u, v);
  else
    wind_uv(w, xn, t, u, v);
}

// The terms of rhs_core_2d that depend on the wind alone: a lane whose wind
// does not vary in t (the constant, half-domain and node kinds) forms them
// once per model step.
template <class T>
struct WindTerms {
  T u, v;
  T u2;  // u * u + v * v
  T uv;  // u * v
  T dv;  // 2 (v * v) - u2
};

template <class T>
__device__ __forceinline__ WindTerms<T> terms_of(T u, T v) {
  WindTerms<T> w;
  w.u = u;
  w.v = v;
  w.u2 = u * u + v * v;
  w.uv = u * v;
  w.dv = T(2) * (v * v) - w.u2;
  return w;
}

template <class T>
__device__ __forceinline__ WindTerms<T> wind_terms_at(const WindParams<T>& p,
                                                      T xn, T t) {
  T u, v;
  wind_uv(p, xn, t, u, v);
  return terms_of(u, v);
}

// The node kind's terms at node i (constant in t).
template <class T>
__device__ __forceinline__ WindTerms<T> node_terms(const WindParams<T>& p,
                                                   long long i) {
  T u, v;
  node_uv(p, i, u, v);
  return terms_of(u, v);
}

template <class T>
__device__ __forceinline__ WindTerms<T> gridded_terms(const GriddedWind<T>& g,
                                                      T t) {
  T u, v;
  gridded_uv(g, t, u, v);
  return terms_of(u, v);
}

// The traced wind's terms at the node (xn, yn) and time t.
template <class T>
__device__ __forceinline__ WindTerms<T> traced_terms(T xn, T yn, T t) {
  T u, v;
  traced_uv(xn, yn, t, u, v);
  return terms_of(u, v);
}

// picles_tpu/ops/rhs.py rhs_core_2d, one lane: the part that depends on the
// state, given the wind's terms.
template <class T>
__device__ __forceinline__ void rhs_state(const RHSParams<T>& c, T lne,
                                          T cg_x, T cg_y,
                                          const WindTerms<T>& w, T out[5]) {
  const T u = w.u, v = w.v, u2 = w.u2;
  const T c2 = cg_x * cg_x + cg_y * cg_y;
  const T cgp2_raw = c2 / c.rg2;

  const T k_p = c.g / (T(4) * jmax(cgp2_raw, T(1e-2)));
  const T omega_p = c.g / (T(2) * jmax(xsqrt(c2) / c.r_g, T(0.1)));
  const T c_gp_x = cg_x / c.r_g;
  const T c_gp_y = cg_y / c.r_g;

  const T ar = u2 / (T(4) * cgp2_raw);
  const T alpha2 = ar > T(250000) ? T(250000) : ar;
  const T a_p = (u * c_gp_x + v * c_gp_y) / (T(2) * jmax(cgp2_raw, T(1e-8)));
  const T H_p = T(0.5) * (T(1) + xtanh(c.p * (a_p - T(0.85))));
  const T ax = xabs(T(10) * (a_p - T(0.85)));
  const T ex = xexp(-ax);
  const T sech = T(2) * ex / (T(1) + ex * ex);
  const T Delta_p = T(1) - T(1.25) * (sech * sech);

  const T I_t = (c.flags & TERM_INPUT) ? c.C_e * H_p * alpha2 : T(0);
  const T D_t = (c.flags & TERM_DISSIPATION)
                    ? xexp(c.n * (lne + T(2) * xlog(k_p / c.e_T)))
                    : T(0);
  T S_cg_t = T(0);
  if (c.flags & TERM_PEAK_SHIFT) {
    const T k_p2 = k_p * k_p;
    S_cg_t = c.C_alpha * Delta_p * (k_p2 * k_p2) * xexp(T(2) * lne);
  }
  T S_dir_t = T(0);
  if (c.flags & TERM_DIRECTION) {
    const T prod = u2 * cgp2_raw;
    const T safe = prod == T(0) ? T(1) : prod;
    const T val = (T(2) / safe) *
                  (w.uv * (T(2) * (c_gp_y * c_gp_y) - cgp2_raw) -
                   c_gp_x * c_gp_y * w.dv);
    const T sin2 = prod == T(0) ? T(0) : val;
    S_dir_t = alpha2 * c.C_varphi * H_p * sin2;
  }
  const T S_sphere_t = c.pc * cg_x;

  out[0] = omega_p * c.r_g * S_cg_t + omega_p * (I_t - D_t);
  out[1] = -cg_x * omega_p * c.r_g * S_cg_t + cg_y * S_dir_t + cg_y * S_sphere_t;
  out[2] = -cg_y * omega_p * c.r_g * S_cg_t - cg_x * S_dir_t - cg_x * S_sphere_t;
  if (c.flags & TERM_PROPAGATION) {
    out[3] = c.m00 * cg_x + c.m01 * cg_y;
    out[4] = c.m10 * cg_x + c.m11 * cg_y;
  } else {
    out[3] = T(0);
    out[4] = T(0);
  }
}

// The RHS at a node of x-coordinate xn, time t, state (lne, cg_x, cg_y): the
// wind's terms, then the state's part, in a row (K3, and K1's `_simple`
// baseline, evaluate it so at every stage).
template <class T>
__device__ __forceinline__ void rhs_at(const RHSParams<T>& c,
                                       const WindParams<T>& w, T xn, T t,
                                       T lne, T cg_x, T cg_y, T out[5]) {
  rhs_state(c, lne, cg_x, cg_y, wind_terms_at(w, xn, t), out);
}

// ---------------------------------------------------------------------------
// The 1D model (K7, advance_1d.cu): picles_torch/ops/rhs.py
// particle_equations_1d and the 1D wind record (forcing/winds.py
// GriddedWinds1D.u), in the operations PyTorch runs for them on a card, in
// the lanes' scalar type T: a division by a Python scalar c is a product
// with 1 / c (ATen's division by a host scalar, the reciprocal in T), c / x
// is (1 / x) * c (Tensor.__rtruediv__), a division by a 0-dim tensor
// (winds.py `_div`) and x / y are divisions.  The two reciprocals of a host
// scalar, 1 / r_g and 1 / e_T, depend on the launch only: the host forms
// them as quotients in T (ops/advance_cuda.py `k7_reciprocals`), the same
// bits as the card's IEEE division, so no evaluation divides by a
// constant, and the term flags arrive as a compile-time constant in K7's
// compiled instances.
// ---------------------------------------------------------------------------

template <class T>
struct RHS1DParams {
  T r_g, C_alpha, C_e, g, p, n, e_T;
  T two_n;             // 2 n, formed in float64
  T inv_r_g, inv_e_T;  // T(1) / T(r_g), / T(e_T)
  int flags;
};

// The term bits the 1D RHS reads (the direction bit it ignores), and K7's
// compiled set: all of them, TermFlags()'s.
constexpr int TERMS_1D =
    TERM_PROPAGATION | TERM_INPUT | TERM_DISSIPATION | TERM_PEAK_SHIFT;

// The 1D RHS of (lne, cg_x, x) under the signed wind u at the lane's node:
// alpha = |u| / (2 |c_gp|) clamped at 500 feeds the H and Delta windows,
// dissipation is exp(n lne) (k_p / e_T)^(2n), no direction terms, and
// dx = cg_x.  `flags`: the term bits, a compile-time constant in K7's
// compiled instances (each test folds) or c.flags.
template <class T>
__device__ __forceinline__ void rhs_1d(const RHS1DParams<T>& c, int flags,
                                       T lne, T cg_x, T u, T out[3]) {
  const T c_gp = xabs(cg_x) * c.inv_r_g;
  const T k_p = (T(1) / (T(4) * jmax(c_gp * c_gp, T(1e-2)))) * c.g;
  const T omega_p = (T(1) / (T(2) * jmax(xabs(c_gp), T(0.1)))) * c.g;
  const T a = xabs(u) / (T(2) * c_gp);
  const T alpha = a > T(500) ? T(500) : a;
  const T H_p = T(0.5) * (T(1) + xtanh((alpha - T(0.85)) * c.p));
  const T ax = xabs((alpha - T(0.85)) * T(10));
  const T ex = xexp(-ax);
  const T sech = (T(2) * ex) / (T(1) + ex * ex);
  const T Delta_p = T(1) - T(1.25) * (sech * sech);

  const T I_t = (flags & TERM_INPUT) ? (H_p * c.C_e) * (alpha * alpha)
                                     : T(0);
  const T D_t = (flags & TERM_DISSIPATION)
                    ? xexp(lne * c.n) * xpow(k_p * c.inv_e_T, c.two_n)
                    : T(0);
  T S_cg_t = T(0);
  if (flags & TERM_PEAK_SHIFT) {
    const T k_p2 = k_p * k_p;
    S_cg_t = ((Delta_p * c.C_alpha) * (k_p2 * k_p2)) * xexp(lne * T(2));
  }
  out[0] = (omega_p * c.r_g) * S_cg_t + omega_p * (I_t - D_t);
  out[1] = ((-cg_x * omega_p) * c.r_g) * S_cg_t;
  out[2] = (flags & TERM_PROPAGATION) ? cg_x : T(0);
}

// A 1D wind record u_data [nx, nt] (float32; x0, dx, t0, dt in T; each axis
// wrapped or clamped), GriddedWinds1D.u's bilinear interpolant.
template <class T>
struct Gridded1D {
  const float* data;
  int nx, nt;
  T x0, dx, t0, dt;
  bool wrap_x, wrap_t;
};

// One axis' coordinate, pre-folded by its mode: torch.remainder (fmod, then
// the divisor added where the signs differ) or torch.clamp to [0, n - 1].
template <class T>
__device__ __forceinline__ T fold_axis(T c, T c0, T dc, int n, bool wrap) {
  const T i = (c - c0) / dc;
  const T nf = T(n);
  if (!wrap) return jmin(jmax(i, T(0)), nf - T(1));
  T m = xfmod(i, nf);
  if (m != T(0) && ((nf < T(0)) != (m < T(0)))) m = m + nf;
  return m;
}

// winds.py `_linear`: the two (index, weight) pairs of one axis, indices
// taken modulo n as torch.remainder takes an int64 (always in [0, n)).
template <class T>
__device__ __forceinline__ void linear_pairs(T c, int n, long long idx[2],
                                             T w[2]) {
  const T lower = xfloor(c);
  const T upper = c - lower;
  const long long i = (long long)lower;
  for (int k = 0; k < 2; ++k) {
    long long r = (i + k) % n;
    if (r != 0 && (r < 0) != (n < 0)) r += n;
    idx[k] = r;
  }
  w[0] = T(1) - upper;
  w[1] = upper;
}

// The record's value of a sum formed in double: map_coordinates returns
// the record's float32.  Out of line, so the build's check of the double
// instances (cuda_build.narrowing_summary) passes over it by name.
static __device__ __noinline__ float record_value_f64(double v) {
  return (float)v;
}

// u(x, t): the four terms (wx wt) u[ix, it] summed in GriddedWinds1D.u's
// order, (x lo, t lo), (x lo, t hi), (x hi, t lo), (x hi, t hi), each
// sample widened to T; in double the sum rounded to float32 (the record's
// dtype) and widened again, as the JAX model casts the sampler's value to
// the lanes' dtype.
template <class T>
__device__ __forceinline__ T gridded_u_1d(const Gridded1D<T>& g, T x, T t) {
  long long ix[2], it[2];
  T wx[2], wt[2];
  linear_pairs(fold_axis(x, g.x0, g.dx, g.nx, g.wrap_x), g.nx, ix, wx);
  linear_pairs(fold_axis(t, g.t0, g.dt, g.nt, g.wrap_t), g.nt, it, wt);
  T out = (wx[0] * wt[0]) * T(g.data[ix[0] * g.nt + it[0]]);
  out = out + (wx[0] * wt[1]) * T(g.data[ix[0] * g.nt + it[1]]);
  out = out + (wx[1] * wt[0]) * T(g.data[ix[1] * g.nt + it[0]]);
  out = out + (wx[1] * wt[1]) * T(g.data[ix[1] * g.nt + it[1]]);
  if constexpr (std::is_same<T, float>::value)
    return out;
  else
    return T(record_value_f64(out));
}

}  // namespace picles
