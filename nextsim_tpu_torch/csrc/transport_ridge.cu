// Transport of every tracer and mechanical redistribution (ridging) for
// NVIDIA Hopper (sm_90a): the CUDA counterpart of the plain
// ops/transport.py:transport_and_ridge_reference with ops/advection.py.
// It replaces no Pallas kernel: the JAX package's nextsim_tpu/ops/
// transport.py and advection.py are XLA-fused jnp. It was added because the
// plain version is ~2,000 small elementwise kernels a call (1,973 a step at
// 1216^2, 7.37 ms), each streaming one to three planes through device memory.
//
// What it computes, per cell of each member's (ny, nx) plane (the batched
// ensemble's member-minor stack (N, ny, nx) is N planes; tice and sigma are
// (3, N, ny, nx), passed as three planes each):
//   face velocities u_face = 0.5 (u_j + u_j+1), v_face = 0.5 (v_i + v_i+1)
//   and the divergence; the 27 tracers advected one after the other (14
//   conservative densities, the 4 weighted tracers age_det * conc, age *
//   thick, the enthalpy of tice[1] and tice[2] * thick, conservative too, and
//   9 intensive tracers), each by the dimensionally split x-then-y scheme,
//   van-Leer-limited MUSCL (upwind2) or donor-cell (upwind), land ghost
//   cells zero (edge-replicate in the donor-cell intensive form), times the
//   mask and kept where upd = mask * (1 - open_mask) > 0.5; then, cell by
//   cell, the inverse transforms, the young-ice ridging, the concentration
//   cap, the thickness limit, the lower bounds, the myi cap and
//   del_ci_ridge_myi. A second entry advects a stack of conservative planes
//   (the floe-size bins) the same way.
//
// Bitwise equal to the plain version on the card in float32, float64 and
// bfloat16, so every operation is one torch op of that version with its
// rounding: built with --fmad=false (no contraction), IEEE division and
// square root (no fast math, no flush to zero), every order of evaluation
// the plain version's, a Python scalar as torch takes it (a factor or
// addend in the operator's type, float for float and bfloat16 planes; a
// bound of clamp, a threshold of a comparison or a value torch.where fills
// in rounded to the plane type; a division by a Python scalar as the
// product with its reciprocal, formed in the operator's type on the host),
// in bfloat16 one rounding an operator, clamp, torch.minimum and the gates
// passing a NaN as torch does, and the limiter's subnormal test
// prod >= finfo.tiny.
//
// What bounds it on an H100. A call reads the 27 tracer planes, the two
// node velocity planes, the mask and open_mask, and writes the 27 planes,
// the divergence and del_ci_ridge_myi: ~60 planes, 355 MB at 1216^2 in
// float32, 0.106 ms at 3.35 TB/s; its ~1,800 operations a cell (2.7 GFLOP)
// take 0.04 ms at 67 TFLOP/s. So the bound is the bytes, and the design
// keeps every intermediate plane out of device memory:
// * one block a 32 x 8 tile (a warp a row, contiguous columns), one thread
//   a cell, the grid's z axis the member;
// * the face velocities of the tile and its halo, and the scheme's
//   per-face factors 0.5 (1 - c) and 0.5 (1 + c) and per-cell compression
//   terms, computed once into shared memory and shared by every tracer;
// * the tracers in groups (Tuning: three in float32 and bfloat16, one in
//   float64): the group's (8 + 4) x (32 + 4) tiles staged in shared memory
//   (two buffers in turn; the next group's loads issued into registers
//   before the current one is computed, so they fly while it computes),
//   the x slopes, the x pass over the 12 rows, the y slopes, each a step
//   between two barriers that interleaves the group's tracers, then the y
//   pass for the thread's own cell: each input plane is read once from
//   device memory (the halos from L2), no intermediate plane is written;
// * the tracers' results that ridging needs are kept in registers (the
//   others are written at once), and the epilogue writes each output once
//   into its final tensor (tice and sigma included: no stack copies).
// What limits it as built is not the bytes but the barriers and the
// shared-memory round trips between them: 0.51 ms in float32 at 1216^2 on
// an H100 (PERF.md), five times the byte bound; unrolled loops, grouping
// tracers and capping the registers for more blocks an SM (Tuning) took it
// there from 0.88 ms. A design with no barrier (warp shuffles along a row,
// a sliding window down a column) is what would come nearer.
// One launch a call (the FSD bins: one more a stack).
//
// Plain C interface, loaded with ctypes by ops/transport_cuda.py:
//   int nextsim_transport_{f32,f64,bf16}(const TransportArgs* a, void* stream, int* kernels)
//   int nextsim_advect_stack_{f32,f64,bf16}(const StackArgs* a, void* stream, int* kernels)
// launch on `stream`, return the first CUDA error (0 on success;
// cudaErrorInvalidValue for arguments the kernel does not take) and set
// *kernels to the number of kernels launched.

#include <climits>
#include <type_traits>
#include <utility>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The tracer planes, in TransportArgs::planes_in and ::planes_out: must match
// transport_cuda._PLANES.
enum Plane {
  CONC, THICK, SNOW_THICK, H_YOUNG, HS_YOUNG, CONC_YOUNG, CONC_MYI, THICK_MYI,
  CONC_SUMMER, THICK_SUMMER, FYI_FRACTION, CONC_UPD, POND_VOLUME, LID_VOLUME,
  AGE_DET, AGE, TICE0, TICE1, TICE2, DAMAGE, RIDGE_RATIO, TSURF_YOUNG, SST, SSS,
  SXX, SYY, SXY,
  N_PLANES
};

// The grid of a call: must match transport_cuda._Geometry.
struct Geometry {
  const void* vt_u;       // (members, ny+1, nx+1) node planes
  const void* vt_v;
  const void* mask;       // (ny, nx), every member's
  const void* open_mask;  // (ny, nx)
  long long ny, nx, members;
  double dtdx;            // dt / dx, the Python float
  int second_order;       // upwind2 (1) or upwind (0)
  int pad_;
};

// Scalars and planes of transport_and_ridge: must match transport_cuda._Args.
struct TransportArgs {
  Geometry g;
  const void* planes_in[N_PLANES];  // the state's planes (tice[k], sigma[k] each one plane)
  void* planes_out[N_PLANES];       // the new state's planes (h_young, hs_young, conc_young:
                                    // unused without young ice, which keeps them)
  void* divergence;
  void* del_ci_ridge_myi;
  double dt, dx, min_h, min_c;
  double mu_si_lf_c;       // freezingpoint_mu * si * Lf / C
  double four_mu_si_lf_c;  // 4.0 * mu_si_lf_c
  double tfr_ice;          // -freezingpoint_mu * si
  double max_true_thickness, ridge_young_aspect, days_in_sec;
  int use_young_ice;
  int myi_with_young;  // the myi cap's bound is conc + conc_young (newice_type 4 and include_young_ice)
};

// A stack of conservative planes (planes, members, ny, nx): must match
// transport_cuda._StackArgs.
struct StackArgs {
  Geometry g;
  const void* q;
  void* out;
  long long planes;
};

namespace {

constexpr int TX = 32;  // columns of a tile: a warp a row
constexpr int TY = 8;   // rows of a tile, one thread a cell
constexpr int THREADS = TX * TY;
constexpr int HALO = 2;  // the MUSCL stencil's reach
constexpr int QX = TX + 2 * HALO, QY = TY + 2 * HALO;
constexpr int LOADS = (QX * QY + THREADS - 1) / THREADS;  // tile elements a thread stages

// f(std::integral_constant<int, 0>{}), ..., f(std::integral_constant<int, N-1>{}):
// a loop unrolled at compile time, its index a constant expression
template <typename F, int... I>
__device__ __forceinline__ void static_for_(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_(f, std::make_integer_sequence<int, N>{});
}

// f(e) for the block's elements e < N, a thread's at tid, tid + THREADS, ...:
// a fixed count a thread, unrolled, so that the iterations interleave
template <int N, typename F>
__device__ __forceinline__ void each(int tid, F&& f) {
#pragma unroll
  for (int k = 0; k < (N + THREADS - 1) / THREADS; ++k) {
    const int e = tid + k * THREADS;
    if (N % THREADS == 0 || e < N) f(e);
  }
}

// bfloat16 as PyTorch's eager operators compute it on the card: every
// operator converts its operands to float, computes in float and rounds its
// result to bfloat16, to nearest even; a Python scalar operand stays a float.
struct bf16 {
  __nv_bfloat16 v;
  bf16() = default;
  __device__ __forceinline__ explicit bf16(float f) : v(__float2bfloat16_rn(f)) {}
  __device__ __forceinline__ explicit operator float() const { return __bfloat162float(v); }
};

#define BF16_ARITH(op)                                                                              \
  __device__ __forceinline__ bf16 operator op(bf16 a, bf16 b) { return bf16(float(a) op float(b)); } \
  __device__ __forceinline__ bf16 operator op(bf16 a, float b) { return bf16(float(a) op b); }       \
  __device__ __forceinline__ bf16 operator op(float a, bf16 b) { return bf16(a op float(b)); }
BF16_ARITH(+)
BF16_ARITH(-)
BF16_ARITH(*)
BF16_ARITH(/)
#undef BF16_ARITH
__device__ __forceinline__ bf16 operator-(bf16 a) { return bf16(-float(a)); }
__device__ __forceinline__ bool operator<(bf16 a, bf16 b) { return float(a) < float(b); }
__device__ __forceinline__ bool operator>(bf16 a, bf16 b) { return float(a) > float(b); }
__device__ __forceinline__ bool operator>=(bf16 a, bf16 b) { return float(a) >= float(b); }

// the type torch computes a plane's operators and keeps its Python scalars in
template <typename T>
struct Opmath {
  using type = T;
};
template <>
struct Opmath<bf16> {
  using type = float;
};
template <typename T>
using opmath_t = typename Opmath<T>::type;

__device__ __forceinline__ float as_op(float a) { return a; }
__device__ __forceinline__ double as_op(double a) { return a; }
__device__ __forceinline__ float as_op(bf16 a) { return float(a); }

// a Python float as torch casts it to the plane type (the bound of a clamp,
// the threshold of a comparison, what torch.where or full_like fills in):
// to the operator type, then (bfloat16) rounded once more
template <typename T>
__device__ __forceinline__ T cast(double v) {
  return T(static_cast<opmath_t<T>>(v));
}

__device__ __forceinline__ float op_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double op_max(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float op_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double op_min(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float op_sqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double op_sqrt(double a) { return sqrt(a); }
__device__ __forceinline__ float op_abs(float a) { return fabsf(a); }
__device__ __forceinline__ double op_abs(double a) { return fabs(a); }

template <typename T>
__device__ __forceinline__ bool isnan_(T a) {
  return as_op(a) != as_op(a);
}
// torch.sqrt and torch.abs
template <typename T>
__device__ __forceinline__ T vsqrt(T a) {
  return T(op_sqrt(as_op(a)));
}
template <typename T>
__device__ __forceinline__ T vabs(T a) {
  return T(op_abs(as_op(a)));
}
// torch.clamp(x, min=lo), clamp(x, max=hi), clamp(x, lo, hi): a NaN passes
template <typename T>
__device__ __forceinline__ T clamp_lo(T x, T lo) {
  return isnan_(x) ? x : T(op_max(as_op(x), as_op(lo)));
}
template <typename T>
__device__ __forceinline__ T clamp_hi(T x, T hi) {
  return isnan_(x) ? x : T(op_min(as_op(x), as_op(hi)));
}
template <typename T>
__device__ __forceinline__ T clamp(T x, T lo, T hi) {
  return isnan_(x) ? x : T(op_min(op_max(as_op(x), as_op(lo)), as_op(hi)));
}
// torch.minimum(a, b): a NaN in either is the result
template <typename T>
__device__ __forceinline__ T vminimum(T a, T b) {
  return isnan_(a) ? a : isnan_(b) ? b : T(op_min(as_op(a), as_op(b)));
}

// ---------------------------------------------------------------------------
// the tracers
// ---------------------------------------------------------------------------

enum Form { CONS, INTENS };       // advect_conservative, advect_intensive
enum Transform { AS_IS, PRODUCT, ENTHALPY };  // the tracer, or its weighted form by `factor`
enum Post { NONE, CLIP01, RELU, MIN0 };       // clip(., 0, 1), maximum(., 0), minimum(., 0)

// what ridging reads, kept in registers; every other tracer is written at once
enum Keep { K_CONC, K_THICK, K_SNOW, K_H_YOUNG, K_HS_YOUNG, K_CONC_YOUNG, K_CONC_MYI, K_THICK_MYI,
            K_AGE_DET_R, K_AGE_R, K_ENTH_R, K_T2_R, K_RIDGE_RATIO, N_KEEP, WRITE = -1 };

struct Tracer {
  int plane;   // the plane advected (its input, and its output unless kept)
  int factor;  // the transform's second plane
  Transform transform;
  Form form;
  Post post;
  int keep;
  bool young;  // advected only with young ice
};

// in transport_and_ridge_reference's order
constexpr Tracer TRACERS[] = {
    {CONC, -1, AS_IS, CONS, NONE, K_CONC, false},
    {THICK, -1, AS_IS, CONS, NONE, K_THICK, false},
    {SNOW_THICK, -1, AS_IS, CONS, NONE, K_SNOW, false},
    {H_YOUNG, -1, AS_IS, CONS, NONE, K_H_YOUNG, true},
    {HS_YOUNG, -1, AS_IS, CONS, NONE, K_HS_YOUNG, true},
    {CONC_YOUNG, -1, AS_IS, CONS, NONE, K_CONC_YOUNG, true},
    {CONC_MYI, -1, AS_IS, CONS, NONE, K_CONC_MYI, false},
    {THICK_MYI, -1, AS_IS, CONS, NONE, K_THICK_MYI, false},
    {CONC_SUMMER, -1, AS_IS, CONS, CLIP01, WRITE, false},
    {THICK_SUMMER, -1, AS_IS, CONS, RELU, WRITE, false},
    {FYI_FRACTION, -1, AS_IS, CONS, CLIP01, WRITE, false},
    {CONC_UPD, -1, AS_IS, CONS, NONE, WRITE, false},
    {POND_VOLUME, -1, AS_IS, CONS, RELU, WRITE, false},
    {LID_VOLUME, -1, AS_IS, CONS, RELU, WRITE, false},
    {AGE_DET, CONC, PRODUCT, CONS, NONE, K_AGE_DET_R, false},  // age_det * conc
    {AGE, THICK, PRODUCT, CONS, NONE, K_AGE_R, false},         // age * thick
    {TICE1, THICK, ENTHALPY, CONS, NONE, K_ENTH_R, false},     // (t1 - c / min(t1, -1e-12)) * thick
    {TICE2, THICK, PRODUCT, CONS, NONE, K_T2_R, false},        // tice[2] * thick
    {DAMAGE, -1, AS_IS, INTENS, CLIP01, WRITE, false},
    {RIDGE_RATIO, -1, AS_IS, INTENS, CLIP01, K_RIDGE_RATIO, false},
    {TICE0, -1, AS_IS, INTENS, MIN0, WRITE, false},
    {TSURF_YOUNG, -1, AS_IS, INTENS, MIN0, WRITE, false},
    {SST, -1, AS_IS, INTENS, NONE, WRITE, false},
    {SSS, -1, AS_IS, INTENS, NONE, WRITE, false},
    {SXX, -1, AS_IS, INTENS, NONE, WRITE, false},
    {SYY, -1, AS_IS, INTENS, NONE, WRITE, false},
    {SXY, -1, AS_IS, INTENS, NONE, WRITE, false},
};
constexpr int N_TRACERS = sizeof(TRACERS) / sizeof(TRACERS[0]);
static_assert(N_TRACERS == 27, "27 tracers");
__host__ __device__ constexpr Tracer tracer(int t) { return TRACERS[t]; }

// The tracers a block advects side by side (each step between two barriers
// holds that many independent chains) and the blocks an SM must hold at
// once (__launch_bounds__, which caps the registers), for each plane type:
// the fastest of the variants timed at 1216^2 on an H100 (PERF.md).
template <typename T>
struct Tuning {
  static constexpr int group = 3, min_blocks = 5;
};
template <>
struct Tuning<bf16> {
  static constexpr int group = 3, min_blocks = 4;
};
template <>
struct Tuning<double> {
  static constexpr int group = 1, min_blocks = 6;
};

constexpr bool groups_ok(int group) {
  for (int t = 0; t < N_TRACERS; ++t) {
    const Tracer first = TRACERS[t - t % group];
    if (TRACERS[t].form != first.form || TRACERS[t].young != first.young) return false;
  }
  return N_TRACERS % group == 0;
}
static_assert(groups_ok(Tuning<float>::group) && groups_ok(Tuning<bf16>::group) && groups_ok(Tuning<double>::group),
              "a group's tracers share their form and their young-ice flag");

// ---------------------------------------------------------------------------
// a block: its tile, its shared memory and the scheme's steps
// ---------------------------------------------------------------------------

template <typename T>
struct Shared {
  static constexpr int G = Tuning<T>::group;
  T q[2][G][QY][QX];    // the group's tiles and halos, two buffers in turn
  T sx[G][QY][TX + 2];  // x slopes of cells -1 .. TX
  T q1[G][QY][TX];      // after the x pass (0 on rows outside the plane)
  T sy[G][TY + 2][TX];  // y slopes of rows -1 .. TY
  T uf[QY][TX + 1];     // u_face on the tile's rows and halo, faces 0 .. TX
  T ua[QY][TX + 1];     // 0.5 (1 - u_face dt/dx)
  T ub[QY][TX + 1];     // 0.5 (1 + u_face dt/dx)
  T cx[QY][TX];         // (u_face E - W) dt/dx
  T vf[TY + 1][TX];     // v_face, faces 0 .. TY
  T va[TY + 1][TX];
  T vb[TY + 1][TX];
};

template <typename T>
struct Block {
  using S = opmath_t<T>;
  Shared<T>& s;
  long long ny, nx, plane, m;  // plane = ny * nx; m the member
  long long i0, j0;            // the tile's first column and row
  int tx, ty, tid;
  bool own;                    // the thread's cell lies in the plane
  long long c;                 // the thread's cell
  S dtdx;
  T zero, tiny, eps30;

  __device__ long long cell(long long j, long long i) const { return m * plane + j * nx + i; }
  __device__ bool inside(long long j, long long i) const { return j >= 0 && j < ny && i >= 0 && i < nx; }
};

// what a thread keeps of its cell across the tracers
template <typename T>
struct Cell {
  T mask;
  bool upd;  // upd = mask * (1 - open_mask) > 0.5
  T cy;      // (v_face N - S) dt/dx
};

// the loads a thread makes for P tracers' tiles (zero outside the plane, or
// the nearest cell's value where the scheme pads by the edge)
template <typename T, int P>
struct Fetch {
  T a[P][LOADS];
  T b[P][LOADS];
};

// the loads of tracers t0 .. t0 + P
template <typename T, int t0, int P, bool REPLICATE>
__device__ __forceinline__ Fetch<T, P> fetch(const Block<T>& b, const TransportArgs& args) {
  Fetch<T, P> out;
  static_for<P>([&](auto p_) {
    constexpr int p = decltype(p_)::value;
    constexpr Tracer tr = tracer(t0 + p);
    const T* a = static_cast<const T*>(args.planes_in[tr.plane]);
    const T* f = static_cast<const T*>(args.planes_in[tr.factor >= 0 ? tr.factor : tr.plane]);
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int e = b.tid + k * THREADS;
      out.a[p][k] = b.zero;
      out.b[p][k] = b.zero;
      if (e < QX * QY) {
        long long j = b.j0 - HALO + e / QX, i = b.i0 - HALO + e % QX;
        if (REPLICATE) {
          j = j < 0 ? 0 : j >= b.ny ? b.ny - 1 : j;
          i = i < 0 ? 0 : i >= b.nx ? b.nx - 1 : i;
        }
        if (b.inside(j, i)) {
          out.a[p][k] = a[b.cell(j, i)];
          if constexpr (tr.factor >= 0) out.b[p][k] = f[b.cell(j, i)];
        }
      }
    }
  });
  return out;
}

// a plane of a stack: no transform, zero outside
template <typename T>
__device__ __forceinline__ Fetch<T, 1> fetch_plane(const Block<T>& b, const T* q) {
  Fetch<T, 1> out;
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int e = b.tid + k * THREADS;
    out.a[0][k] = b.zero;
    if (e < QX * QY) {
      const long long j = b.j0 - HALO + e / QX, i = b.i0 - HALO + e % QX;
      if (b.inside(j, i)) out.a[0][k] = q[b.cell(j, i)];
    }
  }
  return out;
}

// tile p of the buffer from what was fetched, transformed as the plain
// version forms a weighted tracer before advecting it (zero stays zero
// outside the plane)
template <typename T, Transform TR, int P>
__device__ __forceinline__ void commit(const Block<T>& b, const Fetch<T, P>& f, int p, int buf, double mu_si_lf_c) {
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int e = b.tid + k * THREADS;
    if (e < QX * QY) {
      T v = f.a[p][k];
      if constexpr (TR == PRODUCT) {
        v = f.a[p][k] * f.b[p][k];
      } else if constexpr (TR == ENTHALPY) {
        const long long j = b.j0 - HALO + e / QX, i = b.i0 - HALO + e % QX;
        if (b.inside(j, i)) {
          // (t1 - rdiv(mu_si_lf_c, minimum(t1, -1e-12))) * thick; rdiv fills a plane with the scalar
          const T t1 = f.a[p][k];
          v = (t1 - cast<T>(mu_si_lf_c) / clamp_hi(t1, cast<T>(-1e-12))) * f.b[p][k];
        }
      }
      b.s.q[buf][p][e / QX][e % QX] = v;
    }
  }
}

// van Leer's harmonic slope; a subnormal product counts as zero
template <typename T>
__device__ __forceinline__ T slope(const Block<T>& b, T qm, T qc, T qp) {
  using S = opmath_t<T>;
  const T dm = qc - qm;
  const T dp = qp - qc;
  const T prod = dm * dp;
  const T denom = dm + dp;
  const T safe = vabs(denom) < b.eps30 ? b.eps30 : denom;
  return prod >= b.tiny ? (prod * S(2)) / safe : b.zero;
}

// the flux through a face, u * q_face * dt/dx
template <typename T, bool SO>
__device__ __forceinline__ T flux(const Block<T>& b, T u, T a_minus, T a_plus, T qW, T qE, T sW, T sE) {
  T qf;
  if constexpr (SO) {
    qf = u >= b.zero ? qW + a_minus * sW : qE - a_plus * sE;
  } else {
    qf = u >= b.zero ? qW : qE;
  }
  return (u * qf) * b.dtdx;
}

// The face velocities, the scheme's factors and the compression terms of the
// tile and its halo, into shared memory (a barrier after the velocities);
// the thread's cell's mask, upd and (v_face N - S) dt/dx.
template <typename T, bool SO>
__device__ __forceinline__ Cell<T> faces(const Block<T>& b, const Geometry& g) {
  using S = opmath_t<T>;
  const T* u = static_cast<const T*>(g.vt_u);
  const T* v = static_cast<const T*>(g.vt_v);
  const long long nplane = (b.ny + 1) * (b.nx + 1), mo = b.m * nplane;
  each<QY * (TX + 1)>(b.tid, [&](int e) {
    const int r = e / (TX + 1), c = e % (TX + 1);
    const long long j = b.j0 - HALO + r, i = b.i0 + c;
    T uf = b.zero, ua = b.zero, ub = b.zero;
    if (j >= 0 && j < b.ny && i <= b.nx) {
      uf = (u[mo + j * (b.nx + 1) + i] + u[mo + (j + 1) * (b.nx + 1) + i]) * S(0.5);
      if constexpr (SO) {
        const T cc = uf * b.dtdx;
        ua = (S(1) - cc) * S(0.5);
        ub = (cc + S(1)) * S(0.5);
      }
    }
    b.s.uf[r][c] = uf;
    b.s.ua[r][c] = ua;
    b.s.ub[r][c] = ub;
  });
  each<(TY + 1) * TX>(b.tid, [&](int e) {
    const int r = e / TX, c = e % TX;
    const long long j = b.j0 + r, i = b.i0 + c;
    T vf = b.zero, va = b.zero, vb = b.zero;
    if (j <= b.ny && i < b.nx) {
      vf = (v[mo + j * (b.nx + 1) + i] + v[mo + j * (b.nx + 1) + i + 1]) * S(0.5);
      if constexpr (SO) {
        const T cc = vf * b.dtdx;
        va = (S(1) - cc) * S(0.5);
        vb = (cc + S(1)) * S(0.5);
      }
    }
    b.s.vf[r][c] = vf;
    b.s.va[r][c] = va;
    b.s.vb[r][c] = vb;
  });
  Cell<T> cell{b.zero, false, b.zero};
  if (b.own) {
    const long long c = (b.j0 + b.ty) * b.nx + b.i0 + b.tx;
    cell.mask = static_cast<const T*>(g.mask)[c];
    const T om = static_cast<const T*>(g.open_mask)[c];
    cell.upd = cell.mask * (S(1) - om) > cast<T>(0.5);
  }
  __syncthreads();
  if constexpr (SO) {
    each<QY * TX>(b.tid, [&](int e) {
      const int r = e / TX, c = e % TX;
      b.s.cx[r][c] = (b.s.uf[r][c + 1] - b.s.uf[r][c]) * b.dtdx;
    });
  }
  // cx is read after the first tracer's barrier
  cell.cy = (b.s.vf[b.ty + 1][b.tx] - b.s.vf[b.ty][b.tx]) * b.dtdx;
  return cell;
}

// P tracers side by side, their tiles staged in s.q[buf][0 .. P) (the
// caller's barrier after the commit): x pass, y pass, times the mask, kept
// where upd > 0.5, into r: the thread's cell's (meaningless outside the
// plane).
template <typename T, bool SO, Form F, bool DONOR, int P>
__device__ __forceinline__ void advect(const Block<T>& b, int buf, const Cell<T>& cell, T (&r)[P]) {
  const auto& q = b.s.q[buf];
  const int tx = b.tx, ty = b.ty, rr = ty + HALO;
  if constexpr (DONOR) {
    // advect_intensive's donor-cell upwind on the edge-replicated tile
    const T uW = b.s.uf[rr][tx], uE = b.s.uf[rr][tx + 1];
    const T vS = b.s.vf[ty][tx], vN = b.s.vf[ty + 1][tx];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const T qc = q[p][rr][tx + HALO];
      const T dW = qc - q[p][rr][tx + HALO - 1];
      const T dE = q[p][rr][tx + HALO + 1] - qc;
      const T dS = qc - q[p][rr - 1][tx + HALO];
      const T dN = q[p][rr + 1][tx + HALO] - qc;
      const T adv = ((clamp_lo(uW, b.zero) * dW + clamp_hi(uE, b.zero) * dE) + clamp_lo(vS, b.zero) * dS) +
                    clamp_hi(vN, b.zero) * dN;
      r[p] = cell.upd ? (qc - adv * b.dtdx) * cell.mask : qc;
    }
    return;
  }
  if constexpr (SO) {
    each<QY * (TX + 2)>(b.tid, [&](int e) {
      const int y = e / (TX + 2), x = e % (TX + 2);
#pragma unroll
      for (int p = 0; p < P; ++p) b.s.sx[p][y][x] = slope(b, q[p][y][x], q[p][y][x + 1], q[p][y][x + 2]);
    });
    __syncthreads();
  }
  // the x pass on every row of the tile and halo
  each<QY * TX>(b.tid, [&](int e) {
    const int y = e / TX, x = e % TX;
    const long long j = b.j0 - HALO + y;
    const bool inside = j >= 0 && j < b.ny && b.i0 + x < b.nx;
    const T uW = b.s.uf[y][x], uE = b.s.uf[y][x + 1];
    const T aW = b.s.ua[y][x], aE = b.s.ua[y][x + 1], bW = b.s.ub[y][x], bE = b.s.ub[y][x + 1];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      T v = b.zero;
      if (inside) {
        const T* row = q[p][y];
        const T* sx = b.s.sx[p][y];
        const T fW = flux<T, SO>(b, uW, aW, bW, row[x + 1], row[x + 2], SO ? sx[x] : b.zero, SO ? sx[x + 1] : b.zero);
        const T fE = flux<T, SO>(b, uE, aE, bE, row[x + 2], row[x + 3], SO ? sx[x + 1] : b.zero,
                                 SO ? sx[x + 2] : b.zero);
        const T qq = row[x + 2];
        v = qq - (fE - fW);
        if constexpr (F == INTENS) v = v + qq * b.s.cx[y][x];
      }
      b.s.q1[p][y][x] = v;
    }
  });
  __syncthreads();
  const auto& q1 = b.s.q1;
  if constexpr (SO) {
    each<(TY + 2) * TX>(b.tid, [&](int e) {
      const int y = e / TX, x = e % TX;
#pragma unroll
      for (int p = 0; p < P; ++p) b.s.sy[p][y][x] = slope(b, q1[p][y][x], q1[p][y + 1][x], q1[p][y + 2][x]);
    });
    __syncthreads();
  }
  // the y pass on the thread's own cell
  const T vS = b.s.vf[ty][tx], vN = b.s.vf[ty + 1][tx];
  const T aS = b.s.va[ty][tx], aN = b.s.va[ty + 1][tx], bS = b.s.vb[ty][tx], bN = b.s.vb[ty + 1][tx];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const T s0 = SO ? b.s.sy[p][ty][tx] : b.zero, s1 = SO ? b.s.sy[p][ty + 1][tx] : b.zero;
    const T s2 = SO ? b.s.sy[p][ty + 2][tx] : b.zero;
    const T fS = flux<T, SO>(b, vS, aS, bS, q1[p][rr - 1][tx], q1[p][rr][tx], s0, s1);
    const T fN = flux<T, SO>(b, vN, aN, bN, q1[p][rr][tx], q1[p][rr + 1][tx], s1, s2);
    const T q1c = q1[p][rr][tx];
    T v = q1c - (fN - fS);
    if constexpr (F == INTENS) v = v + q1c * cell.cy;
    r[p] = cell.upd ? v * cell.mask : q[p][rr][tx + HALO];
  }
}

template <typename T>
__device__ __forceinline__ T post(T v, Post p) {
  const T zero = cast<T>(0.0);
  switch (p) {
    case CLIP01: return clamp(v, zero, cast<T>(1.0));
    case RELU: return clamp_lo(v, zero);
    case MIN0: return clamp_hi(v, zero);
    default: return v;
  }
}

template <typename T>
__device__ __forceinline__ Block<T> make_block(Shared<T>& s, const Geometry& g) {
  using S = opmath_t<T>;
  Block<T> b{s};
  b.ny = g.ny;
  b.nx = g.nx;
  b.plane = g.ny * g.nx;
  b.m = blockIdx.z;
  b.i0 = static_cast<long long>(blockIdx.x) * TX;
  b.j0 = static_cast<long long>(blockIdx.y) * TY;
  b.tx = threadIdx.x;
  b.ty = threadIdx.y;
  b.tid = threadIdx.y * TX + threadIdx.x;
  b.own = b.j0 + b.ty < b.ny && b.i0 + b.tx < b.nx;
  b.c = b.own ? b.cell(b.j0 + b.ty, b.i0 + b.tx) : 0;
  b.dtdx = S(g.dtdx);
  b.zero = cast<T>(0.0);
  b.tiny = cast<T>(std::is_same_v<T, double> ? 2.2250738585072014e-308 : 1.1754943508222875e-38);  // finfo.tiny
  b.eps30 = cast<T>(1e-30);
  return b;
}

// The inverse transforms (redistributeVariables), ridging, capping, the
// thickness limit, the lower bounds and the myi cap of cell c from its
// advected tracers `keep`, as transport_and_ridge_reference orders them.
template <typename T>
__device__ __forceinline__ void redistribute(const TransportArgs& args, const T (&keep)[N_KEEP], long long c) {
  using S = opmath_t<T>;
  const bool young = args.use_young_ice != 0;
  const T zero = cast<T>(0.0), one = cast<T>(1.0);
  const T eps6 = cast<T>(1e-6), eps15 = cast<T>(1e-15), tfr = cast<T>(args.tfr_ice);
  T conc = keep[K_CONC], thick = keep[K_THICK], snow = keep[K_SNOW];
  T h_young = keep[K_H_YOUNG], hs_young = keep[K_HS_YOUNG];
  T conc_young = young ? keep[K_CONC_YOUNG] : static_cast<const T*>(args.planes_in[CONC_YOUNG])[c];
  T conc_myi = keep[K_CONC_MYI], thick_myi = keep[K_THICK_MYI], ridge_ratio = keep[K_RIDGE_RATIO];

  // inverse transforms (fe.cpp:2219-2248)
  const bool has_c = conc > eps6, has_h = thick > eps6;
  const T age_det = has_c ? keep[K_AGE_DET_R] / clamp_lo(conc, eps6) : zero;
  const T age = has_h ? keep[K_AGE_R] / clamp_lo(thick, eps6) : zero;
  const T enth = keep[K_ENTH_R] / clamp_lo(thick, eps6);
  T t1 = (enth - vsqrt(enth * enth + S(args.four_mu_si_lf_c))) * S(0.5);
  t1 = clamp(has_h ? t1 : tfr, cast<T>(-100.0), tfr);
  T t2 = has_h ? keep[K_T2_R] / clamp_lo(thick, eps6) : tfr;
  t2 = clamp(t2, cast<T>(-100.0), zero);

  // mechanical redistribution (fe.cpp:4032-4115)
  const T conc_before = conc;
  const T open_water = clamp((S(1) - conc) - conc_young, zero, one);
  T newice = zero, newsnow = zero, del_c = zero, new_conc_young = zero;
  if (young) {
    const bool has_young = conc_young > zero;
    new_conc_young = clamp((S(1) - conc) - open_water, zero, one);
    const bool ridging = has_young && conc > cast<T>(args.min_c) && thick > cast<T>(args.min_h) &&
                         new_conc_young < conc_young;
    const T ratio = new_conc_young / clamp_lo(conc_young, eps15);
    const T new_h_young = ridging ? ratio * h_young : h_young;
    const T new_hs_young = ridging ? ratio * hs_young : hs_young;
    newice = ridging ? h_young - new_h_young : zero;
    del_c = ridging ? (conc_young - new_conc_young) * (S(1) / S(args.ridge_young_aspect)) : zero;
    newsnow = ridging ? hs_young - new_hs_young : zero;
    h_young = has_young ? new_h_young : zero;
    hs_young = has_young ? new_hs_young : zero;
    new_conc_young = has_young ? new_conc_young : zero;
    ridge_ratio = ridging ? S(1) - ((S(1) - ridge_ratio) * thick) / clamp_lo(thick + newice, eps15) : ridge_ratio;
    thick = thick + newice;
    snow = snow + newsnow;
  }
  const T conc_capped = clamp(((S(1) - new_conc_young) - open_water) + del_c, zero, one);
  ridge_ratio = conc_before > zero
                    ? S(1) - ((S(1) - ridge_ratio) * clamp_hi(conc_capped, one)) / clamp_lo(conc_before, eps15)
                    : ridge_ratio;
  ridge_ratio = clamp(ridge_ratio, zero, one);
  conc = conc_capped;
  if (young) conc_young = vminimum(clamp_lo(new_conc_young, zero), S(1) - conc);

  // thickness-limit fix (fe.cpp:4097-4105)
  const bool has_ice = conc > zero;
  T true_h = has_ice ? thick / clamp_lo(conc, eps15) : zero;
  true_h = clamp_hi(true_h, cast<T>(args.max_true_thickness));
  conc = has_ice ? vminimum(S(1) - conc_young, thick / clamp_lo(true_h, eps15)) : conc;
  ridge_ratio = has_ice ? ridge_ratio : zero;
  thick = has_ice ? thick : zero;
  snow = has_ice ? snow : zero;

  // lower bounds (fe.cpp:4118-4123)
  conc = clamp_lo(conc, zero);
  thick = clamp_lo(thick, zero);
  thick_myi = clamp_lo(thick_myi, zero);
  snow = clamp_lo(snow, zero);

  // myi capping (fe.cpp:4124-4130)
  const T del_myi = -conc_myi;
  conc_myi = vminimum(clamp_lo(conc_myi, zero), args.myi_with_young ? conc + conc_young : conc);
  const T del_ci = ((del_myi + conc_myi) * S(args.days_in_sec)) * (S(1) / S(args.dt));

  T* const* out = reinterpret_cast<T* const*>(args.planes_out);
  out[CONC][c] = conc;
  out[THICK][c] = thick;
  out[SNOW_THICK][c] = snow;
  out[RIDGE_RATIO][c] = ridge_ratio;
  out[TICE1][c] = t1;
  out[TICE2][c] = t2;
  out[AGE_DET][c] = age_det;
  out[AGE][c] = age;
  out[CONC_MYI][c] = conc_myi;
  out[THICK_MYI][c] = thick_myi;
  if (young) {
    out[H_YOUNG][c] = h_young;
    out[HS_YOUNG][c] = hs_young;
    out[CONC_YOUNG][c] = conc_young;
  }
  static_cast<T*>(args.del_ci_ridge_myi)[c] = del_ci;
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

template <typename T, bool SO>
__global__ void __launch_bounds__(THREADS, Tuning<T>::min_blocks) transport(const TransportArgs args) {
  using S = opmath_t<T>;
  constexpr int G = Tuning<T>::group;
  // the block's Shared<T>, in dynamic shared memory (float64's takes more
  // than the 48 KB of static shared memory)
  extern __shared__ __align__(16) unsigned char shared_bytes[];
  const Block<T> b = make_block(*reinterpret_cast<Shared<T>*>(shared_bytes), args.g);
  const bool young = args.use_young_ice != 0;
  const Cell<T> cell = faces<T, SO>(b, args.g);
  if (b.own) {
    // (u_face E - W + v_face N - S) / dx, the division as torch's product with 1/dx
    const T uW = b.s.uf[b.ty + HALO][b.tx], uE = b.s.uf[b.ty + HALO][b.tx + 1];
    const T vS = b.s.vf[b.ty][b.tx], vN = b.s.vf[b.ty + 1][b.tx];
    static_cast<T*>(args.divergence)[b.c] = (((uE - uW) + vN) - vS) * (S(1) / S(args.dx));
  }

  T keep[N_KEEP];
  Fetch<T, G> f = fetch<T, 0, G, false>(b, args);
  int buf = 0;
  static_for<N_TRACERS / G>([&](auto g_) {
    constexpr int t0 = decltype(g_)::value * G;  // the group's first tracer
    constexpr Tracer lead = tracer(t0);          // its form and young-ice flag are the group's
    const bool active = young || !lead.young;
    if (active) {
      static_for<G>([&](auto p_) {
        constexpr int p = decltype(p_)::value;
        commit<T, tracer(t0 + p).transform>(b, f, p, buf, args.mu_si_lf_c);
      });
      __syncthreads();
    }
    if constexpr (t0 + G < N_TRACERS) f = fetch<T, t0 + G, G, !SO && tracer(t0 + G).form == INTENS>(b, args);
    if (active) {
      T r[G];
      advect<T, SO, lead.form, !SO && lead.form == INTENS>(b, buf, cell, r);
      static_for<G>([&](auto p_) {
        constexpr int p = decltype(p_)::value;
        constexpr Tracer tr = tracer(t0 + p);
        const T v = post(r[p], tr.post);
        if constexpr (tr.keep >= 0) {
          keep[tr.keep] = v;
        } else {
          if (b.own) static_cast<T*>(args.planes_out[tr.plane])[b.c] = v;
        }
      });
      buf ^= 1;
    }
  });
  if (b.own) redistribute(args, keep, b.c);
}

template <typename T, bool SO>
__global__ void __launch_bounds__(THREADS, Tuning<T>::min_blocks) advect_stack(const StackArgs args) {
  extern __shared__ __align__(16) unsigned char shared_bytes[];
  const Block<T> b = make_block(*reinterpret_cast<Shared<T>*>(shared_bytes), args.g);
  const Cell<T> cell = faces<T, SO>(b, args.g);
  const T* q = static_cast<const T*>(args.q);
  T* out = static_cast<T*>(args.out);
  const long long stride = b.plane * args.g.members;  // one bin to the next
  Fetch<T, 1> f = fetch_plane(b, q);
  int buf = 0;
  for (long long p = 0; p < args.planes; ++p) {
    commit<T, AS_IS>(b, f, 0, buf, 0.0);
    __syncthreads();
    if (p + 1 < args.planes) f = fetch_plane(b, q + (p + 1) * stride);
    T r[1];
    advect<T, SO, CONS, false>(b, buf, cell, r);
    if (b.own) out[p * stride + b.c] = r[0];
    buf ^= 1;
  }
}

bool geometry_ok(const Geometry& g) {
  return g.vt_u && g.vt_v && g.mask && g.open_mask && g.ny >= 1 && g.nx >= 1 && g.members >= 1 &&
         g.members <= 65535 && (g.ny + TY - 1) / TY <= 65535 && (g.nx + TX - 1) / TX <= INT_MAX;
}

dim3 grid_of(const Geometry& g) {
  return dim3(static_cast<unsigned>((g.nx + TX - 1) / TX), static_cast<unsigned>((g.ny + TY - 1) / TY),
              static_cast<unsigned>(g.members));
}

// launch `kernel` on the call's grid with a Shared<T> of dynamic shared memory
template <typename T, typename Args>
int launch(void (*kernel)(Args), const Args& a, cudaStream_t st, int* kernels) {
  constexpr int bytes = sizeof(Shared<T>);  // above 48 KB only for float64
  cudaError_t err = cudaSuccess;
  if (bytes > 48 * 1024) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid_of(a.g), dim3(TX, TY), bytes, st>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) *kernels = 1;
  return static_cast<int>(err);
}

template <typename T>
int launch_transport(const TransportArgs* a, void* stream, int* kernels) {
  *kernels = 0;
  if (!geometry_ok(a->g) || !a->divergence || !a->del_ci_ridge_myi) return static_cast<int>(cudaErrorInvalidValue);
  for (int p = 0; p < N_PLANES; ++p) {
    const bool kept = !a->use_young_ice && (p == H_YOUNG || p == HS_YOUNG || p == CONC_YOUNG);
    if (!a->planes_in[p] || (!kept && !a->planes_out[p])) return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return a->g.second_order ? launch<T>(transport<T, true>, *a, st, kernels)
                           : launch<T>(transport<T, false>, *a, st, kernels);
}

template <typename T>
int launch_stack(const StackArgs* a, void* stream, int* kernels) {
  *kernels = 0;
  if (!geometry_ok(a->g) || !a->q || !a->out || a->planes < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a->planes == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  return a->g.second_order ? launch<T>(advect_stack<T, true>, *a, st, kernels)
                           : launch<T>(advect_stack<T, false>, *a, st, kernels);
}

}  // namespace

extern "C" int nextsim_transport_f32(const TransportArgs* a, void* stream, int* kernels) {
  return launch_transport<float>(a, stream, kernels);
}
extern "C" int nextsim_transport_f64(const TransportArgs* a, void* stream, int* kernels) {
  return launch_transport<double>(a, stream, kernels);
}
extern "C" int nextsim_transport_bf16(const TransportArgs* a, void* stream, int* kernels) {
  return launch_transport<bf16>(a, stream, kernels);
}
extern "C" int nextsim_advect_stack_f32(const StackArgs* a, void* stream, int* kernels) {
  return launch_stack<float>(a, stream, kernels);
}
extern "C" int nextsim_advect_stack_f64(const StackArgs* a, void* stream, int* kernels) {
  return launch_stack<double>(a, stream, kernels);
}
extern "C" int nextsim_advect_stack_bf16(const StackArgs* a, void* stream, int* kernels) {
  return launch_stack<bf16>(a, stream, kernels);
}
extern "C" const char* nextsim_transport_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
