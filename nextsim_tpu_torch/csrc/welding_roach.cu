// Roach et al. (2018) welding of the floe size distribution for NVIDIA
// Hopper (sm_90a): the CUDA counterpart of the plain loop
// ops/fsd.py:welding_roach_reference (the JAX package computes it as
// XLA-fused jnp, nextsim_tpu/ops/fsd.py:welding_roach, a fori_loop of 256
// masked substeps over every cell; it has no Pallas kernel).
//
// What it computes, per cell of a (nbins, C) stack (C = ny*nx, or N*ny*nx
// for the member-minor layout (nbins, N, ny, nx) of a batched ensemble,
// whose members are just more cells):
//   the cell is active when freezing & (c_broken > 0.01) & (ctot > 0.1);
//   its substep count is ndt = clip(ceil(dt*kappa*ctot*scaled_up[-1] + 0.5),
//   1, WELDING_NDT_MAX) and its step factor (1/ndt)*dt*kappa; then ndt
//   substeps of: the suffix sums s[a] = c[a] + ... + c[n-1] (s[n] = 0), the
//   pair terms of every lower bin ky, lead[ky]*(s[a] + (c[a-1]/width)*off)
//   (* valid) with a = the pair's merge bin, added to coag[kx >= ky] in ky
//   order, then c = max(c - step*(coag - gain), 0) with gain[m] = coag[m-1].
//   An inactive cell keeps its value. ctot and c_broken are the caller's
//   torch reductions (their order of summation is torch's), passed in as
//   planes.
//
// Bitwise equal to the plain version on the card in float32, float64 and
// bfloat16, so every operation is one torch op of that version with its
// rounding: built with --fmad=false (no contraction), the IEEE quotient
// (formed without a division where that is exact, below),
// the suffix sums sequential from the last bin (CUDA's cumsum along the
// outer axis), the scalar product dt / ndt as torch forms it from a Python
// float (the reciprocal of ndt times dt), and in bfloat16 one rounding an
// operator with the Python scalars kept in float, the thresholds 0.01 and
// 0.1 rounded to bfloat16 before the comparison as torch rounds a scalar
// it compares with a bfloat16 tensor, and max(., 0) as torch.clamp.
//
// What bounds it on an H100. A cell and substep needs nbins suffix adds,
// 2*nbins products for the lead terms, one division a merge bin (a pair's
// width is its merge bin's), 4 operations a pair (times the offset, plus
// the suffix sum, times the lead, into coag) and 4*nbins for the update:
// 1,000 at 20 bins, against nbins*2*sizeof(T) bytes a cell for the whole
// loop. A few thousand active cells (the wave path's freeze-up) are bound
// by the stack's bytes, a few hundred thousand (an ensemble's member
// stack) by the operations. What limits a kernel here is latency: a cell
// is 256 sequential substeps at most, and where few cells weld few warps
// run, each waiting on its own chain. One thread a cell over the whole
// grid with the merge bins read from shared memory at run time (the
// previous design) left the active cells a few to a warp and made every pair a
// chain of dependent shared loads and a division: 20.5 ms where 3,410
// cells weld, 0.48 ms with this one (PERF.md, Findings).
//
// The design, two kernels and a memset a call, nothing read back, so a
// captured CUDA graph replays it:
// * pass 1 (`mark`, one thread a cell): copies every inactive cell's bins
//   to `out` and appends each active cell's index to a list with one
//   atomicAdd a warp (the counter is zeroed by a memset on the same
//   stream). The list's order changes from run to run; every cell is
//   independent, so the result does not.
// * pass 2 (`weld`, one thread a listed cell): the active cells packed into
//   full warps. Blocks past the count exit at once.
// * the bins' merge plan is compiled in: each pair's merge bin and valid
//   flag are -D strings (-DWELDING_MERGE=m<two digits a pair>,
//   -DWELDING_VALID=v<0 or 1 a pair>, in welding_pairs' order; single
//   tokens, since nvcc reads a comma in a -D value as the start of another
//   definition), decoded by constexpr functions, and both pair loops are
//   unrolled at compile time (static_for). So the cell's bins, suffix sums,
//   quotients and sums are indexed by constants only and held in registers
//   (but the few bytes ptxas spills, below): no shared memory.
//   The widths (one a merge bin), offsets (one a pair) and bin centres are
//   values of the plane type that the wrapper builds with torch.as_tensor
//   (the plain version's bits) and passes by value in the kernel's
//   parameters, read from the constant bank at compile-time offsets.
// * one quotient a merge bin a substep, d[a] = c[a-1] / width(a), shared
//   by every pair that merges into a (the same operands as the plain
//   version's per-pair division, so the same bits). The kernel does not
//   use CUDA's IEEE division for it but where it must (a double dividend
//   out of range, below): that division is a range check and a branch to a
//   called slow path around each quotient. The quotient is the reciprocal,
//   rounded once on the host, and two fma corrections (`quotient`, exact
//   by Markstein's theorem) where the dividend and the quotient lie in
//   `Exact`'s range; a zero, an infinity or a NaN is its own quotient.
//   Where a thread meets any other dividend in a substep, all its
//   quotients of that substep are taken again by `exact_quotient`: for a
//   float (float and bfloat16 planes) the same corrections in double,
//   exact for every float, rounded once to float; for a double the IEEE
//   division. A freeze-up's decaying bins fall under float's 2^-90 at
//   many substeps, so that branch is hot there. Measured against it on an
//   H100 (PERF.md, PR 14): the IEEE division in every quotient 3.9x slower
//   where 3,410 cells weld; the IEEE division in that branch alone 3.1x
//   slower (its slow path); every float quotient by the corrections in
//   double, with no range check, 1.09x slower there and 1.32x on a
//   4-member stack. A valid pair's term is not multiplied by its flag
//   (x * 1 is x, NaN included), an invalid one's is multiplied by 0 (an
//   infinite term becomes NaN, as in the plain version). Every order of
//   addition is the plain version's.
// Registers (ptxas, 20 bins): `weld` holds 255 a thread in float32 and
// float64 and spills 12 and 96 bytes, 168 in bfloat16; at 32 bins float64
// spills 900 bytes (PERF.md; welding_cuda.build_log). The builds above
// that hold fewer (216 and 200 in float32, no spill) are the slower ones.
//
// nbins and the plan are compile-time: the wrapper builds one library per
// plan at first use (welding_cuda.plan_defines). A call with another bin
// count is refused (cudaErrorInvalidValue).
//
// Plain C interface, loaded with ctypes by ops/welding_cuda.py:
//   int nextsim_welding_nbins(void)
//   int nextsim_welding_f32(const void* cf, void* out, const void* ctot,
//                           const void* c_broken, const void* freezing,
//                           void* work, const void* table,
//                           const WeldScalars* s, void* stream,
//                           int* kernels)
//   int nextsim_welding_f64(...), int nextsim_welding_bf16(...)
// `cf` and `out` are (nbins, C) planes, `ctot`, `c_broken` (C) planes of the
// same type, `freezing` C bytes, `work` C + 1 int32 on the device (the
// count, then the list), `table` a HOST array of the plane type: the
// widths of merge bins 1..nbins, the offsets of the pairs, the bin
// centres (copied into the launch's parameters). A memset and two launches
// on `stream`; returns the first CUDA error (0 on success) and sets
// *kernels to the number of kernels launched (0 for an empty stack).

#include <climits>
#include <cstring>
#include <type_traits>
#include <utility>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef WELDING_NBINS
#error "build with -DWELDING_NBINS=<number of floe-size bins>"
#endif
#if !defined(WELDING_MERGE) || !defined(WELDING_VALID)
#error "build with -DWELDING_MERGE=m<2 digits a pair> -DWELDING_VALID=v<0|1 a pair> (welding_cuda.plan_defines)"
#endif

#define WELDING_STR_(x) #x
#define WELDING_STR(x) WELDING_STR_(x)

namespace {

constexpr int NB = WELDING_NBINS;
constexpr int N_PAIRS = NB * (NB + 1) / 2;
constexpr int MARK_THREADS = 256;
constexpr int WELD_THREADS = 64;
static_assert(NB >= 2 && NB <= 32, "the kernel takes 2 to 32 bins");

// the plan: pair q = (ky, kx >= ky) in welding_pairs' order (ky, then kx)
constexpr char MERGE_CODE[] = WELDING_STR(WELDING_MERGE);
constexpr char VALID_CODE[] = WELDING_STR(WELDING_VALID);
static_assert(sizeof(MERGE_CODE) == 2 + 2 * N_PAIRS && MERGE_CODE[0] == 'm',
              "WELDING_MERGE: m and two digits for each pair");
static_assert(sizeof(VALID_CODE) == 2 + N_PAIRS && VALID_CODE[0] == 'v',
              "WELDING_VALID: v and one digit for each pair");

__host__ __device__ constexpr int pair_index(int ky, int kx) { return ky * NB - ky * (ky - 1) / 2 + (kx - ky); }
__host__ __device__ constexpr int merge_bin(int q) {
  return 10 * (MERGE_CODE[1 + 2 * q] - '0') + (MERGE_CODE[2 + 2 * q] - '0');
}
__host__ __device__ constexpr bool pair_valid(int q) { return VALID_CODE[1 + q] == '1'; }
constexpr bool plan_ok() {
  for (int q = 0; q < N_PAIRS; ++q) {
    if (merge_bin(q) < 1 || merge_bin(q) > NB) return false;
    if (VALID_CODE[1 + q] != '0' && VALID_CODE[1 + q] != '1') return false;
  }
  return true;
}
static_assert(plan_ok(), "the plan holds a merge bin outside 1..nbins or a flag other than 0 or 1");

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

// bfloat16 as PyTorch's eager operators compute it on the card: every
// operator converts its operands to float, computes in float and rounds its
// result to bfloat16, to nearest even; a Python scalar operand stays a float.
struct bf16 {
  __nv_bfloat16 v;
  bf16() = default;
  __device__ __forceinline__ explicit bf16(float f) : v(__float2bfloat16_rn(f)) {}
  __device__ __forceinline__ explicit operator float() const { return __bfloat162float(v); }
};

#define BF16_ARITH(op)                                                                      \
  __device__ __forceinline__ bf16 operator op(bf16 a, bf16 b) { return bf16(float(a) op float(b)); } \
  __device__ __forceinline__ bf16 operator op(bf16 a, float b) { return bf16(float(a) op b); }
BF16_ARITH(+)
BF16_ARITH(-)
BF16_ARITH(*)
BF16_ARITH(/)
#undef BF16_ARITH
__device__ __forceinline__ bool operator>(bf16 a, bf16 b) { return float(a) > float(b); }

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

template <typename T>
__device__ __forceinline__ T from_op(opmath_t<T> a) {
  return T(a);
}

// ceil, max and min of one opmath value
__device__ __forceinline__ float op_ceil(float a) { return ceilf(a); }
__device__ __forceinline__ double op_ceil(double a) { return ceil(a); }
__device__ __forceinline__ float op_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double op_max(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float op_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double op_min(double a, double b) { return fmin(a, b); }

// torch.ceil, torch.clamp(x, lo, hi) and torch.clamp(x, min=0) of one value
// (NaN passes)
template <typename T>
__device__ __forceinline__ T vceil(T a) {
  return from_op<T>(op_ceil(as_op(a)));
}
template <typename T>
__device__ __forceinline__ T vclamp(T a, opmath_t<T> lo, opmath_t<T> hi) {
  const opmath_t<T> x = as_op(a);
  return x != x ? a : from_op<T>(op_min(op_max(x, lo), hi));
}
template <typename T>
__device__ __forceinline__ T vrelu(T a) {
  const opmath_t<T> x = as_op(a);
  return x != x ? a : from_op<T>(op_max(x, opmath_t<T>(0)));
}

// the plan's values in the plane type, passed by value: the kernel reads
// them from the constant bank at offsets known at compile time
template <typename T>
struct Plan {
  T width[NB];            // width[a - 1]: the width of merge bin a
  T off[N_PAIRS];         // the offset of pair q
  T centre[NB];           // the scaled bin centres
  opmath_t<T> recip[NB];  // 1 / width[a - 1] rounded once, in the type a division runs in
  double recip64[NB];     // 1 / width[a - 1] rounded once to double (`exact_quotient`)
};

// the plane type's value in its operator type, on the host (bfloat16: its
// 16 bits are the high half of the float's)
inline float host_op(float v) { return v; }
inline double host_op(double v) { return v; }
inline float host_op(bf16 v) {
  unsigned short lo;
  std::memcpy(&lo, &v, sizeof(lo));
  const unsigned u = static_cast<unsigned>(lo) << 16;
  float f;
  std::memcpy(&f, &u, sizeof(f));
  return f;
}

// a * b, fma(a, b, c) and |a|, rounded once
__device__ __forceinline__ float op_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double op_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float op_fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double op_fma(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float op_abs(float a) { return fabsf(a); }
__device__ __forceinline__ double op_abs(double a) { return fabs(a); }

// the magnitudes between which the quotient below is exact: far from
// underflow and overflow of a, of a / w and of the remainder
template <typename S>
struct Exact;
template <>
struct Exact<float> {
  static constexpr float lo = 0x1p-90f, hi = 0x1p+90f, max = 3.40282347e+38f;
};
template <>
struct Exact<double> {
  static constexpr double lo = 0x1p-960, hi = 0x1p+960, max = 1.7976931348623157e+308;
};

// The correctly rounded quotient of x by w > 0 from y = 1/w rounded once:
// q0 = x * y, then two corrections q' = q + (x - w * q) * y, each an fma
// of the remainder that an fma forms. q0 may be off by more than an ulp
// where x/w lies just below a power of two; the first correction brings it
// within an ulp, and then Markstein's theorem holds: y within half an ulp
// of 1/w and q within an ulp of x/w make the remainder exact and the second
// correction the correctly rounded quotient, as long as nothing under- or
// overflows (tests/test_torch_welding.py checks this in exact arithmetic).
template <typename S>
__device__ __forceinline__ S markstein(S x, S w, S y) {
  const S q0 = op_mul(x, y);
  const S q1 = op_fma(op_fma(-w, q0, x), y, q0);
  return op_fma(op_fma(-w, q1, x), y, q1);
}

// a / w with IEEE rounding, without a division, where a and the quotient
// lie in Exact's range; a zero, an infinity or a NaN is its own quotient
// (w is positive and finite). Any other a sets `inexact`: the caller then
// takes `exact_quotient`.
template <typename T>
__device__ __forceinline__ T quotient(T a, T w, opmath_t<T> y, bool& inexact) {
  using S = opmath_t<T>;
  const S x = as_op(a);
  const S q = markstein(x, as_op(w), y);
  const S ax = op_abs(x), aq = op_abs(q);
  const bool own = x == S(0) || !(ax <= Exact<S>::max);  // zero, infinite or NaN
  const bool exact = ax >= Exact<S>::lo && ax <= Exact<S>::hi && aq >= Exact<S>::lo && aq <= Exact<S>::hi;
  if (!(exact || own)) inexact = true;
  return own ? a : from_op<T>(q);
}

// a / w with IEEE rounding for any a. A float quotient (float and bfloat16
// planes) is formed in double, where every float and its quotient by w lie
// far inside the range, and rounded once to float: a quotient of two floats
// rounded to double first rounds to the same float (53 >= 2 * 24 + 2 bits;
// the same holds on float's subnormal grid). A double quotient is divided.
template <typename T>
__device__ __forceinline__ T exact_quotient(T a, T w, double y64) {
  if constexpr (std::is_same_v<opmath_t<T>, float>) {
    const float x = as_op(a);
    const bool own = x == 0.0f || !(fabsf(x) <= Exact<float>::max);
    return own ? a : from_op<T>(__double2float_rn(markstein(double(x), double(as_op(w)), y64)));
  } else {
    return a / w;
  }
}

}  // namespace

// Scalars, computed on the host in double: must match welding_cuda._Scalars.
struct WeldScalars {
  double dt_kappa;    // dt * welding_kappa, the Python product
  double scaled_up;   // bins.scaled_up[-1]
  double dt, kappa;
  double broken_min;  // 0.01: least broken area of an active cell
  double total_min;   // 0.1: least concentration of an active cell
  double ndt_max;     // WELDING_NDT_MAX
  long long cells;    // C
  int nbins;
  int pad_;
};

namespace {

// pass 1: inactive cells copied to `out`, active ones appended to the list
template <typename T>
__global__ void __launch_bounds__(MARK_THREADS)
    mark(const T* __restrict__ cf, T* __restrict__ out, const T* __restrict__ ctot,
         const T* __restrict__ c_broken, const unsigned char* __restrict__ freezing, int* __restrict__ work,
         const WeldScalars s) {
  using S = opmath_t<T>;
  const long long C = s.cells;
  const long long i = static_cast<long long>(blockIdx.x) * MARK_THREADS + threadIdx.x;
  bool active = false;
  if (i < C) {
    active = freezing[i] && c_broken[i] > from_op<T>(S(s.broken_min)) && ctot[i] > from_op<T>(S(s.total_min));
    if (!active) {
#pragma unroll
      for (int k = 0; k < NB; ++k) out[k * C + i] = cf[k * C + i];
    }
  }
  // one atomicAdd a warp: the lowest active lane takes the warp's slots
  const unsigned ballot = __ballot_sync(0xffffffffu, active);
  if (ballot) {
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(ballot) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(work, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (active) work[1 + base + __popc(ballot & ((1u << lane) - 1u))] = static_cast<int>(i);
  }
}

// a pair merges into bin a
__host__ __device__ constexpr bool merge_used(int a) {
  for (int q = 0; q < N_PAIRS; ++q)
    if (merge_bin(q) == a) return true;
  return false;
}

// pass 2: listed cell j (one thread each) to its own substep count; blocks
// past the count exit at once
template <typename T>
__global__ void __launch_bounds__(WELD_THREADS)
    weld(const T* __restrict__ cf, T* __restrict__ out, const T* __restrict__ ctot, const int* __restrict__ work,
         const Plan<T> plan, const WeldScalars s) {
  using S = opmath_t<T>;
  const int j = blockIdx.x * WELD_THREADS + threadIdx.x;
  if (j >= work[0]) return;
  const long long C = s.cells;
  const long long i = work[1 + j];
  const T zero = from_op<T>(S(0));
  T c[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) c[k] = cf[k * C + i];
  const T tot = ctot[i];
  // stability limit -> substep count (fe.cpp:4754-4757), capped
  const T stability = (tot * S(s.dt_kappa)) * S(s.scaled_up);
  const T ndt = vclamp(vceil(stability + S(0.5)), S(1), S(s.ndt_max));
  const T step = (from_op<T>(S(1) / as_op(ndt)) * S(s.dt)) * S(s.kappa);
  const int n_steps = static_cast<int>(as_op(ndt));
  for (int t = 0; t < n_steps; ++t) {
    // suffix[a] = c[a] + ... + c[n-1], summed from the last bin
    T suffix[NB + 1];
    T acc = zero;
    static_for<NB>([&](auto j_) {
      constexpr int a = NB - 1 - decltype(j_)::value;
      acc = acc + c[a];
      suffix[a] = acc;
    });
    suffix[NB] = zero;
    // one quotient a merge bin: d[a] = c[a-1] / width(a), from the
    // reciprocal and two corrections; where an operand is out of their
    // range, all again by `exact_quotient`
    T d[NB + 1];
    bool inexact = false;
    static_for<NB>([&](auto j_) {
      constexpr int a = 1 + decltype(j_)::value;
      if constexpr (merge_used(a)) d[a] = quotient(c[a - 1], plan.width[a - 1], plan.recip[a - 1], inexact);
    });
    if (inexact) {
      static_for<NB>([&](auto j_) {
        constexpr int a = 1 + decltype(j_)::value;
        if constexpr (merge_used(a)) d[a] = exact_quotient(c[a - 1], plan.width[a - 1], plan.recip64[a - 1]);
      });
    }
    // the pair terms of lower bin ky, added to coag[kx >= ky] in ky order
    T coag[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) coag[k] = zero;
    static_for<NB>([&](auto ky_) {
      constexpr int ky = decltype(ky_)::value;
      const T lead = (plan.centre[ky] * c[ky]) * tot;
      static_for<NB - ky>([&](auto j_) {
        constexpr int kx = ky + decltype(j_)::value;
        constexpr int q = pair_index(ky, kx);
        constexpr int a = merge_bin(q);
        T term = lead * (suffix[a] + d[a] * plan.off[q]);
        if constexpr (!pair_valid(q)) term = term * zero;
        coag[kx] = coag[kx] + term;
      });
    });
    // bin m loses coag[m] and gains coag[m-1] (fe.cpp:4796-4803)
    static_for<NB>([&](auto j_) {
      constexpr int k = NB - 1 - decltype(j_)::value;
      if constexpr (k > 0) {
        c[k] = vrelu(c[k] - step * (coag[k] - coag[k - 1]));
      } else {
        c[k] = vrelu(c[k] - step * (coag[k] - zero));
      }
    });
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) out[k * C + i] = c[k];
}

template <typename T>
int launch(const void* cf, void* out, const void* ctot, const void* c_broken, const void* freezing, void* work,
           const void* table, const WeldScalars* s, void* stream, int* kernels) {
  *kernels = 0;
  if (s->nbins != NB || s->cells < 0 || s->cells > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (s->cells == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  Plan<T> plan;
  const T* values = static_cast<const T*>(table);
  std::memcpy(plan.width, values, sizeof(plan.width));
  std::memcpy(plan.off, values + NB, sizeof(plan.off));
  std::memcpy(plan.centre, values + NB + N_PAIRS, sizeof(plan.centre));
  for (int k = 0; k < NB; ++k) {
    plan.recip[k] = opmath_t<T>(1) / host_op(plan.width[k]);
    plan.recip64[k] = 1.0 / double(host_op(plan.width[k]));
  }
  cudaError_t err = cudaMemsetAsync(work, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto cells = static_cast<unsigned>(s->cells);
  int* counted = static_cast<int*>(work);  // the count, then the list
  mark<T><<<(cells + MARK_THREADS - 1) / MARK_THREADS, MARK_THREADS, 0, st>>>(
      static_cast<const T*>(cf), static_cast<T*>(out), static_cast<const T*>(ctot),
      static_cast<const T*>(c_broken), static_cast<const unsigned char*>(freezing), counted, *s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  *kernels = 1;
  // as many blocks as the cells could fill; those past the count exit
  weld<T><<<(cells + WELD_THREADS - 1) / WELD_THREADS, WELD_THREADS, 0, st>>>(
      static_cast<const T*>(cf), static_cast<T*>(out), static_cast<const T*>(ctot), counted, plan, *s);
  err = cudaGetLastError();
  if (err == cudaSuccess) *kernels = 2;
  return static_cast<int>(err);
}

}  // namespace

extern "C" int nextsim_welding_nbins() { return NB; }

extern "C" int nextsim_welding_f32(const void* cf, void* out, const void* ctot, const void* c_broken,
                                   const void* freezing, void* work, const void* table, const WeldScalars* s,
                                   void* stream, int* kernels) {
  return launch<float>(cf, out, ctot, c_broken, freezing, work, table, s, stream, kernels);
}

extern "C" int nextsim_welding_f64(const void* cf, void* out, const void* ctot, const void* c_broken,
                                   const void* freezing, void* work, const void* table, const WeldScalars* s,
                                   void* stream, int* kernels) {
  return launch<double>(cf, out, ctot, c_broken, freezing, work, table, s, stream, kernels);
}

extern "C" int nextsim_welding_bf16(const void* cf, void* out, const void* ctot, const void* c_broken,
                                    const void* freezing, void* work, const void* table, const WeldScalars* s,
                                    void* stream, int* kernels) {
  return launch<bf16>(cf, out, ctot, c_broken, freezing, work, table, s, stream, kernels);
}

extern "C" const char* nextsim_welding_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
