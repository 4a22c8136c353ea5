// Roach et al. (2018) welding of the floe size distribution for NVIDIA
// Hopper (sm_90a), one thread a cell: the CUDA counterpart of the plain
// loop ops/fsd.py:welding_roach_reference (the JAX package computes it as
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
// rounding: built with --fmad=false (no contraction), an IEEE division,
// the suffix sums sequential from the last bin (CUDA's cumsum along the
// outer axis), the scalar product dt / ndt as torch forms it from a Python
// float (the reciprocal of ndt times dt), and in bfloat16 one rounding an
// operator with the Python scalars kept in float, the thresholds 0.01 and
// 0.1 rounded to bfloat16 before the comparison as torch rounds a scalar
// it compares with a bfloat16 tensor, and max(., 0) as torch.clamp.
//
// The design: one thread a cell, a loop to the cell's own count: one launch
// a call, no read-back, no host copy. The cell's bins and the bins' sums
// live in registers; the reads at a merge bin known at run time only go to
// the thread's own column of shared memory (registers cannot be indexed so,
// and in local memory the first build spilled and ran 2-10 times slower).
// The pair loop over the lower bin ky is not unrolled, which keeps the code
// small; the loop over kx is, each pair under a guard kx >= ky, so the sums
// coag[kx] stay in registers. The bins' plan -- for each of the
// nbins*(nbins+1)/2 pairs its merge bin, width, offset and valid flag, and
// the bin centres -- is a small device table the wrapper uploads once;
// every block copies it to shared memory, and all threads of a warp read
// the same entry at the same time. A float64 block has 64 threads, a float32
// or bfloat16 block 128: the columns and the table fit the 48 KB of static
// shared memory up to 32 bins (a build for more fails to compile, saying
// so).
//
// What bounds it on an H100: operations where many cells weld. A cell and
// substep needs nbins suffix adds, 2*nbins products for the lead terms, one
// division a merge bin (a pair's width is its merge bin's), 4 operations a
// pair (times the offset, plus the suffix sum, times the lead, into coag)
// and 4*nbins for the update: 1,000 at 20 bins (this kernel does 1,400: it
// divides and multiplies by the valid flag in every pair), against
// nbins*2*sizeof(T) bytes a cell for the whole loop, so a few thousand
// active cells (the wave path's) are bound by the stack's bytes and a few
// hundred thousand by the operations. What
// limits it in fact is latency: a warp runs as long as its slowest cell,
// through ~1,400 dependent operations a substep, and a few thousand active
// cells fill few warps.
//
// nbins is a compile-time constant (-DWELDING_NBINS): the wrapper builds one
// library per bin count at first use. A call with another count is refused.
//
// Plain C interface, loaded with ctypes by ops/welding_cuda.py:
//   int nextsim_welding_nbins(void)
//   int nextsim_welding_f32(const void* cf, void* out, const void* ctot,
//                           const void* c_broken, const void* freezing,
//                           const void* merge, const void* table,
//                           const WeldScalars* s, void* stream)
//   int nextsim_welding_f64(...), int nextsim_welding_bf16(...)
// `cf` and `out` are (nbins, C) planes, `ctot`, `c_broken` (C) planes of the
// same type, `freezing` C bytes, `merge` the pairs' merge bins (int32,
// 1..nbins), `table` the widths, offsets and valid flags of the pairs, then
// the bin centres, in the plane type. One launch on `stream`; returns
// cudaGetLastError() after it (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef WELDING_NBINS
#error "build with -DWELDING_NBINS=<number of floe-size bins>"
#endif

namespace {

constexpr int NB = WELDING_NBINS;
constexpr int N_PAIRS = NB * (NB + 1) / 2;

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

// threads a block: a float64 block holds half as many, so that the cells'
// columns of bins and suffix sums fit the 48 KB of static shared memory
template <typename T>
struct Threads {
  static constexpr int value = sizeof(T) == 8 ? 64 : 128;
};

template <typename T>
__global__ void __launch_bounds__(Threads<T>::value)
    weld(const T* __restrict__ cf, T* __restrict__ out, const T* __restrict__ ctot,
         const T* __restrict__ c_broken, const unsigned char* __restrict__ freezing,
         const int* __restrict__ merge, const T* __restrict__ table, WeldScalars s) {
  using S = opmath_t<T>;
  constexpr int TB = Threads<T>::value;
  __shared__ int s_merge[N_PAIRS];
  __shared__ T s_width[N_PAIRS], s_off[N_PAIRS], s_valid[N_PAIRS], s_centre[NB];
  // each thread's own column of its bins and suffix sums, read at a merge
  // bin known at run time only (registers cannot be indexed so)
  __shared__ T s_c[NB][TB], s_suffix[NB + 1][TB];
  static_assert(sizeof(int) * N_PAIRS + sizeof(T) * (3 * N_PAIRS + NB + (2 * NB + 1) * TB) <= 48 * 1024,
                "the bins' plan and columns exceed the static shared memory: fewer bins");
  for (int q = threadIdx.x; q < N_PAIRS; q += blockDim.x) {
    s_merge[q] = merge[q];
    s_width[q] = table[q];
    s_off[q] = table[N_PAIRS + q];
    s_valid[q] = table[2 * N_PAIRS + q];
  }
  for (int q = threadIdx.x; q < NB; q += blockDim.x) s_centre[q] = table[3 * N_PAIRS + q];
  __syncthreads();

  const int tid = threadIdx.x;
  const long long C = s.cells;
  const long long i = static_cast<long long>(blockIdx.x) * TB + tid;
  if (i >= C) return;
  T c[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) c[k] = cf[k * C + i];
  const T tot = ctot[i];
  const bool active = freezing[i] && c_broken[i] > from_op<T>(S(s.broken_min)) && tot > from_op<T>(S(s.total_min));
  if (active) {
    // stability limit -> substep count (fe.cpp:4754-4757), capped
    const T stability = (tot * S(s.dt_kappa)) * S(s.scaled_up);
    const T ndt = vclamp(vceil(stability + S(0.5)), S(1), S(s.ndt_max));
    const T step = (from_op<T>(S(1) / as_op(ndt)) * S(s.dt)) * S(s.kappa);
    const int n_loop = static_cast<int>(as_op(ndt));
    s_suffix[NB][tid] = from_op<T>(S(0));
    for (int t = 0; t < n_loop; ++t) {
      // suffix[a] = c[a] + ... + c[n-1], summed from the last bin
      T acc = from_op<T>(S(0));
#pragma unroll
      for (int a = NB - 1; a >= 0; --a) {
        acc = acc + c[a];
        s_suffix[a][tid] = acc;
        s_c[a][tid] = c[a];
      }
      T coag[NB];
#pragma unroll
      for (int k = 0; k < NB; ++k) coag[k] = from_op<T>(S(0));
      // the pair terms of lower bin ky, added to coag[kx >= ky] in ky order
#pragma unroll 1
      for (int ky = 0; ky < NB; ++ky) {
        const T lead = (s_centre[ky] * s_c[ky][tid]) * tot;
        const int q0 = ky * NB - ky * (ky - 1) / 2 - ky;  // pair (ky, kx) is q0 + kx
#pragma unroll
        for (int kx = 0; kx < NB; ++kx) {
          if (kx >= ky) {
            const int q = q0 + kx;
            const int a = s_merge[q];
            const T part = (s_c[a - 1][tid] / s_width[q]) * s_off[q];
            const T term = (lead * (s_suffix[a][tid] + part)) * s_valid[q];
            coag[kx] = coag[kx] + term;
          }
        }
      }
      // bin m loses coag[m] and gains coag[m-1] (fe.cpp:4796-4803)
#pragma unroll
      for (int k = NB - 1; k >= 0; --k) {
        const T gain = k ? coag[k - 1] : from_op<T>(S(0));
        c[k] = vrelu(c[k] - step * (coag[k] - gain));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) out[k * C + i] = c[k];
}

template <typename T>
int launch(const void* cf, void* out, const void* ctot, const void* c_broken, const void* freezing,
           const void* merge, const void* table, const WeldScalars* s, void* stream) {
  if (s->nbins != NB || s->cells < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (s->cells == 0) return 0;
  constexpr int threads = Threads<T>::value;
  const long long blocks = (s->cells + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  weld<T><<<static_cast<unsigned>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cf), static_cast<T*>(out), static_cast<const T*>(ctot),
      static_cast<const T*>(c_broken), static_cast<const unsigned char*>(freezing),
      static_cast<const int*>(merge), static_cast<const T*>(table), *s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nextsim_welding_nbins() { return NB; }

extern "C" int nextsim_welding_f32(const void* cf, void* out, const void* ctot, const void* c_broken,
                                   const void* freezing, const void* merge, const void* table,
                                   const WeldScalars* s, void* stream) {
  return launch<float>(cf, out, ctot, c_broken, freezing, merge, table, s, stream);
}

extern "C" int nextsim_welding_f64(const void* cf, void* out, const void* ctot, const void* c_broken,
                                   const void* freezing, const void* merge, const void* table,
                                   const WeldScalars* s, void* stream) {
  return launch<double>(cf, out, ctot, c_broken, freezing, merge, table, s, stream);
}

extern "C" int nextsim_welding_bf16(const void* cf, void* out, const void* ctot, const void* c_broken,
                                    const void* freezing, const void* merge, const void* table,
                                    const WeldScalars* s, void* stream) {
  return launch<bf16>(cf, out, ctot, c_broken, freezing, merge, table, s, stream);
}

extern "C" const char* nextsim_welding_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
