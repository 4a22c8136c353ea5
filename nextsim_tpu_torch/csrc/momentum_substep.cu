// Momentum substep loop for NVIDIA Hopper (sm_90a): the CUDA counterpart of
// the blocked Pallas kernel nextsim_tpu/ops/momentum_pallas.py
// (substep_loop_blocked / _kernel), which runs `steps` substeps of
// nextsim_tpu/ops/momentum.py:_build_substep for bbm, evp or mevp.
//
// What it computes, per substep (the same formulas, term order and float32
// guards as nextsim_tpu_torch/ops/momentum.py:_build_substep):
//   cell stage  strain rates from the 4 corner velocities, then the BBM
//               stress/damage update (rheology.bbm_update_planes) or the
//               (m)EVP update (rheology.vp_update_planes) of sxx, syy, sxy,
//               damage;
//   node stage  stress divergence from the 4 adjacent cells (zero outside),
//               the 2x2 implicit-drag node solve and the displacement
//               ut += dte*vt (not for mevp) of vt and ut.
//
// The design: temporal blocking on a shared-memory tile with a halo.
//   One launch advances the whole grid by k substeps. A block owns a tile of
//   tile_h x tile_w nodes (and the cells with the same indices). It loads
//   the tile plus a halo of k points on every side -- every plane the
//   rheology reads, 8 state planes and up to 22 loop-invariant ones -- into
//   shared memory, runs k times (cell stage, __syncthreads(), node stage,
//   __syncthreads()) there, and writes only its own tile of the state back.
//   One substep's domain of dependence grows by one point (nodes -> cell in
//   the strain rates, cells -> node in the stress divergence), so substep s
//   is computed on the box shrunk by s points on every side whose neighbour
//   lies inside the domain: what it reads is exact, and after k substeps the
//   tile is. A point outside the domain is loaded as zero and never
//   computed: zero volume gives zero force and no solve leaves a zero
//   velocity, which is the closed boundary of the plain version's zero
//   padding, so a box does not shrink on a side that is the domain's edge.
//   Blocks of one launch read their neighbours' tiles as halo, so a launch
//   reads one set of state planes and writes the other (ping-pong); the
//   launch boundary is the grid-wide barrier. A loop of `steps` substeps is
//   ceil(steps / k) launches, the last with the remainder.
//
// What bounds it on an H100: operations. Counting every input plane read
// once and every state plane written once, the loop moves 38 planes for
// 120 x ~190 operations per point: at the card's 67 TFLOP/s against 3.35
// TB/s the arithmetic takes ~7 times longer than the bytes. The design
// keeps the planes out of device memory between the substeps of a launch,
// so the traffic falls from 43 plane moves per substep (two streaming
// launches) to (planes x (box / tile) + 8) / k per substep; the price is
// the halo's redundant loads and arithmetic, (box / tile) - 1. On the card
// a block spends about a third of its time loading (all blocks of a round
// load at once, at the rate of device memory) and two thirds computing, at
// the SM's instruction rate: bitwise float32 division and square root, the
// NaN-propagating clamps and the addressing make ~300 instructions of the
// ~95 operations of an update (PERF.md has the clock readings).
//
// The choice of tile, k and threads is made on the host per dtype, rheology
// and grid (momentum_cuda.launch_plan, a cost model fitted to the kernel's
// own clock counters), and so is every size: this file only checks that the
// plan fits the shared memory it was launched with. On an H100 the plan for
// bbm is tiles of 28 x 31-37 nodes with k = 5-6 in float32 (1024 threads)
// and of 17-23 x 26-31 with k = 3-4 in float64 (512 threads: a value takes
// two registers): more substeps a launch cost more halo, fewer cost more
// launches and loads, and the blocks have to fill rounds of 132 SMs (at
// 464^2, 255 blocks of 28 x 31 run in two full rounds; 169 of 36 x 36 took
// half as long again). Everything lives in
// shared memory: of the ~30 values per point only vt and the stresses (with
// volume) are read across threads, but a box of ~1900 points does not fit
// the register file of 1024 threads beside the temporaries (64 registers a
// thread), and a box small enough to fit has too large a halo share.
// Shared memory holds one record per point (its planes' values side by
// side, an odd number of words): a value's offset in its record is a
// compile-time constant, so a load costs one instruction, and threads walk
// the (shrunk) box row-major, neighbouring threads on neighbouring records,
// which the odd length spreads over all banks. The tile is loaded with
// cp.async, every plane of a point in flight at once, no register staged.
// Rows and columns come from a float reciprocal, not an integer division.
//
// Built with --fmad=false: no multiply-add contraction, so the kernel
// rounds exactly like the eager PyTorch version of the same body (which
// never contracts). The BBM failure branch amplifies a one-ulp difference
// into visible ones, and the plain version is the kernel's oracle.
// Recomputing a halo point gives the bits of computing it once, so the
// blocked loop equals the plain loop bitwise.
//
// bfloat16 (the JAX package's tpu.dtype=bfloat16, whose loop keeps a
// bfloat16 carry after every substep): the planes, the carry and the
// shared-memory records hold bfloat16, and the arithmetic is that of the
// plain loop on bfloat16 tensors: each torch op computes in float and rounds
// its result to bfloat16 (the bf16 type below, one rounding an operator),
// the scalars and literals stay float as a Python scalar does (Coef<float>,
// S(...)), and a bound or threshold that torch compares with a plane or
// selects by torch.where is rounded to bfloat16 first (T(...)). A record of
// 2-byte values is an odd number of words long too; cp.async moves no fewer
// than 4 bytes, so a bfloat16 value is loaded through a register. Nothing
// is upcast for a launch: a carry of float32 across k substeps would
// compute another loop than the plain one.
//
// Members (the batched ensemble, the counterpart of jax.vmap over the
// Pallas call): one launch advances plan->members states, blockIdx.z the
// member, the tiles of every member in one grid. Plane q of member m starts
// member_stride[q] values after member m - 1's: the plane's size for a plane
// of its own (every state plane, and what the member's state or forcing
// sets), 0 for a plane that all members share (the grid's, and those of a
// forcing field that no member perturbs), so nothing is copied N times.
// Inside a member the arithmetic is the same, so member m of a batched
// launch equals a launch on member m alone bitwise. A launch of one member
// runs a build of the kernel without the member offsets (MEMBERS = false):
// their address arithmetic made the bfloat16 loop 4-6% slower.
//
// Plain C interface, loaded with ctypes by ops/momentum_cuda.py:
//   int nextsim_substeps_f32(void* const* planes, void* const* state_b,
//                            const SubstepParams* p, const SubstepPlan* plan,
//                            const int* launch_steps,
//                            const long long* member_stride, void* stream)
//   int nextsim_substeps_f64(...), int nextsim_substeps_bf16(...)
// `planes` holds one pointer per Plane (null where the rheology reads none),
// its first 8 the state slot that launch 0 reads; `state_b` the 8 pointers
// of the other slot, whose member strides are those of the first;
// `member_stride` one stride per Plane, in values. The function makes
// plan->n_launches launches on the stream, launch g running launch_steps[g]
// substeps from slot g % 2 into slot (g + 1) % 2, checks cudaGetLastError()
// after each, and returns the first error (0 on success).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <utility>

#ifdef NEXTSIM_SUBSTEP_CLOCKS
// Built with -DNEXTSIM_SUBSTEP_CLOCKS (nextsim_tpu_torch/tools/tune_substep.py
// --clocks), every
// block adds its SM clocks of loading, computing and storing to these sums
// and counts itself: the readings behind momentum_cuda's cost model.
__device__ unsigned long long g_clocks[4];
#define CLOCK(name) const long long name = clock64()
#else
#define CLOCK(name)
#endif

namespace {

// Plane order: must match momentum_cuda._PLANES.
enum Plane {
  // carried state
  VT_U, VT_V, UT_U, UT_V, SXX, SYY, SXY, DAMAGE,
  // cell coefficients (ny, nx)
  VOLUME, CONC, THICK, COHESION, BBM_EXPC, BBM_PMAX, BBM_HEAL, BBM_RTD, EVP_P,
  // node coefficients (ny+1, nx+1)
  GRAD_SSH_U, GRAD_SSH_V, TAU_AX, TAU_AY, DTE_OVER_MASS, BETA_COR, DOM_COS,
  DOM_SIN, OCN_ROT_X, OCN_ROT_Y, OCEAN_U, OCEAN_V, C_BU, RLMASS, SOLVE,
  VTM_U, VTM_V,
  N_PLANES
};

enum Rheology { BBM = 0, EVP = 1, MEVP = 2 };

constexpr int N_STATE = 8;

// bfloat16 as PyTorch's eager operators compute it on the card: every
// operator converts its operands to float (PyTorch's "opmath" type), computes
// in float and rounds its result to bfloat16, to nearest even; a Python
// scalar operand stays a float. So each operator below is one torch op of
// the plain body. The conversions are explicit, so no expression can slip
// into float arithmetic that the plain version rounds.
struct bf16 {
  __nv_bfloat16 v;
  bf16() = default;
  __device__ __forceinline__ explicit bf16(float f) : v(__float2bfloat16_rn(f)) {}
  __device__ __forceinline__ explicit operator float() const { return __bfloat162float(v); }
};

#define BF16_ARITH(op)                                                                      \
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

// The type a plane's arithmetic takes its scalars in: the plane type itself
// for float and double, float for bfloat16 (torch keeps a Python scalar, and
// computes, in float there).
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

// sqrt and pow of one plane value, rounded to the plane type
__device__ __forceinline__ float vsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double vsqrt(double a) { return sqrt(a); }
__device__ __forceinline__ bf16 vsqrt(bf16 a) { return bf16(sqrtf(float(a))); }
__device__ __forceinline__ float vpow(float a, float e) { return powf(a, e); }
__device__ __forceinline__ double vpow(double a, double e) { return pow(a, e); }
__device__ __forceinline__ bf16 vpow(bf16 a, float e) { return bf16(powf(float(a), e)); }

}  // namespace

// Scalars, computed on the host in double: must match momentum_cuda._Params.
struct SubstepParams {
  int ny, nx, steps, rheology;
  int pow_n, pow_half, pow_generic, pad_;
  double pow_e;  // relaxation exponent alpha-1 (used when pow_generic)
  double r, dte;  // 1/(2 dx), substep length
  double min_c, lambda0, young, d0, d1, d2, compr_strength, tan_phi, mult_cap;
  double re2, ralpha1, ralpha2, delta_min;
  double cw, u0, b_mevp;  // rhow*Cw, Lemieux u0, mevp beta+1
};

// The launch plan, computed on the host: must match momentum_cuda._Plan.
struct SubstepPlan {
  int tile_h, tile_w, halo, threads;
  int blocks_y, blocks_x, n_planes, smem_bytes;
  int n_launches, members;
};

namespace {

// The planes a rheology keeps on the tile (momentum_cuda.tile_planes): the
// state planes it updates and the loop-invariant planes it reads.
__host__ __device__ constexpr bool plane_used(int rheo, int q) {
  if (q == UT_U || q == UT_V) return rheo != MEVP;
  if (q == DAMAGE) return rheo == BBM;
  if (q < N_STATE || q == VOLUME) return true;
  if (q == THICK || q == EVP_P) return rheo != BBM;
  if (q < GRAD_SSH_U) return rheo == BBM;  // conc, cohesion, bbm_*
  if (q == VTM_U || q == VTM_V) return rheo == MEVP;
  return true;  // the 15 node coefficients
}

__host__ __device__ constexpr bool is_node(int q) { return q < SXX || q >= GRAD_SSH_U; }

// position of plane q among the planes on the tile
__host__ __device__ constexpr int plane_slot(int rheo, int q) {
  int s = 0;
  for (int i = 0; i < q; ++i) s += plane_used(rheo, i) ? 1 : 0;
  return s;
}

template <int RHEO, int Q>
constexpr int kSlot = plane_slot(RHEO, Q);

// Shared memory holds one record per point of the box: the values of all its
// planes side by side, so a value's address is the record's plus a constant
// the compiler folds into the load. A record spans an odd number of 4-byte
// words (one word of padding where the planes fill an even number), so
// neighbouring threads, on neighbouring records, fall into different banks:
// n | 1 values of 4 or 8 bytes, and for 2-byte values an even count whose
// half is odd (bbm's 30 planes fill 15 words, evp's 25 take 26 values).
template <typename T, int RHEO>
constexpr int kRecord = sizeof(T) == 2 ? ((plane_slot(RHEO, N_PLANES) + 1) / 2 | 1) * 2
                                       : plane_slot(RHEO, N_PLANES) | 1;

// The planes of member 0 and each plane's member stride (0: shared).
template <typename T>
struct Planes {
  const T* p[N_PLANES];
  long long stride[N_PLANES];
};

template <typename T>
struct StateOut {
  T* p[N_STATE];
  long long stride[N_STATE];
};

// The scalars, in the plane type's opmath type S: a Python float of the
// plain version, which torch rounds to float (for float and bfloat16 planes)
// or keeps (double).
template <typename S>
struct Coef {
  int ny, nx, pow_n, pow_half, pow_generic;
  S pow_e, r, dte;
  S min_c, lambda0, young, d0, d1, d2, compr_strength, tan_phi, mult_cap;
  S re2, ralpha1, ralpha2, delta_min;
  S cw, u0, b_mevp;
};

// NaN-propagating max/min against a scalar bound, as torch.clamp: compared
// in S, the bound rounded to the plane type where it wins
template <typename T>
__device__ __forceinline__ T vmax(T a, opmath_t<T> b) {
  const opmath_t<T> x = opmath_t<T>(a);
  return (x != x || x > b) ? a : T(b);
}
template <typename T>
__device__ __forceinline__ T vmin(T a, opmath_t<T> b) {
  const opmath_t<T> x = opmath_t<T>(a);
  return (x != x || x < b) ? a : T(b);
}

// rheology._fast_pow for the relaxation exponent: square-and-multiply in the
// same order, times sqrt(x + 1e-20) for a half-integer exponent
template <typename T>
__device__ __forceinline__ T fast_pow(T x, const Coef<opmath_t<T>>& k) {
  using S = opmath_t<T>;
  if (k.pow_generic) return vpow(x, k.pow_e);
  // the loop `for (n = pow_n; n; n >>= 1) { if (n & 1) out = have ? out * acc
  // : acc; acc *= acc; }` written out for the exponents the host allows
  // (0..8): the same products in the same order, without the loop's tests
  const T x2 = x * x, x4 = x2 * x2;
  T out;
  switch (k.pow_n) {
    case 0: out = T(1); break;
    case 1: out = x; break;
    case 2: out = x2; break;
    case 3: out = x * x2; break;
    case 4: out = x4; break;
    case 5: out = x * x4; break;
    case 6: out = x2 * x4; break;
    case 7: out = (x * x2) * x4; break;
    default: out = x4 * x4; break;  // 8
  }
  if (k.pow_half) out = out * vsqrt(x + S(1e-20));
  return out;
}

// Row and column of index idx in rows of w points, w >= 1, without the
// integer division (some 45 instructions a point): (idx + 0.5) / w lies at
// least 0.5 / w from an integer, far more than the float product's error
// for any idx a block can hold.
struct Rows {
  int w;
  float inv;
  __device__ __forceinline__ explicit Rows(int w_) : w(w_), inv(1.0f / static_cast<float>(w_)) {}
  __device__ __forceinline__ void split(int idx, int& r, int& c) const {
    r = __float2int_rz((static_cast<float>(idx) + 0.5f) * inv);
    c = idx - r * w;
  }
};

// Plane Q of the point whose record `pt` points to.
#define SM(Q) pt[kSlot<RHEO, Q>]

// One cell, `pt` its record and `row` the words of one row of records: its
// corner nodes are the records at 0, +1, +row, +row+1.
//
// Every arithmetic operator is one torch op of the plain body, rounded to
// the plane type T; a literal or a scalar of Coef is an S operand, as a
// Python float is. Bounds and thresholds that torch compares with a plane
// value are rounded to T first (T(...)), as a comparison with a Python
// scalar and torch.where with a scalar branch do.
template <typename T, int RHEO>
__device__ __forceinline__ void cell_update(T* pt, int row, const Coef<opmath_t<T>>& k) {
  using S = opmath_t<T>;
  constexpr int sw = 0, se = kRecord<T, RHEO>;
  const int nw = row, ne = row + kRecord<T, RHEO>;

  // strain rates (stencil.strain_rates)
  const T* u = pt + kSlot<RHEO, VT_U>;
  const T* v = pt + kSlot<RHEO, VT_V>;
  const T ua = u[ne] - u[sw], ub = u[se] - u[nw];
  const T va = v[ne] - v[sw], vb = v[se] - v[nw];
  const T dudx = (ua + ub) * k.r, dudy = (ua - ub) * k.r;
  const T dvdx = (va + vb) * k.r, dvdy = (va - vb) * k.r;
  const T eps11 = dudx, eps22 = dvdy, eps12 = S(0.5) * (dudy + dvdx);

  T sxx = SM(SXX), syy = SM(SYY), sxy = SM(SXY);
  if constexpr (RHEO == BBM) {
    // rheology.bbm_update_planes with the loop-invariant planes
    const T damage = SM(DAMAGE);
    const T expC = SM(BBM_EXPC);
    const bool has_ice = SM(CONC) > T(k.min_c);
    T sigma_n = S(0.5) * (sxx + syy);
    const T dmg_el = (S(1) - damage) * expC;
    const T time_viscous = k.lambda0 * fast_pow(vmax(dmg_el, S(1e-8)), k);
    const bool compressing = sigma_n < T(0);
    const T s_mag = vmax(-sigma_n, S(1e-15));
    const T s_unyielded = compressing ? vmax(s_mag - SM(BBM_PMAX), S(0)) : s_mag;
    const T tv_s = vmax(time_viscous * s_mag, S(1e-15));
    const T mult = vmin(tv_s / (tv_s + k.dte * s_unyielded), k.mult_cap);

    const T dte_e = k.dte * (k.young * dmg_el);
    sxx = (sxx + dte_e * (k.d0 * eps11 + k.d1 * eps22)) * mult;
    syy = (syy + dte_e * (k.d1 * eps11 + k.d0 * eps22)) * mult;
    sxy = (sxy + dte_e * (k.d2 * eps12)) * mult;

    const T half_diff = S(0.5) * (sxx - syy);
    const T sigma_s = vsqrt(half_diff * half_diff + sxy * sxy + S(1e-20));
    sigma_n = S(0.5) * (sxx + syy);
    const bool compressive = sigma_n < T(-k.compr_strength);
    const T dcrit_num = compressive ? T(-k.compr_strength) : SM(COHESION);
    const T dcrit_den = compressive ? vmin(sigma_n, S(-1e-15))
                                    : vmax(sigma_s + k.tan_phi * sigma_n, S(1e-15));
    const T dcrit = dcrit_num / dcrit_den;
    const bool failing = (dcrit > T(0)) && (dcrit < T(1));
    const T rtd = SM(BBM_RTD) * vsqrt(vmax(S(1) - damage, S(0)) + S(1e-20));
    const T relax = failing ? (S(1) - dcrit) * k.dte * rtd : T(0);

    T damage_new = damage + (S(1) - damage) * relax;
    sxx = sxx * (S(1) - relax);
    syy = syy * (S(1) - relax);
    sxy = sxy * (S(1) - relax);
    damage_new = vmax(damage_new - SM(BBM_HEAL), S(0));

    SM(SXX) = has_ice ? sxx : T(0);
    SM(SYY) = has_ice ? syy : T(0);
    SM(SXY) = has_ice ? sxy : T(0);
    SM(DAMAGE) = has_ice ? damage_new : T(0);
  } else {
    // rheology.vp_update_planes with the loop-invariant pressure plane
    const T eps1 = eps11 + eps22, eps2 = eps11 - eps22;
    const T delta = vsqrt(eps1 * eps1 + (eps2 * eps2 + S(4) * eps12 * eps12) * k.re2);
    const T zeta = SM(EVP_P) / (delta + k.delta_min);
    T sigma1 = sxx + syy, sigma2 = sxx - syy;
    sigma1 = sigma1 + k.ralpha1 * (zeta * (eps1 - delta) - sigma1);
    sigma2 = sigma2 + k.ralpha2 * (zeta * eps2 * k.re2 - sigma2);
    sxy = sxy + k.ralpha2 * (zeta * eps12 * k.re2 - sxy);
    sxx = S(0.5) * (sigma1 + sigma2);
    syy = S(0.5) * (sigma1 - sigma2);
    const bool has_ice = SM(THICK) > T(0);
    SM(SXX) = has_ice ? sxx : T(0);
    SM(SYY) = has_ice ? syy : T(0);
    SM(SXY) = has_ice ? sxy : T(0);
  }
}

// One node, `pt` its record: its adjacent cells are the records at -row-1,
// -row, -1, 0 (a cell outside the domain holds zero volume and zero stress).
template <typename T, int RHEO>
__device__ __forceinline__ void node_update(T* pt, int row, const Coef<opmath_t<T>>& k) {
  using S = opmath_t<T>;
  // stress divergence (stencil.stress_divergence): S = F1+F2, D = F1-F2
  T su[4], du[4], sv[4], dv[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const T* c = pt - ((q >> 1) ? 0 : row) - ((q & 1) ? 0 : kRecord<T, RHEO>);
    const T vol = c[kSlot<RHEO, VOLUME>];
    const T fxx = vol * c[kSlot<RHEO, SXX>], fyy = vol * c[kSlot<RHEO, SYY>], fxy = vol * c[kSlot<RHEO, SXY>];
    su[q] = fxx + fxy;
    du[q] = fxx - fxy;
    sv[q] = fxy + fyy;
    dv[q] = fxy - fyy;
  }
  const T gsu = -((su[0] - du[1] + du[2] - su[3]) * k.r);
  const T gsv = -((sv[0] - dv[1] + dv[2] - sv[3]) * k.r);
  const T grad_u = SM(GRAD_SSH_U) + gsu;
  const T grad_v = SM(GRAD_SSH_V) + gsv;

  // node solve
  const T uice = SM(VT_U), vice = SM(VT_V);
  T delu = T(0), delv = T(0);
  if constexpr (RHEO == MEVP) {
    // torch divides a plane by a Python scalar on the card as the product
    // with the scalar's reciprocal, taken in S
    const S rb = S(1) / k.b_mevp;
    delu = (SM(VTM_U) - uice) * rb;
    delv = (SM(VTM_V) - vice) * rb;
  }
  const T dou = SM(OCEAN_U) - uice, dov = SM(OCEAN_V) - vice;
  const T c_prime = k.cw * vsqrt(dou * dou + dov * dov + S(1e-20));
  const T tau_b = SM(C_BU) / (vsqrt(uice * uice + vice * vice + S(1e-20)) + k.u0);
  const T dom = SM(DTE_OVER_MASS);
  const T alpha = S(1) + SM(DOM_COS) * c_prime + dom * tau_b;
  const T beta = SM(BETA_COR) + SM(DOM_SIN) * c_prime;
  const T rdenom = S(1) / (alpha * alpha + beta * beta);
  const T tau_x = SM(TAU_AX) + c_prime * SM(OCN_ROT_X);
  const T tau_y = SM(TAU_AY) + c_prime * SM(OCN_ROT_Y);
  const T rlmass = SM(RLMASS);
  const T grad_x = grad_u * rlmass;
  const T grad_y = grad_v * rlmass;
  const T A = uice + dom * (grad_x + tau_x) + delu;
  const T B = vice + dom * (grad_y + tau_y) + delv;
  const bool solve = SM(SOLVE) > T(0.5);
  const T u_new = solve ? (alpha * A + beta * B) * rdenom : uice;
  const T v_new = solve ? (alpha * B - beta * A) * rdenom : vice;
  SM(VT_U) = u_new;
  SM(VT_V) = v_new;

  // total displacement
  if constexpr (RHEO != MEVP) {
    SM(UT_U) = SM(UT_U) + k.dte * u_new;
    SM(UT_V) = SM(UT_V) + k.dte * v_new;
  }
}

#undef SM

// Where point idx of the block's box lies in the domain.
struct Point {
  int gn, gc;  // offsets into a node plane and a cell plane
  bool in_node, in_cell;
  long long m;  // the member, blockIdx.z
};

template <typename T, int RHEO, int Q>
__device__ __forceinline__ void load_plane(const Planes<T>& P, T* rec, const Point& pt) {
  if constexpr (plane_used(RHEO, Q)) {
    // an asynchronous copy (cp.async) straight into shared memory: a thread
    // has all its planes' loads in flight at once, none staged in a register
    T* dst = rec + kSlot<RHEO, Q>;
    if (is_node(Q) ? pt.in_node : pt.in_cell) {
      const T* src = P.p[Q] + pt.m * P.stride[Q] + (is_node(Q) ? pt.gn : pt.gc);
      if constexpr (sizeof(T) >= 4) {
        __pipeline_memcpy_async(dst, src, sizeof(T));
      } else {  // cp.async copies no fewer than 4 bytes: a 2-byte value goes through a register
        *dst = *src;
      }
    } else {
      *dst = T(0);
    }
  }
}

template <typename T, int RHEO, int... Q>
__device__ __forceinline__ void load_planes(const Planes<T>& P, T* rec, const Point& pt,
                                            std::integer_sequence<int, Q...>) {
  (load_plane<T, RHEO, Q>(P, rec, pt), ...);
}

template <typename T, int RHEO, int Q>
__device__ __forceinline__ void store_plane(const StateOut<T>& O, const T* rec, const Point& pt) {
  if constexpr (plane_used(RHEO, Q)) {
    if (is_node(Q) || pt.in_cell) O.p[Q][pt.m * O.stride[Q] + (is_node(Q) ? pt.gn : pt.gc)] = rec[kSlot<RHEO, Q>];
  }
}

template <typename T, int RHEO, int... Q>
__device__ __forceinline__ void store_planes(const StateOut<T>& O, const T* rec, const Point& pt,
                                             std::integer_sequence<int, Q...>) {
  (store_plane<T, RHEO, Q>(O, rec, pt), ...);
}

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// ksub substeps of the block's tile of member blockIdx.z (see the header). P
// holds the state slot to read and the coefficients, O the state slot to
// write. MEMBERS = false is the build for one member: its loads and stores
// take no member offset, so a single state's launch pays nothing for the
// member axis.
template <typename T, int RHEO, int MAX_THREADS, bool MEMBERS>
__global__ void __launch_bounds__(MAX_THREADS)
blocked_substeps(Planes<T> P, StateOut<T> O, Coef<opmath_t<T>> k, int tile_h, int tile_w, int ksub) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  constexpr int R = kRecord<T, RHEO>;
  const int tid = threadIdx.x, nthr = blockDim.x;
  CLOCK(t_start);

  // the tile: nodes [j0, j1) x [i0, i1); the box: the tile and its halo
  const int j0 = blockIdx.y * tile_h, i0 = blockIdx.x * tile_w;
  const int j1 = imin(j0 + tile_h, k.ny + 1), i1 = imin(i0 + tile_w, k.nx + 1);
  const int a = j0 - ksub, c = i0 - ksub;  // the box's first row and column
  const int H = j1 - j0 + 2 * ksub, W = i1 - i0 + 2 * ksub;
  const int box = H * W;

  // load, zero outside the domain
  const Rows box_rows(W);
  for (int idx = tid; idx < box; idx += nthr) {
    int r, cc;
    box_rows.split(idx, r, cc);
    const int gj = a + r, gi = c + cc;
    Point pt;
    pt.in_node = gj >= 0 && gj <= k.ny && gi >= 0 && gi <= k.nx;
    pt.in_cell = pt.in_node && gj < k.ny && gi < k.nx;
    pt.gn = gj * (k.nx + 1) + gi;
    pt.gc = gj * k.nx + gi;
    pt.m = MEMBERS ? blockIdx.z : 0;
    load_planes<T, RHEO>(P, sm + idx * R, pt, std::make_integer_sequence<int, N_PLANES>{});
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  CLOCK(t_loaded);

  for (int s = 1; s <= ksub; ++s) {
    {  // cells: rows [a+s-1, a+H-s) of the domain's [0, ny), columns alike
      const int rlo = imax(a + s - 1, 0) - a, rhi = imin(a + H - s, k.ny) - a;
      const int clo = imax(c + s - 1, 0) - c, chi = imin(c + W - s, k.nx) - c;
      const Rows rows(imax(chi - clo, 1));
      const int n = imax(rhi - rlo, 0) * imax(chi - clo, 0);
      for (int idx = tid; idx < n; idx += nthr) {
        int lr, lc;
        rows.split(idx, lr, lc);
        cell_update<T, RHEO>(sm + ((rlo + lr) * W + clo + lc) * R, W * R, k);
      }
    }
    __syncthreads();
    {  // nodes: rows [a+s, a+H-s) of the domain's [0, ny], columns alike
      const int rlo = imax(a + s, 0) - a, rhi = imin(a + H - s, k.ny + 1) - a;
      const int clo = imax(c + s, 0) - c, chi = imin(c + W - s, k.nx + 1) - c;
      const Rows rows(imax(chi - clo, 1));
      const int n = imax(rhi - rlo, 0) * imax(chi - clo, 0);
      for (int idx = tid; idx < n; idx += nthr) {
        int lr, lc;
        rows.split(idx, lr, lc);
        node_update<T, RHEO>(sm + ((rlo + lr) * W + clo + lc) * R, W * R, k);
      }
    }
    __syncthreads();
  }

  CLOCK(t_computed);

  // store the tile
  const Rows tile_rows(i1 - i0);
  const int n = (j1 - j0) * (i1 - i0);
  for (int idx = tid; idx < n; idx += nthr) {
    int lr, lc;
    tile_rows.split(idx, lr, lc);
    const int gj = j0 + lr, gi = i0 + lc;
    Point pt;
    pt.in_node = true;
    pt.in_cell = gj < k.ny && gi < k.nx;
    pt.gn = gj * (k.nx + 1) + gi;
    pt.gc = gj * k.nx + gi;
    pt.m = MEMBERS ? blockIdx.z : 0;
    store_planes<T, RHEO>(O, sm + ((lr + ksub) * W + lc + ksub) * R, pt,
                          std::make_integer_sequence<int, N_STATE>{});
  }
#ifdef NEXTSIM_SUBSTEP_CLOCKS
  __syncthreads();
  if (tid == 0) {
    atomicAdd(&g_clocks[0], static_cast<unsigned long long>(t_loaded - t_start));
    atomicAdd(&g_clocks[1], static_cast<unsigned long long>(t_computed - t_loaded));
    atomicAdd(&g_clocks[2], static_cast<unsigned long long>(clock64() - t_computed));
    atomicAdd(&g_clocks[3], 1ull);
  }
#endif
}

template <typename T, int RHEO, int MAX_THREADS>
int run(const Planes<T>& P0, const StateOut<T>& B, const Coef<opmath_t<T>>& k, const SubstepPlan& plan,
        const int* launch_steps, cudaStream_t stream) {
  // the plan must describe this kernel's tile: a mismatch would write
  // outside the block's shared memory
  constexpr int n_planes = plane_slot(RHEO, N_PLANES);
  const long long box = static_cast<long long>(plan.tile_h + 2 * plan.halo) * (plan.tile_w + 2 * plan.halo);
  if (plan.n_planes != n_planes || plan.tile_h < 1 || plan.tile_w < 1 || plan.halo < 1 ||
      plan.threads < 1 || plan.threads > MAX_THREADS ||
      box * kRecord<T, RHEO> * static_cast<long long>(sizeof(T)) > plan.smem_bytes ||
      plan.blocks_y * plan.tile_h < k.ny + 1 || plan.blocks_x * plan.tile_w < k.nx + 1 ||
      plan.members < 1 || plan.members > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a member stride is 0 (a shared plane) or the plane's size; a state plane
  // the launches write is every member's own
  const long long node_size = static_cast<long long>(k.ny + 1) * (k.nx + 1);
  const long long cell_size = static_cast<long long>(k.ny) * k.nx;
  for (int q = 0; q < N_PLANES; ++q) {
    if (!plane_used(RHEO, q)) continue;
    const long long size = is_node(q) ? node_size : cell_size, st = P0.stride[q];
    if ((st != 0 && st != size) || (q < N_STATE && plan.members > 1 && st != size)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  auto kernel = plan.members > 1 ? blocked_substeps<T, RHEO, MAX_THREADS, true>
                                 : blocked_substeps<T, RHEO, MAX_THREADS, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);

  // slot 0 is P0's state, slot 1 is B
  Planes<T> in[2] = {P0, P0};
  StateOut<T> out[2];
  for (int q = 0; q < N_STATE; ++q) {
    in[1].p[q] = B.p[q];
    out[0].p[q] = B.p[q];                      // a launch that reads slot 0 writes slot 1
    out[1].p[q] = const_cast<T*>(P0.p[q]);     // and the other way round
    out[0].stride[q] = out[1].stride[q] = P0.stride[q];
  }
  const dim3 grid(plan.blocks_x, plan.blocks_y, plan.members);
  for (int g = 0; g < plan.n_launches; ++g) {
    const int ksub = launch_steps[g];
    if (ksub < 1 || ksub > plan.halo) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<grid, plan.threads, plan.smem_bytes, stream>>>(in[g % 2], out[g % 2], k, plan.tile_h,
                                                             plan.tile_w, ksub);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename T>
int substeps(void* const* planes, void* const* state_b, const SubstepParams* h, const SubstepPlan* plan,
             const int* launch_steps, const long long* member_stride, void* stream) {
  // fast_pow writes out the exponents 0..8, the ones the host sends
  if (!h->pow_generic && (h->pow_n < 0 || h->pow_n > 8)) return static_cast<int>(cudaErrorInvalidValue);
  Planes<T> P;
  for (int q = 0; q < N_PLANES; ++q) {
    P.p[q] = static_cast<const T*>(planes[q]);
    P.stride[q] = member_stride[q];
  }
  StateOut<T> B;
  for (int q = 0; q < N_STATE; ++q) B.p[q] = static_cast<T*>(state_b[q]);
  using S = opmath_t<T>;
  Coef<S> k;
  k.ny = h->ny;
  k.nx = h->nx;
  k.pow_n = h->pow_n;
  k.pow_half = h->pow_half;
  k.pow_generic = h->pow_generic;
  k.pow_e = S(h->pow_e);
  k.r = S(h->r);
  k.dte = S(h->dte);
  k.min_c = S(h->min_c);
  k.lambda0 = S(h->lambda0);
  k.young = S(h->young);
  k.d0 = S(h->d0);
  k.d1 = S(h->d1);
  k.d2 = S(h->d2);
  k.compr_strength = S(h->compr_strength);
  k.tan_phi = S(h->tan_phi);
  k.mult_cap = S(h->mult_cap);
  k.re2 = S(h->re2);
  k.ralpha1 = S(h->ralpha1);
  k.ralpha2 = S(h->ralpha2);
  k.delta_min = S(h->delta_min);
  k.cw = S(h->cw);
  k.u0 = S(h->u0);
  k.b_mevp = S(h->b_mevp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 1024 threads a block leave 64 registers a thread, enough in float32 and
  // bfloat16 (whose arithmetic holds floats); a float64 value takes two, so
  // float64 blocks have at most 512
  constexpr int max_threads = sizeof(T) == 8 ? 512 : 1024;
  switch (h->rheology) {
    case BBM: return run<T, BBM, max_threads>(P, B, k, *plan, launch_steps, s);
    case EVP: return run<T, EVP, max_threads>(P, B, k, *plan, launch_steps, s);
    case MEVP: return run<T, MEVP, max_threads>(P, B, k, *plan, launch_steps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int nextsim_substeps_f32(void* const* planes, void* const* state_b, const SubstepParams* p,
                                    const SubstepPlan* plan, const int* launch_steps,
                                    const long long* member_stride, void* stream) {
  return substeps<float>(planes, state_b, p, plan, launch_steps, member_stride, stream);
}

extern "C" int nextsim_substeps_f64(void* const* planes, void* const* state_b, const SubstepParams* p,
                                    const SubstepPlan* plan, const int* launch_steps,
                                    const long long* member_stride, void* stream) {
  return substeps<double>(planes, state_b, p, plan, launch_steps, member_stride, stream);
}

extern "C" int nextsim_substeps_bf16(void* const* planes, void* const* state_b, const SubstepParams* p,
                                     const SubstepPlan* plan, const int* launch_steps,
                                     const long long* member_stride, void* stream) {
  return substeps<bf16>(planes, state_b, p, plan, launch_steps, member_stride, stream);
}

extern "C" const char* nextsim_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef NEXTSIM_SUBSTEP_CLOCKS
// Copies the sums (load, compute, store, blocks) to `out` after the device
// has finished, and sets them to zero.
extern "C" int nextsim_substep_clocks(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, g_clocks, sizeof(g_clocks));
  const unsigned long long zero[4] = {0, 0, 0, 0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif
