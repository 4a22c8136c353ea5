// Momentum substep loop for NVIDIA Hopper (sm_90a): the CUDA counterpart of
// the blocked Pallas kernel nextsim_tpu/ops/momentum_pallas.py
// (substep_loop_blocked / _kernel), which runs `steps` substeps of
// nextsim_tpu/ops/momentum.py:_build_substep for bbm, evp or mevp.
//
// What it computes, per substep (the same formulas, term order and float32
// guards as nextsim_tpu_torch/ops/momentum.py:_build_substep):
//   cell stage  strain rates from the 4 corner velocities, then the BBM
//               stress/damage update (rheology.bbm_update_planes) or the
//               (m)EVP update (rheology.vp_update_planes), in place on
//               sxx, syy, sxy, damage;
//   node stage  stress divergence from the 4 adjacent cells (zero outside),
//               the 2x2 implicit-drag node solve and the displacement
//               ut += dte*vt (not for mevp), in place on vt and ut.
// Neither stage reads a plane it writes at another index, so the in-place
// updates are race-free; the launch boundary on one stream is the grid-wide
// barrier between the stages.
//
// What bounds it on an H100: memory traffic. A substep reads ~30 planes and
// writes 8, at ~1 flop per byte, far below the card's ~20 flop/byte balance
// in float32. At 464^2 a substep's working set (~26 MB) fits in the 50 MB L2,
// so the planes stream from L2 rather than HBM; at 1216^2 (~180 MB) they
// stream from HBM. This first design is the simple, correct one: one thread
// per cell or node, coalesced row-major accesses, and no blocking. The TPU
// kernel's trick -- K substeps per residency of a row strip with a K-row halo
// in fast memory -- maps onto shared-memory tiles with a halo and is left to
// later performance work, as are fusing the two stages and CUDA graphs.
//
// Built with --fmad=false: no multiply-add contraction, so the kernel
// rounds exactly like the eager PyTorch version of the same body (which
// never contracts). The BBM failure branch amplifies a one-ulp difference
// into visible ones, and the plain version is the kernel's oracle.
//
// Plain C interface, loaded with ctypes by ops/momentum_cuda.py:
//   int nextsim_substeps_f32(void* const* planes, const SubstepParams* p, void* stream)
//   int nextsim_substeps_f64(...)
// issue all 2*steps launches on the given stream, check cudaGetLastError()
// after each, and return the first error (0 on success).

#include <cuda_runtime.h>

namespace {

// Plane order: must match momentum_cuda._PLANES.
enum Plane {
  // carried state, updated in place
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

namespace {

template <typename T>
struct Planes {
  T* p[N_PLANES];
};

template <typename T>
struct Coef {
  int ny, nx, pow_n, pow_half, pow_generic;
  T pow_e, r, dte;
  T min_c, lambda0, young, d0, d1, d2, compr_strength, tan_phi, mult_cap;
  T re2, ralpha1, ralpha2, delta_min;
  T cw, u0, b_mevp;
};

// NaN-propagating max/min, as torch.clamp / jnp.maximum
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return (a != a || a > b) ? a : b; }
template <typename T>
__device__ __forceinline__ T vmin(T a, T b) { return (a != a || a < b) ? a : b; }

// rheology._fast_pow for the relaxation exponent: square-and-multiply in the
// same order, times sqrt(x + 1e-20) for a half-integer exponent
template <typename T>
__device__ __forceinline__ T fast_pow(T x, const Coef<T>& k) {
  if (k.pow_generic) return pow(x, k.pow_e);
  T out = T(1);
  bool have = false;
  T acc = x;
  for (int n = k.pow_n; n; n >>= 1) {
    if (n & 1) {
      out = have ? out * acc : acc;
      have = true;
    }
    acc = acc * acc;
  }
  if (k.pow_half) out = out * sqrt(x + T(1e-20));
  return out;
}

template <typename T, int RHEO>
__global__ void cell_stage(Planes<T> P, Coef<T> k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= k.nx || j >= k.ny) return;
  const int c = j * k.nx + i;
  const int sw = j * (k.nx + 1) + i, se = sw + 1, nw = sw + k.nx + 1, ne = nw + 1;

  // strain rates (stencil.strain_rates)
  const T* u = P.p[VT_U];
  const T* v = P.p[VT_V];
  const T ua = u[ne] - u[sw], ub = u[se] - u[nw];
  const T va = v[ne] - v[sw], vb = v[se] - v[nw];
  const T dudx = (ua + ub) * k.r, dudy = (ua - ub) * k.r;
  const T dvdx = (va + vb) * k.r, dvdy = (va - vb) * k.r;
  const T eps11 = dudx, eps22 = dvdy, eps12 = T(0.5) * (dudy + dvdx);

  T sxx = P.p[SXX][c], syy = P.p[SYY][c], sxy = P.p[SXY][c];
  if (RHEO == BBM) {
    // rheology.bbm_update_planes with the loop-invariant planes
    const T damage = P.p[DAMAGE][c];
    const T expC = P.p[BBM_EXPC][c];
    const bool has_ice = P.p[CONC][c] > k.min_c;
    T sigma_n = T(0.5) * (sxx + syy);
    const T dmg_el = (T(1) - damage) * expC;
    const T time_viscous = k.lambda0 * fast_pow(vmax(dmg_el, T(1e-8)), k);
    const bool compressing = sigma_n < T(0);
    const T s_mag = vmax(-sigma_n, T(1e-15));
    const T s_unyielded = compressing ? vmax(s_mag - P.p[BBM_PMAX][c], T(0)) : s_mag;
    const T tv_s = vmax(time_viscous * s_mag, T(1e-15));
    const T mult = vmin(tv_s / (tv_s + k.dte * s_unyielded), k.mult_cap);

    const T dte_e = k.dte * (k.young * dmg_el);
    sxx = (sxx + dte_e * (k.d0 * eps11 + k.d1 * eps22)) * mult;
    syy = (syy + dte_e * (k.d1 * eps11 + k.d0 * eps22)) * mult;
    sxy = (sxy + dte_e * (k.d2 * eps12)) * mult;

    const T half_diff = T(0.5) * (sxx - syy);
    const T sigma_s = sqrt(half_diff * half_diff + sxy * sxy + T(1e-20));
    sigma_n = T(0.5) * (sxx + syy);
    const bool compressive = sigma_n < -k.compr_strength;
    const T dcrit_num = compressive ? -k.compr_strength : P.p[COHESION][c];
    const T dcrit_den = compressive ? vmin(sigma_n, T(-1e-15))
                                    : vmax(sigma_s + k.tan_phi * sigma_n, T(1e-15));
    const T dcrit = dcrit_num / dcrit_den;
    const bool failing = (dcrit > T(0)) && (dcrit < T(1));
    const T rtd = P.p[BBM_RTD][c] * sqrt(vmax(T(1) - damage, T(0)) + T(1e-20));
    const T relax = failing ? (T(1) - dcrit) * k.dte * rtd : T(0);

    T damage_new = damage + (T(1) - damage) * relax;
    sxx = sxx * (T(1) - relax);
    syy = syy * (T(1) - relax);
    sxy = sxy * (T(1) - relax);
    damage_new = vmax(damage_new - P.p[BBM_HEAL][c], T(0));

    P.p[SXX][c] = has_ice ? sxx : T(0);
    P.p[SYY][c] = has_ice ? syy : T(0);
    P.p[SXY][c] = has_ice ? sxy : T(0);
    P.p[DAMAGE][c] = has_ice ? damage_new : T(0);
  } else {
    // rheology.vp_update_planes with the loop-invariant pressure plane
    const T eps1 = eps11 + eps22, eps2 = eps11 - eps22;
    const T delta = sqrt(eps1 * eps1 + (eps2 * eps2 + T(4) * eps12 * eps12) * k.re2);
    const T zeta = P.p[EVP_P][c] / (delta + k.delta_min);
    T sigma1 = sxx + syy, sigma2 = sxx - syy;
    sigma1 = sigma1 + k.ralpha1 * (zeta * (eps1 - delta) - sigma1);
    sigma2 = sigma2 + k.ralpha2 * (zeta * eps2 * k.re2 - sigma2);
    sxy = sxy + k.ralpha2 * (zeta * eps12 * k.re2 - sxy);
    sxx = T(0.5) * (sigma1 + sigma2);
    syy = T(0.5) * (sigma1 - sigma2);
    const bool has_ice = P.p[THICK][c] > T(0);
    P.p[SXX][c] = has_ice ? sxx : T(0);
    P.p[SYY][c] = has_ice ? syy : T(0);
    P.p[SXY][c] = has_ice ? sxy : T(0);
  }
}

template <typename T, int RHEO>
__global__ void node_stage(Planes<T> P, Coef<T> k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i > k.nx || j > k.ny) return;
  const int n = j * (k.nx + 1) + i;

  // stress divergence (stencil.stress_divergence): node (j,i) reads cells
  // (j-1,i-1), (j-1,i), (j,i-1), (j,i); S = F1+F2, D = F1-F2, zero outside
  T su[4], du[4], sv[4], dv[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int cj = j - 1 + (q >> 1), ci = i - 1 + (q & 1);
    su[q] = du[q] = sv[q] = dv[q] = T(0);
    if (cj >= 0 && cj < k.ny && ci >= 0 && ci < k.nx) {
      const int c = cj * k.nx + ci;
      const T vol = P.p[VOLUME][c];
      const T fxx = vol * P.p[SXX][c], fyy = vol * P.p[SYY][c], fxy = vol * P.p[SXY][c];
      su[q] = fxx + fxy;
      du[q] = fxx - fxy;
      sv[q] = fxy + fyy;
      dv[q] = fxy - fyy;
    }
  }
  const T gsu = -((su[0] - du[1] + du[2] - su[3]) * k.r);
  const T gsv = -((sv[0] - dv[1] + dv[2] - sv[3]) * k.r);
  const T grad_u = P.p[GRAD_SSH_U][n] + gsu;
  const T grad_v = P.p[GRAD_SSH_V][n] + gsv;

  // node solve
  const T uice = P.p[VT_U][n], vice = P.p[VT_V][n];
  T delu = T(0), delv = T(0);
  if (RHEO == MEVP) {
    delu = (P.p[VTM_U][n] - uice) / k.b_mevp;
    delv = (P.p[VTM_V][n] - vice) / k.b_mevp;
  }
  const T dou = P.p[OCEAN_U][n] - uice, dov = P.p[OCEAN_V][n] - vice;
  const T c_prime = k.cw * sqrt(dou * dou + dov * dov + T(1e-20));
  const T tau_b = P.p[C_BU][n] / (sqrt(uice * uice + vice * vice + T(1e-20)) + k.u0);
  const T dom = P.p[DTE_OVER_MASS][n];
  const T alpha = T(1) + P.p[DOM_COS][n] * c_prime + dom * tau_b;
  const T beta = P.p[BETA_COR][n] + P.p[DOM_SIN][n] * c_prime;
  const T rdenom = T(1) / (alpha * alpha + beta * beta);
  const T tau_x = P.p[TAU_AX][n] + c_prime * P.p[OCN_ROT_X][n];
  const T tau_y = P.p[TAU_AY][n] + c_prime * P.p[OCN_ROT_Y][n];
  const T grad_x = grad_u * P.p[RLMASS][n];
  const T grad_y = grad_v * P.p[RLMASS][n];
  const T A = uice + dom * (grad_x + tau_x) + delu;
  const T B = vice + dom * (grad_y + tau_y) + delv;
  const bool solve = P.p[SOLVE][n] > T(0.5);
  const T u_new = solve ? (alpha * A + beta * B) * rdenom : uice;
  const T v_new = solve ? (alpha * B - beta * A) * rdenom : vice;
  P.p[VT_U][n] = u_new;
  P.p[VT_V][n] = v_new;

  // total displacement
  if (RHEO != MEVP) {
    P.p[UT_U][n] = P.p[UT_U][n] + k.dte * u_new;
    P.p[UT_V][n] = P.p[UT_V][n] + k.dte * v_new;
  }
}

template <typename T, int RHEO>
int run(const Planes<T>& P, const Coef<T>& k, int steps, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 cells((k.nx + block.x - 1) / block.x, (k.ny + block.y - 1) / block.y);
  const dim3 nodes((k.nx + block.x) / block.x, (k.ny + block.y) / block.y);
  for (int s = 0; s < steps; ++s) {
    cell_stage<T, RHEO><<<cells, block, 0, stream>>>(P, k);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    node_stage<T, RHEO><<<nodes, block, 0, stream>>>(P, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename T>
int substeps(void* const* planes, const SubstepParams* h, void* stream) {
  Planes<T> P;
  for (int q = 0; q < N_PLANES; ++q) P.p[q] = static_cast<T*>(planes[q]);
  Coef<T> k;
  k.ny = h->ny;
  k.nx = h->nx;
  k.pow_n = h->pow_n;
  k.pow_half = h->pow_half;
  k.pow_generic = h->pow_generic;
  k.pow_e = T(h->pow_e);
  k.r = T(h->r);
  k.dte = T(h->dte);
  k.min_c = T(h->min_c);
  k.lambda0 = T(h->lambda0);
  k.young = T(h->young);
  k.d0 = T(h->d0);
  k.d1 = T(h->d1);
  k.d2 = T(h->d2);
  k.compr_strength = T(h->compr_strength);
  k.tan_phi = T(h->tan_phi);
  k.mult_cap = T(h->mult_cap);
  k.re2 = T(h->re2);
  k.ralpha1 = T(h->ralpha1);
  k.ralpha2 = T(h->ralpha2);
  k.delta_min = T(h->delta_min);
  k.cw = T(h->cw);
  k.u0 = T(h->u0);
  k.b_mevp = T(h->b_mevp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (h->rheology) {
    case BBM: return run<T, BBM>(P, k, h->steps, s);
    case EVP: return run<T, EVP>(P, k, h->steps, s);
    case MEVP: return run<T, MEVP>(P, k, h->steps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int nextsim_substeps_f32(void* const* planes, const SubstepParams* p, void* stream) {
  return substeps<float>(planes, p, stream);
}

extern "C" int nextsim_substeps_f64(void* const* planes, const SubstepParams* p, void* stream) {
  return substeps<double>(planes, p, stream);
}

extern "C" const char* nextsim_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
