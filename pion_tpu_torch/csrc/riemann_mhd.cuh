// MHD Riemann solvers for one interface, in the sweep frame (VX/BX normal).
//
// Device-side counterpart of pion_tpu_torch/ops/riemann_mhd.py: HLL
// (reference: HLLD_MHD.cpp:380-430), HLLD (Miyoshi & Kusano 2005; reference:
// HLLD_MHD.cpp:120-335) and the per-interface HLLD->HLL fallback (Mignone et
// al. 2011).  Each returns the flux and the conserved interface state for the
// eight physical slots.  The plain version evaluates every region and selects
// with masks; here one thread owns one interface, so it takes the branch.
#pragma once

#include "eqns.cuh"

namespace pion {

// Conserved states, fluxes and HLL wave-speed estimates of one interface
// (riemann_mhd._interface_common and _signal_speeds), shared by both solvers.
template <typename T>
struct InterfaceCommon {
  T ul[8], ur[8], fl[8], fr[8], sl, sr;
};

template <typename T>
__device__ __forceinline__ void interface_common(const T (&Pl)[8], const T (&Pr)[8],
                                                 const Consts<T>& c, InterfaceCommon<T>& ic) {
  prim_to_cons<T, 8>(Pl, ic.ul, c.gm1);
  prim_to_cons<T, 8>(Pr, ic.ur, c.gm1);
  flux_from_pu(Pl, ic.ul, ic.fl);
  flux_from_pu(Pr, ic.ur, ic.fr);
  const T bx = T(0.5) * (Pl[BX] + Pr[BX]);
  const T cf_l = cfast_components(Pl[RO], Pl[PG], bx, Pl[BY], Pl[BZ], c.gamma);
  const T cf_r = cfast_components(Pr[RO], Pr[PG], bx, Pr[BY], Pr[BZ], c.gamma);
  const T cmax = fmax(cf_l, cf_r);
  ic.sl = fmin(Pl[VX], Pr[VX]) - cmax;
  ic.sr = fmax(Pl[VX], Pr[VX]) + cmax;
}

// Two-wave HLL flux in the single-formula form with clamped wave speeds.
template <typename T>
__device__ __forceinline__ void hll(const InterfaceCommon<T>& ic, T (&f)[8], T (&us)[8]) {
  const T lp = fmax(ic.sr, T(0.0));
  const T lm = fmin(ic.sl, T(0.0));
  const T inv = T(1.0) / (lp - lm);
  const T c_l = lp * inv;
  const T c_r = -lm * inv;
  const T c_u = lp * lm * inv;
  const T ds = ic.sr - ic.sl;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    f[v] = c_l * ic.fl[v] + c_r * ic.fr[v] + c_u * (ic.ur[v] - ic.ul[v]);
    us[v] = (ic.sr * ic.ur[v] - ic.sl * ic.ul[v] + ic.fl[v] - ic.fr[v]) / ds;
  }
}

// One outer star state (m05 eq. 43-48) with the Bx -> 0 degeneracy guard.
template <typename T>
struct Star {
  T u[8];  // conserved star state
  T vy, vz, by, bz;
};

template <typename T>
__device__ __forceinline__ void hlld_star(const T (&PK)[8], const T (&uK)[8], T sK, T sK_vK, T ptK,
                                          T sm, T pts, T bx, Star<T>& s) {
  const T tiny = T(1.0e-30);
  const T sK_sm = sK - sm;
  const T inv_sK_sm = T(1.0) / sK_sm;
  const T rho_s = PK[RO] * sK_vK * inv_sK_sm;
  const T dd = PK[RO] * sK_vK * sK_sm - bx * bx;
  const bool degenerate = fabs(dd) < tiny * (PK[RO] * sK_vK * sK_vK + bx * bx + tiny);
  const T inv_dd = T(1.0) / (degenerate ? T(1.0) : dd);
  const T fac_v = bx * (sm - PK[VX]) * inv_dd;
  s.vy = degenerate ? PK[VY] : PK[VY] - PK[BY] * fac_v;
  s.vz = degenerate ? PK[VZ] : PK[VZ] - PK[BZ] * fac_v;
  const T fac_b = (PK[RO] * sK_vK * sK_vK - bx * bx) * inv_dd;
  s.by = degenerate ? PK[BY] : PK[BY] * fac_b;
  s.bz = degenerate ? PK[BZ] : PK[BZ] * fac_b;
  const T vdotb_K = PK[VX] * bx + PK[VY] * PK[BY] + PK[VZ] * PK[BZ];
  const T vdotb_s = sm * bx + s.vy * s.by + s.vz * s.bz;
  const T e_s = (sK_vK * uK[PG] - ptK * PK[VX] + pts * sm + bx * (vdotb_K - vdotb_s)) * inv_sK_sm;
  s.u[RO] = rho_s;
  s.u[PG] = e_s;
  s.u[VX] = rho_s * sm;
  s.u[VY] = rho_s * s.vy;
  s.u[VZ] = rho_s * s.vz;
  s.u[BX] = bx;
  s.u[BY] = s.by;
  s.u[BZ] = s.bz;
}

// HLLD five-wave solver.
template <typename T>
__device__ __forceinline__ void hlld(const T (&Pl)[8], const T (&Pr)[8],
                                     const InterfaceCommon<T>& ic, T (&f)[8], T (&us)[8]) {
  const T bx = T(0.5) * (Pl[BX] + Pr[BX]);
  const T sl = ic.sl, sr = ic.sr;

  const T ptl = Pl[PG] + T(0.5) * (bx * bx + sq(Pl[BY]) + sq(Pl[BZ]));
  const T ptr = Pr[PG] + T(0.5) * (bx * bx + sq(Pr[BY]) + sq(Pr[BZ]));
  const T sl_vl = sl - Pl[VX];
  const T sr_vr = sr - Pr[VX];
  const T inv_denom = T(1.0) / (sr_vr * Pr[RO] - sl_vl * Pl[RO]);
  // entropy-wave speed S_M (m05 eq. 38) and star-region total pressure (eq. 41)
  const T sm = (sr_vr * ic.ur[VX] - sl_vl * ic.ul[VX] - ptr + ptl) * inv_denom;
  const T pts = (sr_vr * Pr[RO] * ptl - sl_vl * Pl[RO] * ptr
                 + Pl[RO] * Pr[RO] * sr_vr * sl_vl * (Pr[VX] - Pl[VX])) * inv_denom;

  Star<T> L, R;
  hlld_star(Pl, ic.ul, sl, sl_vl, ptl, sm, pts, bx, L);
  hlld_star(Pr, ic.ur, sr, sr_vr, ptr, sm, pts, bx, R);

  // Alfven-wave speeds in the star region (m05 eq. 51)
  const T sqrt_rls = sqrt(L.u[RO]);
  const T sqrt_rrs = sqrt(R.u[RO]);
  const T sls = sm - fabs(bx) / sqrt_rls;
  const T srs = sm + fabs(bx) / sqrt_rrs;

  if (sl > T(0.0)) {
#pragma unroll
    for (int v = 0; v < 8; ++v) { f[v] = ic.fl[v]; us[v] = ic.ul[v]; }
    return;
  }
  if (sls >= T(0.0)) {
#pragma unroll
    for (int v = 0; v < 8; ++v) { f[v] = ic.fl[v] + sl * (L.u[v] - ic.ul[v]); us[v] = L.u[v]; }
    return;
  }
  const bool right_outer = !(sm >= T(0.0)) && !(srs >= T(0.0));
  if (right_outer) {
    if (sr >= T(0.0)) {
#pragma unroll
      for (int v = 0; v < 8; ++v) { f[v] = ic.fr[v] + sr * (R.u[v] - ic.ur[v]); us[v] = R.u[v]; }
    } else {
#pragma unroll
      for (int v = 0; v < 8; ++v) { f[v] = ic.fr[v]; us[v] = ic.ur[v]; }
    }
    return;
  }

  // double-star states (m05 eq. 59-63); sign(0) := +1
  const T sgn_bx = bx > T(0.0) ? T(1.0) : (bx < T(0.0) ? T(-1.0) : (bx == T(0.0) ? T(1.0) : bx));
  const T inv_ssum = T(1.0) / (sqrt_rls + sqrt_rrs);
  const T sqrt_rlrs = sqrt_rls * sqrt_rrs;
  const T vy_ss = (sqrt_rls * L.vy + sqrt_rrs * R.vy + (R.by - L.by) * sgn_bx) * inv_ssum;
  const T vz_ss = (sqrt_rls * L.vz + sqrt_rrs * R.vz + (R.bz - L.bz) * sgn_bx) * inv_ssum;
  const T by_ss = (sqrt_rls * R.by + sqrt_rrs * L.by + sqrt_rlrs * (R.vy - L.vy) * sgn_bx) * inv_ssum;
  const T bz_ss = (sqrt_rls * R.bz + sqrt_rrs * L.bz + sqrt_rlrs * (R.vz - L.vz) * sgn_bx) * inv_ssum;
  const T vdotb_ss = sm * bx + vy_ss * by_ss + vz_ss * bz_ss;

  T uss[8];
  if (sm >= T(0.0)) {
    const T rho = L.u[RO];
    const T vdotb_s = sm * bx + L.vy * L.by + L.vz * L.bz;
    uss[RO] = rho;
    uss[PG] = L.u[PG] + T(-1.0) * sqrt_rls * (vdotb_s - vdotb_ss) * sgn_bx;
    uss[VX] = rho * sm;
    uss[VY] = rho * vy_ss;
    uss[VZ] = rho * vz_ss;
    uss[BX] = bx;
    uss[BY] = by_ss;
    uss[BZ] = bz_ss;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      f[v] = ic.fl[v] + sls * uss[v] - (sls - sl) * L.u[v] - sl * ic.ul[v];
      us[v] = uss[v];
    }
  } else {
    const T rho = R.u[RO];
    const T vdotb_s = sm * bx + R.vy * R.by + R.vz * R.bz;
    uss[RO] = rho;
    uss[PG] = R.u[PG] + T(1.0) * sqrt_rrs * (vdotb_s - vdotb_ss) * sgn_bx;
    uss[VX] = rho * sm;
    uss[VY] = rho * vy_ss;
    uss[VZ] = rho * vz_ss;
    uss[BX] = bx;
    uss[BY] = by_ss;
    uss[BZ] = bz_ss;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      f[v] = ic.fr[v] + srs * uss[v] - (srs - sr) * R.u[v] - sr * ic.ur[v];
      us[v] = uss[v];
    }
  }
}

// The configured solver for one interface: HLLD with the HLL fallback where
// the interface is flagged, or plain HLL.
template <typename T, int SOLVER>
__device__ __forceinline__ void riemann(const T (&Pl)[8], const T (&Pr)[8], const Consts<T>& c,
                                        bool use_hll, T (&f)[8], T (&us)[8]) {
  InterfaceCommon<T> ic;
  interface_common(Pl, Pr, c, ic);
  if (SOLVER == SOLVER_HLL || use_hll) {
    hll(ic, f, us);
  } else {
    hlld(Pl, Pr, ic, f, us);
  }
}

}  // namespace pion
