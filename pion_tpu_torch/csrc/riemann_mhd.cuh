// MHD Riemann solvers for one interface, in the sweep frame (VX/BX normal).
//
// Device-side counterpart of pion_tpu_torch/ops/riemann_mhd.py: HLL
// (reference: HLLD_MHD.cpp:380-430), HLLD (Miyoshi & Kusano 2005; reference:
// HLLD_MHD.cpp:120-335), the per-interface HLLD->HLL fallback (Mignone et
// al. 2011), the 7-wave linear solver (riemannMHD.cpp:540-1110) and the Roe
// conserved-variable solver (Cargo & Gallice 1997; Roe_MHD_ConservedVar_
// solver.cpp, no H-correction).  Each returns the flux and the conserved
// interface state for the eight physical slots.  The plain version evaluates every region and selects
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

// riemann_mhd.linear: P* crossed from the left state over every wave of
// negative speed (and, by the contact, averaged with the one crossed from the
// right over every wave of positive speed); flux(P*) and U(P*).
template <typename T>
__device__ __forceinline__ void mhd_linear(const T (&Pl)[8], const T (&Pr)[8], const Consts<T>& c,
                                           T (&f)[8], T (&us)[8]) {
  const T tiny = T(1.0e-30);
  const T sqrt2 = T(1.4142135623730951);
  const T g = c.gamma;
  const T bx_i = T(0.5) * (Pl[BX] + Pr[BX]);
  const T rho = T(0.5) * (Pl[RO] + Pr[RO]);
  const T pg = T(0.5) * (Pl[PG] + Pr[PG]);
  const T vx = T(0.5) * (Pl[VX] + Pr[VX]);
  const T by = T(0.5) * (Pl[BY] + Pr[BY]);
  const T bz = T(0.5) * (Pl[BZ] + Pr[BZ]);
  const T sqrt_rho = sqrt(rho);

  const T a = sqrt(g * pg / rho);
  const T ca = fabs(bx_i / sqrt_rho);
  const T bt2 = (by * by + bz * bz) / rho;
  const T bt = sqrt(bt2);
  const bool degen_t = bt <= T(1.0e-12) * (a + ca + bt);
  const T bt_safe = degen_t ? T(1.0) : bt;
  const T betay = degen_t ? T(1.0) / sqrt2 : by / (sqrt_rho * bt_safe);
  const T betaz = degen_t ? T(1.0) / sqrt2 : bz / (sqrt_rho * bt_safe);

  const T t1 = a * a + ca * ca + bt2;
  const T t2 = fmax(t1 * t1 - T(4.0) * a * a * ca * ca, tiny);
  T cf = sqrt(T(0.5) * (t1 + sqrt(t2)));
  T cs = sqrt(T(0.5) * fmax(t1 - sqrt(t2), tiny));
  // ordering guards (reference: riemannMHD.cpp:695-705)
  const T small = T(1.0e-12) * a;
  cs = fmin(cs, a - small);
  cf = fmax(cf, a + small);
  cs = fmin(fmax(cs, T(0.0)), fmax(ca - small, T(0.5) * ca));
  cf = fmax(cf, ca + small);

  const T cf2_cs2 = fmax(cf * cf - cs * cs, tiny);
  const T alphaf = sqrt(fmin(fmax((a * a - cs * cs) / cf2_cs2, T(0.0)), T(1.0)));
  const T alphas = sqrt(fmin(fmax((cf * cf - a * a) / cf2_cs2, T(0.0)), T(1.0)));
  const T sbx = bx_i > T(0.0) ? T(1.0) : (bx_i < T(0.0) ? T(-1.0) : T(1.0));

  const T d_ro = Pr[RO] - Pl[RO];
  const T d_pg = Pr[PG] - Pl[PG];
  const T d_vx = Pr[VX] - Pl[VX];
  const T d_vy = Pr[VY] - Pl[VY];
  const T d_vz = Pr[VZ] - Pl[VZ];
  const T d_by = Pr[BY] - Pl[BY];
  const T d_bz = Pr[BZ] - Pl[BZ];

  const T inv2a2 = T(1.0) / (T(2.0) * a * a);
  const T dvt = betay * d_vy + betaz * d_vz;
  const T dbt = (betay * d_by + betaz * d_bz);
  const T s_fn = inv2a2 * (-alphaf * cf * d_vx + alphas * cs * sbx * dvt + alphaf * d_pg / rho
                           + alphas * a * dbt / sqrt_rho);
  const T s_fp = inv2a2 * (+alphaf * cf * d_vx - alphas * cs * sbx * dvt + alphaf * d_pg / rho
                           + alphas * a * dbt / sqrt_rho);
  const T s_sn = inv2a2 * (-alphas * cs * d_vx - alphaf * cf * sbx * dvt + alphas * d_pg / rho
                           - alphaf * a * dbt / sqrt_rho);
  const T s_sp = inv2a2 * (+alphas * cs * d_vx + alphaf * cf * sbx * dvt + alphas * d_pg / rho
                           - alphaf * a * dbt / sqrt_rho);
  const T s_an = (sbx * (betaz * d_vy - betay * d_vz) + (betaz * d_by - betay * d_bz) / sqrt_rho)
                 / sqrt2;
  const T s_ap = (sbx * (betaz * d_vy - betay * d_vz) - (betaz * d_by - betay * d_bz) / sqrt_rho)
                 / sqrt2;
  const T s_ct = d_ro - d_pg / (a * a);

  // right eigenvectors, slots (ro, pg, vx, vy, vz, by, bz), waves in order
  // of speed (reference: riemannMHD.cpp:1044-1098)
  const T fast[7] = {alphaf * rho, alphaf * rho * a * a, -alphaf * cf,
                     alphas * cs * sbx * betay, alphas * cs * sbx * betaz,
                     alphas * a * betay * sqrt_rho, alphas * a * betaz * sqrt_rho};
  const T slow[7] = {alphas * rho, alphas * rho * a * a, -alphas * cs,
                     -alphaf * cf * sbx * betay, -alphaf * cf * sbx * betaz,
                     -alphaf * a * betay * sqrt_rho, -alphaf * a * betaz * sqrt_rho};
  const T lam[7] = {vx - cf, vx - ca, vx - cs, vx, vx + cs, vx + ca, vx + cf};
  const T st[7] = {s_fn, s_an, s_sn, s_ct, s_sp, s_ap, s_fp};
  constexpr int slot[7] = {RO, PG, VX, VY, VZ, BY, BZ};
  T star_l[7], star_r[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    star_l[j] = Pl[slot[j]];
    star_r[j] = Pr[slot[j]];
  }
#pragma unroll
  for (int w = 0; w < 7; ++w) {
    T r[7];
    if (w == 0 || w == 6 || w == 2 || w == 4) {
      // fast or slow: the plus wave (w > 3) negates the velocity slots
      const T* e = (w == 0 || w == 6) ? fast : slow;
      const T sg = w < 3 ? T(1.0) : T(-1.0);
      r[0] = e[0];
      r[1] = e[1];
      r[2] = sg * e[2];
      r[3] = sg * e[3];
      r[4] = sg * e[4];
      r[5] = e[5];
      r[6] = e[6];
    } else if (w == 1 || w == 5) {
      const T sg = w == 1 ? T(1.0) : T(-1.0);
      r[0] = T(0.0);
      r[1] = T(0.0);
      r[2] = T(0.0);
      r[3] = sbx * betaz / sqrt2;
      r[4] = -sbx * betay / sqrt2;
      r[5] = sg * betaz * sqrt_rho / sqrt2;
      r[6] = sg * (-betay) * sqrt_rho / sqrt2;
    } else {
#pragma unroll
      for (int j = 0; j < 7; ++j) r[j] = j == 0 ? T(1.0) : T(0.0);
    }
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      if (lam[w] < T(0.0)) star_l[j] = star_l[j] + st[w] * r[j];
      if (lam[w] > T(0.0)) star_r[j] = star_r[j] - st[w] * r[j];
    }
  }
  // contact-straddling symmetrisation (reference: riemannMHD.cpp:884-905)
  if (fabs(vx) < T(1.0e-4) * a) {
#pragma unroll
    for (int j = 0; j < 7; ++j) star_l[j] = T(0.5) * (star_l[j] + star_r[j]);
  }
  T Ps[8];
  Ps[RO] = fmax(star_l[0], tiny);
  Ps[PG] = fmax(star_l[1], tiny);
  Ps[VX] = star_l[2];
  Ps[VY] = star_l[3];
  Ps[VZ] = star_l[4];
  Ps[BX] = bx_i;
  Ps[BY] = star_l[5];
  Ps[BZ] = star_l[6];
  prim_to_cons<T, 8>(Ps, us, c.gm1);
  flux_from_pu(Ps, us, f);
}

// riemann_mhd.roe_cv with hc_eta = None: the symmetric sum over seven waves
// of the Roe-averaged state (Cargo & Gallice's X parameter, Roe-Balsara
// normalised strengths, conserved-variable right eigenvectors); U of the Roe
// mean with p = rho a^2 / gamma.
template <typename T>
__device__ __forceinline__ void mhd_roe_cv(const T (&Pl)[8], const T (&Pr)[8], const Consts<T>& c,
                                           T (&f)[8], T (&us)[8]) {
  const T tiny = T(1.0e-30);
  const T inv_sqrt2 = T(0.7071067811865475);
  const T g = c.gamma, gm1 = c.gm1;
  const T rl = sqrt(Pl[RO]);
  const T rr = sqrt(Pr[RO]);
  const T denom = T(1.0) / (rl + rr);
  const T rho = rl * rr;
  const T sqrt_rho = sqrt(rho);
  const T vx = (rl * Pl[VX] + rr * Pr[VX]) * denom;
  const T vy = (rl * Pl[VY] + rr * Pr[VY]) * denom;
  const T vz = (rl * Pl[VZ] + rr * Pr[VZ]) * denom;
  // swapped weights for the transverse field (reference :363-364)
  const T by = (rr * Pl[BY] + rl * Pr[BY]) * denom;
  const T bz = (rr * Pl[BZ] + rl * Pr[BZ]) * denom;
  const T bx = T(0.5) * (Pl[BX] + Pr[BX]);
  const T sgn_bx = bx >= T(0.0) ? T(1.0) : T(-1.0);

  T ul[8], ur[8];
  prim_to_cons<T, 8>(Pl, ul, gm1);
  prim_to_cons<T, 8>(Pr, ur, gm1);
  const T b2l = sq(Pl[BX]) + sq(Pl[BY]) + sq(Pl[BZ]);
  const T b2r = sq(Pr[BX]) + sq(Pr[BY]) + sq(Pr[BZ]);
  const T Hl = (ul[PG] + Pl[PG] + T(0.5) * b2l) / Pl[RO];
  const T Hr = (ur[PG] + Pr[PG] + T(0.5) * b2r) / Pr[RO];
  const T H = (rl * Hl + rr * Hr) * denom;

  const T V2 = vx * vx + vy * vy + vz * vz;
  const T B = sqrt(bx * bx + by * by + bz * bz);
  const T Bt = sqrt(by * by + bz * bz);
  const bool degen = Bt < tiny;
  const T bty = degen ? inv_sqrt2 : by / Bt;
  const T btz = degen ? inv_sqrt2 : bz / Bt;

  const T du_mx = ur[VX] - ul[VX];
  const T du_my = ur[VY] - ul[VY];
  const T du_mz = ur[VZ] - ul[VZ];
  const T du_e = ur[PG] - ul[PG];
  const T d_ro = Pr[RO] - Pl[RO];
  const T d_vx = Pr[VX] - Pl[VX];
  const T d_vy = Pr[VY] - Pl[VY];
  const T d_vz = Pr[VZ] - Pl[VZ];
  const T d_by = Pr[BY] - Pl[BY];
  const T d_bz = Pr[BZ] - Pl[BZ];
  const T X = (d_by * d_by + d_bz * d_bz) * T(0.5) * denom * denom;
  const T d_pg = ((T(0.5) * V2 - X) * d_ro - (vx * du_mx + vy * du_my + vz * du_mz) + du_e
                  - (by * d_by + bz * d_bz)) * gm1;

  // wave speeds (reference: Roe_get_wavespeeds:473-560)
  const T b2 = B * B / rho;
  const T a2 = (T(2.0) - g) * X + gm1 * fmax(H - T(0.5) * V2 - b2, T(1.0e-12) * V2 + tiny);
  const T a = sqrt(a2);
  const T astar2 = a2 + b2;
  T ca = sqrt(bx * bx / rho);
  const T disc = sqrt(fmax(astar2 * astar2 - T(4.0) * a2 * ca * ca, T(0.0)));
  const T cf = sqrt(T(0.5) * (astar2 + disc));
  T cs = sqrt(T(0.5) * fmax(astar2 - disc, T(0.0)));
  ca = fmin(ca, cf);
  cs = fmin(cs, ca);
  const T cf2_cs2 = cf * cf - cs * cs;
  const bool safe = cf2_cs2 > T(1.0e-300);
  const T denom_a = safe ? cf2_cs2 : T(1.0);
  const T alphaf = safe ? sqrt(fmin(fmax(fmax(a2 - cs * cs, T(0.0)) / denom_a, T(0.0)), T(1.0)))
                        : inv_sqrt2;
  const T alphas = safe ? sqrt(fmin(fmax(fmax(cf * cf - a2, T(0.0)) / denom_a, T(0.0)), T(1.0)))
                        : inv_sqrt2;

  // wave strengths (reference: Roe_get_wavestrengths:615-670)
  const T dv_t = bty * d_vy + btz * d_vz;
  const T db_t = bty * d_by + btz * d_bz;
  const T base = X * d_ro + d_pg;
  const T st[7] = {
      T(0.5) * (alphaf * base + rho * alphas * cs * sgn_bx * dv_t - rho * alphaf * cf * d_vx
                + sqrt_rho * alphas * a * db_t),
      T(0.5) * (bty * d_vz - btz * d_vy + sgn_bx * (bty * d_bz - btz * d_by) / sqrt_rho),
      T(0.5) * (alphas * base - rho * alphaf * cf * sgn_bx * dv_t - rho * alphas * cs * d_vx
                - sqrt_rho * alphaf * a * db_t),
      (a2 - X) * d_ro - d_pg,
      T(0.5) * (alphas * base + rho * alphaf * cf * sgn_bx * dv_t + rho * alphas * cs * d_vx
                - sqrt_rho * alphaf * a * db_t),
      T(0.5) * (-bty * d_vz + btz * d_vy + sgn_bx * (bty * d_bz - btz * d_by) / sqrt_rho),
      T(0.5) * (alphaf * base - rho * alphas * cs * sgn_bx * dv_t + rho * alphaf * cf * d_vx
                + sqrt_rho * alphas * a * db_t)};
  const T lam[7] = {vx - cf, vx - ca, vx - cs, vx, vx + cs, vx + ca, vx + cf};

  // F = (F_l + F_r - sum_w |lam_w| s_w K_w) / 2; eigenvectors in conserved
  // variables, slots (rho, mx, my, mz, by, bz, E) (reference:
  // Roe_get_right_evectors:699-830)
  T fl[8], fr[8];
  flux_from_pu(Pl, ul, fl);
  flux_from_pu(Pr, ur, fr);
#pragma unroll
  for (int v = 0; v < 8; ++v) f[v] = fl[v] + fr[v];
  const T inv_a2 = T(1.0) / a2;
  const T rho_as = rho * alphas;
  const T rho_af = rho * alphaf;
  const T HB = H - B * B / rho;
  const T vdotbt = vy * bty + vz * btz;
  const T norm = T(1.0) / (rho * a2);
  constexpr int slot[7] = {RO, VX, VY, VZ, BY, BZ, PG};
#pragma unroll
  for (int w = 0; w < 7; ++w) {
    T k[7];
    if (w == 3) {
      k[0] = T(1.0) * inv_a2;
      k[1] = vx * inv_a2;
      k[2] = vy * inv_a2;
      k[3] = vz * inv_a2;
      k[4] = T(0.0) * vx * inv_a2;
      k[5] = T(0.0) * vx * inv_a2;
      k[6] = (T(0.5) * V2 + X * (g - T(2.0)) / gm1) * inv_a2;
    } else if (w == 1 || w == 5) {
      const T sg = w == 1 ? T(-1.0) : T(1.0);
      k[0] = T(0.0) * vx;
      k[1] = T(0.0) * vx;
      k[2] = sg * rho * btz;
      k[3] = -sg * rho * bty;
      k[4] = -sgn_bx * sqrt_rho * btz;
      k[5] = sgn_bx * sqrt_rho * bty;
      k[6] = sg * rho * (vy * btz - vz * bty);
    } else if (w == 2 || w == 4) {
      const T sg = w == 2 ? T(-1.0) : T(1.0);
      k[0] = rho_as * norm;
      k[1] = rho_as * (vx + sg * cs) * norm;
      k[2] = (rho_as * vy + sg * rho_af * cf * bty * sgn_bx) * norm;
      k[3] = (rho_as * vz + sg * rho_af * cf * btz * sgn_bx) * norm;
      k[4] = -sqrt_rho * alphaf * a * bty * norm;
      k[5] = -sqrt_rho * alphaf * a * btz * norm;
      k[6] = (rho_as * (HB + sg * vx * cs) + sg * rho_af * cf * sgn_bx * vdotbt
              - sqrt_rho * alphaf * a * Bt) * norm;
    } else {
      const T sg = w == 0 ? T(-1.0) : T(1.0);
      k[0] = rho_af * norm;
      k[1] = rho_af * (vx + sg * cf) * norm;
      k[2] = (rho_af * vy - sg * rho_as * cs * bty * sgn_bx) * norm;
      k[3] = (rho_af * vz - sg * rho_as * cs * btz * sgn_bx) * norm;
      k[4] = sqrt_rho * alphas * a * bty * norm;
      k[5] = sqrt_rho * alphas * a * btz * norm;
      k[6] = (rho_af * (HB + sg * vx * cf) - sg * rho_as * cs * sgn_bx * vdotbt
              + sqrt_rho * alphas * a * Bt) * norm;
    }
    const T cw = st[w] * fabs(lam[w]);
#pragma unroll
    for (int j = 0; j < 7; ++j) f[slot[j]] = f[slot[j]] + (-cw * k[j]);
  }
#pragma unroll
  for (int v = 0; v < 8; ++v) f[v] = T(0.5) * f[v];
  T Ps[8] = {rho, rho * a2 / g, vx, vy, vz, bx, by, bz};
  prim_to_cons<T, 8>(Ps, us, gm1);
}

// The configured MHD solver for one interface: HLLD with the HLL fallback
// where the interface is flagged, plain HLL, the linear solver (also for
// roe_pv) or Roe-CV.
template <typename T, int SOLVER>
__device__ __forceinline__ void riemann(const T (&Pl)[8], const T (&Pr)[8], const Consts<T>& c,
                                        bool use_hll, T (&f)[8], T (&us)[8]) {
  if constexpr (SOLVER == SOLVER_LINEAR || SOLVER == SOLVER_RPV) {
    mhd_linear(Pl, Pr, c, f, us);
  } else if constexpr (SOLVER == SOLVER_RCV) {
    mhd_roe_cv(Pl, Pr, c, f, us);
  } else {
    InterfaceCommon<T> ic;
    interface_common(Pl, Pr, c, ic);
    if (SOLVER == SOLVER_HLL || use_hll) {
      hll(ic, f, us);
    } else {
      hlld(Pl, Pr, ic, f, us);
    }
  }
}

}  // namespace pion
