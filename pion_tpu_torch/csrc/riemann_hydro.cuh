// Euler Riemann solvers for one interface, in the sweep frame (VX normal).
//
// Device-side counterpart of pion_tpu_torch/ops/riemann_hydro.py for the
// solvers the kernels take: HLL (reference: HLL_hydro.cpp:92-161), the
// linearised primitive-variable solver about the arithmetic mean (riemann.cpp
// linear solver), the Roe conserved-variable solver (Roe_Hydro_ConservedVar_
// solver.cpp; Toro 11.2.2; no H-correction) and the Roe-mean
// primitive-variable solver (Roe_Hydro_PrimitiveVar_solver.cpp).  Each returns
// the flux and the full primitive interface state P* of the five base slots
// -- Falle viscosity for the Euler system reads the sound speed of P*, so the
// state is never cut short as the MHD branch's is.  The plain versions select
// with masks; here one thread owns one interface, so it takes the branch.
#pragma once

#include "eqns.cuh"

namespace pion {

template <typename T>
__device__ __forceinline__ T sound_speed(const T (&P)[5], T gamma) {
  return sqrt(gamma * P[PG] / P[RO]);
}

// riemann_hydro.hll: the mid-state flux between the two-wave speeds, and
// ustar converted with the Euler floors.
template <typename T>
__device__ __forceinline__ void hll_euler(const T (&Pl)[5], const T (&Pr)[5], const Consts<T>& c,
                                          T (&f)[5], T (&ps)[5]) {
  T ul[5], ur[5], fl[5], fr[5];
  prim_to_cons<T, 5>(Pl, ul, c.gm1);
  prim_to_cons<T, 5>(Pr, ur, c.gm1);
  flux_from_prim<T, 5>(Pl, fl, c.gm1);
  flux_from_prim<T, 5>(Pr, fr, c.gm1);
  const T cmax = fmax(sound_speed(Pl, c.gamma), sound_speed(Pr, c.gamma));
  const T sl = fmin(Pl[VX], Pr[VX]) - cmax;
  const T sr = fmax(Pl[VX], Pr[VX]) + cmax;
  const T ds = sr - sl;
  const T srsl = sr * sl;
  T us[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    if (sl > T(0.0)) {
      f[v] = fl[v];
    } else if (sr < T(0.0)) {
      f[v] = fr[v];
    } else {
      f[v] = (sr * fl[v] - sl * fr[v] + srsl * (ur[v] - ul[v])) / ds;
    }
    us[v] = (sr * ur[v] - sl * ul[v] + fl[v] - fr[v]) / ds;
  }
  cons_to_prim<T, 5>(us, ps, c);
}

// riemann_hydro.linear_pv: p*, v* of the linearised characteristic
// equations about the arithmetic mean, rho* one-sided, sampled at x/t = 0.
template <typename T>
__device__ __forceinline__ void linear_pv(const T (&Pl)[5], const T (&Pr)[5], const Consts<T>& c,
                                          T (&f)[5], T (&ps)[5]) {
  const T small = T(1.0e-12);
  const T cl = sound_speed(Pl, c.gamma);
  const T cr = sound_speed(Pr, c.gamma);
  const T rho_av = T(0.5) * (Pl[RO] + Pr[RO]);
  const T c_av = T(0.5) * (cl + cr);
  const T rc = rho_av * c_av;
  T pstar = T(0.5) * (Pl[PG] + Pr[PG]) - T(0.5) * (Pr[VX] - Pl[VX]) * rc;
  pstar = fmax(pstar, small * (Pl[PG] + Pr[PG]));
  const T vstar = T(0.5) * (Pl[VX] + Pr[VX]) - T(0.5) * (Pr[PG] - Pl[PG]) / rc;
  const bool left = vstar >= T(0.0);
  const T PK_ro = left ? Pl[RO] : Pr[RO];
  const T PK_pg = left ? Pl[PG] : Pr[PG];
  T rho_star = PK_ro + (pstar - PK_pg) / (c_av * c_av);
  rho_star = fmax(rho_star, small * rho_av);
  // supersonic: the upstream state itself
  const bool sup_l = Pl[VX] - cl > T(0.0);
  const bool sup_r = Pr[VX] + cr < T(0.0);
  ps[RO] = sup_l ? Pl[RO] : (sup_r ? Pr[RO] : rho_star);
  ps[PG] = sup_l ? Pl[PG] : (sup_r ? Pr[PG] : pstar);
  ps[VX] = sup_l ? Pl[VX] : (sup_r ? Pr[VX] : vstar);
  ps[VY] = left ? Pl[VY] : Pr[VY];
  ps[VZ] = left ? Pl[VZ] : Pr[VZ];
  flux_from_prim<T, 5>(ps, f, c.gm1);
}

// riemann_hydro.roe_cv with hc_eta = None: the symmetric sum over the five
// waves of the Roe-averaged state; P* is the Roe mean with p from H.
template <typename T>
__device__ __forceinline__ void roe_cv_euler(const T (&Pl)[5], const T (&Pr)[5],
                                             const Consts<T>& c, T (&f)[5], T (&ps)[5]) {
  const T g = c.gamma, gm1 = c.gm1;
  const T rl = sqrt(Pl[RO]);
  const T rr = sqrt(Pr[RO]);
  const T denom = T(1.0) / (rl + rr);
  const T v2l = sq(Pl[VX]) + sq(Pl[VY]) + sq(Pl[VZ]);
  const T v2r = sq(Pr[VX]) + sq(Pr[VY]) + sq(Pr[VZ]);
  const T Hl = T(0.5) * v2l + g * Pl[PG] / gm1 / Pl[RO];
  const T Hr = T(0.5) * v2r + g * Pr[PG] / gm1 / Pr[RO];
  const T rho_m = rl * rr;
  const T vx = (rl * Pl[VX] + rr * Pr[VX]) * denom;
  const T vy = (rl * Pl[VY] + rr * Pr[VY]) * denom;
  const T vz = (rl * Pl[VZ] + rr * Pr[VZ]) * denom;
  const T H = (rl * Hl + rr * Hr) * denom;
  const T v2 = vx * vx + vy * vy + vz * vz;
  // 1e-300 underflows to 0 in float, as in the plain version
  const T a = sqrt(gm1 * fmax(H - T(0.5) * v2, T(1.0e-12) * v2 + T(1.0e-300)));

  T ul[5], ur[5], ud[5];
  prim_to_cons<T, 5>(Pl, ul, gm1);
  prim_to_cons<T, 5>(Pr, ur, gm1);
#pragma unroll
  for (int v = 0; v < 5; ++v) ud[v] = ur[v] - ul[v];
  // wave strengths (Toro eq. 11.68-70)
  const T s2 = ud[VY] - vy * ud[RO];
  const T s3 = ud[VZ] - vz * ud[RO];
  const T u5bar = ud[PG] - s2 * vy - s3 * vz;
  const T s1 = (ud[RO] * (H - vx * vx) + vx * ud[VX] - u5bar) * gm1 / (a * a);
  const T s0 = T(0.5) * (ud[RO] * (vx + a) - ud[VX] - a * s1) / a;
  const T s4 = ud[RO] - s0 - s1;

  T fl[5], fr[5];
  flux_from_prim<T, 5>(Pl, fl, gm1);
  flux_from_prim<T, 5>(Pr, fr, gm1);
#pragma unroll
  for (int v = 0; v < 5; ++v) f[v] = fl[v] + fr[v];
  // right eigenvectors (Toro eq. 11.59), slots (rho, E, mx, my, mz)
  const T K[5][5] = {
      {T(1.0), H - vx * a, vx - a, vy, vz},
      {T(1.0), T(0.5) * v2, vx, vy, vz},
      {T(0.0), vy, T(0.0), T(1.0), T(0.0)},
      {T(0.0), vz, T(0.0), T(0.0), T(1.0)},
      {T(1.0), H + vx * a, vx + a, vy, vz}};
  const T s[5] = {s0, s1, s2, s3, s4};
  const T lam[5] = {vx - a, vx, vx, vx, vx + a};
#pragma unroll
  for (int w = 0; w < 5; ++w) {
    const T sa = s[w] * fabs(lam[w]);
#pragma unroll
    for (int v = 0; v < 5; ++v) f[v] = f[v] - sa * K[w][v];
  }
#pragma unroll
  for (int v = 0; v < 5; ++v) f[v] = T(0.5) * f[v];
  ps[RO] = rho_m;
  ps[PG] = (H - T(0.5) * v2) * rho_m * gm1 / g;
  ps[VX] = vx;
  ps[VY] = vy;
  ps[VZ] = vz;
}

// Enthalpy per unit mass of a primitive state.
template <typename T>
__device__ __forceinline__ T enthalpy(const T (&P)[5], T g, T gm1) {
  const T v2 = sq(P[VX]) + sq(P[VY]) + sq(P[VZ]);
  return T(0.5) * v2 + g * P[PG] / (gm1 * P[RO]);
}

// riemann_hydro.roe_pv: the two-characteristic linearisation about the
// Roe-averaged state, supersonic pass-through on the mean eigenvalues.
template <typename T>
__device__ __forceinline__ void roe_pv(const T (&Pl)[5], const T (&Pr)[5], const Consts<T>& c,
                                       T (&f)[5], T (&ps)[5]) {
  const T g = c.gamma, gm1 = c.gm1;
  const T small = T(1.0e-12);
  const T rl = sqrt(Pl[RO]);
  const T rr = sqrt(Pr[RO]);
  const T den = T(1.0) / (rl + rr);
  const T rho_m = rl * rr;
  const T vx_m = (rl * Pl[VX] + rr * Pr[VX]) * den;
  const T vy_m = (rl * Pl[VY] + rr * Pr[VY]) * den;
  const T vz_m = (rl * Pl[VZ] + rr * Pr[VZ]) * den;
  const T H = (rl * enthalpy(Pl, g, gm1) + rr * enthalpy(Pr, g, gm1)) * den;
  const T v2_m = vx_m * vx_m + vy_m * vy_m + vz_m * vz_m;
  const T a = sqrt(fmax(gm1 * (H - T(0.5) * v2_m),
                        small * (Pl[PG] + Pr[PG]) / (Pl[RO] + Pr[RO])));
  T pstar = T(0.5) * (Pl[PG] + Pr[PG] - rho_m * a * (Pr[VX] - Pl[VX]));
  pstar = fmax(pstar, small * (Pl[PG] + Pr[PG]));
  const T vstar = T(0.5) * (Pl[VX] + Pr[VX] - (Pr[PG] - Pl[PG]) / (rho_m * a));
  const bool left = vstar > T(0.0);
  T rho_star = left ? Pl[RO] + rho_m * (Pl[VX] - vstar) / a
                    : Pr[RO] + rho_m * (vstar - Pr[VX]) / a;
  rho_star = fmax(rho_star, small * rho_m);
  const bool sup_l = vx_m - a >= T(0.0);
  const bool sup_r = vx_m + a <= T(0.0);
  ps[RO] = sup_l ? Pl[RO] : (sup_r ? Pr[RO] : rho_star);
  ps[PG] = sup_l ? Pl[PG] : (sup_r ? Pr[PG] : pstar);
  ps[VX] = sup_l ? Pl[VX] : (sup_r ? Pr[VX] : vstar);
  ps[VY] = sup_l ? Pl[VY] : (sup_r ? Pr[VY] : (left ? Pl[VY] : Pr[VY]));
  ps[VZ] = sup_l ? Pl[VZ] : (sup_r ? Pr[VZ] : (left ? Pl[VZ] : Pr[VZ]));
  flux_from_prim<T, 5>(ps, f, gm1);
}

// The configured Euler solver for one interface: flux and P*.
template <typename T, int SOLVER>
__device__ __forceinline__ void riemann_hydro(const T (&Pl)[5], const T (&Pr)[5],
                                              const Consts<T>& c, T (&f)[5], T (&ps)[5]) {
  if constexpr (SOLVER == SOLVER_LINEAR) {
    linear_pv(Pl, Pr, c, f, ps);
  } else if constexpr (SOLVER == SOLVER_RCV) {
    roe_cv_euler(Pl, Pr, c, f, ps);
  } else if constexpr (SOLVER == SOLVER_RPV) {
    roe_pv(Pl, Pr, c, f, ps);
  } else {
    hll_euler(Pl, Pr, c, f, ps);
  }
}

}  // namespace pion
