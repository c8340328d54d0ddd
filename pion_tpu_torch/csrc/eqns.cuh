// Equation-system algebra on per-thread register arrays: P<->U conversion,
// ideal-MHD flux, fast magnetosonic speed, the van Albada limiter.
//
// Device-side counterpart of pion_tpu_torch/ops/eqns.py and ops/recon.py for
// the MHD and GLM-MHD systems.  The scalar type T is float or double; every
// literal goes through T(...) so that nothing in a float kernel is promoted
// to double.  Slot layout as in constants.py: the same index holds the same
// kind of quantity in the primitive and the conserved vector.
#pragma once

namespace pion {

enum Slot : int { RO = 0, PG = 1, VX = 2, VY = 3, VZ = 4, BX = 5, BY = 6, BZ = 7, SI = 8 };

constexpr int EQN_MHD = 0;
constexpr int EQN_GLM = 1;
constexpr int SOLVER_HLL = 0;
constexpr int SOLVER_HLLD = 1;

template <int EQN>
struct NBase {
  static constexpr int value = (EQN == EQN_GLM) ? 9 : 8;
};

// Numbers of a run that the kernels take by value, already in the scalar
// type (the host computes them in double and rounds once, as the plain
// version does with Python scalars).
template <typename T>
struct Consts {
  T dx;         // cell size
  T half_dx;    // 0.5 * dx, rounded from the double product
  T gamma;      // adiabatic index
  T gm1;        // gamma - 1
  T etav;       // Falle artificial-viscosity coefficient
  T rho_floor;  // BASE_RHO * rho_ref
  T p_floor;    // 1e-6 * p_ref
  T cr;         // glm_cr_factor / dx
};

template <typename T>
__device__ __forceinline__ T sq(T x) { return x * x; }

// Falle / van Albada slope average (recon.van_albada).  VERY_TINY = 1e-200
// rounds to zero in float, so the test is prod > 0 there, as in the plain
// version.
template <typename T>
__device__ __forceinline__ T van_albada(T a, T b) {
  const T prod = a * b;
  const T denom = a * a + b * b;
  const T safe = denom > T(0.0) ? denom : T(1.0);
  return prod > T(1.0e-200) ? prod * (a + b) / safe : T(0.0);
}

// eqns.cfast_components: the discriminant as t1^2 (1 - q) so that t1^2 is
// never formed.
template <typename T>
__device__ __forceinline__ T cfast_components(T rho, T pg, T bx, T by, T bz, T gamma) {
  const T a2 = gamma * pg / rho;
  const T t1 = a2 + (bx * bx + by * by + bz * bz) / rho;
  const T q = T(4.0) * (a2 / t1) * ((bx * bx / rho) / t1);
  const T root = sqrt(fmax(T(1.0) - q, T(0.0)));
  return sqrt(T(0.5) * t1 * (T(1.0) + root));
}

// eqns.prim_to_cons for the NB base variables (tracers are handled by the
// caller, one at a time).
template <typename T, int NB>
__device__ __forceinline__ void prim_to_cons(const T (&P)[NB], T (&U)[NB], T gm1) {
  const T rho = P[RO];
  const T v2 = sq(P[VX]) + sq(P[VY]) + sq(P[VZ]);
  T E = T(0.5) * rho * v2 + P[PG] / gm1;
  const T b2 = sq(P[BX]) + sq(P[BY]) + sq(P[BZ]);
  E = E + T(0.5) * b2;
  U[RO] = rho;
  U[VX] = rho * P[VX];
  U[VY] = rho * P[VY];
  U[VZ] = rho * P[VZ];
  U[BX] = P[BX];
  U[BY] = P[BY];
  U[BZ] = P[BZ];
  if (NB == 9) {
    E = E + T(0.5) * sq(P[NB - 1]);
    U[NB - 1] = P[NB - 1];
  }
  U[PG] = E;
}

// eqns.cons_to_prim with the density and pressure floors.
template <typename T, int NB>
__device__ __forceinline__ void cons_to_prim(const T (&U)[NB], T (&P)[NB], const Consts<T>& c) {
  const T rho = U[RO] > T(0.0) ? U[RO] : c.rho_floor;
  const T vx = U[VX] / rho, vy = U[VY] / rho, vz = U[VZ] / rho;
  const T ke = T(0.5) * rho * (vx * vx + vy * vy + vz * vz);
  T e_int = U[PG] - ke;
  const T b2 = sq(U[BX]) + sq(U[BY]) + sq(U[BZ]);
  e_int = e_int - T(0.5) * b2;
  if (NB == 9) {
    e_int = e_int - T(0.5) * sq(U[NB - 1]);
    P[NB - 1] = U[NB - 1];
  }
  const T pg = c.gm1 * e_int;
  P[RO] = rho;
  P[PG] = pg > T(0.0) ? pg : c.p_floor;
  P[VX] = vx;
  P[VY] = vy;
  P[VZ] = vz;
  P[BX] = U[BX];
  P[BY] = U[BY];
  P[BZ] = U[BZ];
}

// eqns.flux_from_pu, MHD branch: the eight physical slots (F(Bx) = 0; the
// psi slot is owned by the GLM interface solve).
template <typename T>
__device__ __forceinline__ void flux_from_pu(const T (&P)[8], const T (&U)[8], T (&f)[8]) {
  const T mx = U[VX];
  const T pm = T(0.5) * (sq(U[BX]) + sq(U[BY]) + sq(U[BZ]));
  f[RO] = mx;
  f[VX] = mx * P[VX] + P[PG] + pm - U[BX] * U[BX];
  f[VY] = mx * P[VY] - U[BX] * U[BY];
  f[VZ] = mx * P[VZ] - U[BX] * U[BZ];
  const T udotb = P[VX] * U[BX] + P[VY] * U[BY] + P[VZ] * U[BZ];
  f[PG] = P[VX] * (U[PG] + P[PG] + pm) - U[BX] * udotb;
  f[BX] = T(0.0);
  f[BY] = P[VX] * P[BY] - P[VY] * P[BX];
  f[BZ] = P[VX] * P[BZ] - P[VZ] * P[BX];
}

}  // namespace pion
