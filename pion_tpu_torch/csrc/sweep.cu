// Fused finite-volume sweep kernels for the Euler, MHD and GLM-MHD systems on
// Cartesian grids.
//
// What they replace.  `sweep_axis_kernel` replaces the TPU kernel
// `_sweep_axis_pallas` (pion_tpu/ops/pallas_sweep.py, tile math in
// `_axis_tile_math`): for one axis, MUSCL reconstruction -> rotation into the
// sweep frame -> GLM (Bx, psi) interface solve -> Riemann flux (Euler: HLL,
// linear, Roe-CV, Roe-PV, riemann_hydro.cuh; MHD: HLL, HLLD with the
// per-interface HLL fallback, linear, Roe-CV, riemann_mhd.cuh) -> Falle
// artificial viscosity -> upwind tracer flux with the sCMA clamp and element
// renormalisation -> flux divergence -> Powell and GLM source terms (MHD);
// it writes dt*dU for the interior.
// `final_axis_kernel` replaces `_final_axis_pallas` (same file): the axis-0
// sweep followed in the same thread as each cell's flux divergence by U(P) +
// dU + sum(contribs) -> cons_to_prim with floors -> GLM psi damping; it
// writes the new primitive state.
//
// What bounds them here.  Bytes: per cell a sweep reads the padded state and
// the mask once and writes nvar values (at 128^3, 10 variables, float32:
// 178 MB, 0.0532 ms at 3.35 TB/s), against roughly a thousand floating-point
// operations per interface.
//
// sweep_axis_kernel: each interface solved once, from a staged tile.  A block
// owns a tile of T cells along the sweep axis by W pencils across it (W along
// x for the y and z sweeps, so that loads coalesce; along y for the x sweep,
// whose rows are then read contiguously).  It
//   1. stages the stencil -- every variable of the T + 2*ORDER cells of each
//      pencil, and the fallback mask -- in shared memory once (cp.async, one
//      element a copy: padded rows are not 16-byte aligned);
//   2. solves the T + 1 interfaces of the tile, one a thread, with the same
//      `interface_flux` as the final kernel, and writes their base fluxes to
//      shared memory (the mass flux among them is what the tracers need);
//   3. after one barrier forms each cell's flux divergence, Powell and GLM
//      sources and tracer updates from shared memory and writes dt*dU once.
// So a cell costs (T+1)/T interface solves (the tile's two edge faces are
// solved by both tiles that share them, from the same staged values by the
// same code, so both get the same bits and the scheme stays conservative),
// and each state value is read from device memory once by its own tile, and
// the 2*ORDER halo cells of a pencil once more by the neighbouring tile
// along the axis: (T+2*ORDER)/T reads a value.  T and W are chosen per
// scalar type and variable count by the wrapper (fused_sweep.sweep_plan):
// at the main path's 10 float32 variables T = 15, W = 32, so a cell costs
// 16/15 solves and 19/15 (order 2) or 17/15 (order 1) reads, the 16 x 32
// faces are four rounds of the block's 128 threads, and five blocks fit an
// SM; above 48 KB of shared memory the launcher opts the kernel in.
//
// final_axis_kernel runs on the same tiles along axis 0 (z in 3D, y in 2D;
// pencils across x) through the same phases 1 and 2 (`stage_and_solve`).
// Its phase 3 also reads the cell's base state and the other axes'
// contributions, coalesced along x, applies the conserved update and writes
// the new primitive state once.  Its shared memory and tile size are B1's
// for the same variables (fused_sweep.sweep_plan along axis 0).
//
// Both kernels share every device function below; the stencil is read
// through a cell accessor (`TileCells`, the staged tile).  Tracers are
// handled one at a time after the base variables, so any number of tracers
// runs without per-thread arrays indexed at run time.
//
// The Euler system (5 base variables) runs the same tiles and phases; its
// interface state P* is the solver's full primitive state (Falle viscosity
// reads its sound speed), and it has no Powell or GLM sources.  The Euler
// and the MHD linear/Roe branches are the plain port of their solvers to one
// interface a thread, on the tiles redesigned for MHD.
//
// Built once per (scalar type, solver) with -DPION_REAL and -DPION_SOLVER;
// equation system, viscosity and order are template parameters selected in the
// launchers.  The HLLD library holds no Euler kernels, the Roe-PV library only
// Euler ones (for MHD, roe_pv is the linear solver: the host takes the linear
// library).  dt and c_h are read through device pointers, so the host never
// has to know them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "riemann_hydro.cuh"
#include "riemann_mhd.cuh"

#ifndef PION_REAL
#define PION_REAL float
#endif
#ifndef PION_SOLVER
#define PION_SOLVER 1
#endif
// which equation systems this library holds
#define PION_HAS_EULER (PION_SOLVER != 1)
#define PION_HAS_MHD (PION_SOLVER != 4)

namespace pion {

constexpr int THREADS = 128;
constexpr size_t SMEM_DEFAULT = 48 * 1024;   // without opting in
constexpr size_t SMEM_MAX = 232448;          // what a block can opt in to

// Shapes and strides of one launch.  A 2D grid is a 3D one with nz = 1 and no
// ghost layers in z.
struct Layout {
  int nz, ny, nx;      // interior cells
  int gz;              // ghost depth in z (2 in 3D, 0 in 2D); y and x have 2
  long sz, sy;         // strides of the padded spatial axes (x has stride 1)
  long vs;             // stride between variables of the padded state
  long cells;          // nz * ny * nx, also the variable stride of the output
  int k;               // physical index of the sweep axis (0 = x, 1 = y, 2 = z)
  int nvar;            // base variables + tracers
  int scma;            // 0: none, 1: clamp advected tracers to <= 1
  unsigned long long el_mask;  // bit v set: variable v is an element tracer
};

// How sweep_axis_kernel cuts the interior into tiles: `along` is the sweep
// axis, `across` the axis a tile's W pencils lie side by side on, `third` the
// remaining one (one plane a tile).  Strides ps_* are of the padded state,
// os_* of the output.
struct Tiling {
  int T, W;                        // cells along, pencils across a tile
  int n_along, n_across, n_third;  // interior cells on each
  int n_ta, n_tw;                  // tiles along and across
  long ps_along, ps_across, ps_third, p_origin;  // p_origin: interior (0,0,0)
  long os_along, os_across, os_third;
  int along_fast;                  // the sweep axis is the contiguous one
};

// The sweep-frame slot j of the velocity/field triple lives in slot (k+j)%3.
__device__ __forceinline__ int rot(int k, int j) {
  const int r = k + j;
  return r >= 3 ? r - 3 : r;
}

// The cells of a tile staged in shared memory, addressed relative to the
// cell `pos` along the sweep axis: variable v of staged row r and
// pencil w at s[v * vstride + r * rstride + w]; `pos` = r * rstride + w.
template <typename T>
struct TileCells {
  const T* s;
  const uint8_t* m;   // staged mask, or null
  int vstride, rstride, pos;
  __device__ __forceinline__ T operator()(int v, int rel) const { return s[v * vstride + pos + rel * rstride]; }
  __device__ __forceinline__ bool has_mask() const { return m != nullptr; }
  __device__ __forceinline__ uint8_t flag(int rel) const { return m[pos + rel * rstride]; }
};

// Base variables of the cell `rel` steps along the axis, rotated into the
// sweep frame.
template <typename T, int NB, class Cells>
__device__ __forceinline__ void load_cell(const Cells& P, int rel, int k, T (&q)[NB]) {
  q[RO] = P(RO, rel);
  q[PG] = P(PG, rel);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    q[VX + j] = P(VX + rot(k, j), rel);
    if constexpr (NB >= 8) q[BX + j] = P(BX + rot(k, j), rel);
  }
  if constexpr (NB == 9) q[NB - 1] = P(SI, rel);
}

// Edge states of one variable at the face between cells a and b = a + 1, from
// the values of cells a-1, a, b, b+1 (the kernels' reconstruction: one-sided
// differences over the constant dx, edge offsets +-dx/2).
template <typename T, int ORDER>
__device__ __forceinline__ void edge_pair(T qm, T qa, T qb, T qp, const Consts<T>& c, T& pl, T& pr) {
  if (ORDER == 1) {
    pl = qa;
    pr = qb;
  } else {
    const T d0 = (qa - qm) / c.dx;
    const T d1 = (qb - qa) / c.dx;
    const T d2 = (qp - qb) / c.dx;
    pl = qa + van_albada(d0, d1) * c.half_dx;
    pr = qb - van_albada(d1, d2) * c.half_dx;
  }
}

// The Euler system's solve of one interface from its edge states: the
// configured solver's flux and full interface state P*, and Falle, Komissarov
// & Joarder (1998) viscosity from the sound speed of P*.
template <typename T, int SOLVER, int AV>
__device__ __forceinline__ void euler_flux(const T (&Pl)[5], const T (&Pr)[5], const Consts<T>& c,
                                           T (&flux)[5]) {
  T ps[5];
  riemann_hydro<T, SOLVER>(Pl, Pr, c, flux, ps);
  if (AV == 1) {
    const T pref = sqrt(c.gamma * ps[PG] / ps[RO]) * c.etav * ps[RO];
    T erg = T(0.0);
#pragma unroll
    for (int v = VX; v <= VZ; ++v) {
      const T mv = pref * (Pr[v] - Pl[v]);
      flux[v] = flux[v] - mv;
      erg = erg + mv * ps[v];
    }
    flux[PG] = flux[PG] - erg;
  }
}

// The MHD and GLM-MHD solve of one interface from its edge states (Pl, Pr
// are written: the GLM solve replaces Bx): the GLM (Bx, psi) problem, the
// configured solver with the HLL fallback of flagged interfaces, and Falle
// viscosity from the slim star state.
template <typename T, int EQN, int SOLVER, int AV>
__device__ __forceinline__ void mhd_flux(T (&Pl)[NBase<EQN>::value], T (&Pr)[NBase<EQN>::value],
                                         bool use_hll, const Consts<T>& c, T ch,
                                         T (&flux)[NBase<EQN>::value]) {
  constexpr int NB = NBase<EQN>::value;
  T psistar = T(0.0), bxstar = T(0.0);
  if (EQN == EQN_GLM) {
    // Dedner 2x2 Riemann problem for (Bx, psi)
    psistar = T(0.5) * (Pl[NB - 1] + Pr[NB - 1] - (Pr[BX] - Pl[BX]));
    bxstar = T(0.5) * (Pl[BX] + Pr[BX] - (Pr[NB - 1] - Pl[NB - 1]));
    Pl[BX] = bxstar;
    Pr[BX] = bxstar;
  }

  T f8[8], us[8];
  {
    T Pl8[8], Pr8[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) { Pl8[v] = Pl[v]; Pr8[v] = Pr[v]; }
    riemann<T, SOLVER>(Pl8, Pr8, c, use_hll, f8, us);
  }

  if (EQN == EQN_GLM) {
    // Mackey & Lim (2011) energy correction + Dedner fluxes
    f8[PG] = f8[PG] + ch * bxstar * psistar;
    f8[BX] = ch * psistar;
    flux[NB - 1] = ch * bxstar;
  }

  if (AV == 1) {
    // Falle, Komissarov & Joarder (1998) viscous flux.  It reads only the
    // density, velocity and transverse field of the interface state, so the
    // star state is floored and divided, never converted in full.
    const T rho_s = us[RO] > T(0.0) ? us[RO] : c.rho_floor;
    const T inv_rho = T(1.0) / rho_s;
    const T pref = cfast_components(T(0.5) * (Pl[RO] + Pr[RO]), T(0.5) * (Pl[PG] + Pr[PG]),
                                    T(0.5) * (Pl[BX] + Pr[BX]), T(0.5) * (Pl[BY] + Pr[BY]),
                                    T(0.5) * (Pl[BZ] + Pr[BZ]), c.gamma)
                   * c.etav * rho_s;
    T erg = T(0.0);
#pragma unroll
    for (int v = VX; v <= VZ; ++v) {
      const T mv = pref * (Pr[v] - Pl[v]);
      f8[v] = f8[v] - mv;
      erg = erg + mv * (us[v] * inv_rho);
    }
    const T prefb = pref / rho_s;
#pragma unroll
    for (int b = BY; b <= BZ; ++b) {
      const T mv = prefb * (Pr[b] - Pl[b]);
      f8[b] = f8[b] - mv;
      erg = erg + mv * us[b];
    }
    f8[PG] = f8[PG] - erg;
  }

#pragma unroll
  for (int v = 0; v < 8; ++v) flux[v] = f8[v];
}

// The interface pipeline for the base variables: sweep-frame flux through the
// face between the cell `P` is centred on and the next one along the axis.
template <typename T, int EQN, int SOLVER, int AV, int ORDER, class Cells>
__device__ __forceinline__ void interface_flux(const Cells& P, int k, const Consts<T>& c, T ch,
                                               T (&flux)[NBase<EQN>::value]) {
  constexpr int NB = NBase<EQN>::value;
  T Pl[NB], Pr[NB];
  {
    T qa[NB], qb[NB];
    load_cell<T, NB>(P, 0, k, qa);
    load_cell<T, NB>(P, 1, k, qb);
    if (ORDER == 1) {
#pragma unroll
      for (int v = 0; v < NB; ++v) { Pl[v] = qa[v]; Pr[v] = qb[v]; }
    } else {
      T qm[NB], qp[NB];
      load_cell<T, NB>(P, -1, k, qm);
      load_cell<T, NB>(P, 2, k, qp);
#pragma unroll
      for (int v = 0; v < NB; ++v) edge_pair<T, ORDER>(qm[v], qa[v], qb[v], qp[v], c, Pl[v], Pr[v]);
    }
  }
  if constexpr (EQN == EQN_EULER) {
    euler_flux<T, SOLVER, AV>(Pl, Pr, c, flux);
  } else {
    // interface uses HLL when either adjacent cell is flagged
    const bool use_hll = SOLVER == SOLVER_HLLD && P.has_mask() && (P.flag(0) | P.flag(1)) != 0;
    mhd_flux<T, EQN, SOLVER, AV>(Pl, Pr, use_hll, c, ch, flux);
  }
}

// Upwind tracer flux on the mass flux (reference: solver_eqn_base.cpp:281-342).
template <typename T>
__device__ __forceinline__ T tracer_flux(T fm, T pl, T pr) {
  const T f = fm > T(0.0) ? pl * fm : pr * fm;
  return fm == T(0.0) ? T(0.0) : f;
}

// Edge states of tracer variable v at the low and the high face of the cell
// `P` is centred on.
template <typename T, int ORDER, class Cells>
__device__ __forceinline__ void tracer_edges(const Cells& P, int v, const Consts<T>& c, T (&pl)[2],
                                             T (&pr)[2]) {
  const T q0 = P(v, 0), qm1 = P(v, -1), qp1 = P(v, 1);
  if (ORDER == 1) {
    pl[0] = qm1; pr[0] = q0;
    pl[1] = q0;  pr[1] = qp1;
  } else {
    const T qm2 = P(v, -2), qp2 = P(v, 2);
    edge_pair<T, ORDER>(qm2, qm1, q0, qp1, c, pl[0], pr[0]);
    edge_pair<T, ORDER>(qm1, q0, qp1, qp2, c, pl[1], pr[1]);
  }
}

// dt * d(tracer)/dt of every tracer of one cell, handed to `sink(v, value)`.
template <typename T, int EQN, int ORDER, class Cells, typename Sink>
__device__ __forceinline__ void tracer_updates(const Cells& P, const Layout& L, const Consts<T>& c,
                                               T dt, T fm_lo, T fm_hi, Sink sink) {
  constexpr int NB = NBase<EQN>::value;
  T fac_l[2] = {T(1.0), T(1.0)}, fac_r[2] = {T(1.0), T(1.0)};
  if (L.scma && L.el_mask) {
    // element tracers advect scaled so that their clamped sum is 1
    T sl[2] = {T(0.0), T(0.0)}, sr[2] = {T(0.0), T(0.0)};
    for (int e = NB; e < L.nvar; ++e) {
      if (!((L.el_mask >> e) & 1ull)) continue;
      T pl[2], pr[2];
      tracer_edges<T, ORDER>(P, e, c, pl, pr);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        sl[f] = sl[f] + fmin(fmax(pl[f], T(0.0)), T(1.0));
        sr[f] = sr[f] + fmin(fmax(pr[f], T(0.0)), T(1.0));
      }
    }
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      fac_l[f] = T(1.0) / fmax(sl[f], T(1.0e-30));
      fac_r[f] = T(1.0) / fmax(sr[f], T(1.0e-30));
    }
  }
  for (int v = NB; v < L.nvar; ++v) {
    T pl[2], pr[2];
    tracer_edges<T, ORDER>(P, v, c, pl, pr);
    if (L.scma) {
      const bool el = (L.el_mask >> v) & 1ull;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        pl[f] = fmin(pl[f], T(1.0));
        pr[f] = fmin(pr[f], T(1.0));
        if (el) {
          pl[f] = pl[f] * fac_l[f];
          pr[f] = pr[f] * fac_r[f];
        }
      }
    }
    const T f_lo = tracer_flux(fm_lo, pl[0], pr[0]);
    const T f_hi = tracer_flux(fm_hi, pl[1], pr[1]);
    sink(v, dt * ((f_lo - f_hi) / c.dx));
  }
}

// Powell 8-wave and GLM advective source terms of the cell `P` is centred on,
// added to its flux divergence `acc` (sweep frame); writes dt * dU.  The
// Euler system has no sources.
template <typename T, int EQN, class Cells>
__device__ __forceinline__ void cell_sources(const Cells& P, int k, const Consts<T>& c, T dt,
                                             T (&acc)[NBase<EQN>::value],
                                             T (&dU)[NBase<EQN>::value]) {
  constexpr int NB = NBase<EQN>::value;
  if constexpr (EQN != EQN_EULER) {
    // Powell 8-wave source terms (reference: solver_eqn_mhd_adi.cpp:396-443)
    T Pc[NB];
    load_cell<T, NB>(P, 0, k, Pc);
    const int bn = BX + k;
    const T b_lo = P(bn, -1), b_hi = P(bn, 1);
    const T dbm = (T(0.5) * (b_lo + Pc[BX]) - T(0.5) * (Pc[BX] + b_hi)) / c.dx;
    // u.B summed in the order of the unrotated slots x, y, z
    const int jx = rot(3 - k, 0);  // sweep-frame slot that holds the x component
    T ub[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) ub[j] = Pc[VX + j] * Pc[BX + j];
    const T udotb = jx == 0 ? ub[0] + ub[1] + ub[2]
                            : (jx == 1 ? ub[1] + ub[2] + ub[0] : ub[2] + ub[0] + ub[1]);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      acc[VX + j] = acc[VX + j] + dbm * Pc[BX + j];
      acc[BX + j] = acc[BX + j] + dbm * Pc[VX + j];
    }
    T pg_new = acc[PG] + dbm * udotb;
    if (EQN == EQN_GLM) {
      // GLM advective psi source (reference: solver_eqn_mhd_adi.cpp:782-813)
      const T s_lo = P(SI, -1), s_hi = P(SI, 1);
      const T dsm = (T(0.5) * (s_lo + Pc[NB - 1]) - T(0.5) * (Pc[NB - 1] + s_hi)) / c.dx;
      const T vn = Pc[VX];
      pg_new = pg_new + dsm * vn * Pc[NB - 1];
      acc[NB - 1] = acc[NB - 1] + dsm * vn;
    }
    acc[PG] = pg_new;
  }
#pragma unroll
  for (int v = 0; v < NB; ++v) dU[v] = dt * acc[v];
}

// Position (along, across) of item j of a tile's n_a x n_w items, the
// contiguous axis of device memory fastest.
__device__ __forceinline__ void tile_pos(int j, int n_a, int n_w, int along_fast, int& a, int& w) {
  if (along_fast) {
    a = j % n_a;
    w = j / n_a;
  } else {
    w = j % n_w;
    a = j / n_w;
  }
}

// One tile of a sweep, staged and solved: the shared-memory layout of a
// block of sweep_axis_kernel and final_axis_kernel, and which tile it owns.
template <typename T>
struct Tile {
  T* s_state;        // nvar x R x rs: the staged stencil
  T* s_flux;         // NB x (T+1) x rs: the base fluxes of the tile's faces
  uint8_t* s_mask;   // R x rs, or null
  int R, rs, fs;     // staged rows, row stride, flux rows
  int a0, w0, t3;    // first cell along, first pencil across, plane
  int nA, nW;        // cells along, pencils across
};

// Phases 1 and 2 of a tile: stage the stencil -- every variable of the
// T + 2*ORDER cells of each pencil, and the fallback mask -- in shared
// memory once, then solve each of the tile's T + 1 interfaces once and keep
// their base fluxes in shared memory.  Ends with a block barrier.  dt and
// ch are read from the card while the stencil's copies are in flight.
template <typename T, int EQN, int SOLVER, int AV, int ORDER>
__device__ __forceinline__ Tile<T> stage_and_solve(const T* __restrict__ P,
                                                   const uint8_t* __restrict__ mask,
                                                   const T* __restrict__ dt_p,
                                                   const T* __restrict__ ch_p, const Layout& L,
                                                   const Tiling& tl, const Consts<T>& c, T& dt,
                                                   T& ch) {
  constexpr int NB = NBase<EQN>::value;
  constexpr int H = ORDER;  // halo cells a side along the axis
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile<T> t;
  t.R = tl.T + 2 * H;  // staged rows
  t.rs = tl.W + 1;     // row stride: odd, so that column walks miss no bank
  t.fs = tl.T + 1;
  t.s_state = reinterpret_cast<T*>(smem_raw);
  t.s_flux = t.s_state + (long)L.nvar * t.R * t.rs;
  t.s_mask = mask != nullptr ? reinterpret_cast<uint8_t*>(t.s_flux + NB * t.fs * t.rs) : nullptr;

  // which tile
  int b = blockIdx.x;
  const int tw = b % tl.n_tw;
  b /= tl.n_tw;
  const int ta = b % tl.n_ta;
  t.t3 = b / tl.n_ta;
  t.a0 = ta * tl.T;
  t.w0 = tw * tl.W;
  t.nA = min(tl.T, tl.n_along - t.a0);
  t.nW = min(tl.W, tl.n_across - t.w0);
  const int nR = t.nA + 2 * H;

  // 1. stage the stencil (staged row r holds interior cell a0 - H + r)
  const long g0 = tl.p_origin + (long)(t.a0 - H) * tl.ps_along + (long)t.w0 * tl.ps_across +
                  (long)t.t3 * tl.ps_third;
  for (int j = threadIdx.x; j < nR * t.nW; j += THREADS) {
    int r, w;
    tile_pos(j, nR, t.nW, tl.along_fast, r, w);
    const long g = g0 + (long)r * tl.ps_along + (long)w * tl.ps_across;
    const int s = r * t.rs + w;
    for (int v = 0; v < L.nvar; ++v) cp_async(t.s_state + v * t.R * t.rs + s, P + g + v * L.vs);
    if (mask != nullptr) t.s_mask[s] = mask[g];
  }
  dt = *dt_p;
  ch = *ch_p;
  cp_async_wait_all();
  __syncthreads();

  // 2. each interface of the tile once: face f lies between interior cells
  // a0 + f - 1 and a0 + f, i.e. staged rows H - 1 + f and H + f
  for (int j = threadIdx.x; j < (t.nA + 1) * t.nW; j += THREADS) {
    int f, w;
    tile_pos(j, t.nA + 1, t.nW, tl.along_fast, f, w);
    const TileCells<T> cells{t.s_state, t.s_mask, t.R * t.rs, t.rs, (H - 1 + f) * t.rs + w};
    T flux[NB];
    interface_flux<T, EQN, SOLVER, AV, ORDER>(cells, L.k, c, ch, flux);
#pragma unroll
    for (int v = 0; v < NB; ++v) t.s_flux[(v * t.fs + f) * t.rs + w] = flux[v];
  }
  __syncthreads();
  return t;
}

// Phase 3's start for cell (a, w) of a tile: the flux divergence from the
// staged face fluxes, the mass flux through its two faces, and the
// accessor of its staged stencil.
template <typename T, int NB, int ORDER>
__device__ __forceinline__ TileCells<T> cell_divergence(const Tile<T>& t, int a, int w,
                                                        const Consts<T>& c, T (&acc)[NB], T& fm_lo,
                                                        T& fm_hi) {
#pragma unroll
  for (int v = 0; v < NB; ++v)
    acc[v] = (t.s_flux[(v * t.fs + a) * t.rs + w] - t.s_flux[(v * t.fs + a + 1) * t.rs + w]) / c.dx;
  fm_lo = t.s_flux[a * t.rs + w];
  fm_hi = t.s_flux[(a + 1) * t.rs + w];
  return TileCells<T>{t.s_state, t.s_mask, t.R * t.rs, t.rs, (ORDER + a) * t.rs + w};
}

template <typename T, int EQN, int SOLVER, int AV, int ORDER>
__global__ void __launch_bounds__(THREADS)
sweep_axis_kernel(const T* __restrict__ P, const uint8_t* __restrict__ mask, T* __restrict__ out,
                  const T* __restrict__ dt_p, const T* __restrict__ ch_p, Layout L, Tiling tl,
                  Consts<T> c) {
  constexpr int NB = NBase<EQN>::value;
  T dt, ch;
  const Tile<T> t =
      stage_and_solve<T, EQN, SOLVER, AV, ORDER>(P, mask, dt_p, ch_p, L, tl, c, dt, ch);

  // 3. each cell: divergence, sources, tracers; dt*dU written once
  const long o0 = (long)t.a0 * tl.os_along + (long)t.w0 * tl.os_across + (long)t.t3 * tl.os_third;
  for (int j = threadIdx.x; j < t.nA * t.nW; j += THREADS) {
    int a, w;
    tile_pos(j, t.nA, t.nW, tl.along_fast, a, w);
    T acc[NB], fm_lo, fm_hi;
    const TileCells<T> cells = cell_divergence<T, NB, ORDER>(t, a, w, c, acc, fm_lo, fm_hi);
    T dU[NB];
    cell_sources<T, EQN>(cells, L.k, c, dt, acc, dU);
    const long o = o0 + (long)a * tl.os_along + (long)w * tl.os_across;
    // back out of the sweep frame while storing
    out[o + RO * L.cells] = dU[RO];
    out[o + PG * L.cells] = dU[PG];
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) {
      out[o + (VX + rot(L.k, jj)) * L.cells] = dU[VX + jj];
      if constexpr (NB >= 8) out[o + (BX + rot(L.k, jj)) * L.cells] = dU[BX + jj];
    }
    if constexpr (NB == 9) out[o + SI * L.cells] = dU[NB - 1];
    T* outp = out;
    const long cells_n = L.cells;
    tracer_updates<T, EQN, ORDER>(cells, L, c, dt, fm_lo, fm_hi,
                                  [outp, o, cells_n](int v, T val) { outp[o + v * cells_n] = val; });
  }
}

// The axis-0 sweep plus the conserved update, on the tiles of
// sweep_axis_kernel: phases 1 and 2 are the same; phase 3 adds each cell's
// dt*dU and the other axes' contributions to U(P_int), converts back with
// the floors, damps psi and writes the new primitive state once.  K =
// ndim - 1 is the physical index of axis 0 and fixes the rotation at compile
// time, so the update runs on registers in the unrotated frame.
template <typename T, int EQN, int SOLVER, int AV, int ORDER, int K>
__global__ void __launch_bounds__(THREADS)
final_axis_kernel(const T* __restrict__ P, const uint8_t* __restrict__ mask,
                  const T* __restrict__ P_int, const T* __restrict__ c0, const T* __restrict__ c1,
                  T* __restrict__ out, const T* __restrict__ dt_p, const T* __restrict__ ch_p,
                  Layout L, Tiling tl, Consts<T> c) {
  constexpr int NB = NBase<EQN>::value;
  T dt, ch;
  const Tile<T> t =
      stage_and_solve<T, EQN, SOLVER, AV, ORDER>(P, mask, dt_p, ch_p, L, tl, c, dt, ch);

  // 3. each cell, x fastest: P_int, c0, c1 and the output are read and
  // written coalesced
  const long o0 = (long)t.a0 * tl.os_along + (long)t.w0 * tl.os_across + (long)t.t3 * tl.os_third;
  for (int j = threadIdx.x; j < t.nA * t.nW; j += THREADS) {
    int a, w;
    tile_pos(j, t.nA, t.nW, tl.along_fast, a, w);
    T acc[NB], fm_lo, fm_hi;
    const TileCells<T> cells = cell_divergence<T, NB, ORDER>(t, a, w, c, acc, fm_lo, fm_hi);
    T dUr[NB], dU[NB];
    cell_sources<T, EQN>(cells, K, c, dt, acc, dUr);
    dU[RO] = dUr[RO];
    dU[PG] = dUr[PG];
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) {
      dU[VX + (K + jj) % 3] = dUr[VX + jj];
      if constexpr (NB >= 8) dU[BX + (K + jj) % 3] = dUr[BX + jj];
    }
    if constexpr (NB == 9) dU[NB - 1] = dUr[NB - 1];
    const long o = o0 + (long)a * tl.os_along + (long)w * tl.os_across;

    // U(P) + dU + sum(contribs) -> primitive with floors -> psi damping
    T Pb[NB], U[NB];
#pragma unroll
    for (int v = 0; v < NB; ++v) Pb[v] = P_int[o + v * L.cells];
    prim_to_cons<T, NB>(Pb, U, c.gm1);
#pragma unroll
    for (int v = 0; v < NB; ++v) {
      U[v] = U[v] + dU[v];
      if (c0 != nullptr) U[v] = U[v] + c0[o + v * L.cells];
      if (c1 != nullptr) U[v] = U[v] + c1[o + v * L.cells];
    }
    T Pn[NB];
    cons_to_prim<T, NB>(U, Pn, c);
    if constexpr (EQN == EQN_GLM) Pn[NB - 1] = Pn[NB - 1] * exp(-dt * ch * c.cr);
#pragma unroll
    for (int v = 0; v < NB; ++v) out[o + v * L.cells] = Pn[v];

    const T rho_old = Pb[RO], rho_new = Pn[RO];
    const long cells_n = L.cells;
    T* outp = out;
    tracer_updates<T, EQN, ORDER>(
        cells, L, c, dt, fm_lo, fm_hi,
        [outp, o, cells_n, P_int, c0, c1, rho_old, rho_new](int v, T val) {
          T u = P_int[o + v * cells_n] * rho_old + val;
          if (c0 != nullptr) u = u + c0[o + v * cells_n];
          if (c1 != nullptr) u = u + c1[o + v * cells_n];
          outp[o + v * cells_n] = u / rho_new;
        });
  }
}

template <typename T>
Consts<T> make_consts(double dx, double gamma, double etav, double rho_floor, double p_floor,
                      double cr) {
  Consts<T> c;
  c.dx = T(dx);
  c.half_dx = T(0.5 * dx);
  c.gamma = T(gamma);
  c.gm1 = T(gamma - 1.0);
  c.etav = T(etav);
  c.rho_floor = T(rho_floor);
  c.p_floor = T(p_floor);
  c.cr = T(cr);
  return c;
}

inline Layout make_layout(int ndim, int nz, int ny, int nx, int axis, int nvar, int scma,
                          unsigned long long el_mask) {
  Layout L;
  L.nz = nz;
  L.ny = ny;
  L.nx = nx;
  L.gz = ndim == 3 ? 2 : 0;
  L.sy = nx + 4;
  L.sz = (long)(ny + 4) * L.sy;
  L.vs = (long)(nz + 2 * L.gz) * L.sz;
  L.k = ndim - 1 - axis;
  L.cells = (long)nz * ny * nx;
  L.nvar = nvar;
  L.scma = scma;
  L.el_mask = el_mask;
  return L;
}

// The tiling of a sweep along L.k (x: pencils side by side along y; y and z:
// along x), with T cells along and W pencils across a tile.
inline Tiling make_tiling(const Layout& L, int T, int W) {
  Tiling t;
  t.T = T;
  t.W = W;
  const long os_y = L.nx, os_z = (long)L.ny * L.nx;
  if (L.k == 0) {
    t.n_along = L.nx; t.ps_along = 1;    t.os_along = 1;
    t.n_across = L.ny; t.ps_across = L.sy; t.os_across = os_y;
    t.n_third = L.nz; t.ps_third = L.sz; t.os_third = os_z;
  } else if (L.k == 1) {
    t.n_along = L.ny; t.ps_along = L.sy; t.os_along = os_y;
    t.n_across = L.nx; t.ps_across = 1;   t.os_across = 1;
    t.n_third = L.nz; t.ps_third = L.sz; t.os_third = os_z;
  } else {
    t.n_along = L.nz; t.ps_along = L.sz; t.os_along = os_z;
    t.n_across = L.nx; t.ps_across = 1;   t.os_across = 1;
    t.n_third = L.ny; t.ps_third = L.sy; t.os_third = os_y;
  }
  t.n_ta = (t.n_along + T - 1) / T;
  t.n_tw = (t.n_across + W - 1) / W;
  t.p_origin = (long)L.gz * L.sz + 2 * L.sy + 2;
  t.along_fast = L.k == 0;
  return t;
}

// Shared memory of one sweep_axis block; fused_sweep.sweep_plan computes the
// same number.
inline size_t tile_bytes(int nvar, int nb, int order, int T, int W, bool mask, size_t esz) {
  const size_t R = T + 2 * order, rs = W + 1;
  return (nvar * R * rs + nb * (size_t)(T + 1) * rs) * esz + (mask ? R * rs : 0);
}

// Opt a tile kernel in to `bytes` of dynamic shared memory once it needs
// more than the default (once per instantiation and size).  K < 0:
// sweep_axis_kernel<E, S, A, O>; else final_axis_kernel<E, S, A, O, K>.
template <typename T, int E, int S, int A, int O, int K>
cudaError_t allow_tile_smem(size_t bytes) {
  static size_t allowed = SMEM_DEFAULT;
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t e;
  if constexpr (K < 0) {
    e = cudaFuncSetAttribute(sweep_axis_kernel<T, E, S, A, O>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  } else {
    e = cudaFuncSetAttribute(final_axis_kernel<T, E, S, A, O, K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

}  // namespace pion

using real = PION_REAL;
using namespace pion;

// The base variables of an equation system, and whether this library holds
// its kernels.
inline int nbase_of(int eqn) { return eqn == EQN_GLM ? 9 : (eqn == EQN_MHD ? 8 : 5); }
inline bool holds(int eqn) {
  if (eqn == EQN_EULER) return PION_HAS_EULER;
  return (eqn == EQN_MHD || eqn == EQN_GLM) && PION_HAS_MHD;
}

#define PION_AV_ORDER(KERNEL_CALL, E)                  \
  if (av) {                                            \
    if (order == 2) { KERNEL_CALL(E, 1, 2); }          \
    else            { KERNEL_CALL(E, 1, 1); }          \
  } else {                                             \
    if (order == 2) { KERNEL_CALL(E, 0, 2); }          \
    else            { KERNEL_CALL(E, 0, 1); }          \
  }
#if PION_HAS_EULER
#define PION_CASE_EULER(KERNEL_CALL) \
  if (eqn == EQN_EULER) { PION_AV_ORDER(KERNEL_CALL, EQN_EULER) } else
#else
#define PION_CASE_EULER(KERNEL_CALL)
#endif
#if PION_HAS_MHD
#define PION_CASE_MHD(KERNEL_CALL)                                 \
  if (eqn == EQN_GLM) { PION_AV_ORDER(KERNEL_CALL, EQN_GLM) }      \
  else if (eqn == EQN_MHD) { PION_AV_ORDER(KERNEL_CALL, EQN_MHD) } \
  else
#else
#define PION_CASE_MHD(KERNEL_CALL)
#endif
#define PION_DISPATCH(KERNEL_CALL) \
  PION_CASE_EULER(KERNEL_CALL) PION_CASE_MHD(KERNEL_CALL) { return (int)cudaErrorInvalidValue; }

// One axis's dt*dU.  P: padded state (nvar, [nz+4,] ny+4, nx+4); mask: padded
// per-cell flags as bytes, or null; out: (nvar, [nz,] ny, nx).  eqn: 0 MHD,
// 1 GLM, 2 Euler.  tile_t, tile_w: cells along and pencils across a block's tile
// (fused_sweep.sweep_plan).  Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for arguments no instantiation covers and tiles
// whose shared memory exceeds what a block can have.
extern "C" int pion_sweep_axis(const void* P, const void* mask, void* out, const void* dt,
                               const void* ch, int ndim, int nz, int ny, int nx, int axis,
                               int nvar, int eqn, int av, int order, int scma,
                               unsigned long long el_mask, int tile_t, int tile_w, double dx,
                               double gamma, double etav, double rho_floor, double p_floor,
                               double cr, void* stream) {
  if ((ndim != 2 && ndim != 3) || axis < 0 || axis >= ndim || (order != 1 && order != 2) ||
      !holds(eqn) || nvar < nbase_of(eqn) || nvar > 64 || tile_t < 1 || tile_w < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L = make_layout(ndim, nz, ny, nx, axis, nvar, scma, el_mask);
  const Tiling tl = make_tiling(L, tile_t, tile_w);
  const size_t smem = tile_bytes(nvar, nbase_of(eqn), order, tile_t, tile_w,
                                 mask != nullptr, sizeof(real));
  const long nblocks = (long)tl.n_ta * tl.n_tw * tl.n_third;
  if (smem > SMEM_MAX || nblocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const Consts<real> c = make_consts<real>(dx, gamma, etav, rho_floor, p_floor, cr);
  cudaStream_t s = (cudaStream_t)stream;
#define PION_SWEEP_CALL(E, A, O)                                                       \
  {                                                                                    \
    const cudaError_t e = allow_tile_smem<real, E, PION_SOLVER, A, O, -1>(smem);           \
    if (e != cudaSuccess) return (int)e;                                               \
    sweep_axis_kernel<real, E, PION_SOLVER, A, O><<<(unsigned)nblocks, THREADS, smem, s>>>( \
        (const real*)P, (const uint8_t*)mask, (real*)out, (const real*)dt,             \
        (const real*)ch, L, tl, c);                                                    \
  }
  PION_DISPATCH(PION_SWEEP_CALL)
#undef PION_SWEEP_CALL
  return (int)cudaGetLastError();
}

// The axis-0 sweep fused with the conserved update: writes the new primitive
// state.  P_int: base state (nvar, [nz,] ny, nx); c0, c1: the other axes'
// dt*dU of the same shape, or null.  tile_t, tile_w: the tiles along axis 0
// (fused_sweep.sweep_plan).  Returns as pion_sweep_axis.
extern "C" int pion_final_axis(const void* P, const void* mask, const void* P_int, const void* c0,
                               const void* c1, void* out, const void* dt, const void* ch, int ndim,
                               int nz, int ny, int nx, int nvar, int eqn, int av, int order,
                               int tile_t, int tile_w, double dx, double gamma, double etav,
                               double rho_floor, double p_floor, double cr, void* stream) {
  if ((ndim != 2 && ndim != 3) || (order != 1 && order != 2) || !holds(eqn) ||
      nvar < nbase_of(eqn) || nvar > 64 || tile_t < 1 || tile_w < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L = make_layout(ndim, nz, ny, nx, 0, nvar, 0, 0ull);
  const Tiling tl = make_tiling(L, tile_t, tile_w);
  const size_t smem = tile_bytes(nvar, nbase_of(eqn), order, tile_t, tile_w,
                                 mask != nullptr, sizeof(real));
  const long nblocks = (long)tl.n_ta * tl.n_tw * tl.n_third;
  if (smem > SMEM_MAX || nblocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const Consts<real> c = make_consts<real>(dx, gamma, etav, rho_floor, p_floor, cr);
  cudaStream_t s = (cudaStream_t)stream;
#define PION_FINAL_LAUNCH(E, A, O, K)                                                       \
  {                                                                                         \
    const cudaError_t e = allow_tile_smem<real, E, PION_SOLVER, A, O, K>(smem);             \
    if (e != cudaSuccess) return (int)e;                                                    \
    final_axis_kernel<real, E, PION_SOLVER, A, O, K><<<(unsigned)nblocks, THREADS, smem, s>>>( \
        (const real*)P, (const uint8_t*)mask, (const real*)P_int, (const real*)c0,          \
        (const real*)c1, (real*)out, (const real*)dt, (const real*)ch, L, tl, c);           \
  }
#define PION_FINAL_CALL(E, A, O)       \
  if (ndim == 3) {                     \
    PION_FINAL_LAUNCH(E, A, O, 2)      \
  } else {                             \
    PION_FINAL_LAUNCH(E, A, O, 1)      \
  }
  PION_DISPATCH(PION_FINAL_CALL)
#undef PION_FINAL_CALL
#undef PION_FINAL_LAUNCH
  return (int)cudaGetLastError();
}
