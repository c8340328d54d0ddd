// Fused finite-volume sweep kernels for MHD and GLM-MHD on Cartesian grids.
//
// What they replace.  `sweep_axis_kernel` replaces the TPU kernel
// `_sweep_axis_pallas` (pion_tpu/ops/pallas_sweep.py, tile math in
// `_axis_tile_math`): for one axis, MUSCL reconstruction -> rotation into the
// sweep frame -> GLM (Bx, psi) interface solve -> HLL/HLLD Riemann flux with
// the per-interface HLL fallback -> Falle artificial viscosity -> upwind
// tracer flux with the sCMA clamp and element renormalisation -> flux
// divergence -> Powell and GLM source terms; it writes dt*dU for the interior.
// `final_axis_kernel` replaces `_final_axis_pallas` (same file): the axis-0
// sweep followed in the same thread by U(P) + dU + sum(contribs) ->
// cons_to_prim with floors -> GLM psi damping; it writes the new primitive
// state.
//
// What bounds them here.  Bytes: per cell a sweep reads the padded state and
// the mask once and writes nvar values, a few hundred bytes, against roughly
// a thousand floating-point operations per interface.  At the card's ratio of
// float32 rate to memory rate (about 20 operations per byte) the memory time
// is the larger one, so the bound is the byte count over the memory rate.
//
// What the design does about it.  Nothing is staged in device memory between
// the stages above: one thread owns one interior cell, keeps every
// intermediate in registers and touches device memory only to read the
// stencil and to write its nvar results.  Threads are numbered with x fastest,
// so a warp reads 32 neighbouring addresses of each variable plane whatever
// the sweep axis.  The kernels read the fully padded state with strides, so no
// transverse-interior copy is made beforehand.  The thread evaluates the
// interface pipeline at the cell's low and its high face with the same
// function: a face shared by two threads gets bit-identical fluxes, which
// keeps the scheme conservative.  That does every Riemann solve twice, and the
// stencil is re-read through the caches; a pencil march or a shared-memory
// tile that solves each interface once is the next step, and the time it would
// save is the gap between the measured time and the bound.
//
// The two faces are a loop of two trips that is deliberately not unrolled, so
// each kernel holds one copy of the pipeline.  Tracers are handled one at a
// time after the base variables (they only need the mass flux of each face),
// so any number of tracers runs without per-thread arrays indexed at run time.
//
// Built once per (scalar type, solver) with -DPION_REAL and -DPION_SOLVER;
// equation system, viscosity and order are template parameters selected in the
// launchers.  dt and c_h are read through device pointers, so the host never
// has to know them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "riemann_mhd.cuh"

#ifndef PION_REAL
#define PION_REAL float
#endif
#ifndef PION_SOLVER
#define PION_SOLVER 1
#endif

namespace pion {

constexpr int THREADS = 128;

// Shapes and strides of one launch.  A 2D grid is a 3D one with nz = 1 and no
// ghost layers in z.
struct Layout {
  int nz, ny, nx;      // interior cells
  int gz;              // ghost depth in z (2 in 3D, 0 in 2D); y and x have 2
  long sz, sy;         // strides of the padded spatial axes (x has stride 1)
  long vs;             // stride between variables of the padded state
  long ss;             // stride of the sweep axis in the padded state
  long cells;          // nz * ny * nx, also the variable stride of the output
  int k;               // physical index of the sweep axis (0 = x, 1 = y, 2 = z)
  int nvar;            // base variables + tracers
  int scma;            // 0: none, 1: clamp advected tracers to <= 1
  unsigned long long el_mask;  // bit v set: variable v is an element tracer
};

// The sweep-frame slot j of the velocity/field triple lives in slot (k+j)%3.
__device__ __forceinline__ int rot(int k, int j) {
  const int r = k + j;
  return r >= 3 ? r - 3 : r;
}

// Base variables of one padded cell, rotated into the sweep frame.
template <typename T, int NB>
__device__ __forceinline__ void load_cell(const T* __restrict__ P, long off, long vs, int k,
                                          T (&q)[NB]) {
  q[RO] = P[off + RO * vs];
  q[PG] = P[off + PG * vs];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    q[VX + j] = P[off + (VX + rot(k, j)) * vs];
    q[BX + j] = P[off + (BX + rot(k, j)) * vs];
  }
  if (NB == 9) q[NB - 1] = P[off + SI * vs];
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

// The interface pipeline for the base variables: sweep-frame flux through the
// face whose left cell sits at padded offset `offa`.
template <typename T, int EQN, int SOLVER, int AV, int ORDER>
__device__ __forceinline__ void interface_flux(const T* __restrict__ P,
                                               const uint8_t* __restrict__ mask, long offa,
                                               const Layout& L, const Consts<T>& c, T ch,
                                               T (&flux)[NBase<EQN>::value]) {
  constexpr int NB = NBase<EQN>::value;
  T Pl[NB], Pr[NB];
  {
    T qa[NB], qb[NB];
    load_cell<T, NB>(P, offa, L.vs, L.k, qa);
    load_cell<T, NB>(P, offa + L.ss, L.vs, L.k, qb);
    if (ORDER == 1) {
#pragma unroll
      for (int v = 0; v < NB; ++v) { Pl[v] = qa[v]; Pr[v] = qb[v]; }
    } else {
      T qm[NB], qp[NB];
      load_cell<T, NB>(P, offa - L.ss, L.vs, L.k, qm);
      load_cell<T, NB>(P, offa + 2 * L.ss, L.vs, L.k, qp);
#pragma unroll
      for (int v = 0; v < NB; ++v) edge_pair<T, ORDER>(qm[v], qa[v], qb[v], qp[v], c, Pl[v], Pr[v]);
    }
  }

  // interface uses HLL when either adjacent cell is flagged
  bool use_hll = false;
  if (SOLVER == SOLVER_HLLD && mask != nullptr) {
    use_hll = (mask[offa] | mask[offa + L.ss]) != 0;
  }

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

// Upwind tracer flux on the mass flux (reference: solver_eqn_base.cpp:281-342).
template <typename T>
__device__ __forceinline__ T tracer_flux(T fm, T pl, T pr) {
  const T f = fm > T(0.0) ? pl * fm : pr * fm;
  return fm == T(0.0) ? T(0.0) : f;
}

// Edge states of tracer plane `Pv` at the low and the high face of the cell at
// padded offset `off`.
template <typename T, int ORDER>
__device__ __forceinline__ void tracer_edges(const T* __restrict__ Pv, long off, long ss,
                                             const Consts<T>& c, T (&pl)[2], T (&pr)[2]) {
  const T q0 = Pv[off], qm1 = Pv[off - ss], qp1 = Pv[off + ss];
  if (ORDER == 1) {
    pl[0] = qm1; pr[0] = q0;
    pl[1] = q0;  pr[1] = qp1;
  } else {
    const T qm2 = Pv[off - 2 * ss], qp2 = Pv[off + 2 * ss];
    edge_pair<T, ORDER>(qm2, qm1, q0, qp1, c, pl[0], pr[0]);
    edge_pair<T, ORDER>(qm1, q0, qp1, qp2, c, pl[1], pr[1]);
  }
}

// dt * d(tracer)/dt of every tracer of one cell, handed to `sink(v, value)`.
template <typename T, int EQN, int ORDER, typename Sink>
__device__ __forceinline__ void tracer_updates(const T* __restrict__ P, long offc, const Layout& L,
                                               const Consts<T>& c, T dt, T fm_lo, T fm_hi,
                                               Sink sink) {
  constexpr int NB = NBase<EQN>::value;
  T fac_l[2] = {T(1.0), T(1.0)}, fac_r[2] = {T(1.0), T(1.0)};
  if (L.scma && L.el_mask) {
    // element tracers advect scaled so that their clamped sum is 1
    T sl[2] = {T(0.0), T(0.0)}, sr[2] = {T(0.0), T(0.0)};
    for (int e = NB; e < L.nvar; ++e) {
      if (!((L.el_mask >> e) & 1ull)) continue;
      T pl[2], pr[2];
      tracer_edges<T, ORDER>(P + e * L.vs, offc, L.ss, c, pl, pr);
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
    tracer_edges<T, ORDER>(P + v * L.vs, offc, L.ss, c, pl, pr);
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

// dt * dU of the base variables of the cell at padded offset `offc`, in the
// sweep frame, plus the mass flux through its two faces.
template <typename T, int EQN, int SOLVER, int AV, int ORDER>
__device__ __forceinline__ void cell_dU(const T* __restrict__ P, const uint8_t* __restrict__ mask,
                                        long offc, const Layout& L, const Consts<T>& c, T dt, T ch,
                                        T (&dU)[NBase<EQN>::value], T& fm_lo, T& fm_hi) {
  constexpr int NB = NBase<EQN>::value;
  T acc[NB];
  fm_lo = T(0.0);
  fm_hi = T(0.0);
  // low face, then high face: one copy of the pipeline, two trips
#pragma unroll 1
  for (int f = 0; f < 2; ++f) {
    T flux[NB];
    interface_flux<T, EQN, SOLVER, AV, ORDER>(P, mask, offc + (f - 1) * L.ss, L, c, ch, flux);
    if (f == 0) {
      fm_lo = flux[RO];
#pragma unroll
      for (int v = 0; v < NB; ++v) acc[v] = flux[v];
    } else {
      fm_hi = flux[RO];
#pragma unroll
      for (int v = 0; v < NB; ++v) acc[v] = (acc[v] - flux[v]) / c.dx;
    }
  }

  // Powell 8-wave source terms (reference: solver_eqn_mhd_adi.cpp:396-443)
  T Pc[NB];
  load_cell<T, NB>(P, offc, L.vs, L.k, Pc);
  const long bn = (BX + L.k) * L.vs;
  const T b_lo = P[offc - L.ss + bn], b_hi = P[offc + L.ss + bn];
  const T dbm = (T(0.5) * (b_lo + Pc[BX]) - T(0.5) * (Pc[BX] + b_hi)) / c.dx;
  // u.B summed in the order of the unrotated slots x, y, z
  const int jx = rot(3 - L.k, 0);  // sweep-frame slot that holds the x component
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
    const long sn = SI * L.vs;
    const T s_lo = P[offc - L.ss + sn], s_hi = P[offc + L.ss + sn];
    const T dsm = (T(0.5) * (s_lo + Pc[NB - 1]) - T(0.5) * (Pc[NB - 1] + s_hi)) / c.dx;
    const T vn = Pc[VX];
    pg_new = pg_new + dsm * vn * Pc[NB - 1];
    acc[NB - 1] = acc[NB - 1] + dsm * vn;
  }
  acc[PG] = pg_new;
#pragma unroll
  for (int v = 0; v < NB; ++v) dU[v] = dt * acc[v];
}

// Cell index -> padded offset and output offset; false past the end.
__device__ __forceinline__ bool locate(const Layout& L, long& offc, long& o) {
  o = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= L.cells) return false;
  const int x = (int)(o % L.nx);
  const long r = o / L.nx;
  const int y = (int)(r % L.ny);
  const int z = (int)(r / L.ny);
  offc = (long)(z + L.gz) * L.sz + (long)(y + 2) * L.sy + (x + 2);
  return true;
}

template <typename T, int EQN, int SOLVER, int AV, int ORDER>
__global__ void __launch_bounds__(THREADS)
sweep_axis_kernel(const T* __restrict__ P, const uint8_t* __restrict__ mask, T* __restrict__ out,
                  const T* __restrict__ dt_p, const T* __restrict__ ch_p, Layout L, Consts<T> c) {
  constexpr int NB = NBase<EQN>::value;
  long offc, o;
  if (!locate(L, offc, o)) return;
  const T dt = *dt_p;
  const T ch = *ch_p;
  T dU[NB], fm_lo, fm_hi;
  cell_dU<T, EQN, SOLVER, AV, ORDER>(P, mask, offc, L, c, dt, ch, dU, fm_lo, fm_hi);
  // back out of the sweep frame while storing
  out[o + RO * L.cells] = dU[RO];
  out[o + PG * L.cells] = dU[PG];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    out[o + (VX + rot(L.k, j)) * L.cells] = dU[VX + j];
    out[o + (BX + rot(L.k, j)) * L.cells] = dU[BX + j];
  }
  if (NB == 9) out[o + SI * L.cells] = dU[NB - 1];
  T* outp = out;
  const long cells = L.cells;
  tracer_updates<T, EQN, ORDER>(P, offc, L, c, dt, fm_lo, fm_hi,
                                [outp, o, cells](int v, T val) { outp[o + v * cells] = val; });
}

// The axis-0 sweep plus the conserved update.  K = ndim - 1 is the physical
// index of axis 0 and fixes the rotation at compile time, so the update runs
// on registers in the unrotated frame.
template <typename T, int EQN, int SOLVER, int AV, int ORDER, int K>
__global__ void __launch_bounds__(THREADS)
final_axis_kernel(const T* __restrict__ P, const uint8_t* __restrict__ mask,
                  const T* __restrict__ P_int, const T* __restrict__ c0, const T* __restrict__ c1,
                  T* __restrict__ out, const T* __restrict__ dt_p, const T* __restrict__ ch_p,
                  Layout L, Consts<T> c) {
  constexpr int NB = NBase<EQN>::value;
  long offc, o;
  if (!locate(L, offc, o)) return;
  const T dt = *dt_p;
  const T ch = *ch_p;
  T dUr[NB], fm_lo, fm_hi;
  cell_dU<T, EQN, SOLVER, AV, ORDER>(P, mask, offc, L, c, dt, ch, dUr, fm_lo, fm_hi);
  T dU[NB];
  dU[RO] = dUr[RO];
  dU[PG] = dUr[PG];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    dU[VX + (K + j) % 3] = dUr[VX + j];
    dU[BX + (K + j) % 3] = dUr[BX + j];
  }
  if (NB == 9) dU[NB - 1] = dUr[NB - 1];

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
  if (EQN == EQN_GLM) Pn[NB - 1] = Pn[NB - 1] * exp(-dt * ch * c.cr);
#pragma unroll
  for (int v = 0; v < NB; ++v) out[o + v * L.cells] = Pn[v];

  const T rho_old = Pb[RO], rho_new = Pn[RO];
  const long cells = L.cells;
  T* outp = out;
  tracer_updates<T, EQN, ORDER>(
      P, offc, L, c, dt, fm_lo, fm_hi,
      [outp, o, cells, P_int, c0, c1, rho_old, rho_new](int v, T val) {
        T u = P_int[o + v * cells] * rho_old + val;
        if (c0 != nullptr) u = u + c0[o + v * cells];
        if (c1 != nullptr) u = u + c1[o + v * cells];
        outp[o + v * cells] = u / rho_new;
      });
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
  L.ss = L.k == 0 ? 1 : (L.k == 1 ? L.sy : L.sz);
  L.cells = (long)nz * ny * nx;
  L.nvar = nvar;
  L.scma = scma;
  L.el_mask = el_mask;
  return L;
}

}  // namespace pion

using real = PION_REAL;
using namespace pion;

#define PION_DISPATCH(KERNEL_CALL)                      \
  if (eqn == EQN_GLM) {                                 \
    if (av) {                                           \
      if (order == 2) { KERNEL_CALL(EQN_GLM, 1, 2); }   \
      else            { KERNEL_CALL(EQN_GLM, 1, 1); }   \
    } else {                                            \
      if (order == 2) { KERNEL_CALL(EQN_GLM, 0, 2); }   \
      else            { KERNEL_CALL(EQN_GLM, 0, 1); }   \
    }                                                   \
  } else {                                              \
    if (av) {                                           \
      if (order == 2) { KERNEL_CALL(EQN_MHD, 1, 2); }   \
      else            { KERNEL_CALL(EQN_MHD, 1, 1); }   \
    } else {                                            \
      if (order == 2) { KERNEL_CALL(EQN_MHD, 0, 2); }   \
      else            { KERNEL_CALL(EQN_MHD, 0, 1); }   \
    }                                                   \
  }

// One axis's dt*dU.  P: padded state (nvar, [nz+4,] ny+4, nx+4); mask: padded
// per-cell flags as bytes, or null; out: (nvar, [nz,] ny, nx).  eqn: 0 MHD,
// 1 GLM.  Returns cudaGetLastError() of the launch, or cudaErrorInvalidValue
// for arguments no instantiation covers.
extern "C" int pion_sweep_axis(const void* P, const void* mask, void* out, const void* dt,
                               const void* ch, int ndim, int nz, int ny, int nx, int axis,
                               int nvar, int eqn, int av, int order, int scma,
                               unsigned long long el_mask, double dx, double gamma, double etav,
                               double rho_floor, double p_floor, double cr, void* stream) {
  if ((ndim != 2 && ndim != 3) || axis < 0 || axis >= ndim || (order != 1 && order != 2) ||
      (eqn != EQN_MHD && eqn != EQN_GLM) || nvar < (eqn == EQN_GLM ? 9 : 8) || nvar > 64) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L = make_layout(ndim, nz, ny, nx, axis, nvar, scma, el_mask);
  const Consts<real> c = make_consts<real>(dx, gamma, etav, rho_floor, p_floor, cr);
  const unsigned blocks = (unsigned)((L.cells + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
#define PION_SWEEP_CALL(E, A, O)                                                       \
  sweep_axis_kernel<real, E, PION_SOLVER, A, O><<<blocks, THREADS, 0, s>>>(            \
      (const real*)P, (const uint8_t*)mask, (real*)out, (const real*)dt, (const real*)ch, L, c)
  PION_DISPATCH(PION_SWEEP_CALL)
#undef PION_SWEEP_CALL
  return (int)cudaGetLastError();
}

// The axis-0 sweep fused with the conserved update: writes the new primitive
// state.  P_int: base state (nvar, [nz,] ny, nx); c0, c1: the other axes'
// dt*dU of the same shape, or null.
extern "C" int pion_final_axis(const void* P, const void* mask, const void* P_int, const void* c0,
                               const void* c1, void* out, const void* dt, const void* ch, int ndim,
                               int nz, int ny, int nx, int nvar, int eqn, int av, int order,
                               double dx, double gamma, double etav, double rho_floor,
                               double p_floor, double cr, void* stream) {
  if ((ndim != 2 && ndim != 3) || (order != 1 && order != 2) ||
      (eqn != EQN_MHD && eqn != EQN_GLM) || nvar < (eqn == EQN_GLM ? 9 : 8) || nvar > 64) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L = make_layout(ndim, nz, ny, nx, 0, nvar, 0, 0ull);
  const Consts<real> c = make_consts<real>(dx, gamma, etav, rho_floor, p_floor, cr);
  const unsigned blocks = (unsigned)((L.cells + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
#define PION_FINAL_CALL(E, A, O)                                                            \
  if (ndim == 3) {                                                                          \
    final_axis_kernel<real, E, PION_SOLVER, A, O, 2><<<blocks, THREADS, 0, s>>>(            \
        (const real*)P, (const uint8_t*)mask, (const real*)P_int, (const real*)c0,          \
        (const real*)c1, (real*)out, (const real*)dt, (const real*)ch, L, c);               \
  } else {                                                                                  \
    final_axis_kernel<real, E, PION_SOLVER, A, O, 1><<<blocks, THREADS, 0, s>>>(            \
        (const real*)P, (const uint8_t*)mask, (const real*)P_int, (const real*)c0,          \
        (const real*)c1, (real*)out, (const real*)dt, (const real*)ch, L, c);               \
  }
  PION_DISPATCH(PION_FINAL_CALL)
#undef PION_FINAL_CALL
  return (int)cudaGetLastError();
}
