// MPv3 chemistry kernels for Hopper (sm_90a): the ODE right-hand side of every
// cell (ydot_kernel) and the whole cell update -- forward Euler or a
// backward-Euler Newton ladder -- of every cell (update_euler_kernel, then
// update_ladder_kernel).
//
// Replaces the TPU kernels of pion_tpu/microphysics/pallas_mpv3.py:
//   ydot_kernel                               <- ydot_pallas   (pallas_call at :314)
//   update_euler_kernel + update_ladder_kernel <- update_pallas (pallas_call at :489)
//
// What they compute is MPv3.ydot term by term (reference: MPv3.cpp:1619-1936)
// and the integrator of update_pallas.  What is not carried over is the TPU's
// tiling: the hat-basis matrix products that stood in for table lookups are
// plain reads here.  The update's kernels stage the rate curves (11 x NT)
// and, where they fit beside them in the 48 KB a block gets without opting
// in, the per-source tau tables (K x 4 x NTAU) in shared memory once a block;
// tau tables that do not fit are read in place (L1/L2), and ydot_kernel reads
// all of them in place.  The bin index is arithmetic (the grids
// are log-uniform), and a lookup is two reads.  The number of ionizing sources
// K is a run-time loop over the sources' plane pointers, up to MAX_SRC = 16.
// The pointers travel by value in the launch's parameters (a __grid_constant__
// struct, read in place through the constant cache), so a launch reads nothing
// the host has to copy to the card first, and a CUDA graph of the step
// replays it as it was recorded.
//
// The integrator's unit of adaptivity is a TILE of 1024 consecutive cells of
// the flattened grid, and must stay so: a tile takes its substep count from
// its own largest relative change among the cells past the Euler cutoff,
// skips the ladder when it has none, and stops each Newton iteration on its
// own largest correction, taken over every cell of the tile (Euler and pad
// cells included).  Cells beyond the end of the grid in the last tile take
// part with benign values (1-x 0.5, E 1, nH 1, tau 1e6, ds 0), as the padded
// lanes of the TPU kernel do.
//
// The Newton step needs the exact 2x2 Jacobian of ydot.  ydot_cell is one
// template on its scalar type; the ladder instantiates it with a forward-mode
// dual number carrying two tangents (d/d(1-x), d/dE), the other kernels with
// the plain scalar: they share the formulas letter for letter.  Derivative
// conventions follow the JAX package: max/min give half the tangent at a tie
// (a cell sitting exactly on MIN_NEUTRAL is common), integer bin indices carry
// none.
//
// What bounds them.  ydot_kernel and a tile without the ladder: bytes by the
// roofline count (8 planes read, 2 written for one source; ~250 flops and ~12
// transcendentals a cell are under the card's rate for that many bytes), but
// in fact the issue of that arithmetic: without --use_fast_math each IEEE
// exp, log, pow and division is tens of instructions.  A tile that runs the
// ladder: operations -- up to 32 substeps x 8 Newton iterations of a
// dual-number evaluation (about three times the flops of ydot) for each of its
// 1024 cells -- but in fact latency: each Newton iteration of a tile is one
// dependent chain of evaluation, clamp and tile-wide reduction, and a state
// typically sends a few dozen of its 2048 tiles (128^3) through the ladder.
//
// What the design does about it.  Measured on an H100 (kernel_times.py,
// 128^3 float32, one source): the first design of ydot_kernel -- every one
// of its 2048 blocks staging the tables before its 1024 cells -- takes 0.075
// ms with the source pointers by value, its staging and barrier alone
// 0.0066, its cells alone with the tables read in place 0.070: the kernel is
// bound by issuing its IEEE arithmetic (~1000 instructions a cell), not by
// bytes or by the staging.  Trials whose code is not kept ran slower or
// gained little: persistent grids that staged once a block and strode over
// the tiles (their walk and static share of tiles cost more than the
// staging), four cells a thread read first into registers by 128-bit loads
// (80 registers), and source 0's inputs held in registers with only the two
// tau-table curves the evaluation reads (a few per cent, for a template
// parameter in ydot_cell, which the ladder shares).  So ydot_kernel keeps
// one block a tile and stages nothing: it reads the tables in place.  The
// update is two launches.  Pass 1, one
// block of 256 threads a tile (4 cells a thread), evaluates ydot (or reads
// the caller's f0), forms the Euler result and the tile's stiffness (a block
// reduction), writes every cell it owns the result of, and appends each tile
// that needs the ladder -- its index, its stiffness and one bit a cell for
// the Euler flags -- to a list in device memory through an atomic counter;
// the host never reads the count.  Pass 2 serves each listed tile with a
// thread-block cluster of CLUSTER = 4 blocks of 256 threads, one cell a
// thread, so that a tile's ladder runs on four SMs and each thread's serial
// chain is one cell long.  The tile-wide max of each Newton iteration's
// correction is reduced through distributed shared memory: each warp's
// maximum is stored into every block of the cluster (map_shared_rank), and
// after one cluster barrier each thread reduces the 32 words of its own
// block.  A cell's inputs (nH, the
// column, path length and rate of the first HOIST sources, the UV fields) and
// the four tau-table curves at each of those columns stay in registers
// through the ladder; further sources are read again at each evaluation.
// Pass 2's clusters walk the list (fused_mpv3.update_plan sizes its grid);
// clusters past the count exit at once.
//
// Compiled once per scalar type (-DPION_REAL=float|double), without
// --use_fast_math: exp, log and division keep their IEEE rounding and
// subnormals are kept, so the kernels stay within rounding of their plain
// PyTorch versions (pion_tpu_torch/microphysics/fused_mpv3.py).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#ifndef PION_REAL
#define PION_REAL float
#endif

namespace pion {

namespace cg = cooperative_groups;

constexpr int TILE = 1024;     // cells a block owns: the unit of adaptivity
constexpr int THREADS = 256;
constexpr int CPT = TILE / THREADS;
constexpr int CLUSTER = 4;     // blocks of the cluster that runs one tile's ladder
constexpr int LTHREADS = TILE / CLUSTER;   // one cell a thread there
constexpr int HOIST = 4;       // sources whose inputs are kept through the ladder
constexpr int MAX_SRC = 16;    // ionizing sources a launch takes
constexpr int NCURVE = 10;     // temperature curves after the grid row

constexpr double MIN_NEUTRAL = 1.0e-20;
constexpr double EULER_CUTOFF = 0.05;
constexpr double SIGMA0 = 6.3042e-18;
constexpr double E_EXCESS = 8.01e-12;
constexpr double LOGTEN = 2.302585092994046;

enum { ION_NONE = 0, ION_MONO = 1, ION_MFION = 2 };

// ---------------------------------------------------------------------------
// scalar maths, overloaded so that one formula serves float and double
// ---------------------------------------------------------------------------
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_log10(float x) { return log10f(x); }
__device__ __forceinline__ double m_log10(double x) { return log10(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_pow(float x, float p) { return powf(x, p); }
__device__ __forceinline__ double m_pow(double x, double p) { return pow(x, p); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
__device__ __forceinline__ float m_ceil(float x) { return ceilf(x); }
__device__ __forceinline__ double m_ceil(double x) { return ceil(x); }

// max that hands a NaN on, as the reductions of the plain version do
template <class R>
__device__ __forceinline__ R nan_max(R a, R b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// ---------------------------------------------------------------------------
// forward-mode dual number with two tangents
// ---------------------------------------------------------------------------
template <class R>
struct Dual {
  R v, a, b;
};

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ double val(double x) { return x; }
template <class R> __device__ __forceinline__ R val(const Dual<R>& x) { return x.v; }

#define PION_DD template <class R> __device__ __forceinline__ Dual<R>
PION_DD operator-(const Dual<R>& x) { return {-x.v, -x.a, -x.b}; }
PION_DD operator+(const Dual<R>& x, const Dual<R>& y) { return {x.v + y.v, x.a + y.a, x.b + y.b}; }
PION_DD operator+(const Dual<R>& x, R y) { return {x.v + y, x.a, x.b}; }
PION_DD operator+(R x, const Dual<R>& y) { return {x + y.v, y.a, y.b}; }
PION_DD operator-(const Dual<R>& x, const Dual<R>& y) { return {x.v - y.v, x.a - y.a, x.b - y.b}; }
PION_DD operator-(const Dual<R>& x, R y) { return {x.v - y, x.a, x.b}; }
PION_DD operator-(R x, const Dual<R>& y) { return {x - y.v, -y.a, -y.b}; }
PION_DD operator*(const Dual<R>& x, const Dual<R>& y) {
  return {x.v * y.v, x.a * y.v + x.v * y.a, x.b * y.v + x.v * y.b};
}
PION_DD operator*(const Dual<R>& x, R y) { return {x.v * y, x.a * y, x.b * y}; }
PION_DD operator*(R x, const Dual<R>& y) { return {x * y.v, x * y.a, x * y.b}; }
PION_DD operator/(const Dual<R>& x, const Dual<R>& y) {
  const R q = x.v / y.v;
  return {q, (x.a - q * y.a) / y.v, (x.b - q * y.b) / y.v};
}
PION_DD operator/(const Dual<R>& x, R y) { return {x.v / y, x.a / y, x.b / y}; }
PION_DD operator/(R x, const Dual<R>& y) {
  const R q = x / y.v;
  return {q, -q * y.a / y.v, -q * y.b / y.v};
}
PION_DD m_exp(const Dual<R>& x) {
  const R e = m_exp(x.v);
  return {e, e * x.a, e * x.b};
}
PION_DD m_log(const Dual<R>& x) { return {m_log(x.v), x.a / x.v, x.b / x.v}; }
PION_DD m_log10(const Dual<R>& x) {
  const R d = x.v * R(LOGTEN);
  return {m_log10(x.v), x.a / d, x.b / d};
}
PION_DD m_sqrt(const Dual<R>& x) {
  const R s = m_sqrt(x.v);
  const R d = R(0.5) / s;
  return {s, d * x.a, d * x.b};
}
PION_DD m_pow(const Dual<R>& x, R p) {
  const R d = p * m_pow(x.v, p - R(1));
  return {m_pow(x.v, p), d * x.a, d * x.b};
}
#undef PION_DD

// max/min against a constant or another value: the larger (smaller) operand's
// tangent, half of each at a tie
__device__ __forceinline__ float m_max(float x, float c) { return x > c ? x : c; }
__device__ __forceinline__ double m_max(double x, double c) { return x > c ? x : c; }
__device__ __forceinline__ float m_min(float x, float c) { return x < c ? x : c; }
__device__ __forceinline__ double m_min(double x, double c) { return x < c ? x : c; }
template <class R>
__device__ __forceinline__ Dual<R> m_max(const Dual<R>& x, R c) {
  if (x.v > c) return x;
  if (x.v < c) return {c, R(0), R(0)};
  return {c, R(0.5) * x.a, R(0.5) * x.b};
}
template <class R>
__device__ __forceinline__ Dual<R> m_min(const Dual<R>& x, R c) {
  if (x.v < c) return x;
  if (x.v > c) return {c, R(0), R(0)};
  return {c, R(0.5) * x.a, R(0.5) * x.b};
}
template <class R>
__device__ __forceinline__ Dual<R> m_max(const Dual<R>& x, const Dual<R>& y) {
  if (x.v > y.v) return x;
  if (x.v < y.v) return y;
  return {x.v, R(0.5) * (x.a + y.a), R(0.5) * (x.b + y.b)};
}

// ---------------------------------------------------------------------------
// what a launch is given
// ---------------------------------------------------------------------------
template <class R>
struct Params {
  R gm1, kB, n_ion, n_elec, Z, Tmin, Tmax;
  R lt0, inv_dlt;                  // log10 T grid: origin and bins per dex
  R ltau0, inv_dltau, tau_lo, tau_hi;
  R mono_frac;
  int nt, ntau, K;
  long n;                          // cells of the grid
  const R* omx;
  const R* E;
  const R* nH;
  // 4 pointers a source: the planes of the column to the cell's entry, of the
  // path length through the cell and of Ndot/Vshell (mono) or scale/Vshell
  // (mfion), then the (4, NTAU) log10 rate tables
  const R* src[4 * MAX_SRC];
  int stage_tau;                   // the tau tables fit in shared memory
  const R* g0uv;
  const R* g0ir;
  const R* t1;                     // (11, NT): the T grid, then the 10 curves
};

enum { SRC_TAU0 = 0, SRC_DS = 1, SRC_NVSV = 2, SRC_TAB = 3 };

// Stage the tables in shared memory: [11*nt | K*4*ntau], the second part
// only where it fits.
template <class R>
__device__ void stage_tables(const Params<R>& p, R* s_t1, R* s_tau, int ion) {
  for (int i = threadIdx.x; i < (NCURVE + 1) * p.nt; i += blockDim.x) s_t1[i] = p.t1[i];
  if (ion == ION_MFION && p.stage_tau) {
    for (int k = 0; k < p.K; ++k) {
      const R* tab = p.src[4 * k + SRC_TAB];
      for (int i = threadIdx.x; i < 4 * p.ntau; i += blockDim.x)
        s_tau[k * 4 * p.ntau + i] = tab[i];
    }
  }
  __syncthreads();
}

// Source k's (4, NTAU) table: the staged copy, or the caller's in place.
template <class R>
__device__ __forceinline__ const R* tau_table(const Params<R>& p, const R* s_tau, int k) {
  return p.stage_tau ? s_tau + k * 4 * p.ntau : p.src[4 * k + SRC_TAB];
}

// One curve of a tau table at fractional coordinate (i, w).
template <class R, class S>
__device__ __forceinline__ S tau_curve(const R* tab, int ntau, int c, int i, const S& w) {
  const R lo = tab[c * ntau + i];
  const R hi = tab[c * ntau + i + 1];
  return m_exp(R(LOGTEN) * (lo + w * (hi - lo)));
}

// Bin and clipped weight of a column density on the log10 tau grid.
template <class R, class S>
__device__ __forceinline__ void tau_coord(const Params<R>& p, const S& tau, int& i, S& w) {
  const S lt = m_log10(m_min(m_max(tau, p.tau_lo), p.tau_hi));
  const S f = (lt - p.ltau0) * p.inv_dltau;
  i = (int)val(f);
  i = i < 0 ? 0 : (i > p.ntau - 2 ? p.ntau - 2 : i);
  w = m_min(m_max(f - R(i), R(0)), R(1));
}

// The four curves of a source's table at the column to the cell's entry.
template <class R>
__device__ __forceinline__ void tau0_curves(const Params<R>& p, const R* tab, R tau0, R* out) {
  int i0;
  R w0;
  tau_coord<R, R>(p, tau0, i0, w0);
  for (int c = 0; c < 4; ++c) out[c] = tau_curve<R, R>(tab, p.ntau, c, i0, w0);
}

// What a cell of a ladder tile keeps in registers through the ladder: its
// inputs from the first HOIST sources, the four tau-table curves at each one's
// column to the cell's entry (mfion; constant through the ladder), and its UV
// fields.
template <class R>
struct CellIn {
  R tau0[HOIST], ds[HOIST], nv[HOIST], r0[4 * HOIST];
  R g0uv, g0ir;
};

// Photoionization rate and heating of source k at one cell.  c0: the source's
// tau0_curves at this cell made beforehand, or null to make them here.
template <class R, class S, int ION>
__device__ __forceinline__ void photo_term(const Params<R>& p, const R* s_tau, int k, R tau0, R ds,
                                           R nv, const R* c0, const S& omx, R nH, S& omx_dot,
                                           S& Edot) {
  if (ION == ION_MONO) {
    const S dtau = nH * ds * omx * R(SIGMA0) * p.mono_frac;
    R rate0 = nv * m_exp(-tau0 * p.mono_frac);
    const S att = val(dtau) < R(1.0e-4) ? dtau : R(1) - m_exp(-dtau);
    const S rate = rate0 * att / nH;
    omx_dot = omx_dot - rate;
    Edot = Edot + rate * R(E_EXCESS);
  } else {
    const S dtau_cur = nH * ds * omx * R(SIGMA0);
    const R* tab = tau_table(p, s_tau, k);
    R here[4];   // rate, heat and their low-tau slopes at tau0
    if (c0 == nullptr) {
      tau0_curves<R>(p, tab, tau0, here);
      c0 = here;
    }
    S pir, pih;
    if (val(dtau_cur) < R(0.01)) {
      pir = c0[2] * dtau_cur / (R(SIGMA0) * nH);
      pih = c0[3] * dtau_cur / (R(SIGMA0) * nH);
    } else {
      int i1;
      S w1;
      tau_coord<R, S>(p, tau0 + dtau_cur, i1, w1);
      pir = c0[0] - tau_curve<R, S>(tab, p.ntau, 0, i1, w1);
      pih = c0[1] - tau_curve<R, S>(tab, p.ntau, 1, i1, w1);
    }
    omx_dot = omx_dot - pir * nv / nH;
    Edot = Edot + pih * nv / nH;
  }
}

// The right-hand side of one cell: MPv3.ydot term by term.  S is R or
// Dual<R>.  idx/valid address the per-source planes; a cell past the end of
// the grid takes the pad values.  HOISTED: the inputs of the first HOIST
// sources and the UV fields come from `in` (registers) instead of device
// memory; further sources are read at each evaluation as without it.
template <class R, class S, int ION, int UV, bool HOISTED>
__device__ __forceinline__ void ydot_cell(const Params<R>& p, const R* s_t1, const R* s_tau,
                                          long idx, bool valid, const S& omx_in, const S& Eint,
                                          R nH, const CellIn<R>& in, S& omx_dot, S& Edot) {
  const S omx = m_max(omx_in, R(MIN_NEUTRAL));
  const S x = R(1) - omx;
  const S ntot = (p.n_ion + p.n_elec * x) * nH;
  const S T = p.gm1 * Eint / (p.kB * ntot);
  const S Tc = m_min(m_max(T, p.Tmin), p.Tmax);
  const R expnh = m_exp(-nH / R(1.0e4));
  const S ne = p.n_elec * x * nH + nH * R(1.5e-4) * p.Z * expnh;

  // the ten temperature curves: bin from log10(Tc), weight from the stored grid
  int iT = (int)((m_log10(val(Tc)) - p.lt0) * p.inv_dlt);
  iT = iT < 0 ? 0 : (iT > p.nt - 2 ? p.nt - 2 : iT);
  const R Tg0 = s_t1[iT], Tg1 = s_t1[iT + 1];
  const S wT = (Tc - Tg0) / (Tg1 - Tg0);
#define PION_CURVE(k) \
  (s_t1[((k) + 1) * p.nt + iT] + wT * (s_t1[((k) + 1) * p.nt + iT + 1] - s_t1[((k) + 1) * p.nt + iT]))
  const S cirh = PION_CURVE(0), C_cih0 = PION_CURVE(1), rrhp = PION_CURVE(2);
  const S C_rrh = PION_CURVE(3), C_ffhe = PION_CURVE(4), C_cxh0 = PION_CURVE(5);
  const S C_fbdn = PION_CURVE(6), C_cie = PION_CURVE(7), C_cxch = PION_CURVE(8);
  const S C_cxo = PION_CURVE(9);
#undef PION_CURVE

  // Wolfire+ (2003) closed forms in (T, ne)
  const S lnT = m_log(Tc);
  const S sqT = m_sqrt(Tc);
  const S H_pah = R(1.083e-25) * p.Z / (R(1) + R(9.77e-3) * m_pow(sqT / ne, R(0.73)));
  const S C_pah = R(3.02e-30) * p.Z *
                  m_exp(R(0.94) * lnT + R(0.74) * m_pow(Tc, R(-0.068)) * m_log(R(3.4) * sqT / ne)) *
                  ne;
  const S C_cxce = R(1.4e-23) * p.Z * m_exp(R(-0.5) * lnT - R(92.0) / Tc) * ne /
                   (R(1) + R(0.05) * ne * m_pow(Tc / R(2000.0), R(-0.37)));

  // collisional ionization + cooling
  omx_dot = -(cirh * ne * omx);
  Edot = -(C_cih0 * ne * omx);

  // photoionization, summed over the ionizing sources in order
  if (ION != ION_NONE) {
    int k0 = 0;
    if (HOISTED) {
#pragma unroll
      for (int k = 0; k < HOIST; ++k) {
        if (k < p.K)
          photo_term<R, S, ION>(p, s_tau, k, in.tau0[k], in.ds[k], in.nv[k],
                                ION == ION_MFION ? in.r0 + 4 * k : nullptr, omx, nH, omx_dot,
                                Edot);
      }
      k0 = HOIST;
    }
    for (int k = k0; k < p.K; ++k) {
      const R tau0 = valid ? p.src[4 * k + SRC_TAU0][idx] : R(1.0e6);
      const R ds = valid ? p.src[4 * k + SRC_DS][idx] : R(0);
      const R nv = valid ? p.src[4 * k + SRC_NVSV][idx] : R(0);
      photo_term<R, S, ION>(p, s_tau, k, tau0, ds, nv, nullptr, omx, nH, omx_dot, Edot);
    }
  }

  // recombination + cooling, He free-free, H0 collisional excitation
  omx_dot = omx_dot + rrhp * x * ne;
  Edot = Edot - C_rrh * x * ne;
  Edot = Edot - C_ffhe * x * ne;
  Edot = Edot - C_cxh0 * omx * ne;

  // UV/IR heating (Henney+09)
  if (UV) {
    const R g0uv = HOISTED ? in.g0uv : (valid ? p.g0uv[idx] : R(0));
    const R g0ir = HOISTED ? in.g0ir : (valid ? p.g0ir[idx] : R(0));
    const R q = R(1) + R(3.0e4) / nH;
    Edot = Edot + R(1.9e-26) * p.Z * g0uv / (R(1) + R(6.4) * (g0uv / nH));
    Edot = Edot + R(7.7e-32) * p.Z * g0ir / (q * q);
  }

  // cosmic-ray heating and ionization, PAH heating
  Edot = Edot + R(5.0e-28) * omx;
  omx_dot = omx_dot - R(1.8e-17) * omx;
  Edot = Edot + omx * H_pah;

  // metal cooling: max(forbidden-line, CIE + CII-e)
  const S fbdn = C_fbdn * x * ne;
  const S cie = C_cie * x * x * nH + C_cxce;
  Edot = Edot - m_max(fbdn, cie);

  // CII/OI cooling by neutral H collisions, PAH cooling
  Edot = Edot - C_cxch * nH * omx * expnh;
  Edot = Edot - C_cxo * nH * omx;
  Edot = Edot - C_pah;

  Edot = Edot * nH;
  // limit cooling near the temperature floor
  if (val(Edot) < R(0) && val(T) < R(2) * p.Tmin) {
    Edot = m_min(Edot * (T - p.Tmin) / p.Tmin, R(0));
  }
}

// Largest value over the block, NaN handed on; every thread gets it.
template <class R>
__device__ R block_max(R v, R* scratch) {
  for (int off = 16; off > 0; off >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  R out = scratch[0];
  for (int w = 1; w < (THREADS + 31) / 32; ++w) out = nan_max(out, scratch[w]);
  __syncthreads();
  return out;
}

// ---------------------------------------------------------------------------
// B4: ydot over the grid
// ---------------------------------------------------------------------------
// One block a tile of 1024 cells, thread r the cells r + j THREADS (j < CPT),
// one after another.  Nothing is staged: the temperature curves and the tau
// tables are read in place, through L1.
template <class R, int ION, int UV>
__global__ void __launch_bounds__(THREADS)
    ydot_kernel(const __grid_constant__ Params<R> p, R* __restrict__ out_o,
                R* __restrict__ out_e) {
  const long base = (long)blockIdx.x * TILE + threadIdx.x;
#pragma unroll 1
  for (int j = 0; j < CPT; ++j) {
    const long idx = base + (long)j * THREADS;
    if (idx >= p.n) break;
    R od, ed;
    const CellIn<R> none{};
    ydot_cell<R, R, ION, UV, false>(p, p.t1, nullptr, idx, true, p.omx[idx], p.E[idx],
                                    p.nH[idx], none, od, ed);
    out_o[idx] = od;
    out_e[idx] = ed;
  }
}

#ifdef PION_YDOT_PROBE
// Timing probes of B4's first design (kernel_times.py), built only into the
// probe library: one block a tile, four cells a thread one after another,
// the tables staged in shared memory by every block; and that design's
// staging and barrier alone.
template <class R, int ION, int UV>
__global__ void __launch_bounds__(THREADS)
    ydot_tile_probe_kernel(const __grid_constant__ Params<R> p, R* __restrict__ out_o,
                           R* __restrict__ out_e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  R* s_t1 = reinterpret_cast<R*>(smem_raw);
  R* s_tau = s_t1 + (NCURVE + 1) * p.nt;
  stage_tables(p, s_t1, s_tau, ION);
  const long base = (long)blockIdx.x * TILE;
#pragma unroll 1
  for (int j = 0; j < CPT; ++j) {
    const long idx = base + j * THREADS + threadIdx.x;
    if (idx >= p.n) continue;
    R od, ed;
    const CellIn<R> none{};
    ydot_cell<R, R, ION, UV, false>(p, s_t1, s_tau, idx, true, p.omx[idx], p.E[idx], p.nH[idx],
                                    none, od, ed);
    out_o[idx] = od;
    out_e[idx] = ed;
  }
}

template <class R>
__global__ void __launch_bounds__(THREADS)
    ydot_stage_probe_kernel(const __grid_constant__ Params<R> p, R* __restrict__ sink) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  R* s_t1 = reinterpret_cast<R*>(smem_raw);
  R* s_tau = s_t1 + (NCURVE + 1) * p.nt;
  stage_tables(p, s_t1, s_tau, ION_MFION);
  // a value no table holds: the staging is kept, nothing is written
  if (s_t1[threadIdx.x] == R(-1.2345e30)) sink[blockIdx.x] = s_tau[threadIdx.x];
}
#endif

// Largest value over a cluster of CLUSTER blocks, NaN handed on; every thread
// of the cluster gets it, from the same values in the same order, so every
// thread takes the same branch after it.  Each warp reduces its own values by
// shuffles and stores the result into slot [rank][warp] of `wall[par]` in
// every block of the cluster (distributed shared memory); after one cluster
// barrier each thread reads the CLUSTER x LTHREADS/32 words of its own block.
// The two halves of `wall` are used in turns (`par`): a block's words of one
// half are written again only two calls later, after every thread of the
// cluster has passed the barrier of the call in between and so finished
// reading them.
template <class R>
__device__ __forceinline__ R cluster_max(R v, R (*wall)[TILE / 32], int& par,
                                         cg::cluster_group& cluster) {
  for (int off = 16; off > 0; off >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) {
    const int slot = (int)cluster.block_rank() * (LTHREADS / 32) + (threadIdx.x >> 5);
    for (int r = 0; r < CLUSTER; ++r) *cluster.map_shared_rank(&wall[par][slot], r) = v;
  }
  cluster.sync();
  R out = wall[par][0];
#pragma unroll
  for (int w = 1; w < TILE / 32; ++w) out = nan_max(out, wall[par][w]);
  par ^= 1;
  return out;
}

// The device-side list of the tiles that take the ladder, written by pass 1
// and read by pass 2; the host never reads it.
template <class R>
struct Ladder {
  int* count;             // tiles listed (zeroed before pass 1)
  int* tiles;             // their indices, in the order they were listed
  R* stiff;               // the stiffness of each
  unsigned* euler_bits;   // 32 words a tile of the grid: bit set = Euler cell
};

// ---------------------------------------------------------------------------
// B3 pass 1: one block a tile -- ydot (or f0), Euler results, the tile's
// stiffness; lists the tiles that need the ladder
// ---------------------------------------------------------------------------
template <class R, int ION, int UV>
__global__ void __launch_bounds__(THREADS)
    update_euler_kernel(const __grid_constant__ Params<R> p, const R* __restrict__ dt_ptr,
                        const R* __restrict__ f0o,
                        const R* __restrict__ f0e, R* __restrict__ out_o, R* __restrict__ out_e,
                        Ladder<R> lad, int* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ R scratch[(THREADS + 31) / 32];
  R* s_t1 = reinterpret_cast<R*>(smem_raw);
  R* s_tau = s_t1 + (NCURVE + 1) * p.nt;
  stage_tables(p, s_t1, s_tau, ION);
  const R dt = *dt_ptr;
  const long base = (long)blockIdx.x * TILE;

  R o[CPT], e[CPT], o_eul[CPT], e_eul[CPT];
  bool euler[CPT];
  R stiff = R(0);
#pragma unroll 1
  for (int j = 0; j < CPT; ++j) {
    const long idx = base + j * THREADS + threadIdx.x;
    const bool valid = idx < p.n;
    o[j] = valid ? p.omx[idx] : R(0.5);
    e[j] = valid ? p.E[idx] : R(1);
    const R nHc = valid ? p.nH[idx] : R(1);
    R f0v, f1v;
    if (f0o != nullptr) {
      // first evaluation handed over by the caller (pad cells: 0)
      f0v = valid ? f0o[idx] : R(0);
      f1v = valid ? f0e[idx] : R(0);
    } else {
      const CellIn<R> none{};
      ydot_cell<R, R, ION, UV, false>(p, s_t1, s_tau, idx, valid, o[j], e[j], nHc, none, f0v,
                                      f1v);
    }
    const R maxdelta = nan_max(m_abs(f0v * dt / o[j]), m_abs(f1v * dt / e[j]));
    o_eul[j] = o[j] + dt * f0v;
    e_eul[j] = e[j] + dt * f1v;
    euler[j] = maxdelta < R(EULER_CUTOFF);
    if (!euler[j]) stiff = nan_max(stiff, maxdelta);
  }
  const R stiffness = block_max(stiff, scratch);
  const bool ladder = stiffness > R(0);   // the same for every thread of the block

  if (ladder) {
    // the tile's Euler flags, cell j * THREADS + threadIdx.x at bit lane of
    // word j * THREADS / 32 + warp
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const unsigned bits = __ballot_sync(0xffffffffu, euler[j]);
      if ((threadIdx.x & 31) == 0)
        lad.euler_bits[blockIdx.x * (TILE / 32) + j * (THREADS / 32) + (threadIdx.x >> 5)] = bits;
    }
    if (threadIdx.x == 0) {
      const int slot = atomicAdd(lad.count, 1);
      lad.tiles[slot] = blockIdx.x;
      lad.stiff[slot] = stiffness;
      if (stats != nullptr) atomicAdd(stats, 1);
    }
  }
  // every cell but a ladder tile's non-Euler ones, which pass 2 writes (a
  // non-Euler cell of a tile without the ladder -- a NaN stiffness -- keeps
  // its state)
#pragma unroll 1
  for (int j = 0; j < CPT; ++j) {
    const long idx = base + j * THREADS + threadIdx.x;
    if (idx >= p.n || (ladder && !euler[j])) continue;
    out_o[idx] = euler[j] ? o_eul[j] : o[j];
    out_e[idx] = euler[j] ? e_eul[j] : e[j];
  }
}

// ---------------------------------------------------------------------------
// B3 pass 2: the ladder of each listed tile, one thread-block cluster a tile,
// one cell a thread; clusters walk the list from their index by the number of
// clusters
// ---------------------------------------------------------------------------
template <class R, int ION, int UV>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(LTHREADS)
    update_ladder_kernel(const __grid_constant__ Params<R> p, const R* __restrict__ dt_ptr,
                         int n_sub, int n_newton,
                         R tol, R* __restrict__ out_o, R* __restrict__ out_e, Ladder<R> lad,
                         int* __restrict__ stats) {
  const int listed = *lad.count;
  const int first = blockIdx.x / CLUSTER;
  const int stride = gridDim.x / CLUSTER;
  if (first >= listed) return;   // the whole cluster, before any barrier
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ R wall[2][TILE / 32];   // the cluster's warp maxima, two halves
  R* s_t1 = reinterpret_cast<R*>(smem_raw);
  R* s_tau = s_t1 + (NCURVE + 1) * p.nt;
  stage_tables(p, s_t1, s_tau, ION);
  const R dt = *dt_ptr;
  const int c = (int)cluster.block_rank() * LTHREADS + threadIdx.x;   // cell of the tile
  int par = 0;

  for (int slot = first; slot < listed; slot += stride) {
    const int tile = lad.tiles[slot];
    const long idx = (long)tile * TILE + c;
    const bool valid = idx < p.n;
    const bool euler = (lad.euler_bits[tile * (TILE / 32) + (c >> 5)] >> (c & 31)) & 1u;
    R o = valid ? p.omx[idx] : R(0.5);
    R e = valid ? p.E[idx] : R(1);
    const R nHc = valid ? p.nH[idx] : R(1);
    // the cell's inputs, kept in registers through the ladder
    CellIn<R> in;
#pragma unroll
    for (int k = 0; k < HOIST; ++k) {
      if (ION != ION_NONE && k < p.K) {
        in.tau0[k] = valid ? p.src[4 * k + SRC_TAU0][idx] : R(1.0e6);
        in.ds[k] = valid ? p.src[4 * k + SRC_DS][idx] : R(0);
        in.nv[k] = valid ? p.src[4 * k + SRC_NVSV][idx] : R(0);
        // tau0 is constant through the ladder: its lookup is made once
        if (ION == ION_MFION) tau0_curves<R>(p, tau_table(p, s_tau, k), in.tau0[k], in.r0 + 4 * k);
      }
    }
    if (UV) {
      in.g0uv = valid ? p.g0uv[idx] : R(0);
      in.g0ir = valid ? p.g0ir[idx] : R(0);
    }
    // the tile's substep count from its own stiffness, clipped as a real so
    // that an infinite stiffness takes the most substeps
    R nf = m_ceil(R(4) * lad.stiff[slot]);
    nf = nf < R(2) ? R(2) : (nf > R(n_sub) ? R(n_sub) : nf);
    const int n_eff = (int)nf;
    const R h = dt / R(n_eff);
    for (int s = 0; s < n_eff; ++s) {
      const R op = o, ep = e;
      R err = R(INFINITY);
      for (int it = 0; it < n_newton && err > tol; ++it) {
        const Dual<R> od{o, R(1), R(0)};
        const Dual<R> ed{e, R(0), R(1)};
        Dual<R> fo, fe;
        ydot_cell<R, Dual<R>, ION, UV, true>(p, s_t1, s_tau, idx, valid, od, ed, nHc, in, fo, fe);
        // g(y) = y - y_prev - h f(y);  J_g = I - h J_f
        const R g0 = o - op - h * fo.v;
        const R g1 = e - ep - h * fe.v;
        const R a = R(1) - h * fo.a;
        const R b = -h * fo.b;
        const R cc = -h * fe.a;
        const R d = R(1) - h * fe.b;
        R det = a * d - b * cc;
        // 1e-300 is 0 in float: the guard then only catches an exact zero
        det = m_abs(det) > R(1e-300) ? det : R(1);
        R d_o = (d * g0 - b * g1) / det;
        R d_e = (a * g1 - cc * g0) / det;
        d_o = m_min(m_max(d_o, R(-0.3)), R(0.3));
        d_e = m_min(m_max(d_e, R(-0.6) * e), R(0.6) * e);
        const R o_n = m_min(m_max(o - d_o, R(MIN_NEUTRAL)), R(1.0 - MIN_NEUTRAL));
        const R e_n = m_max(e - d_e, R(1.0e-10) * ep);
        // every cell of the tile counts, Euler and pad cells included
        R lerr = nan_max(R(0), m_abs(o_n - o));
        lerr = nan_max(lerr, m_abs((e_n - e) / m_max(e, R(1e-300))));
        o = o_n;
        e = e_n;
        err = cluster_max(lerr, wall, par, cluster);
        if (c == 0 && stats != nullptr) atomicAdd(stats + 1, 1);
      }
    }
    if (valid && !euler) {
      out_o[idx] = o;
      out_e[idx] = e;
    }
  }
  cluster.sync();   // no block leaves while another may still write to its wall
}

}  // namespace pion

using real = PION_REAL;
using namespace pion;

// consts: gm1, kB, n_ion, n_elec, Z, Tmin, Tmax, lt0, inv_dlt, ltau0,
// inv_dltau, tau_lo, tau_hi, mono_frac (14 doubles on the host).
// srcs: a host array of 4*K device pointers, source by source: tau0, ds,
// nvsv, tau table (null unless mfion); K at most MAX_SRC.
static int make_params(Params<real>& p, const void* omx, const void* E, const void* nH,
                       const void* const* srcs, int K, const void* g0uv, const void* g0ir,
                       const void* t1, long n, int ion, int has_uv, const double* consts, int nt,
                       int ntau) {
  if (n <= 0 || nt < 2 || K < 0 || K > MAX_SRC || ion < ION_NONE || ion > ION_MFION) return 1;
  if (ion != ION_NONE && (K < 1 || srcs == nullptr)) return 1;
  if (ion == ION_MFION && ntau < 2) return 1;
  if (has_uv && (g0uv == nullptr || g0ir == nullptr)) return 1;
  p.gm1 = (real)consts[0];
  p.kB = (real)consts[1];
  p.n_ion = (real)consts[2];
  p.n_elec = (real)consts[3];
  p.Z = (real)consts[4];
  p.Tmin = (real)consts[5];
  p.Tmax = (real)consts[6];
  p.lt0 = (real)consts[7];
  p.inv_dlt = (real)consts[8];
  p.ltau0 = (real)consts[9];
  p.inv_dltau = (real)consts[10];
  p.tau_lo = (real)consts[11];
  p.tau_hi = (real)consts[12];
  p.mono_frac = (real)consts[13];
  p.nt = nt;
  p.ntau = ntau;
  p.K = ion == ION_NONE ? 0 : K;
  p.n = n;
  p.omx = (const real*)omx;
  p.E = (const real*)E;
  p.nH = (const real*)nH;
  for (int i = 0; i < 4 * MAX_SRC; ++i)
    p.src[i] = i < 4 * p.K ? (const real*)srcs[i] : nullptr;
  p.g0uv = (const real*)g0uv;
  p.g0ir = (const real*)g0ir;
  p.t1 = (const real*)t1;
  return 0;
}

// Shared memory of a launch; sets p.stage_tau.  0: the temperature curves
// alone do not fit.
static size_t table_bytes(Params<real>& p, int ion) {
  const size_t limit = 48 * 1024;
  const size_t t1 = (size_t)(NCURVE + 1) * p.nt * sizeof(real);
  const size_t tau = ion == ION_MFION ? (size_t)p.K * 4 * p.ntau * sizeof(real) : 0;
  if (t1 > limit) return 0;
  p.stage_tau = t1 + tau <= limit;
  return p.stage_tau ? t1 + tau : t1;
}

#define PION_MP_DISPATCH(CALL)                        \
  if (ion == ION_NONE) {                              \
    if (has_uv) { CALL(ION_NONE, 1); } else { CALL(ION_NONE, 0); }   \
  } else if (ion == ION_MONO) {                       \
    if (has_uv) { CALL(ION_MONO, 1); } else { CALL(ION_MONO, 0); }   \
  } else {                                            \
    if (has_uv) { CALL(ION_MFION, 1); } else { CALL(ION_MFION, 0); } \
  }

// ydot of every cell, one block a tile (fused_mpv3.ydot_plan), the tables
// read in place.  Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int pion_mpv3_ydot(const void* omx, const void* E, const void* nH,
                              const void* const* srcs, int K, const void* g0uv,
                              const void* g0ir, const void* t1, void* out_o, void* out_e, long n,
                              int ion, int has_uv, const double* consts, int nt, int ntau,
                              void* stream) {
  Params<real> p;
  if (make_params(p, omx, E, nH, srcs, K, g0uv, g0ir, t1, n, ion, has_uv, consts, nt, ntau))
    return (int)cudaErrorInvalidValue;
  p.stage_tau = 0;
  const unsigned blocks = (unsigned)((n + TILE - 1) / TILE);
  cudaStream_t s = (cudaStream_t)stream;
#define PION_YDOT_CALL(I, U) \
  ydot_kernel<real, I, U><<<blocks, THREADS, 0, s>>>(p, (real*)out_o, (real*)out_e)
  PION_MP_DISPATCH(PION_YDOT_CALL)
#undef PION_YDOT_CALL
  return (int)cudaGetLastError();
}

#ifdef PION_YDOT_PROBE
// which: 0 the first design of ydot_kernel, 1 its staging and barrier alone
// (nothing written).
extern "C" int pion_mpv3_ydot_probe(int which, const void* omx, const void* E, const void* nH,
                                    const void* const* srcs, int K, const void* g0uv,
                                    const void* g0ir, const void* t1, void* out_o, void* out_e,
                                    long n, int ion, int has_uv, const double* consts, int nt,
                                    int ntau, void* stream) {
  Params<real> p;
  if (make_params(p, omx, E, nH, srcs, K, g0uv, g0ir, t1, n, ion, has_uv, consts, nt, ntau))
    return (int)cudaErrorInvalidValue;
  const size_t smem = table_bytes(p, ion);
  if (smem == 0 || which < 0 || which > 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + TILE - 1) / TILE);
  cudaStream_t s = (cudaStream_t)stream;
  if (which == 1) {
    if (ion != ION_MFION) return (int)cudaErrorInvalidValue;
    ydot_stage_probe_kernel<real><<<blocks, THREADS, smem, s>>>(p, (real*)out_o);
    return (int)cudaGetLastError();
  }
#define PION_PROBE_CALL(I, U) \
  ydot_tile_probe_kernel<real, I, U><<<blocks, THREADS, smem, s>>>(p, (real*)out_o, (real*)out_e)
  PION_MP_DISPATCH(PION_PROBE_CALL)
#undef PION_PROBE_CALL
  return (int)cudaGetLastError();
}
#endif

// The update of every cell by *dt (a device scalar), in two launches: pass 1
// (one block a tile) and pass 2 (the ladder, `clusters` clusters of CLUSTER
// blocks walking the list pass 1 made).  f0o/f0e: the caller's first ydot
// evaluation, or null.  stats: two device ints to which the kernels add the
// number of tiles that ran the ladder and the Newton iterations they took in
// all (diagnostics), or null.  ws_int: 1 + 33 * tiles ints, ws_real: tiles
// reals of scratch (fused_mpv3.update_plan).  Returns cudaGetLastError() after
// each launch, or cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int pion_mpv3_update(const void* omx, const void* E, const void* nH,
                                const void* const* srcs, int K, const void* g0uv,
                                const void* g0ir, const void* t1, const void* dt, const void* f0o,
                                const void* f0e, void* out_o, void* out_e, void* stats,
                                long n, int ion, int has_uv, const double* consts, int nt,
                                int ntau, int n_sub, int n_newton, double tol, void* ws_int,
                                void* ws_real, int clusters, void* stream) {
  Params<real> p;
  if (make_params(p, omx, E, nH, srcs, K, g0uv, g0ir, t1, n, ion, has_uv, consts, nt, ntau))
    return (int)cudaErrorInvalidValue;
  if ((f0o == nullptr) != (f0e == nullptr) || dt == nullptr || n_sub < 2 || n_newton < 1 ||
      ws_int == nullptr || ws_real == nullptr || clusters < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = table_bytes(p, ion);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const long tiles = (n + TILE - 1) / TILE;
  if (tiles > 0x3fffffffL / (TILE / 32) || (long)clusters * CLUSTER > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  Ladder<real> lad;
  lad.count = (int*)ws_int;
  lad.tiles = lad.count + 1;
  lad.euler_bits = (unsigned*)(lad.tiles + tiles);
  lad.stiff = (real*)ws_real;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(lad.count, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
#define PION_UPDATE_CALL(I, U)                                                              \
  update_euler_kernel<real, I, U><<<(unsigned)tiles, THREADS, smem, s>>>(                   \
      p, (const real*)dt, (const real*)f0o, (const real*)f0e, (real*)out_o, (real*)out_e,   \
      lad, (int*)stats);                                                                    \
  e = cudaGetLastError();                                                                   \
  if (e != cudaSuccess) return (int)e;                                                      \
  update_ladder_kernel<real, I, U><<<(unsigned)(clusters * CLUSTER), LTHREADS, smem, s>>>(  \
      p, (const real*)dt, n_sub, n_newton, (real)tol, (real*)out_o, (real*)out_e, lad,      \
      (int*)stats)
  PION_MP_DISPATCH(PION_UPDATE_CALL)
#undef PION_UPDATE_CALL
  return (int)cudaGetLastError();
}
