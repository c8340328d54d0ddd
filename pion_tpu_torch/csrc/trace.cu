// Point-source short-characteristics column density for Hopper (sm_90a).
//
// Replaces the TPU kernel _octant_kernel_3d of
// pion_tpu/raytracing/pallas_trace.py (the pallas_call at :229) together with
// its host-side wrapper OctantSweep3D (:241-300).
//
// What it computes: col, the optical depth from the source to each cell's
// exit, by the C2Ray short-characteristics interpolation (Mellema et al. 2006
// eq. A5; reference: raytracer_SC.cpp:2627-2682).  A cell's entry column is a
// weighted mean of the columns of four upstream cells one step nearer the
// source along its major axis (the axis of largest offset, ties preferring x,
// then y, then z); cells on a grid axis through the source take their
// neighbour's column times a geometric factor while nearer than 10 cells.
// With these weights a cell depends only on cells whose offsets from the
// source are component-wise no larger, so the eight source-centred octants
// (each including the source planes) are independent.
//
// Design: one launch a source, eight thread blocks, one an octant, working
// directly on the unflipped (nz, ny, nx) arrays with a sign per axis — no
// flips, transposes or octant copies.  An octant is swept outward in
// Chebyshev shells max(|dz|,|dy|,|dx|) = m; within a shell the z-face, the
// y-face and the x-face are updated in that order with a block barrier after
// each: an edge or corner cell's upstream cells can lie in a lower-preference
// face of the same shell, and this order has them written first.  col lives
// in global memory (an octant of 65^3 cells does not fit in shared memory; it
// stays in the 50 MB L2).  The source planes belong to several octants; each
// of them computes the same values from the same inputs by the same
// arithmetic and writes them, so the duplicate stores agree bit for bit.
//
// Bound: by bytes it reads dtau once and writes col once, but the sweep is a
// chain of max(n) shells of three dependent phases, each a few global-memory
// round trips and a barrier, on 8 of the card's 132 SMs: latency, not bytes,
// sets its floor.  More blocks an octant need a grid-wide barrier per face.
//
// Any source cell, any octant size, nz = 1 allowed (a 2D grid as a slab: the
// 3D weights with z-offset 0 reduce exactly to the 2D ones).  Compiled once
// per scalar type (-DPION_REAL=float|double), without --use_fast_math.
#include <cuda_runtime.h>
#include <math.h>

#ifndef PION_REAL
#define PION_REAL float
#endif

namespace pion {

constexpr int TRACE_THREADS = 1024;

__device__ __forceinline__ float t_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double t_sqrt(double x) { return sqrt(x); }

struct TraceGeom {
  int n[3];      // nz, ny, nx
  int src[3];    // source cell
  long stride[3];
};

// One face of shell m of one octant.  a: the face's (major) axis; p1 < p2:
// the other two axes in array order, n1 x n2 cells to update on this face.
template <class R>
__device__ __forceinline__ void face_pass(const R* __restrict__ dtau, R* col, const TraceGeom& g,
                                          const int sgn[3], int a, int p1, int p2, int m, int n1,
                                          int n2, R tmin, R corr) {
  const R mf = R(m);
  const long base_prev = (long)(g.src[a] + sgn[a] * (m - 1)) * g.stride[a];
  const long base_cur = (long)(g.src[a] + sgn[a] * m) * g.stride[a];
  for (int t = threadIdx.x; t < n1 * n2; t += blockDim.x) {
    const int i1 = t / n2;
    const int i2 = t - i1 * n2;
    // offsets toward the source on the perpendicular axes; at offset 0 the
    // neighbour is the cell itself (edge replication)
    const int j1 = i1 > 0 ? i1 - 1 : 0;
    const int j2 = i2 > 0 ? i2 - 1 : 0;
    const long o1 = (long)(g.src[p1] + sgn[p1] * i1) * g.stride[p1];
    const long o2 = (long)(g.src[p2] + sgn[p2] * i2) * g.stride[p2];
    const long q1 = (long)(g.src[p1] + sgn[p1] * j1) * g.stride[p1];
    const long q2 = (long)(g.src[p2] + sgn[p2] * j2) * g.stride[p2];
    const R c1 = col[base_prev + o1 + o2];
    R tau_in;
    if (i1 == 0 && i2 == 0) {
      tau_in = c1 * corr;                     // on the axis through the source
    } else {
      const R c2 = col[base_prev + q1 + o2];
      const R c3 = col[base_prev + o1 + q2];
      const R c4 = col[base_prev + q1 + q2];
      const R d0 = R(i1) / mf;
      const R d1 = R(i2) / mf;
      const R w1 = (R(1) - d0) * (R(1) - d1) / (c1 > tmin ? c1 : tmin);
      const R w2 = d0 * (R(1) - d1) / (c2 > tmin ? c2 : tmin);
      const R w3 = (R(1) - d0) * d1 / (c3 > tmin ? c3 : tmin);
      const R w4 = d0 * d1 / (c4 > tmin ? c4 : tmin);
      tau_in = (w1 * c1 + w2 * c2 + w3 * c3 + w4 * c4) / (w1 + w2 + w3 + w4);
    }
    const long cell = base_cur + o1 + o2;
    col[cell] = tau_in + dtau[cell];
  }
}

template <class R>
__global__ void __launch_bounds__(TRACE_THREADS)
    octant_trace_kernel(const R* __restrict__ dtau, R* col, TraceGeom g, R tmin) {
  // octant: bit a set -> sweep toward +a from the source cell
  int sgn[3], size[3];
  for (int a = 0; a < 3; ++a) {
    const bool up = (blockIdx.x >> a) & 1;
    sgn[a] = up ? 1 : -1;
    size[a] = up ? g.n[a] - g.src[a] : g.src[a] + 1;
  }
  const int sz = size[0], sy = size[1], sx = size[2];
  const int M = max(sz, max(sy, sx)) - 1;
  if (threadIdx.x == 0) {
    const long s = g.src[0] * g.stride[0] + g.src[1] * g.stride[1] + g.src[2] * g.stride[2];
    col[s] = dtau[s];
  }
  __syncthreads();
  for (int m = 1; m <= M; ++m) {
    const R mf = R(m);
    R corr = R(1);
    if (m < 10) {
      corr = t_sqrt((mf * mf + R(0.25)) / ((mf - R(1)) * (mf - R(1)) + R(0.25))) * (mf - R(1)) /
             (mf > R(1) ? mf : R(1));
    }
    // z-face: z = m, y < m, x < m
    if (m < sz) face_pass<R>(dtau, col, g, sgn, 0, 1, 2, m, min(m, sy), min(m, sx), tmin, corr);
    __syncthreads();
    // y-face: y = m, z <= m, x < m
    if (m < sy) face_pass<R>(dtau, col, g, sgn, 1, 0, 2, m, min(m + 1, sz), min(m, sx), tmin, corr);
    __syncthreads();
    // x-face: x = m, z <= m, y <= m
    if (m < sx)
      face_pass<R>(dtau, col, g, sgn, 2, 0, 1, m, min(m + 1, sz), min(m + 1, sy), tmin, corr);
    __syncthreads();
  }
}

}  // namespace pion

using real = PION_REAL;
using namespace pion;

// col of one point source over an (nz, ny, nx) grid of per-cell optical depth
// increments; (sz, sy, sx) is the source cell.  Returns cudaGetLastError() of
// the launch, or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int pion_octant_trace(const void* dtau, void* col, int nz, int ny, int nx, int sz,
                                 int sy, int sx, double tau_min, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || sz < 0 || sz >= nz || sy < 0 || sy >= ny || sx < 0 ||
      sx >= nx || dtau == nullptr || col == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  TraceGeom g;
  g.n[0] = nz;  g.n[1] = ny;  g.n[2] = nx;
  g.src[0] = sz;  g.src[1] = sy;  g.src[2] = sx;
  g.stride[0] = (long)ny * nx;  g.stride[1] = nx;  g.stride[2] = 1;
  octant_trace_kernel<real><<<8, TRACE_THREADS, 0, (cudaStream_t)stream>>>(
      (const real*)dtau, (real*)col, g, (real)tau_min);
  return (int)cudaGetLastError();
}
