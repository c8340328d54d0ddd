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
// (each including the source planes) are independent.  An octant is swept
// outward in Chebyshev shells max(|dz|,|dy|,|dx|) = m; within a shell the
// z-face, the y-face and the x-face are updated in that order: an edge or
// corner cell's upstream cells can lie in a lower-preference face of the same
// shell, and this order has them written first.  The source planes belong to
// several octants; each of them computes the same values from the same
// inputs by the same arithmetic and writes them, so the duplicate stores
// agree bit for bit.
//
// What bounds it.  By bytes it reads dtau once and writes col once (0.005 ms
// at 128^3 float32), but the sweep is a chain of max(n) shells of three
// dependent phases: latency, not bytes, sets its floor.  On an H100 SXM
// (700 W) the 128^3 centred trace takes 0.394 ms, 192 phases of 2.05 us,
// of which the cluster barrier alone (arrive.release / wait.acquire on the
// same clusters: the probe of trace_floor.cu, timed by kernel_times.py)
// takes 0.136 ms; the rest is each thread's chain between a wait and an
// arrive: address arithmetic, four loads through the cluster's shared
// window and five IEEE divisions.
//
// Design (plan "cluster", octant_trace_cluster_kernel): one launch a source,
// one thread-block cluster of C blocks an octant (C = 8, or 16 where a
// face's share would pass a cell a thread).  A face of shell m
// reads only cells of shell m - 1 and cells of shell m in faces already
// written, so the cluster keeps the working set on chip: three shells'
// buffers in shared memory, used in turn -- shell m - 1, shell m, and shell
// m + 1, into which each block stages its cells' dtau with cp.async while
// shell m computes.  A cell's col is written over its staged dtau in shared
// memory and stored to device memory once.  Every face of every shell is
// dealt out over the cluster's blocks by rows: cell (i1, i2) of a face (i1
// and i2 its offsets on the face's two axes in array order, n2 cells a row)
// belongs to block i1 % C at slot (i1 / C) * n2 + i2 of that block's part
// of the face; a block's buffer holds its part of the z-face, then of the
// y-face, then of the x-face.  A cell's four upstream cells are found by
// the same rule (the tie rule says which face owns an edge cell) and read
// through distributed shared memory: rows i1 and i1 - 1 of the shell
// before, so a warp's reads fall on its own block and its neighbour, row
// by row.  Each face is bracketed by a wait and an arrive of the cluster
// barrier (release / acquire), so no block reads a neighbour's face before
// it is written, and the last wait keeps every block resident until no
// other reads it.
// fused_trace.trace_plan picks C and the threads a block from the octants'
// sizes and the shared-memory limit; the launcher refuses a cluster the
// card cannot place.
//
// Plan "global" (octant_trace_global_kernel): the first design, kept for the
// octants whose three shells do not fit even a 16-block cluster's shared
// memory (trace_plan chooses it by shape): one block an octant working in
// device memory through the L2, a block barrier a face.
//
// Any source cell, any octant size, nz = 1 allowed (a 2D grid as a slab: the
// 3D weights with z-offset 0 reduce exactly to the 2D ones).  Compiled once
// per scalar type (-DPION_REAL=float|double), without --use_fast_math.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"

#ifndef PION_REAL
#define PION_REAL float
#endif

namespace pion {

namespace cg = cooperative_groups;

constexpr int TRACE_THREADS = 1024;
constexpr int MAX_CLUSTER = 16;
constexpr size_t TRACE_SMEM_MAX = 232448;   // what a block can opt in to

__device__ __forceinline__ float t_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double t_sqrt(double x) { return sqrt(x); }

struct TraceGeom {
  int n[3];      // nz, ny, nx
  int src[3];    // source cell
  long stride[3];
};

// The near-axis factor of shell m (1 from m = 10 on).
template <class R>
__device__ __forceinline__ R axis_corr(int m) {
  const R mf = R(m);
  R corr = R(1);
  if (m < 10) {
    corr = t_sqrt((mf * mf + R(0.25)) / ((mf - R(1)) * (mf - R(1)) + R(0.25))) * (mf - R(1)) /
           (mf > R(1) ? mf : R(1));
  }
  return corr;
}

// Entry column of a cell at offsets (i1, i2) on the face's axes in shell m
// (d0 = i1 / m, d1 = i2 / m), from its four upstream cells c1 (same
// offsets), c2 (i1 - 1), c3 (i2 - 1) and c4 (both); on the axis through the
// source only c1 is used.
template <class R>
__device__ __forceinline__ R entry_column(bool axis, R d0, R d1, R c1, R c2, R c3, R c4, R tmin,
                                          R corr) {
  if (axis) return c1 * corr;
  const R w1 = (R(1) - d0) * (R(1) - d1) / (c1 > tmin ? c1 : tmin);
  const R w2 = d0 * (R(1) - d1) / (c2 > tmin ? c2 : tmin);
  const R w3 = (R(1) - d0) * d1 / (c3 > tmin ? c3 : tmin);
  const R w4 = d0 * d1 / (c4 > tmin ? c4 : tmin);
  return (w1 * c1 + w2 * c2 + w3 * c3 + w4 * c4) / (w1 + w2 + w3 + w4);
}

// ---------------------------------------------------------------------------
// plan "global": one block an octant, col in device memory
// ---------------------------------------------------------------------------

// One face of shell m of one octant.  a: the face's (major) axis; p1 < p2:
// the other two axes in array order, n1 x n2 cells to update on this face.
template <class R>
__device__ __forceinline__ void face_pass(const R* __restrict__ dtau, R* col, const TraceGeom& g,
                                          const int sgn[3], int a, int p1, int p2, int m, int n1,
                                          int n2, R tmin, R corr) {
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
    R c2 = c1, c3 = c1, c4 = c1;
    if (i1 != 0 || i2 != 0) {
      c2 = col[base_prev + q1 + o2];
      c3 = col[base_prev + o1 + q2];
      c4 = col[base_prev + q1 + q2];
    }
    const long cell = base_cur + o1 + o2;
    const R mf = R(m);
    col[cell] = entry_column<R>(i1 == 0 && i2 == 0, R(i1) / mf, R(i2) / mf, c1, c2, c3, c4, tmin,
                                corr) + dtau[cell];
  }
}

template <class R>
__global__ void __launch_bounds__(TRACE_THREADS)
    octant_trace_global_kernel(const R* __restrict__ dtau, R* col, TraceGeom g, R tmin) {
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
    const R corr = axis_corr<R>(m);
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

// ---------------------------------------------------------------------------
// plan "cluster": one thread-block cluster an octant, shells in shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// Face a of shell s of an octant of size[0..2] cells along z, y, x: n1 x n2
// cells (0 where the face lies outside the octant).  The z-face holds the
// cells z = s, y < s, x < s; the y-face y = s, z <= s, x < s; the x-face
// x = s, z <= s, y <= s (shell 0 is the source cell, on its x-face).
__device__ __forceinline__ void face_dims(const int size[3], int s, int a, int& n1,
                                                   int& n2) {
  if (s >= size[a]) {
    n1 = 0;
    n2 = 0;
  } else if (a == 0) {
    n1 = imin(s, size[1]);
    n2 = imin(s, size[2]);
  } else if (a == 1) {
    n1 = imin(s + 1, size[0]);
    n2 = imin(s, size[2]);
  } else {
    n1 = imin(s + 1, size[0]);
    n2 = imin(s + 1, size[1]);
  }
}

// Rows of a face of n1 rows that block `rank` of a cluster of 1 << lg
// blocks holds: rows rank, rank + (1 << lg), ...
__device__ __forceinline__ int rows_of(int n1, int lg, int rank) {
  return n1 > rank ? (n1 - rank + (1 << lg) - 1) >> lg : 0;
}

// Where a block keeps shell s: its buffer, and the first slot of its part of
// the y-face and of the x-face (the z-face's starts at 0).
template <class R>
struct Shell {
  R* buf;
  int b1, b2;
};

template <class R>
__device__ __forceinline__ Shell<R> shell_at(const int size[3], int s, int lg, R* smem, int cap) {
  int n1, n2;
  Shell<R> sh;
  sh.buf = smem + (s % 3) * cap;
  face_dims(size, s, 0, n1, n2);
  sh.b1 = rows_of(n1, lg, 0) * n2;
  face_dims(size, s, 1, n1, n2);
  sh.b2 = sh.b1 + rows_of(n1, lg, 0) * n2;
  return sh;
}

// One octant: its size, and its cells' offsets in the grid.
struct Octant {
  int size[3];
  long origin;     // the source cell
  long st[3];      // signed strides: one step outward along z, y, x
  __device__ __forceinline__ long cell(int c0, int c1, int c2) const {
    return origin + c0 * st[0] + c1 * st[1] + c2 * st[2];
  }
};

// Where the octant cell (c0, c1, c2) of shell m - 1 or m is kept: its slot
// in the shared memory of the block that holds it, as an address in the
// cluster's shared window.
template <class R>
__device__ __forceinline__ unsigned slot_of(const Octant& o, int m, const Shell<R>& prev,
                                            const Shell<R>& cur, int c0, int c1, int c2,
                                            int lg) {
  const int s = max(c0, max(c1, c2));
  const bool now = s == m;
  int i1, i2, n2, base;
  if (c2 == s) {          // x-face (ties go to x)
    i1 = c0;
    i2 = c1;
    n2 = min(s + 1, o.size[1]);
    base = now ? cur.b2 : prev.b2;
  } else if (c1 == s) {   // y-face
    i1 = c0;
    i2 = c2;
    n2 = min(s, o.size[2]);
    base = now ? cur.b1 : prev.b1;
  } else {                // z-face
    i1 = c1;
    i2 = c2;
    n2 = min(s, o.size[2]);
    base = 0;
  }
  const R* p = (now ? cur.buf : prev.buf) + base + (i1 >> lg) * n2 + i2;
  const unsigned local = (unsigned)__cvta_generic_to_shared(p);
  unsigned remote;
  const unsigned holder = (unsigned)(i1 & ((1 << lg) - 1));
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(holder));
  return remote;
}

// A value from the cluster's shared window (after the barrier wait).
__device__ __forceinline__ float ld_cluster(unsigned a, float) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ double ld_cluster(unsigned a, double) {
  double v;
  asm volatile("ld.shared::cluster.f64 %0, [%1];" : "=d"(v) : "r"(a) : "memory");
  return v;
}

// The octant coordinates of a cell with offset ca on axis A and (q1, q2) on
// the other two axes in array order.
template <int A>
__device__ __forceinline__ void coords(int ca, int q1, int q2, int& c0, int& c1, int& c2) {
  c0 = A == 0 ? ca : q1;
  c1 = A == 1 ? ca : (A == 0 ? q1 : q2);
  c2 = A == 2 ? ca : q2;
}

// Stage dtau of this block's cells of face A of shell s; thread l % blockDim
// copies slot l, the thread that computes it.
template <class R, int A>
__device__ __forceinline__ void stage_face(const R* __restrict__ dtau, const Octant& o, int s,
                                           R* dst, int lg, int rank) {
  int n1, n2;
  face_dims(o.size, s, A, n1, n2);
  const int mine = rows_of(n1, lg, rank) * n2;
  for (int l = threadIdx.x; l < mine; l += blockDim.x) {
    const int k = l / n2;
    const int i2 = l - k * n2;
    const int i1 = (k << lg) + rank;
    int c0, c1, c2;
    coords<A>(s, i1, i2, c0, c1, c2);
    cp_async(dst + l, dtau + o.cell(c0, c1, c2));
  }
}

template <class R>
__device__ __forceinline__ void stage_shell(const R* __restrict__ dtau, const Octant& o, int s,
                                            const Shell<R>& sh, int lg, int rank) {
  stage_face<R, 0>(dtau, o, s, sh.buf, lg, rank);
  stage_face<R, 1>(dtau, o, s, sh.buf + sh.b1, lg, rank);
  stage_face<R, 2>(dtau, o, s, sh.buf + sh.b2, lg, rank);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// col of slot l of this block's part of face A of shell m (n2 cells a
// row), written over its staged dtau; returns it and its offset in the grid.
template <class R, int A>
__device__ __forceinline__ R face_col(const Octant& o, int m, const Shell<R>& prev,
                                      const Shell<R>& cur, R* part, int l, int n2, int lg,
                                      int rank, R tmin, R corr, long& g) {
  const int k = l / n2;
  const int i2 = l - k * n2;
  const int i1 = (k << lg) + rank;
  const int j1 = i1 > 0 ? i1 - 1 : 0;
  const int j2 = i2 > 0 ? i2 - 1 : 0;
  const bool axis = i1 == 0 && i2 == 0;
  int c0, c1, c2;
  coords<A>(m - 1, i1, i2, c0, c1, c2);
  const R u1 = ld_cluster(slot_of<R>(o, m, prev, cur, c0, c1, c2, lg), R(0));
  R u2 = u1, u3 = u1, u4 = u1;
  if (!axis) {
    coords<A>(m - 1, j1, i2, c0, c1, c2);
    u2 = ld_cluster(slot_of<R>(o, m, prev, cur, c0, c1, c2, lg), R(0));
    coords<A>(m - 1, i1, j2, c0, c1, c2);
    u3 = ld_cluster(slot_of<R>(o, m, prev, cur, c0, c1, c2, lg), R(0));
    coords<A>(m - 1, j1, j2, c0, c1, c2);
    u4 = ld_cluster(slot_of<R>(o, m, prev, cur, c0, c1, c2, lg), R(0));
  }
  const R mf = R(m);
  const R v =
      entry_column<R>(axis, R(i1) / mf, R(i2) / mf, u1, u2, u3, u4, tmin, corr) + part[l];
  part[l] = v;
  coords<A>(m, i1, i2, c0, c1, c2);
  g = o.cell(c0, c1, c2);
  return v;
}

// This block's cells of face A of shell m, if the face exists, between a
// wait and an arrive of the cluster barrier.  A thread's first cell goes to
// device memory after the arrive, so that the release does not wait for
// the store; after the first face of a shell the block stages dtau of
// shell m + 1 (the wait before it guarantees no block still reads shell
// m - 2, whose buffer it takes).  Both run while the barrier completes.
template <class R, int A>
__device__ __forceinline__ void cluster_face(const R* __restrict__ dtau, R* __restrict__ col,
                                             const Octant& o, int m, int M, const Shell<R>& prev,
                                             const Shell<R>& cur, const Shell<R>& next,
                                             bool& staged, int lg, int rank, R tmin, R corr) {
  if (m >= o.size[A]) return;   // the same for every block of the cluster
  int n1, n2;
  face_dims(o.size, m, A, n1, n2);
  const int mine = rows_of(n1, lg, rank) * n2;
  R* part = cur.buf + (A == 0 ? 0 : (A == 1 ? cur.b1 : cur.b2));
  cluster_wait();
  R v = R(0);
  long g = -1;
  if ((int)threadIdx.x < mine)
    v = face_col<R, A>(o, m, prev, cur, part, threadIdx.x, n2, lg, rank, tmin, corr, g);
  for (int l = threadIdx.x + blockDim.x; l < mine; l += blockDim.x) {
    long gl;
    const R vl = face_col<R, A>(o, m, prev, cur, part, l, n2, lg, rank, tmin, corr, gl);
    col[gl] = vl;
  }
  cluster_arrive();
  if (g >= 0) col[g] = v;
  if (!staged) {
    if (m < M) stage_shell<R>(dtau, o, m + 1, next, lg, rank);
    staged = true;
  }
}

// One cluster of 1 << lg blocks an octant (clusters in octant order); cap:
// slots of one shell's buffer, three buffers a block.
template <class R>
__global__ void __launch_bounds__(TRACE_THREADS)
    octant_trace_cluster_kernel(const R* __restrict__ dtau, R* __restrict__ col, TraceGeom g,
                                R tmin, int lg, int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  R* smem = reinterpret_cast<R*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int oct = (int)(blockIdx.x >> lg);
  Octant o;
  o.origin = 0;
  for (int a = 0; a < 3; ++a) {
    const bool up = (oct >> a) & 1;
    o.size[a] = up ? g.n[a] - g.src[a] : g.src[a] + 1;
    o.st[a] = up ? g.stride[a] : -g.stride[a];
    o.origin += g.src[a] * g.stride[a];
  }
  const int M = max(o.size[0], max(o.size[1], o.size[2])) - 1;

  // shell 0, the source cell (slot 0 of block 0's x-face): col = dtau
  Shell<R> prev = shell_at<R>(o.size, 0, lg, smem, cap);
  stage_shell<R>(dtau, o, 0, prev, lg, rank);
  Shell<R> cur = shell_at<R>(o.size, 1, lg, smem, cap);
  if (M >= 1) stage_shell<R>(dtau, o, 1, cur, lg, rank);
  cp_async_wait_all();
  if (rank == 0 && threadIdx.x == 0) col[o.origin] = prev.buf[prev.b2];
  cluster_arrive();

  for (int m = 1; m <= M; ++m) {
    cp_async_wait_all();   // this thread's dtau of shell m
    // shell m + 1 goes where shell m - 2 was
    const Shell<R> next = shell_at<R>(o.size, m + 1, lg, smem, cap);
    const R corr = axis_corr<R>(m);
    bool staged = false;
    cluster_face<R, 0>(dtau, col, o, m, M, prev, cur, next, staged, lg, rank, tmin, corr);
    cluster_face<R, 1>(dtau, col, o, m, M, prev, cur, next, staged, lg, rank, tmin, corr);
    cluster_face<R, 2>(dtau, col, o, m, M, prev, cur, next, staged, lg, rank, tmin, corr);
    prev = cur;
    cur = next;
  }
  cluster_wait();   // no block leaves while another may still read its shells
}

}  // namespace pion

using real = PION_REAL;
using namespace pion;

// col of one point source over an (nz, ny, nx) grid of per-cell optical depth
// increments; (sz, sy, sx) is the source cell.  plan 0 ("global"): one block
// an octant of `threads`; plan 1 ("cluster"): clusters of `cluster` blocks of
// `threads`, `cap` slots a shell buffer: the most any block keeps of any
// shell, which fused_trace.trace_plan computes from the same layout.
// Returns cudaGetLastError() of the launch; cudaErrorInvalidValue for
// arguments the kernels do not take or three buffers larger than a block's
// shared memory; cudaErrorLaunchOutOfResources when the card cannot place
// one such cluster.
extern "C" int pion_octant_trace(const void* dtau, void* col, int nz, int ny, int nx, int sz,
                                 int sy, int sx, double tau_min, int plan, int cluster,
                                 int threads, int cap, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || sz < 0 || sz >= nz || sy < 0 || sy >= ny || sx < 0 ||
      sx >= nx || dtau == nullptr || col == nullptr || threads < 32 ||
      threads > TRACE_THREADS || threads % 32 != 0 || (plan != 0 && plan != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  TraceGeom g;
  g.n[0] = nz;  g.n[1] = ny;  g.n[2] = nx;
  g.src[0] = sz;  g.src[1] = sy;  g.src[2] = sx;
  g.stride[0] = (long)ny * nx;  g.stride[1] = nx;  g.stride[2] = 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (plan == 0) {
    octant_trace_global_kernel<real><<<8, threads, 0, s>>>((const real*)dtau, (real*)col, g,
                                                           (real)tau_min);
    return (int)cudaGetLastError();
  }
  if (cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) != 0 || cap < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int lg = 0;
  while ((1 << lg) < cluster) ++lg;
  const size_t smem = 3 * (size_t)cap * sizeof(real);
  if (smem > TRACE_SMEM_MAX) return (int)cudaErrorInvalidValue;
  // opt in once per size: above 48 KB of shared memory, above 8 blocks a
  // cluster
  static size_t allowed_smem = 48 * 1024;
  static bool non_portable = false;
  auto kernel = octant_trace_cluster_kernel<real>;
  cudaError_t e = cudaSuccess;
  if (smem > allowed_smem) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed_smem = smem;
  }
  if (cluster > 8 && !non_portable) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    non_portable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(8 * cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster the card cannot place is refused here, never run another way
  static long placed_key = -1;
  const long key = ((long)cluster << 40) | ((long)threads << 24) | (long)smem;
  if (key != placed_key) {
    int n_clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&n_clusters, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n_clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    placed_key = key;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, (const real*)dtau, (real*)col, g, (real)tau_min, lg, cap);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
