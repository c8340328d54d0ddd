"""The launch plans of the CUDA kernels B1 and B2 (``fused_sweep.sweep_plan``),
B3 (``fused_mpv3.update_plan``) and B5 (``fused_trace.trace_plan``), held on
the CPU: they are pure functions of the shape, and ``_tile_of_block`` below
decodes a B1/B2 block's index as ``sweep_axis_kernel`` and
``final_axis_kernel`` do (``csrc/sweep.cu``, ``Tiling``).

- B1: every interior cell lies in exactly one tile; every interface is solved
  by exactly one tile, except a face between two tiles along the sweep axis,
  which both solve; a block's shared memory stays within the card's 227 KB
  (and within the per-dtype budget) for float32 and float64.
- B2: the same tiles along axis 0 update every interior cell exactly once.
- B3: pass 1 covers every cell of every 1024-cell tile once; pass 2 maps
  one cluster a tile up to 32 blocks an SM, and every cell of a tile to
  exactly one thread of its cluster; the Euler flags pass 1 writes sit where
  pass 2 reads them.
- B4: ``fused_mpv3.ydot_plan`` -- block ``b``'s thread ``r`` serves cells
  ``1024 b + r + 256 j`` -- writes every cell of the grid exactly once and
  none past its end, the last tile partial.
- B5: every cell of every face of every shell of every octant belongs to
  exactly one block's share (rows dealt out in turn), at a slot of its own
  within the block's buffer; the faces of the shells cover each octant
  once; a block's three shell buffers fit 227 KB; and
  ``_emulate_cluster_trace`` -- the cluster kernel's addressing, buffer
  rotation and staging written out in Python -- reproduces the plain
  trace.
"""
import math

import numpy as np
import pytest

import torch

from pion_tpu_torch.microphysics import fused_mpv3 as fm
from pion_tpu_torch.ops import fused_sweep as fs
from pion_tpu_torch.raytracing import fused_trace as ft

SHAPES = [(40, 70, 150), (12, 20, 36), (1, 1, 5), (33, 17, 65), (70, 150),
          (20, 36), (5, 129)]
NVARS = [(8, 8), (9, 10), (9, 12), (8, 11), (9, 64)]   # (nbase, nvar)


def _tile_of_block(plan, b: int) -> tuple:
    """The tile block ``b`` owns: ``(a0, nA, w0, nW, t3)`` -- its first cell
    and cell count along the sweep axis, its first pencil and pencil count
    across, and its plane of the third axis.  It solves faces ``a0 .. a0 +
    nA`` (face ``i`` lies between cells ``i - 1`` and ``i``)."""
    tw = b % plan["n_tw"]
    ta = (b // plan["n_tw"]) % plan["n_ta"]
    t3 = b // (plan["n_tw"] * plan["n_ta"])
    a0, w0 = ta * plan["T"], tw * plan["W"]
    return (a0, min(plan["T"], plan["n_along"] - a0), w0,
            min(plan["W"], plan["n_across"] - w0), t3)


def _cells_and_faces(shape, axis, plan):
    """Times each interior cell is owned and each face is solved, indexed
    (along, across, third)."""
    along, across, third = plan["n_along"], plan["n_across"], plan["n_third"]
    cells = np.zeros((along, across, third), dtype=int)
    faces = np.zeros((along + 1, across, third), dtype=int)
    for b in range(plan["blocks"]):
        a0, nA, w0, nW, t3 = _tile_of_block(plan, b)
        assert nA >= 1 and nW >= 1 and 0 <= t3 < third
        cells[a0:a0 + nA, w0:w0 + nW, t3] += 1
        faces[a0:a0 + nA + 1, w0:w0 + nW, t3] += 1
    return cells, faces


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("order", [1, 2])
def test_sweep_tiles_cover_every_cell_and_face(shape, itemsize, order):
    nd = len(shape)
    for axis in range(nd):
        for nbase, nvar in NVARS:
            plan = fs.sweep_plan(shape, axis, nvar, nbase, itemsize, order,
                                 mask=True)
            nz, ny, nx = ((1,) + tuple(shape))[-3:]
            k = nd - 1 - axis
            assert (plan["n_along"], plan["n_across"], plan["n_third"]) == \
                ((nx, ny, nz), (ny, nx, nz), (nz, nx, ny))[k]
            cells, faces = _cells_and_faces(shape, axis, plan)
            assert (cells == 1).all()
            # a face between two tiles along the axis is solved by both;
            # every other face (the domain's two ends among them) by one
            shared = np.zeros(plan["n_along"] + 1, dtype=bool)
            shared[plan["T"]:plan["n_along"]:plan["T"]] = True
            want = np.where(shared, 2, 1)[:, None, None]
            assert (faces == want).all()
            # the x sweep lays pencils across y, the others across x
            assert plan["n_across"] == (ny if k == 0 else nx)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("mask", [True, False])
def test_sweep_tile_shared_memory_fits(itemsize, order, mask):
    for nbase in (8, 9):
        for nvar in range(nbase, fs.MAX_NVAR + 1):
            plan = fs.sweep_plan((64, 64, 64), 0, nvar, nbase, itemsize,
                                 order, mask)
            assert plan["smem"] == fs.tile_bytes(
                nvar, nbase, order, plan["T"], plan["W"], mask, itemsize)
            assert plan["smem"] <= fs.SMEM_MAX
            assert plan["smem"] <= fs.TILE_SMEM_BUDGET[itemsize]
            assert plan["T"] >= 3 and plan["W"] >= 8


def test_sweep_plan_main_path_sizes():
    """The tiles the main paths run: 128^3, 10 variables (GLM + one
    tracer), the mask on: 15 x 32, whose 16 x 32 faces are four rounds of
    the block's threads; float32 keeps five blocks an SM, float64 two."""
    for itemsize, blocks_per_sm in ((4, 5), (8, 2)):
        for order in (1, 2):
            plan = fs.sweep_plan((128,) * 3, 1, 10, 9, itemsize, order, True)
            assert (plan["T"], plan["W"]) == (15, 32)
            assert (plan["T"] + 1) * plan["W"] % plan["threads"] == 0
            assert plan["blocks"] == 9 * 4 * 128
            assert blocks_per_sm * (plan["smem"] + 1024) <= 228 * 1024


@pytest.mark.parametrize("itemsize", [4, 8])
def test_sweep_plan_euler_base(itemsize):
    """The Euler base of 5 variables with 0, 1 and 4 tracers (no fallback
    mask: HLLD is MHD's): within the per-dtype budget, the 15 x 32 tile of
    the main paths at 128^3, and every cell and face covered as for MHD."""
    for nvar in (5, 6, 9):
        for order in (1, 2):
            plan = fs.sweep_plan((128,) * 3, 2, nvar, 5, itemsize, order,
                                 False)
            assert plan["smem"] == fs.tile_bytes(nvar, 5, order, plan["T"],
                                                 plan["W"], False, itemsize)
            assert plan["smem"] <= fs.TILE_SMEM_BUDGET[itemsize]
            assert (plan["T"], plan["W"]) == (15, 32)
            for shape in ((12, 20, 36), (20, 36)):
                for axis in range(len(shape)):
                    p = fs.sweep_plan(shape, axis, nvar, 5, itemsize, order,
                                      False)
                    cells, faces = _cells_and_faces(shape, axis, p)
                    assert (cells == 1).all() and faces.min() == 1


@pytest.mark.parametrize("shape", [s for s in SHAPES if len(s) == 2])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_radial_sweep_plan_stages_the_pack(shape, itemsize):
    """The radial axis (axis 0 of a 2D cylindrical grid, B1 and B2): the
    tiles of the Cartesian plan, every cell and face covered as there, and
    the geometry pack's six rows of the staged cells on top of the tile's
    shared memory, within the per-dtype budget."""
    for nbase, nvar in NVARS + [(5, 6)]:
        for order in (1, 2):
            cart = fs.sweep_plan(shape, 0, nvar, nbase, itemsize, order,
                                 nbase > 5)
            rad = fs.sweep_plan(shape, 0, nvar, nbase, itemsize, order,
                                nbase > 5, geo=True)
            rows = rad["T"] + 2 * order
            assert rad["smem"] == fs.tile_bytes(
                nvar, nbase, order, rad["T"], rad["W"], nbase > 5, itemsize,
                geo=True)
            assert rad["smem"] <= fs.TILE_SMEM_BUDGET[itemsize]
            if (rad["T"], rad["W"]) == (cart["T"], cart["W"]):
                assert rad["smem"] == cart["smem"] + \
                    fs.GEO_ROWS * rows * itemsize
            cells, faces = _cells_and_faces(shape, 0, rad)
            assert (cells == 1).all() and faces.min() == 1


def test_flops_per_interface_distinct_by_system_and_solver():
    """The operations side of B1/B2's bound counts each (equation system,
    solver) the kernels run: ten distinct counts at both orders, with MHD's
    ``roe_pv`` the linear solver's own count; order 2 and Falle AV add."""
    from pion_tpu_torch import SimConfig

    box = dict(ndim=3, shape=(8, 8, 8), xmin=(0,) * 3, xmax=(1,) * 3,
               bcs=(("outflow", "outflow"),) * 3, ntracer=1, av="falle")
    runs = [("euler", s) for s in ("hll", "linear", "roe", "roe_pv")] + \
        [(e, s) for e in ("mhd", "glm") for s in ("hll", "hlld", "linear",
                                                  "roe")]
    for order in (1, 2):
        counts = {r: fs.flops_per_interface(
            SimConfig(eqn=r[0], solver=r[1], **box), order) for r in runs}
        assert len(set(counts.values())) == len(runs), counts
        for eqn in ("mhd", "glm"):
            assert fs.flops_per_interface(
                SimConfig(eqn=eqn, solver="roe_pv", **box), order) \
                == counts[(eqn, "linear")]
    cfg = SimConfig(eqn="euler", solver="roe", **box)
    assert fs.flops_per_interface(cfg, 2) > fs.flops_per_interface(cfg, 1)
    none = SimConfig(eqn="euler", solver="roe", **dict(box, av="none"))
    assert fs.flops_per_interface(cfg, 1) > fs.flops_per_interface(none, 1)


def test_sweep_plan_rejects_bad_arguments():
    with pytest.raises(ValueError):
        fs.sweep_plan((8, 8, 8), 3, 10, 9, 4, 2, True)
    with pytest.raises(ValueError):
        fs.sweep_plan((8, 8, 8), 0, 10, 9, 4, 3, True)


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 7 * 33 * 41, 128 ** 3,
                               2 * 1024 * 66 + 5])
@pytest.mark.parametrize("n_sm", [132, 114, 1])
def test_update_plan_maps_tiles_and_cells_once(n, n_sm):
    plan = fm.update_plan(n, n_sm)
    tiles = -(-n // fm.TILE)
    assert plan["tiles"] == plan["pass1_blocks"] == tiles
    assert plan["cluster"] * plan["pass2_threads"] == fm.TILE
    assert plan["pass1_threads"] * (fm.TILE // plan["pass1_threads"]) == fm.TILE
    assert plan["pass2_blocks"] == plan["ladder_clusters"] * plan["cluster"]
    assert 1 <= plan["ladder_clusters"] <= tiles
    # pass 1: block b, thread t, cell j of the thread -> cell of the grid
    T1 = plan["pass1_threads"]
    j, t = np.meshgrid(np.arange(fm.TILE // T1), np.arange(T1), indexing="ij")
    in_tile = (j * T1 + t).ravel()
    assert np.array_equal(np.sort(in_tile), np.arange(fm.TILE))
    # Euler flags: pass 1 writes word j*T1/32 + t/32, bit t%32; pass 2 reads
    # word c/32, bit c%32 of cell c
    assert np.array_equal((j * (T1 // 32) + t // 32).ravel(), in_tile // 32)
    assert np.array_equal((t % 32).ravel(), in_tile % 32)
    # pass 2: cluster rank r, thread t -> cell r * threads + t of its tile
    r, t2 = np.meshgrid(np.arange(plan["cluster"]),
                        np.arange(plan["pass2_threads"]), indexing="ij")
    assert np.array_equal(np.sort((r * plan["pass2_threads"] + t2).ravel()),
                          np.arange(fm.TILE))
    # pass 2's grid: a cluster a tile, at most 32 blocks an SM
    assert plan["ladder_clusters"] == min(tiles,
                                          max(1, n_sm * 32 // plan["cluster"]))
    assert plan["ws_int"] == 1 + tiles + tiles * fm.TILE // 32
    assert plan["ws_real"] == tiles


def test_update_plan_rejects_bad_arguments():
    with pytest.raises(ValueError):
        fm.update_plan(0)
    with pytest.raises(ValueError):
        fm.update_plan(10, 0)


@pytest.mark.parametrize("n", [1, 3, 255, 256, 257, 1023, 1024, 1025, 2635,
                               7 * 33 * 41, 531 * 1024 - 3, 128 ** 3])
def test_ydot_plan_covers_every_cell_once(n):
    plan = fm.ydot_plan(n)
    tiles = -(-n // fm.TILE)
    assert plan["tiles"] == plan["blocks"] == tiles
    assert plan["threads"] * plan["cells_per_thread"] == fm.TILE
    # the kernel's cells: block b, thread r, cell j; it stops at the end of
    # the grid
    b, j, r = np.meshgrid(np.arange(plan["blocks"]),
                          np.arange(plan["cells_per_thread"]),
                          np.arange(plan["threads"]), indexing="ij")
    cell = (b * fm.TILE + j * plan["threads"] + r).ravel()
    written = np.bincount(cell[cell < n], minlength=n)
    assert (written == 1).all() and written.size == n
    # the last tile holds the rest: n - TILE (tiles - 1) cells
    assert 1 <= n - fm.TILE * (tiles - 1) <= fm.TILE


def test_ydot_plan_rejects_bad_arguments():
    with pytest.raises(ValueError):
        fm.ydot_plan(0)


@pytest.mark.parametrize("shape", [(37, 40, 48), (20, 36), (15, 7, 9),
                                   (16, 33), (1, 1, 5), (128, 128, 128)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_final_axis_tiles_update_every_cell_once(shape, itemsize):
    """B2 runs on B1's tiles along axis 0 (z in 3D, y in 2D, pencils across
    x): each interior cell is updated by exactly one block, also where axis
    0 is no multiple of ``T``."""
    for order in (1, 2):
        plan = fs.sweep_plan(shape, 0, 10, 9, itemsize, order, mask=True)
        nz, ny, nx = ((1,) + tuple(shape))[-3:]
        assert (plan["n_along"], plan["n_across"]) == (
            (nz, nx) if len(shape) == 3 else (ny, nx))
        cells, _ = _cells_and_faces(shape, 0, plan)
        assert (cells == 1).all()
        assert plan["smem"] <= fs.TILE_SMEM_BUDGET[itemsize]


TRACE_SHAPES = [((8, 8, 8), (0, 0, 0)), ((8, 8, 8), (7, 1, 4)),
                ((1, 12, 20), (0, 3, 14)), ((5, 9, 11), (0, 4, 5)),
                ((5, 9, 11), (2, 8, 5)), ((5, 9, 11), (2, 4, 0)),
                ((37, 40, 48), (5, 39, 20)), ((4, 4, 60), (2, 1, 0)),
                ((1, 1, 1), (0, 0, 0))]


def _shell_layout(size, s, cluster):
    """``[(n1, n2, base)]`` of the z-, y- and x-face of shell ``s``: a
    block's slots of a face start at ``base`` of its shell buffer."""
    faces = [(int(n1), int(n2)) for n1, n2 in ft.face_cells(size, s)]
    shares = [int(x) for x in ft.shell_slots(size, s, cluster)]
    return [(n1, n2, sum(shares[:a])) for a, (n1, n2) in enumerate(faces)]


def _cap(shape, src, cluster):
    """Slots of one shell buffer a block for a cluster of ``cluster``
    blocks: the most any block keeps of any shell of any octant."""
    return max(int(ft.shell_slots(size, np.arange(max(size)), cluster)
                   .sum(axis=0).max())
               for size in ft.octant_sizes(shape, src))


def _owner(i1, i2, n2, base, cluster):
    """(block, slot) of cell (i1, i2) of a face whose part starts at
    ``base``: rows are dealt out in turn."""
    return i1 % cluster, base + (i1 // cluster) * n2 + i2


def _face_coords(a, s, i1, i2):
    """Octant offsets (z, y, x) of cell (i1, i2) of face ``a`` of shell s."""
    c = [0, 0, 0]
    p1, p2 = [b for b in range(3) if b != a]
    c[a], c[p1], c[p2] = s, i1, i2
    return tuple(c)


@pytest.mark.parametrize("shape,src", TRACE_SHAPES)
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_trace_shares_cover_every_cell_once(shape, src, cluster):
    cap = _cap(shape, src, cluster)
    share = 0
    for size in ft.octant_sizes(shape, src):
        seen = np.zeros(size, dtype=int)
        for s in range(max(size)):
            slots = set()
            layout = _shell_layout(size, s, cluster)
            for a, (n1, n2, base) in enumerate(layout):
                share = max(share, -(-n1 // cluster) * n2)
                for t in range(n1 * n2):
                    i1, i2 = divmod(t, n2)
                    seen[_face_coords(a, s, i1, i2)] += 1
                    block, slot = _owner(i1, i2, n2, base, cluster)
                    assert slot < cap and (block, slot) not in slots
                    slots.add((block, slot))
        assert (seen == 1).all()
    # the plan's buffers are this layout's at the cluster size it takes
    plan = ft.trace_plan(shape, src, 8)
    assert plan["plan"] == "cluster"
    assert plan["cluster"] in (ft.TRACE_CLUSTER, ft.MAX_CLUSTER)
    assert plan["cap"] == _cap(shape, src, plan["cluster"])
    assert plan["blocks"] == 8 * plan["cluster"]
    assert plan["smem"] == 24 * plan["cap"]
    if plan["cluster"] == cluster:
        # one round of a block's threads takes its largest share of a face
        assert plan["threads"] == min(ft.TRACE_THREADS, -(-share // 32) * 32)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_trace_plan_shared_memory_and_sizes(itemsize):
    # 128^3, the source at the centre: the plan PERF.md names, one cell of
    # a face a thread
    plan = ft.trace_plan((128, 128, 128), (64, 64, 64), itemsize)
    assert (plan["plan"], plan["cluster"], plan["threads"]) == (
        "cluster", 8, 608)
    assert plan["shells"] == 65 and plan["smem"] <= ft.SMEM_MAX
    # the corner: one octant of 128 shells, sixteen blocks
    plan = ft.trace_plan((128, 128, 128), (0, 0, 0), itemsize)
    assert (plan["plan"], plan["cluster"], plan["threads"]) == (
        "cluster", 16, 1024)
    # the largest octant side a cluster holds; one more takes the
    # device-memory plan, by shape
    side = {4: 320, 8: 224}[itemsize]
    plan = ft.trace_plan((side,) * 3, (0, 0, 0), itemsize)
    assert plan["plan"] == "cluster" and plan["cluster"] == ft.MAX_CLUSTER
    assert plan["smem"] <= ft.SMEM_MAX
    assert ft.trace_plan((side + 1,) * 3, (0, 0, 0), itemsize)["plan"] \
        == "global"
    assert ft.trace_plan((2 * side - 1,) * 3, (side - 1,) * 3,
                         itemsize)["plan"] == "cluster"


def test_trace_plan_rejects_bad_arguments():
    for args in (((8, 8), (0, 0), 4), ((8, 8, 8), (8, 0, 0), 4),
                 ((0, 8, 8), (0, 0, 0), 4), ((8, 8, 8), (0, 0, 0), 2),
                 ((8, 8, 8), (-1, 0, 0), 4), ((8, 8, 8), (0, 0, 0), 16),
                 ((8, 8, 8), (0, 0), 8)):
        with pytest.raises(ValueError):
            ft.trace_plan(*args)


def _emulate_cluster_trace(dtau: np.ndarray, src, tmin: float,
                           cluster: int) -> np.ndarray:
    """``octant_trace_cluster_kernel`` in Python: per octant, three shell
    buffers a block; shell m + 1 staged into shell m - 2's buffer after the
    first face of shell m; each face reads every upstream cell before it
    writes any, as the barrier orders them, and a read must find a cell
    that an earlier face or shell computed (a staged or stale slot fails)."""
    shape = dtau.shape
    cap = _cap(shape, src, cluster)
    col = np.full(shape, np.nan)
    for o, size in enumerate(ft.octant_sizes(shape, src)):
        sgn = [1 if (o >> a) & 1 else -1 for a in range(3)]
        smem = np.full((cluster, 3 * cap), np.nan)
        done = np.zeros((cluster, 3 * cap), dtype=bool)

        def grid(c):
            return tuple(src[a] + sgn[a] * c[a] for a in range(3))

        def where(a, s, i1, i2):
            _, n2, base = _shell_layout(size, s, cluster)[a]
            block, slot = _owner(i1, i2, n2, base, cluster)
            return block, (s % 3) * cap + slot

        def stage(s):
            buf = (s % 3) * cap
            smem[:, buf:buf + cap] = np.nan
            done[:, buf:buf + cap] = False
            for a, (n1, n2, _) in enumerate(_shell_layout(size, s, cluster)):
                for i1 in range(n1):
                    for i2 in range(n2):
                        smem[where(a, s, i1, i2)] = dtau[grid(
                            _face_coords(a, s, i1, i2))]

        def upstream(c):
            s = max(c)
            if c[2] == s:
                at = where(2, s, c[0], c[1])
            elif c[1] == s:
                at = where(1, s, c[0], c[2])
            else:
                at = where(0, s, c[1], c[2])
            assert done[at], f"read of {c} before it was computed"
            return smem[at]

        def cell(m, a, i1, i2, corr):
            p1, p2 = [b for b in range(3) if b != a]

            def at(q1, q2):
                c = [0, 0, 0]
                c[a], c[p1], c[p2] = m - 1, q1, q2
                return upstream(tuple(c))

            u1 = at(i1, i2)
            if i1 == 0 and i2 == 0:
                tau_in = u1 * corr
            else:
                j1, j2 = max(i1 - 1, 0), max(i2 - 1, 0)
                u2, u3, u4 = at(j1, i2), at(i1, j2), at(j1, j2)
                d0, d1 = i1 / m, i2 / m
                w = [(1 - d0) * (1 - d1) / max(u1, tmin),
                     d0 * (1 - d1) / max(u2, tmin),
                     (1 - d0) * d1 / max(u3, tmin),
                     d0 * d1 / max(u4, tmin)]
                tau_in = (w[0] * u1 + w[1] * u2 + w[2] * u3
                          + w[3] * u4) / sum(w)
            return (a, i1, i2), tau_in + smem[where(a, m, i1, i2)]

        def write(m, results):
            for (a, i1, i2), v in results:
                at = where(a, m, i1, i2)
                assert not done[at]
                smem[at], done[at] = v, True
                col[grid(_face_coords(a, m, i1, i2))] = v

        stage(0)
        write(0, [((2, 0, 0), smem[where(2, 0, 0, 0)])])
        n_shells = max(size)
        if n_shells > 1:
            stage(1)
        for m in range(1, n_shells):
            corr = 1.0
            if m < 10:
                corr = math.sqrt((m * m + 0.25) / ((m - 1) ** 2 + 0.25)) \
                    * (m - 1) / max(m, 1)
            staged = False
            for a, (n1, n2, _) in enumerate(_shell_layout(size, m, cluster)):
                if m >= size[a]:
                    continue
                write(m, [cell(m, a, i1, i2, corr)
                          for i1 in range(n1) for i2 in range(n2)])
                if not staged and m + 1 < n_shells:
                    stage(m + 1)
                staged = True
    return col


@pytest.mark.parametrize("shape,src", [((8, 8, 8), (0, 0, 0)),
                                       ((8, 8, 8), (7, 1, 4)),
                                       ((1, 12, 20), (0, 3, 14)),
                                       ((5, 9, 11), (2, 4, 0))])
@pytest.mark.parametrize("cluster", [1, 4, 16])
def test_cluster_trace_addressing_matches_plain(shape, src, cluster):
    """float64: the emulated cluster kernel and the plain plane sweep
    compute each cell from the same four values by the same formula, so
    they agree to rounding (1e-13)."""
    dtau = np.random.default_rng(60).uniform(0.01, 0.5, shape)
    ref = ft.octant_trace_plain(torch.from_numpy(dtau), src, 0.6).numpy()
    got = _emulate_cluster_trace(dtau, src, 0.6, cluster)
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()
