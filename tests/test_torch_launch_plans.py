"""The launch plans of the CUDA kernels B1 (``fused_sweep.sweep_plan``) and
B3 (``fused_mpv3.update_plan``), held on the CPU: they are pure functions of
the shape, and ``_tile_of_block`` below decodes a B1 block's index as
``sweep_axis_kernel`` does (``csrc/sweep.cu``, ``Tiling``).

- B1: every interior cell lies in exactly one tile; every interface is solved
  by exactly one tile, except a face between two tiles along the sweep axis,
  which both solve; a block's shared memory stays within the card's 227 KB
  (and within the per-dtype budget) for float32 and float64.
- B3: pass 1 covers every cell of every 1024-cell tile once; pass 2 maps
  one cluster a tile up to 32 blocks an SM, and every cell of a tile to
  exactly one thread of its cluster; the Euler flags pass 1 writes sit where
  pass 2 reads them.
"""
import numpy as np
import pytest

from pion_tpu_torch.microphysics import fused_mpv3 as fm
from pion_tpu_torch.ops import fused_sweep as fs

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
