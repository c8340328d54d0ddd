"""Fused sweep kernels: wrappers, plain versions, and the fused update.

Two CUDA kernels (sources in ``csrc/sweep.cu``) take the place of the two
TPU kernels of ``pion_tpu/ops/pallas_sweep.py``:

- :func:`sweep_axis` replaces ``_sweep_axis_pallas``: one axis's ``dt*dU``,
  the whole pipeline of :func:`..ops.sweep.dynamics_dU`, each interface
  solved once from a tile staged in shared memory (:func:`sweep_plan` cuts
  the grid into those tiles).
- :func:`final_axis` replaces ``_final_axis_pallas``: the axis-0 sweep plus
  ``U(P) + dU + sum(contribs)`` -> ``cons_to_prim`` -> GLM psi damping; it
  returns the new primitive state.  It runs on the same tiles along axis 0
  (:func:`sweep_plan` with ``axis=0``) and applies the update where
  :func:`sweep_axis` writes ``dt*dU``.

Both are bound by bytes on an H100, not by operations; what the design does
about it is written at the head of ``csrc/sweep.cu``.

Beside each kernel stands its plain PyTorch version (:func:`sweep_axis_plain`,
:func:`final_axis_plain`), built from :mod:`..ops.sweep`.  A wrapper takes
the plain version only because the tensor it was given lies on the CPU; for a
CUDA tensor it launches the kernel or raises.  Each wrapper counts its
launches in its ``launches`` attribute.

:func:`sweep_axis` can also hand back the face fluxes of a few interfaces of
its axis (``planes``, at order 2 on a Cartesian axis): the kernel writes the
faces it solves there, so the nested-grid hierarchy's BC89 correction and
boundary restriction read the fluxes that went into ``dU``
(``sweep_axis.planes`` counts them, on either path).

On a Cartesian axis the reconstruction differs in the last bit between the
two: the plain sweep divides the one-sided differences by the
centre-of-volume spacing and multiplies the slopes by ``del_n``/``del_p``;
the kernels divide by the constant ``dx`` and use ``+-dx/2``.  Tests hold
them at ``rtol=1e-10`` in float64.  On the radial axis of a cylindrical grid
the kernels read the spacing and the offsets from the geometry pack
(:func:`radial_geo`), as the plain sweep does.

Scope (:func:`supports`, the scope of the Pallas gate
``pallas_sweep.supports``): Cartesian 2D and 3D, and 2D axisymmetric
(cylindrical (R, z), R on array axis 0: the kernels take the geometry pack
on that axis, for the metric divergence, the centre-of-volume slopes and the
radial geometric sources); the Euler system with the
HLL, linear (``linear_pv``), Roe conserved-variable and Roe-mean
primitive-variable solvers; MHD and GLM-MHD with HLL, HLLD (with or without
the fallback mask), linear and Roe conserved-variable (``roe_pv`` runs the
linear solver for MHD, as in the reference); Falle viscosity or none, any
number of tracers up to slot 63, sCMA off, on, or with element slots, orders
1 and 2, float32 and float64.  The other solvers (``lf``, ``exact``,
``hybrid``, ``fvs``) lie outside it, as they lie outside the Pallas gate:
the stepper routes them to the plain sweep by configuration.
"""
from __future__ import annotations

import functools
from types import MappingProxyType
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SimConfig
from ..constants import AV, SI, Coord, Eqn, Solver
from ..grid import Geometry
from .eqns import BASE_RHO, cons_to_prim, prim_to_cons
from .sweep import dynamics_dU, hlld_fallback_cells

MAX_NVAR = 64  # element slots travel as a 64-bit mask
MAX_PLANES = 4  # interface planes a sweep_axis launch writes (csrc/sweep.cu)

SWEEP_THREADS = 128            # threads a block of sweep_axis_kernel
SMEM_MAX = 232448              # shared memory a block can opt in to (H100)
# shared memory a tile may take, by bytes of the scalar type: four (at the
# main path's 10 variables, five) float32 blocks or two float64 blocks fit an
# SM's 228 KB
TILE_SMEM_BUDGET = {4: 48 * 1024, 8: 100 * 1024}
GEO_ROWS = 6   # rows of the radial geometry pack (radial_geo)


def supports(cfg: SimConfig) -> bool:
    """Whether the CUDA kernels cover this configuration (everything else
    takes the plain torch sweep)."""
    return (
        (cfg.coords is Coord.CARTESIAN
         or (cfg.coords is Coord.CYLINDRICAL and cfg.ndim == 2))
        and cfg.ndim in (2, 3)
        and (cfg.solver in (Solver.HLL, Solver.LINEAR, Solver.RCV,
                            Solver.RPV)
             or (cfg.solver is Solver.HLLD and cfg.eqn.is_mhd))
        and cfg.av in (AV.NONE, AV.FALLE)
        and cfg.nvar <= MAX_NVAR
        and cfg.dtype in ("float32", "float64")
    )


def kernel_solver(cfg: SimConfig) -> Solver:
    """The solver the kernels compute for ``cfg``: its own, but ``roe_pv``
    for MHD and GLM-MHD is the linear solver (reference:
    ``pallas_sweep.py:220-223``, ``sweep.py:167``)."""
    if cfg.solver is Solver.RPV and cfg.eqn.is_mhd:
        return Solver.LINEAR
    return cfg.solver


# equation-system codes of csrc/sweep.cu (EQN_MHD, EQN_GLM, EQN_EULER)
_EQN_CODE = {Eqn.MHD: 0, Eqn.GLM: 1, Eqn.EULER: 2}


def _uses_mask(cfg: SimConfig) -> bool:
    return (cfg.solver is Solver.HLLD and cfg.eqn.is_mhd
            and cfg.hlld_fallback)


# Operations of one interface's Riemann solve, by (Euler?, solver), counted
# by hand from the formulas of the plain version (an add, multiply, divide,
# square root, compare-and-select each count one).  Each includes what the
# solver itself needs of the two sides (conserved states, fluxes, sound or
# fast speeds); the MHD HLL and HLLD rows share 161 of them (prim_to_cons
# 2 x 27, flux_from_pu 2 x 33, fast speeds 2 x 18, wave speeds 5).
_SOLVE_FLOPS = {
    # Euler: both sides' U and flux 2 x 18; speeds 11; mid flux 35, selects
    # 10, ustar 30, cons_to_prim with floors 17
    (True, Solver.HLL): 139,
    # linear_pv: arithmetic means, p*, v*, rho*, the sampling selects, and
    # flux_from_prim of the sampled state (18)
    (True, Solver.LINEAR): 71,
    # roe_cv: Roe averages and enthalpies 54, both sides' U 24, strengths 32,
    # eigenvector entries 7, both fluxes 41, 5 waves x 12 of dissipation, p
    (True, Solver.RCV): 229,
    # roe_pv: roe_average_state 48, the enthalpy mean again 24, a 13, p* v*
    # rho* 32, sampling 16, flux_from_prim 18
    (True, Solver.RPV): 146,
    (False, Solver.HLL): 161 + 8 + 8 * 11,
    # star 30, two outer stars 2 x 62, Alfven speeds 10, double star 45,
    # 2 x 16, assembly 8 x 7
    (False, Solver.HLLD): 161 + 30 + 2 * 62 + 10 + 45 + 2 * 16 + 8 * 7,
    # linear: means and betas 35, speeds 50, jumps 10, strengths 91,
    # eigenvectors 66, P* from the left 154 and from the right 178, floors,
    # flux_from_prim and prim_to_cons of P* 87
    (False, Solver.LINEAR): 673,
    # roe_cv: Roe averages 24, both sides' U 54, enthalpies 22, jumps and X
    # and dp 42, speeds 65, strengths 81, eigenvectors 144, both fluxes 128,
    # 7 waves x 16 of dissipation, U of the Roe mean 29
    (False, Solver.RCV): 725,
}


def radial_geo(cfg: SimConfig, geom: Geometry, dtype,
               device) -> torch.Tensor:
    """The ``(GEO_ROWS, n0 + 4)`` geometry pack of the radial axis of a 2D
    cylindrical grid (the TPU kernel's ``_radial_geo``): rows ``com``,
    ``del_n``, ``del_p``, ``pos`` over the padded cells, then ``div_cn``,
    ``div_cp`` over the interior cells, padded with ``1/dx``.  The geometry's
    arrays were computed in float64 and cast once to the config's dtype
    (:func:`..grid.make_geometry`); they are stacked here in float64 and cast
    to ``dtype`` once, so the kernels read the values the plain sweep reads
    and no radius is squared on the card.  Kept per geometry, dtype and
    device: the tensor outlives any CUDA graph that records its pointer."""
    key = ("radial_geo", dtype, str(device))
    kept = geom._tensors.get(key)
    if kept is None:
        g = geom.axes[0]
        n = cfg.shape[0]
        pack = np.full((GEO_ROWS, n + 2 * cfg.ng), 1.0 / float(geom.dx),
                       dtype=np.float64)
        for row, name in enumerate(("com", "del_n", "del_p", "pos")):
            pack[row] = getattr(g, name)
        pack[4, :n] = g.div_cn
        pack[5, :n] = g.div_cp
        kept = torch.as_tensor(pack).to(dtype=dtype, device=device)
        geom._tensors[key] = kept
    return kept


# Operations of a radial cell's geometric sources, by (system, order): a
# slope over the centre-of-volume spacing is 7; Euler p/R is 1, and 4 more
# with its slope term; MHD adds B^2/2 (6) and the B.dB term (4 slopes and
# 7); GLM adds c_h psi/R (3, or 5 and a slope)
_RADIAL_SOURCE_FLOPS = {
    (Eqn.EULER, 1): 1, (Eqn.EULER, 2): 1 * 7 + 4,
    (Eqn.MHD, 1): 8, (Eqn.MHD, 2): 4 * 7 + 17,
    (Eqn.GLM, 1): 8 + 3, (Eqn.GLM, 2): 5 * 7 + 17 + 5,
}


def flops_per_interface(cfg: SimConfig, order: int,
                        radial: bool = False) -> int:
    """Floating-point operations of one interface solve and its share of
    the cell update, counted by hand from the formulas of the plain version
    (an add, multiply, divide, square root, compare-and-select each count
    one); distinct for each (equation system, solver) the kernels run.
    ``radial``: on the radial axis of a cylindrical grid, with the metric
    divergence and the geometric sources.  Used for the operations side of
    the kernels' roofline bound."""
    nb = cfg.eqn.nbase
    euler = cfg.eqn is Eqn.EULER
    n = 0
    if order == 2:
        n += cfg.nvar * 29          # 3 differences/dx, 2 limiters, 2 edges
    n += _SOLVE_FLOPS[(euler, kernel_solver(cfg))]
    if _uses_mask(cfg):
        n += 8 + 8 * 11             # the HLL fallback of flagged interfaces
    if cfg.eqn is Eqn.GLM:
        n += 14
    if cfg.av is AV.FALLE:
        # Euler: sound speed of p*, 3 momenta, energy; MHD: fast speed of
        # the mean, momenta and transverse field of the slim star
        n += 21 if euler else 5 + 18 + 2 + 3 * 5 + 1 + 2 * 5 + 1
    n += cfg.ntracer * 6
    # divergence and dt; MHD also the Powell and GLM sources
    n += nb * 3 + (5 if euler else 24)
    if radial:
        # the metric divergence takes one more a variable, an interface at
        # order 2 its three centre-of-volume spacings, the Powell term its
        # two factors
        n += nb + cfg.ntracer + _RADIAL_SOURCE_FLOPS[(cfg.eqn, order)]
        if order == 2:
            n += 3
        if cfg.eqn.is_mhd:
            n += 1
    return n


def tile_bytes(nvar: int, nbase: int, order: int, T: int, W: int,
               mask: bool, itemsize: int, geo: bool = False) -> int:
    """Shared memory of one ``sweep_axis_kernel`` block (``tile_bytes`` of
    ``csrc/sweep.cu``): the staged stencil, ``nvar`` variables of ``T +
    2*order`` rows of ``W + 1`` (a padded row), the ``T + 1`` face fluxes of
    the base variables, on the radial axis (``geo``) the geometry pack's
    ``GEO_ROWS`` rows of the staged cells, and the mask's bytes."""
    rows, rs = T + 2 * order, W + 1
    return ((nvar * rows * rs + nbase * (T + 1) * rs
             + (GEO_ROWS * rows if geo else 0)) * itemsize
            + (rows * rs if mask else 0))


@functools.lru_cache(maxsize=None)
def sweep_plan(shape: Tuple[int, ...], axis: int, nvar: int, nbase: int,
               itemsize: int, order: int, mask: bool,
               geo: bool = False) -> Mapping[str, int]:
    """How ``sweep_axis_kernel`` (and, along axis 0, ``final_axis_kernel``)
    cuts the interior of ``shape`` for a sweep along ``axis``: tiles of
    ``T`` cells along the axis by ``W`` pencils across it (across x for the
    y and z sweeps, across y for the x sweep), one plane of the third axis
    each; one block a tile.  ``T`` starts at
    15 and ``W`` at 32, so that the tile's 16 x 32 faces are exactly four
    rounds of the block's 128 threads; while the tile's shared memory
    exceeds ``TILE_SMEM_BUDGET``, ``T + 1`` is halved (down to ``T = 3``),
    then ``W``.  ``geo``: the radial axis of a 2D cylindrical grid, whose
    geometry pack is staged with the tile (axis 0 of a 2D shape only).  The
    keys ``n_along``/``n_across``/``n_third`` and
    ``n_ta``/``n_tw`` mirror the kernel's ``Tiling``; blocks are numbered
    across fastest, then along, then third.  Cached: it runs on every
    launch."""
    ndim = len(shape)
    if ndim not in (2, 3) or not 0 <= axis < ndim or order not in (1, 2):
        raise ValueError(f"bad shape {tuple(shape)}, axis {axis} or "
                         f"order {order}")
    if geo and (ndim != 2 or axis != 0):
        raise ValueError("the geometry pack is for axis 0 of a 2D grid")
    nz, ny, nx = ((1,) + tuple(shape))[-3:]
    k = ndim - 1 - axis
    along, across, third = ((nx, ny, nz), (ny, nx, nz), (nz, nx, ny))[k]
    T, W = 15, 32
    budget = TILE_SMEM_BUDGET[itemsize]
    while tile_bytes(nvar, nbase, order, T, W, mask, itemsize, geo) > budget:
        if T > 3:
            T = (T + 1) // 2 - 1
        elif W > 8:
            W //= 2
        else:
            break
    smem = tile_bytes(nvar, nbase, order, T, W, mask, itemsize, geo)
    if smem > SMEM_MAX:
        raise ValueError(f"a sweep tile of {nvar} variables needs {smem} "
                         f"bytes of shared memory")
    n_ta, n_tw = -(-along // T), -(-across // W)
    return MappingProxyType({
        "T": T, "W": W, "n_along": along, "n_across": across,
        "n_third": third, "n_ta": n_ta, "n_tw": n_tw,
        "blocks": n_ta * n_tw * third, "threads": SWEEP_THREADS,
        "smem": smem, "geo": bool(geo)})


def _el_mask(cfg: SimConfig, scma) -> tuple:
    """(clamp flag, element bit mask) of an ``scma`` argument."""
    if not scma or not cfg.ntracer:
        return 0, 0
    bits = 0
    if isinstance(scma, (tuple, list)):
        for e in scma:
            if not cfg.eqn.nbase <= int(e) < cfg.nvar:
                raise ValueError(
                    f"element slot {e} is not a tracer slot of this config")
            bits |= 1 << int(e)
    return 1, bits


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A number (None: 0) as a 0-d tensor of the state's dtype on its
    device; the kernels read it through its device pointer.  A number is
    written there by a fill kernel, not copied from the host, and a tensor
    that already lives there is passed on untouched: nothing waits for the
    card, and a CUDA graph of the step can be recorded."""
    if not isinstance(x, torch.Tensor):
        return torch.full((), 0.0 if x is None else float(x),
                          dtype=like.dtype, device=like.device)
    return torch.as_tensor(x, dtype=like.dtype,
                           device=like.device).reshape(())


def _check_state(name: str, A: torch.Tensor, shape, like: torch.Tensor):
    if tuple(A.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(A.shape)}, expected "
                         f"{tuple(shape)}")
    if A.dtype != like.dtype or A.device != like.device:
        raise ValueError(f"{name} is {A.dtype} on {A.device}, expected "
                         f"{like.dtype} on {like.device}")
    if not A.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_args(Ph_pad, cfg: SimConfig, geom: Geometry, strong):
    """What both launches share: checks, the library, mask pointer, the
    interior shape as (nz, ny, nx) and the by-value constants."""
    from .. import _build

    if not supports(cfg):
        raise ValueError("configuration outside fused_sweep.supports()")
    if Ph_pad.dtype != cfg.torch_dtype:
        raise ValueError(f"state is {Ph_pad.dtype}, config says {cfg.dtype}")
    ng = cfg.ng
    padded = (cfg.nvar,) + tuple(n + 2 * ng for n in cfg.shape)
    _check_state("Ph_pad", Ph_pad, padded, Ph_pad)
    mask_ptr = None
    if _uses_mask(cfg):
        if strong is None:
            strong = hlld_fallback_cells(Ph_pad, cfg, geom.dx)
        if (strong.dtype != torch.bool or strong.device != Ph_pad.device
                or tuple(strong.shape) != padded[1:]
                or not strong.is_contiguous()):
            raise ValueError("mask must be a contiguous bool tensor of the "
                             "padded spatial shape on the state's device")
        mask_ptr = strong.data_ptr()
    lib = _build.get_lib(cfg.dtype, kernel_solver(cfg).value)
    nz, ny, nx = ((1,) + tuple(cfg.shape))[-3:]
    dx = float(geom.dx)
    # the floors of cons_to_prim: Euler's density floor is BASE_RHO itself
    # and its pressure floor 0.01 rho (in the kernel)
    euler = cfg.eqn is Eqn.EULER
    consts = (dx, float(cfg.gamma), float(cfg.etav),
              BASE_RHO if euler else BASE_RHO * cfg.rho_ref,
              0.0 if euler else 1.0e-6 * cfg.p_ref,
              cfg.glm_cr_factor / dx)
    # ``strong`` is returned so that it outlives the launch in the caller
    return lib, mask_ptr, strong, (nz, ny, nx), consts


def _check_planes(cfg: SimConfig, axis: int, order: int, planes) -> list:
    js = [int(j) for j in planes]
    if cfg.coords is not Coord.CARTESIAN or order != 2:
        raise ValueError("interface planes are written by order-2 sweeps "
                         "of Cartesian axes (the nested-grid corrector's)")
    if not 1 <= len(js) <= MAX_PLANES or len(set(js)) != len(js) or any(
            not 0 <= j <= cfg.shape[axis] for j in js):
        raise ValueError(f"planes {js}: 1 to {MAX_PLANES} distinct "
                         f"interfaces in 0..{cfg.shape[axis]}")
    return js


def sweep_axis(Ph_pad: torch.Tensor, cfg: SimConfig, geom: Geometry,
               axis: int, order: int, dt, ch=None, scma=False,
               strong: Optional[torch.Tensor] = None, planes=None):
    """``dt*dU`` of one axis for the interior cells, ``(nvar, *shape)``.

    ``Ph_pad`` is the fully padded primitive state.  ``strong`` is the
    per-cell HLLD->HLL flag of :func:`..ops.sweep.hlld_fallback_cells`
    (padded, bool); it is computed here when the config needs it and the
    caller has none.  ``dt`` and ``ch`` may be numbers or 0-d tensors.
    ``planes``: up to ``MAX_PLANES`` interface indices ``j`` (0..n) of a
    Cartesian axis, at order 2; then ``(dU, F)`` is returned, ``F[i]`` the
    face flux at ``planes[i]``, ``(nvar, *transverse)`` (the plain sweep's
    ``face_fluxes[axis]`` at that index).  A CPU tensor takes
    :func:`sweep_axis_plain`; a CUDA tensor launches the kernel or raises.
    """
    js = None if planes is None else _check_planes(cfg, axis, order, planes)
    if js is not None:
        sweep_axis.planes += len(js)
    if not Ph_pad.is_cuda:
        return sweep_axis_plain(Ph_pad, cfg, geom, axis, order, dt, ch=ch,
                                scma=scma, planes=js)
    if not 0 <= axis < cfg.ndim or order not in (1, 2):
        raise ValueError(f"bad axis {axis} or order {order}")
    lib, mask_ptr, strong, (nz, ny, nx), consts = _launch_args(
        Ph_pad, cfg, geom, strong)
    dt_t = _scalar(dt, Ph_pad)
    if cfg.eqn is Eqn.GLM and ch is None:
        ch = cfg.cfl * geom.dx / dt_t
    ch_t = _scalar(ch, Ph_pad)
    clamp, bits = _el_mask(cfg, scma)
    geo = (radial_geo(cfg, geom, Ph_pad.dtype, Ph_pad.device)
           if cfg.coords is Coord.CYLINDRICAL and axis == 0 else None)
    plan = sweep_plan(tuple(cfg.shape), axis, cfg.nvar, cfg.eqn.nbase,
                      Ph_pad.element_size(), order, mask_ptr is not None,
                      geo is not None)
    out = torch.empty((cfg.nvar,) + tuple(cfg.shape), dtype=Ph_pad.dtype,
                      device=Ph_pad.device)
    F, planes_args = None, (None, 0, 0, 0, 0, 0)
    if js is not None:
        F = torch.empty((len(js), cfg.nvar) + tuple(
            n for a, n in enumerate(cfg.shape) if a != axis),
            dtype=Ph_pad.dtype, device=Ph_pad.device)
        planes_args = (F.data_ptr(), len(js),
                       *(js + [0] * (MAX_PLANES - len(js))))
    err = lib.pion_sweep_axis(
        Ph_pad.data_ptr(), mask_ptr,
        None if geo is None else geo.data_ptr(), out.data_ptr(),
        dt_t.data_ptr(),
        ch_t.data_ptr(), cfg.ndim, nz, ny, nx, axis, cfg.nvar,
        _EQN_CODE[cfg.eqn], 1 if cfg.av is AV.FALLE else 0,
        order, clamp, bits, plan["T"], plan["W"], *consts, *planes_args,
        torch.cuda.current_stream(Ph_pad.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sweep_axis kernel launch failed: CUDA error {err}")
    sweep_axis.launches += 1
    return out if F is None else (out, F)


sweep_axis.launches = 0
sweep_axis.planes = 0


def sweep_axis_plain(Ph_pad, cfg: SimConfig, geom: Geometry, axis: int,
                     order: int, dt, ch=None, scma=False, planes=None):
    """The plain PyTorch version of :func:`sweep_axis`: the plain sweep of
    one axis, and with ``planes`` its face tensor at those indices."""
    dU, faces = dynamics_dU(Ph_pad, cfg, geom, dt, order, ch=ch, scma=scma,
                            axes=[axis])
    if planes is None:
        return dU
    return dU, torch.stack([faces[axis].select(1 + axis, j)
                            for j in planes])


def final_axis(P: torch.Tensor, Ph_pad: torch.Tensor,
               contribs: Sequence[torch.Tensor], cfg: SimConfig,
               geom: Geometry, order: int, dt, ch=None,
               strong: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The new primitive state of a pure-dynamics partial update.

    ``P`` is the base state (interior shape), ``Ph_pad`` the padded state
    the fluxes are taken from, ``contribs`` the other axes' ``dt*dU``
    (at most two).  Computes the axis-0 sweep, adds it and the contribs to
    ``U(P)``, converts back with the floors and damps psi.  Neither ``P``
    nor ``Ph_pad`` is written.
    """
    if not Ph_pad.is_cuda:
        return final_axis_plain(P, Ph_pad, contribs, cfg, geom, order, dt,
                                ch=ch)
    if order not in (1, 2):
        raise ValueError(f"bad order {order}")
    if len(contribs) > 2:
        raise ValueError("at most two contribs")
    lib, mask_ptr, strong, (nz, ny, nx), consts = _launch_args(
        Ph_pad, cfg, geom, strong)
    interior = (cfg.nvar,) + tuple(cfg.shape)
    _check_state("P", P, interior, Ph_pad)
    for i, c in enumerate(contribs):
        _check_state(f"contribs[{i}]", c, interior, Ph_pad)
    dt_t = _scalar(dt, Ph_pad)
    if cfg.eqn is Eqn.GLM and ch is None:
        ch = cfg.cfl * geom.dx / dt_t
    ch_t = _scalar(ch, Ph_pad)
    cptr = [c.data_ptr() for c in contribs] + [None, None]
    geo = (radial_geo(cfg, geom, Ph_pad.dtype, Ph_pad.device)
           if cfg.coords is Coord.CYLINDRICAL else None)
    plan = sweep_plan(tuple(cfg.shape), 0, cfg.nvar, cfg.eqn.nbase,
                      Ph_pad.element_size(), order, mask_ptr is not None,
                      geo is not None)
    out = torch.empty(interior, dtype=Ph_pad.dtype, device=Ph_pad.device)
    err = lib.pion_final_axis(
        Ph_pad.data_ptr(), mask_ptr,
        None if geo is None else geo.data_ptr(), P.data_ptr(), cptr[0],
        cptr[1],
        out.data_ptr(), dt_t.data_ptr(), ch_t.data_ptr(), cfg.ndim, nz, ny,
        nx, cfg.nvar, _EQN_CODE[cfg.eqn],
        1 if cfg.av is AV.FALLE else 0, order, plan["T"], plan["W"], *consts,
        torch.cuda.current_stream(Ph_pad.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"final_axis kernel launch failed: CUDA error {err}")
    final_axis.launches += 1
    return out


final_axis.launches = 0


def final_axis_plain(P, Ph_pad, contribs, cfg: SimConfig, geom: Geometry,
                     order: int, dt, ch=None) -> torch.Tensor:
    """The plain PyTorch version of :func:`final_axis`: the axis-0 sweep,
    then the conserved update, the floors and the psi damping in the order
    the kernel applies them."""
    if cfg.eqn is Eqn.GLM and ch is None:
        ch = cfg.cfl * geom.dx / dt
    U = prim_to_cons(P, cfg) + sweep_axis_plain(Ph_pad, cfg, geom, 0, order,
                                                dt, ch=ch)
    for c in contribs:
        U = U + c
    Pn = cons_to_prim(U, cfg)
    if cfg.eqn is Eqn.GLM:
        cr = cfg.glm_cr_factor / geom.dx
        # Pn was created just above, so it is damped in place
        Pn[SI] *= torch.exp(torch.as_tensor(-dt * ch * cr, dtype=Pn.dtype,
                                            device=Pn.device))
    return Pn


def dynamics_dU_fused(Ph_pad: torch.Tensor, cfg: SimConfig, geom: Geometry,
                      dt, order: int, ch=None, scma=False, planes=None):
    """``dt*dU`` of the whole sweep, every axis through :func:`sweep_axis`,
    summed in ascending axis order.  The partial update takes this form
    when a microphysics term joins ``dU`` before the conserved update, so
    that :func:`final_axis` cannot apply it.  ``planes``: ``{axis: [j,
    ...]}``, the interface planes to hand back; then ``(dU, {(axis, j):
    face flux})`` is returned, each plane ``(nvar, *transverse)`` as
    :func:`sweep_axis` gives it."""
    if not supports(cfg):
        raise ValueError("configuration outside fused_sweep.supports()")
    if cfg.eqn is Eqn.GLM and ch is None:
        ch = cfg.cfl * geom.dx / dt
    strong = None
    if Ph_pad.is_cuda and _uses_mask(cfg):
        strong = hlld_fallback_cells(Ph_pad, cfg, geom.dx)
    dU, faces = None, {}
    for axis in range(cfg.ndim):
        js = None if planes is None else planes.get(axis) or None
        contrib = sweep_axis(Ph_pad, cfg, geom, axis, order, dt, ch=ch,
                             scma=scma, strong=strong, planes=js)
        if js is not None:
            contrib, F = contrib
            faces.update(((axis, int(j)), F[i]) for i, j in enumerate(js))
        dU = contrib if dU is None else dU.add_(contrib)
    return dU if planes is None else (dU, faces)


def advance_dynamics(P: torch.Tensor, Ph_pad: torch.Tensor, cfg: SimConfig,
                     geom: Geometry, dt, order: int, ch=None) -> torch.Tensor:
    """One fused pure-dynamics partial update: ``P + dt*dU[Ph] -> P-new``.

    The transverse axes run :func:`sweep_axis`; the axis-0 launch of
    :func:`final_axis` also applies the conserved update, the floors and the
    GLM psi damping.  The fallback mask is one plain pass shared by the
    launches.  It has no place for another term of the update: a caller
    with microphysics or conduction takes :func:`dynamics_dU_fused` and
    composes the update itself (``stepper._partial_update``, as the JAX
    package's ``stepper.py:85``)."""
    if not supports(cfg):
        raise ValueError("configuration outside fused_sweep.supports()")
    if cfg.eqn is Eqn.GLM and ch is None:
        ch = cfg.cfl * geom.dx / dt
    strong = None
    if Ph_pad.is_cuda and _uses_mask(cfg):
        strong = hlld_fallback_cells(Ph_pad, cfg, geom.dx)
    contribs = [sweep_axis(Ph_pad, cfg, geom, axis, order, dt, ch=ch,
                           strong=strong)
                for axis in range(1, cfg.ndim)]
    return final_axis(P, Ph_pad, contribs, cfg, geom, order, dt, ch=ch,
                      strong=strong)
