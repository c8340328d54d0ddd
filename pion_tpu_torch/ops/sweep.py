"""Directionally-unsplit finite-volume flux sweeps (the plain torch path).

Counterpart of the reference's per-column pointer walk
(reference: source/sim_control/time_integrator.cpp:498-860
``calc_dynamics_dU`` -> ``dynamics_dU_column``, and
source/spatial_solvers/solver_eqn_base.cpp:152-204 ``InterCellFlux``):
instead of marching cell-by-cell down columns, every axis is processed as one
whole-tensor shifted-slice computation — slopes, edge states, Riemann fluxes
and source terms are dense elementwise ops on views of the padded state, with
the sweep axis left in its natural position.

Every stage here is a full-grid tensor in device memory; the fused CUDA
kernels of :mod:`.fused_sweep` compute the same thing per cell in registers.
This module is what those kernels are held against, what runs for a CPU
tensor, and what runs for configurations the kernels do not cover.

``dynamics_dU`` returns the *accumulated conserved increment* dt*(-div F + S)
for interior cells, plus the per-axis face fluxes (for Berger-Colella 1989
flux correction between refinement levels), with each flux tensor keeping the
sweep axis in its natural position (length n+1 there).

``interface_flux`` and ``interface_flux_pair`` give single interface planes
of those face fluxes from 4-cell slabs, for the nested-grid hierarchy.

Ported: Cartesian grids, the Euler, MHD and GLM-MHD systems with every
solver of the reference's menu, Falle artificial viscosity.  Curvilinear
metrics and the H-correction raise ``NotImplementedError``.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch

from ..config import SimConfig
from ..constants import BX, BY, BZ, PG, RO, SI, VX, VY, VZ, AV, Coord, Eqn, Solver
from ..grid import Geometry
from . import riemann_hydro as rh
from . import riemann_mhd as rm
from .eqns import (
    cfast_components,
    cons_to_prim,
    inverse_perm,
    maxspeed,
    permute,
    sweep_perm,
)
from .recon import van_albada


def _slab(A, ax: int, lo: int, hi: Optional[int]):
    """A[..., lo:hi, ...] along tensor axis ``ax`` (hi=None means to end;
    negative hi counts from the end)."""
    idx = [slice(None)] * A.ndim
    idx[ax] = slice(lo, hi)
    return A[tuple(idx)]


def _bcast(v: torch.Tensor, axis: int, ndim: int):
    """Reshape a 1D per-cell tensor so it broadcasts along spatial ``axis``
    of a (nvar, *spatial) tensor."""
    return v.reshape((1,) * (1 + axis) + (-1,) + (1,) * (ndim - 1 - axis))


def _replace(A: torch.Tensor, updates: dict) -> torch.Tensor:
    """A new tensor equal to ``A`` with some variables replaced (the
    counterpart of a chain of functional ``.at[i].set``; ``A`` itself is
    not written)."""
    return torch.stack([updates.get(i, A[i]) for i in range(A.shape[0])])


def _scma_elements(Plt, Prt, Pl_r, Pr_r, el_slots, cfg: SimConfig):
    """Scale the element tracers of each edge state by 1/sum(clip(el,0,1))
    (reference: microphysics_base.cpp:96-118 sCMA element loop)."""
    def factor(P):
        ssum = None
        for e in el_slots:
            v = torch.clamp(P[e], 0.0, 1.0)
            ssum = v if ssum is None else ssum + v
        return 1.0 / torch.clamp(ssum, min=1.0e-30)

    fl = factor(Pl_r)
    fr = factor(Pr_r)
    base = cfg.eqn.nbase
    li = list(range(Plt.shape[0]))
    Plt = torch.stack([Plt[i] * fl if (base + i) in el_slots else Plt[i]
                       for i in li])
    Prt = torch.stack([Prt[i] * fr if (base + i) in el_slots else Prt[i]
                       for i in li])
    return Plt, Prt


def _interior(A: torch.Tensor, cfg: SimConfig, skip_axis: Optional[int] = None):
    """Slice ghost zones off every spatial axis (except ``skip_axis``)."""
    ng = cfg.ng
    sl = [slice(None)]  # variable axis
    for ax in range(cfg.ndim):
        sl.append(slice(None) if ax == skip_axis else slice(ng, -ng))
    return A[tuple(sl)]


def _reconstruct(Pt, cfg: SimConfig, geom: Geometry, axis: int, order: int):
    """Slopes + edge states along the sweep axis.

    ``Pt`` is padded along the sweep axis only.  Returns (Pl, Pr, slope_c).
    The one-sided differences are divided by the centre-of-volume spacing
    and the slopes multiplied by the face offsets ``del_n``/``del_p`` (the
    fused kernels divide by the constant ``dx`` and use ``+-dx/2``, which
    differs in the last bit).
    """
    ng = cfg.ng
    n = cfg.shape[axis]
    ax = 1 + axis
    nd = cfg.ndim
    if order == 1:
        # Piecewise-constant (reference: VectorOps.cpp:587-589 with OA1)
        Pl = _slab(Pt, ax, ng - 1, ng + n)
        Pr = _slab(Pt, ax, ng, ng + n + 1)
        slope_c = torch.zeros_like(_slab(Pt, ax, ng, ng + n))
        return Pl, Pr, slope_c
    g = geom.axis_tensors(axis, Pt.dtype, Pt.device)
    com = _bcast(g["com"], axis, nd)
    d = _slab(Pt, ax, 1, None) - _slab(Pt, ax, 0, -1)
    h = _slab(com, ax, 1, None) - _slab(com, ax, 0, -1)
    one_sided = d / h
    slopes = van_albada(_slab(one_sided, ax, 0, -1), _slab(one_sided, ax, 1, None))
    cells = _slab(Pt, ax, 1, -1)
    del_n = _slab(_bcast(g["del_n"], axis, nd), ax, 1, -1)
    del_p = _slab(_bcast(g["del_p"], axis, nd), ax, 1, -1)
    lo = cells + slopes * del_n
    hi = cells + slopes * del_p
    # interface i+1/2 between padded cells (c, c+1):
    #   left state = hi-face state of c, right = lo-face state of c+1
    Pl = _slab(hi, ax, ng - 2, ng + n - 1)
    Pr = _slab(lo, ax, ng - 1, ng + n)
    slope_c = _slab(slopes, ax, ng - 1, ng + n - 1)
    return Pl, Pr, slope_c


def _riemann(Pl_r, Pr_r, cfg: SimConfig, dx_over_dt, hc_eta,
             hll_mask=None):
    """Dispatch on the configured flux solver (sweep frame).

    Mirrors reference solver dispatch (solver_eqn_hydro_adi.cpp:94-201,
    solver_eqn_mhd_adi.cpp:102-200).  Returns (flux, pstar).
    """
    s = cfg.solver
    if cfg.eqn is Eqn.EULER:
        if s is Solver.LF:
            return rh.lax_friedrichs(Pl_r, Pr_r, cfg, dx_over_dt)
        if s is Solver.HLL:
            return rh.hll(Pl_r, Pr_r, cfg)
        if s is Solver.RCV:
            return rh.roe_cv(Pl_r, Pr_r, cfg, hc_eta)
        if s is Solver.RPV:
            # distinct Roe-mean PV solver (reference:
            # Roe_Hydro_PrimitiveVar_solver.cpp), not the arithmetic-mean
            # linear solver
            return rh.roe_pv(Pl_r, Pr_r, cfg)
        if s is Solver.LINEAR:
            return rh.linear_pv(Pl_r, Pr_r, cfg)
        if s is Solver.EXACT:
            return rh.exact(Pl_r, Pr_r, cfg)
        if s is Solver.HYBRID:
            return rh.hybrid(Pl_r, Pr_r, cfg)
        if s is Solver.FVS:
            return rh.fvs(Pl_r, Pr_r, cfg)
        raise ValueError(f"unsupported hydro solver {s}")
    # MHD / GLM
    if s is Solver.LF:
        return rh.lax_friedrichs(Pl_r, Pr_r, cfg, dx_over_dt)
    if s is Solver.HLL:
        return rm_to_pstar(rm.hll(Pl_r, Pr_r, cfg), cfg)
    if s is Solver.HLLD:
        return rm_to_pstar(
            rm.hlld_with_hll_fallback(Pl_r, Pr_r, cfg, hll_mask), cfg)
    if s is Solver.RCV:
        return rm_to_pstar(rm.roe_cv(Pl_r, Pr_r, cfg, hc_eta), cfg)
    if s in (Solver.LINEAR, Solver.EXACT, Solver.HYBRID, Solver.RPV):
        return rm_to_pstar(rm.linear(Pl_r, Pr_r, cfg), cfg)
    raise ValueError(f"unsupported MHD solver {s}")


def rm_to_pstar(fu, cfg):
    f, ustar = fu
    return f, cons_to_prim(ustar, cfg)


def _av_falle(flux, Pl, Pr, pstar, cfg: SimConfig):
    """FKJ98 viscous flux correction (reference:
    solver_eqn_hydro_adi.cpp:283-330, solver_eqn_mhd_adi.cpp:209-286).
    Returns a new flux tensor."""
    if cfg.eqn is Eqn.EULER:
        pref = maxspeed(pstar, cfg) * cfg.etav * pstar[RO]
    else:
        pref = (
            cfast_components(
                0.5 * (Pl[RO] + Pr[RO]),
                0.5 * (Pl[PG] + Pr[PG]),
                0.5 * (Pl[BX] + Pr[BX]),
                0.5 * (Pl[BY] + Pr[BY]),
                0.5 * (Pl[BZ] + Pr[BZ]),
                cfg.gamma,
            )
            * cfg.etav
            * pstar[RO]
        )
    upd = {}
    erg = torch.zeros_like(pref)
    for v in (VX, VY, VZ):
        mv = pref * (Pr[v] - Pl[v])
        upd[v] = flux[v] + (-mv)
        erg = erg + mv * pstar[v]
    if cfg.eqn.is_mhd:
        prefb = pref / pstar[RO]  # etaB == etav (reference :277)
        for b in (BY, BZ):
            mv = prefb * (Pr[b] - Pl[b])
            upd[b] = flux[b] + (-mv)
            erg = erg + mv * pstar[b]
    upd[PG] = flux[PG] + (-erg)
    return _replace(flux, upd)


def hlld_fallback_cells(Ph_pad, cfg: SimConfig, dx: float):
    """Per-cell div(v) and pressure-jump measure for the HLLD->HLL switch
    (Mignone et al. 2011; reference: solver_eqn_base.cpp:398-412 preprocess
    sets DivV and MagGradP = sum_axes |dp|/min(p), threshold 5 at
    solver_eqn_mhd_adi.cpp:167-182).  Computed on the padded tensor so the
    one-ghost-deep cells used by boundary interfaces are covered.

    All terms are evaluated on the aligned 1-ring region (every spatial
    axis sliced to 1..npad-2), then written into a zero bool tensor of the
    padded shape.  Both sweep paths only read the mask at cells
    1..npad-2 along the sweep axis and interior transverse cells, so the
    zero edge layer never feeds an interface."""
    nd = cfg.ndim
    p = Ph_pad[PG]

    def ring(A, ax0, shift):
        # A sliced to the 1-ring region, offset by ``shift`` along ax0
        return A[tuple(slice(1 + shift, A.shape[a] - 1 + shift)
                       if a == ax0 else slice(1, -1)
                       for a in range(nd))]

    divv = None
    gradp = None
    for ax0 in range(nd):
        k = nd - 1 - ax0
        v = Ph_pad[VX + k]
        d = (ring(v, ax0, 1) - ring(v, ax0, -1)) / (2.0 * dx)
        divv = d if divv is None else divv + d
        phi = ring(p, ax0, 1)
        plo = ring(p, ax0, -1)
        gz = torch.abs(phi - plo) / torch.minimum(phi, plo)
        gradp = gz if gradp is None else gradp + gz
    strong = (divv < 0.0) & (gradp > 5.0)
    # a bool tensor is padded by writing into a fresh zero tensor
    out = torch.zeros(p.shape, dtype=torch.bool, device=p.device)
    out[(slice(1, -1),) * nd] = strong
    return out


def dynamics_dU(
    Ph_pad: torch.Tensor,
    cfg: SimConfig,
    geom: Geometry,
    dt,
    order: int,
    ch=None,
    scma=False,
    axes=None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """dt * (-div F + Powell/GLM sources) for all interior cells.

    ``Ph_pad`` is the primitive state padded with ``ng`` ghost cells on every
    axis (boundary conditions already applied).  ``order`` is the spatial
    order for this partial step (1 on the predictor half-step, cfg.ooa on the
    corrector — reference: time_integrator.cpp:151-243).  ``axes``: restrict
    the sweep to these axes (skipped axes append None to the face list).  The
    returned dU is only the selected axes' contribution.  ``dt`` and ``ch``
    may be Python numbers or 0-d tensors on the state's device.
    """
    if cfg.coords is not Coord.CARTESIAN:
        raise NotImplementedError(
            "cylindrical/spherical metric and geometric source terms are "
            "not ported yet")
    if cfg.av in (AV.HCORR, AV.HCORR_FALLE):
        raise NotImplementedError("the H-correction is not ported yet")
    ng = cfg.ng
    dx = geom.dx
    nd = cfg.ndim
    glm = cfg.eqn is Eqn.GLM
    if glm and ch is None:
        # hyperbolic cleaning speed c_h = cfl*dx/t_dyn; the stepper passes the
        # full-step value (reference: solver_eqn_mhd_adi.cpp:906-922 via
        # calc_timestep.cpp:112-139) so the half-step reuses it.
        ch = cfg.cfl * dx / dt

    hlld_strong = None
    if (cfg.solver is Solver.HLLD and cfg.eqn.is_mhd
            and cfg.hlld_fallback):
        hlld_strong = hlld_fallback_cells(Ph_pad, cfg, dx)

    dU = None
    face_fluxes: List[torch.Tensor] = []
    for axis in range(nd):
        if axes is not None and axis not in axes:
            face_fluxes.append(None)
            continue
        n = cfg.shape[axis]
        # interior on transverse axes only; sweep axis stays padded
        Pt = _interior(Ph_pad, cfg, skip_axis=axis)
        ax = 1 + axis
        Pl, Pr, slope_c = _reconstruct(Pt, cfg, geom, axis, order)

        perm = sweep_perm(cfg, axis)
        inv = inverse_perm(perm)
        Pl_r = permute(Pl, perm)
        Pr_r = permute(Pr, perm)

        hll_mask = None
        if hlld_strong is not None:
            # interface uses HLL when either adjacent cell is flagged
            smi = _interior(hlld_strong[None], cfg, skip_axis=axis)
            ml = _slab(smi, ax, ng - 1, ng + n)[0]
            mr = _slab(smi, ax, ng, ng + n + 1)[0]
            hll_mask = torch.logical_or(ml, mr)

        psistar = bxstar = None
        if glm:
            # Dedner 2x2 Riemann problem for (Bx, psi)
            # (reference: solver_eqn_mhd_adi.cpp:724-738)
            psistar = 0.5 * (Pl_r[SI] + Pr_r[SI] - (Pr_r[BX] - Pl_r[BX]))
            bxstar = 0.5 * (Pl_r[BX] + Pr_r[BX] - (Pr_r[SI] - Pl_r[SI]))
            zero = torch.zeros_like(bxstar)
            Pl_r = _replace(Pl_r, {SI: zero, BX: bxstar})
            Pr_r = _replace(Pr_r, {SI: zero, BX: bxstar})

        flux_r, pstar = _riemann(Pl_r, Pr_r, cfg, dx / dt, None,
                                 hll_mask=hll_mask)

        if glm:
            # Mackey & Lim (2011) energy correction + Dedner fluxes
            # (reference: solver_eqn_mhd_adi.cpp:760-762)
            flux_r = _replace(flux_r, {
                PG: flux_r[PG] + ch * bxstar * psistar,
                BX: ch * psistar,
                SI: ch * bxstar,
            })

        if cfg.av is AV.FALLE:
            flux_r = _av_falle(flux_r, Pl_r, Pr_r, pstar, cfg)

        # Tracer advection: upwind on the mass flux
        # (reference: solver_eqn_base.cpp:281-342)
        if cfg.ntracer:
            fm = flux_r[RO]
            tr = cfg.tracer_slice
            Plt, Prt = Pl_r[tr], Pr_r[tr]
            if scma:
                # sCMA corrector (Plewa & Muller 1999; reference:
                # microphysics_base.cpp:80-131 + solver_eqn_base.cpp:320-334):
                # tracers above 1 advect as 1 (corrector = 1/p; the p<0 -> 0
                # branch upstream is dead code, overwritten on the next line,
                # so negative values pass through unchanged).  Only active
                # when a microphysics module owns the tracers.
                Plt = torch.clamp(Plt, max=1.0)
                Prt = torch.clamp(Prt, max=1.0)
                if isinstance(scma, (tuple, list)) and len(scma):
                    # element mass-fraction renormalization: the declared
                    # element tracers advect with values scaled so their
                    # clamped sum is 1 (reference:
                    # microphysics_base.cpp:96-118)
                    Plt, Prt = _scma_elements(Plt, Prt, Pl_r, Pr_r,
                                              scma, cfg)
            f_tr = torch.where(fm > 0.0, Plt * fm, Prt * fm)
            f_tr = torch.where(fm == 0.0, 0.0, f_tr)
            flux_r = torch.cat([flux_r[:tr.start], f_tr])

        flux = permute(flux_r, inv)

        # -div(F): per-axis divergence with metric coefficients
        # (reference: VectorOps.cpp:624-644)
        g = geom.axis_tensors(axis, Pt.dtype, Pt.device)
        cn = _bcast(g["div_cn"], axis, nd)
        cp = _bcast(g["div_cp"], axis, nd)
        dudt = cn * _slab(flux, ax, 0, -1) - cp * _slab(flux, ax, 1, None)

        face_fluxes.append(flux)
        if cfg.eqn.is_mhd:
            dudt = _mhd_sources(dudt, Pt, cfg, axis, dx, glm)
        contrib = dt * dudt
        dU = contrib if dU is None else dU + contrib

    return dU, face_fluxes


def _mhd_sources(dudt, Pt, cfg: SimConfig, axis: int, dx: float, glm: bool):
    """``dudt`` of one axis with the Powell 8-wave and GLM advective source
    terms added (``Pt`` padded along ``axis`` only)."""
    ng = cfg.ng
    n = cfg.shape[axis]
    ax = 1 + axis
    nd = cfg.ndim
    Pc = _slab(Pt, ax, ng, ng + n)  # interior cells

    # Powell 8-wave source terms (MHD; reference:
    # solver_eqn_mhd_adi.cpp:396-443): dU_i -= (d<Bn>/dx) * S_i
    k = nd - 1 - axis
    bn = Pt[BX + k:BX + k + 1]  # padded along the sweep axis
    bm = 0.5 * (_slab(bn, ax, ng - 1, ng + n)[0]
                + _slab(bn, ax, ng, ng + n + 1)[0])
    dbm = (_slab(bm[None], ax, 0, -1)[0]
           - _slab(bm[None], ax, 1, None)[0]) / dx
    udotb = Pc[VX] * Pc[BX] + Pc[VY] * Pc[BY] + Pc[VZ] * Pc[BZ]
    upd = {
        VX: dudt[VX] + dbm * Pc[BX],
        VY: dudt[VY] + dbm * Pc[BY],
        VZ: dudt[VZ] + dbm * Pc[BZ],
        BX: dudt[BX] + dbm * Pc[VX],
        BY: dudt[BY] + dbm * Pc[VY],
        BZ: dudt[BZ] + dbm * Pc[VZ],
    }
    pg_new = dudt[PG] + dbm * udotb
    if glm:
        # GLM advective psi source (reference:
        # solver_eqn_mhd_adi.cpp:782-813)
        psi = Pt[SI:SI + 1]
        sm = 0.5 * (_slab(psi, ax, ng - 1, ng + n)[0]
                    + _slab(psi, ax, ng, ng + n + 1)[0])
        dsm = (_slab(sm[None], ax, 0, -1)[0]
               - _slab(sm[None], ax, 1, None)[0]) / dx
        vn = Pc[VX + k]
        pg_new = pg_new + dsm * vn * Pc[SI]
        upd[SI] = dudt[SI] + dsm * vn
    upd[PG] = pg_new
    return _replace(dudt, upd)


@functools.lru_cache(maxsize=64)
def _slab_setup(cfg: SimConfig, axis: int, ncell: int):
    """Config and geometry of a slab ``ncell`` cells deep along ``axis`` with
    the grid's own ``dx``; kept, because the nested-grid hierarchy asks for the
    same few slabs at every step."""
    from ..grid import make_geometry

    shape = list(cfg.shape)
    shape[axis] = ncell
    xmax = list(cfg.xmax)
    # preserve dx: slab extents = xmin + ncell*dx on the slab axis
    xmax[axis] = cfg.xmin[axis] + float(ncell) * cfg.dx
    cfg_slab = cfg.with_(shape=tuple(shape), xmax=tuple(xmax))
    return cfg_slab, make_geometry(cfg_slab)


def _slab_faces(Ph_pad, cfg: SimConfig, axis: int, starts, dt, order: int,
                ch, scma):
    """Face fluxes along ``axis`` of the slab made of the 4-cell windows of
    ``Ph_pad`` that begin at the padded indices ``starts``."""
    if cfg.coords is not Coord.CARTESIAN or cfg.av not in (AV.NONE, AV.FALLE):
        raise ValueError("interface fluxes from slabs need a Cartesian grid "
                         "and no H-correction")
    ng = cfg.ng
    ax = 1 + axis
    parts = [Ph_pad.narrow(ax, lo, 4) for lo in starts]

    def edge(A, i):
        e = A.narrow(ax, i, 1)
        return e.expand(e.shape[:ax] + (ng,) + e.shape[ax + 1:])

    # the slab's own ghosts: edge replication
    slab_pad = torch.cat([edge(parts[0], 0)] + parts + [edge(parts[-1], 3)],
                         dim=ax)
    cfg_slab, geom_slab = _slab_setup(cfg, axis, 4 * len(starts))
    _, faces = dynamics_dU(slab_pad, cfg_slab, geom_slab, dt, order, ch=ch,
                           scma=scma, axes=[axis])
    return faces[axis]


def interface_flux(Ph_pad, cfg: SimConfig, geom: Geometry, axis: int,
                   j: int, dt, order: int, ch=None, scma=False):
    """Face flux at ONE interface plane ``j`` (0..n) of ``axis``, equal to
    ``dynamics_dU(...)[1][axis]`` indexed at j, from a 4-cell slab.

    Lets the nested-grid hierarchy use the fused kernels for the dU (which do
    not expose face fluxes) and still obtain the handful of interface planes
    that BC89 flux correction and the parent-boundary restriction need
    (reference: NG_BC89flux save_fine/coarse_fluxes) — O(N^2) work per plane
    instead of a second full plain sweep.

    The interface flux depends only on cells j-2..j+1 of the sweep axis
    (2nd-order MUSCL stencil), all present in ``Ph_pad``; the slab's own
    ghost values are edge-replicated and provably do not reach the middle
    interface.  Scope: Cartesian, AV none/falle (H-correction needs global
    transverse etas).
    """
    # padded index of interior cell j-2; the slab has 5 interfaces and the
    # middle one (index 2) is interface j
    F = _slab_faces(Ph_pad, cfg, axis, [cfg.ng + j - 2], dt, order, ch, scma)
    return F.select(1 + axis, 2)


def interface_flux_pair(Ph_pad, cfg: SimConfig, geom: Geometry, axis: int,
                        j_lo: int, j_hi: int, dt, order: int, ch=None,
                        scma=False):
    """Face fluxes at TWO interface planes of ``axis`` from ONE 8-cell
    slab sweep (the two 4-cell stencils are disjoint, so concatenating
    the slabs changes nothing for the two middle interfaces).  Halves the
    slab-sweep count of the nested-grid BC89/leaf-face machinery, whose
    per-call cost is bound by the number of small launches."""
    F = _slab_faces(Ph_pad, cfg, axis,
                    [cfg.ng + j_lo - 2, cfg.ng + j_hi - 2], dt, order, ch,
                    scma)
    return F.select(1 + axis, 2), F.select(1 + axis, 6)
