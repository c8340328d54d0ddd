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

The reconstruction differs in the last bit between the two: the plain sweep
divides the one-sided differences by the centre-of-volume spacing and
multiplies the slopes by ``del_n``/``del_p``; the kernels divide by the
constant ``dx`` and use ``+-dx/2``.  Tests hold them at ``rtol=1e-10`` in
float64.

Scope (:func:`supports`): Cartesian 2D and 3D, MHD and GLM-MHD, the HLL and
HLLD solvers (HLLD with or without the fallback mask), Falle viscosity or
none, any number of tracers up to slot 63, sCMA off, on, or with element
slots, orders 1 and 2, float32 and float64.
"""
from __future__ import annotations

import functools
from types import MappingProxyType
from typing import Mapping, Optional, Sequence, Tuple

import torch

from ..config import SimConfig
from ..constants import AV, SI, Coord, Eqn, Solver
from ..grid import Geometry
from .eqns import BASE_RHO, cons_to_prim, prim_to_cons
from .sweep import dynamics_dU, hlld_fallback_cells

MAX_NVAR = 64  # element slots travel as a 64-bit mask

SWEEP_THREADS = 128            # threads a block of sweep_axis_kernel
SMEM_MAX = 232448              # shared memory a block can opt in to (H100)
# shared memory a tile may take, by bytes of the scalar type: four (at the
# main path's 10 variables, five) float32 blocks or two float64 blocks fit an
# SM's 228 KB
TILE_SMEM_BUDGET = {4: 48 * 1024, 8: 100 * 1024}


def supports(cfg: SimConfig) -> bool:
    """Whether the CUDA kernels cover this configuration (everything else
    takes the plain torch sweep)."""
    return (
        cfg.coords is Coord.CARTESIAN
        and cfg.ndim in (2, 3)
        and cfg.eqn in (Eqn.MHD, Eqn.GLM)
        and cfg.solver in (Solver.HLL, Solver.HLLD)
        and cfg.av in (AV.NONE, AV.FALLE)
        and cfg.nvar <= MAX_NVAR
        and cfg.dtype in ("float32", "float64")
    )


def _uses_mask(cfg: SimConfig) -> bool:
    return (cfg.solver is Solver.HLLD and cfg.eqn.is_mhd
            and cfg.hlld_fallback)


def flops_per_interface(cfg: SimConfig, order: int) -> int:
    """Floating-point operations of one interface solve, counted by hand
    from the formulas of the plain version (an add, multiply, divide,
    square root, compare-and-select each count one).  Used for the
    operations side of the kernels' roofline bound."""
    nb = cfg.eqn.nbase
    n = 0
    if order == 2:
        n += cfg.nvar * 29          # 3 differences/dx, 2 limiters, 2 edges
    n += 2 * 27 + 2 * 33            # prim_to_cons and flux_from_pu, both sides
    n += 2 * 18 + 5                 # fast speeds and the two wave speeds
    if cfg.solver is Solver.HLLD:
        n += 30 + 2 * 62 + 10 + 45 + 2 * 16 + 8 * 7   # star, double-star, assembly
        if cfg.hlld_fallback:
            n += 8 + 8 * 11         # the HLL fallback of flagged interfaces
    else:
        n += 8 + 8 * 11
    if cfg.eqn is Eqn.GLM:
        n += 14
    if cfg.av is AV.FALLE:
        n += 5 + 18 + 2 + 3 * 5 + 1 + 2 * 5 + 1
    n += cfg.ntracer * 6
    n += nb * 3 + 24                # divergence, Powell and GLM sources, dt
    return n


def tile_bytes(nvar: int, nbase: int, order: int, T: int, W: int,
               mask: bool, itemsize: int) -> int:
    """Shared memory of one ``sweep_axis_kernel`` block (``tile_bytes`` of
    ``csrc/sweep.cu``): the staged stencil, ``nvar`` variables of ``T +
    2*order`` rows of ``W + 1`` (a padded row), the ``T + 1`` face fluxes of
    the base variables, and the mask's bytes."""
    rows, rs = T + 2 * order, W + 1
    return ((nvar * rows * rs + nbase * (T + 1) * rs) * itemsize
            + (rows * rs if mask else 0))


@functools.lru_cache(maxsize=None)
def sweep_plan(shape: Tuple[int, ...], axis: int, nvar: int, nbase: int,
               itemsize: int, order: int, mask: bool) -> Mapping[str, int]:
    """How ``sweep_axis_kernel`` (and, along axis 0, ``final_axis_kernel``)
    cuts the interior of ``shape`` for a sweep along ``axis``: tiles of
    ``T`` cells along the axis by ``W`` pencils across it (across x for the
    y and z sweeps, across y for the x sweep), one plane of the third axis
    each; one block a tile.  ``T`` starts at
    15 and ``W`` at 32, so that the tile's 16 x 32 faces are exactly four
    rounds of the block's 128 threads; while the tile's shared memory
    exceeds ``TILE_SMEM_BUDGET``, ``T + 1`` is halved (down to ``T = 3``),
    then ``W``.  The keys ``n_along``/``n_across``/``n_third`` and
    ``n_ta``/``n_tw`` mirror the kernel's ``Tiling``; blocks are numbered
    across fastest, then along, then third.  Cached: it runs on every
    launch."""
    ndim = len(shape)
    if ndim not in (2, 3) or not 0 <= axis < ndim or order not in (1, 2):
        raise ValueError(f"bad shape {tuple(shape)}, axis {axis} or "
                         f"order {order}")
    nz, ny, nx = ((1,) + tuple(shape))[-3:]
    k = ndim - 1 - axis
    along, across, third = ((nx, ny, nz), (ny, nx, nz), (nz, nx, ny))[k]
    T, W = 15, 32
    budget = TILE_SMEM_BUDGET[itemsize]
    while tile_bytes(nvar, nbase, order, T, W, mask, itemsize) > budget:
        if T > 3:
            T = (T + 1) // 2 - 1
        elif W > 8:
            W //= 2
        else:
            break
    smem = tile_bytes(nvar, nbase, order, T, W, mask, itemsize)
    if smem > SMEM_MAX:
        raise ValueError(f"a sweep tile of {nvar} variables needs {smem} "
                         f"bytes of shared memory")
    n_ta, n_tw = -(-along // T), -(-across // W)
    return MappingProxyType({
        "T": T, "W": W, "n_along": along, "n_across": across,
        "n_third": third, "n_ta": n_ta, "n_tw": n_tw,
        "blocks": n_ta * n_tw * third, "threads": SWEEP_THREADS,
        "smem": smem})


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
    lib = _build.get_lib(cfg.dtype, cfg.solver.value)
    nz, ny, nx = ((1,) + tuple(cfg.shape))[-3:]
    dx = float(geom.dx)
    consts = (dx, float(cfg.gamma), float(cfg.etav),
              BASE_RHO * cfg.rho_ref, 1.0e-6 * cfg.p_ref,
              cfg.glm_cr_factor / dx)
    # ``strong`` is returned so that it outlives the launch in the caller
    return lib, mask_ptr, strong, (nz, ny, nx), consts


def sweep_axis(Ph_pad: torch.Tensor, cfg: SimConfig, geom: Geometry,
               axis: int, order: int, dt, ch=None, scma=False,
               strong: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dt*dU`` of one axis for the interior cells, ``(nvar, *shape)``.

    ``Ph_pad`` is the fully padded primitive state.  ``strong`` is the
    per-cell HLLD->HLL flag of :func:`..ops.sweep.hlld_fallback_cells`
    (padded, bool); it is computed here when the config needs it and the
    caller has none.  ``dt`` and ``ch`` may be numbers or 0-d tensors.
    A CPU tensor takes :func:`sweep_axis_plain`; a CUDA tensor launches
    the kernel or raises.
    """
    if not Ph_pad.is_cuda:
        return sweep_axis_plain(Ph_pad, cfg, geom, axis, order, dt, ch=ch,
                                scma=scma)
    if not 0 <= axis < cfg.ndim or order not in (1, 2):
        raise ValueError(f"bad axis {axis} or order {order}")
    lib, mask_ptr, strong, (nz, ny, nx), consts = _launch_args(
        Ph_pad, cfg, geom, strong)
    dt_t = _scalar(dt, Ph_pad)
    if cfg.eqn is Eqn.GLM and ch is None:
        ch = cfg.cfl * geom.dx / dt_t
    ch_t = _scalar(ch, Ph_pad)
    clamp, bits = _el_mask(cfg, scma)
    plan = sweep_plan(tuple(cfg.shape), axis, cfg.nvar, cfg.eqn.nbase,
                      Ph_pad.element_size(), order, mask_ptr is not None)
    out = torch.empty((cfg.nvar,) + tuple(cfg.shape), dtype=Ph_pad.dtype,
                      device=Ph_pad.device)
    err = lib.pion_sweep_axis(
        Ph_pad.data_ptr(), mask_ptr, out.data_ptr(), dt_t.data_ptr(),
        ch_t.data_ptr(), cfg.ndim, nz, ny, nx, axis, cfg.nvar,
        1 if cfg.eqn is Eqn.GLM else 0, 1 if cfg.av is AV.FALLE else 0,
        order, clamp, bits, plan["T"], plan["W"], *consts,
        torch.cuda.current_stream(Ph_pad.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sweep_axis kernel launch failed: CUDA error {err}")
    sweep_axis.launches += 1
    return out


sweep_axis.launches = 0


def sweep_axis_plain(Ph_pad, cfg: SimConfig, geom: Geometry, axis: int,
                     order: int, dt, ch=None, scma=False) -> torch.Tensor:
    """The plain PyTorch version of :func:`sweep_axis`."""
    return dynamics_dU(Ph_pad, cfg, geom, dt, order, ch=ch, scma=scma,
                       axes=[axis])[0]


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
    plan = sweep_plan(tuple(cfg.shape), 0, cfg.nvar, cfg.eqn.nbase,
                      Ph_pad.element_size(), order, mask_ptr is not None)
    out = torch.empty(interior, dtype=Ph_pad.dtype, device=Ph_pad.device)
    err = lib.pion_final_axis(
        Ph_pad.data_ptr(), mask_ptr, P.data_ptr(), cptr[0], cptr[1],
        out.data_ptr(), dt_t.data_ptr(), ch_t.data_ptr(), cfg.ndim, nz, ny,
        nx, cfg.nvar, 1 if cfg.eqn is Eqn.GLM else 0,
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
                      dt, order: int, ch=None, scma=False) -> torch.Tensor:
    """``dt*dU`` of the whole sweep, every axis through :func:`sweep_axis`,
    summed in ascending axis order (no face fluxes).  The partial update
    takes this form when a microphysics term joins ``dU`` before the
    conserved update, so that :func:`final_axis` cannot apply it."""
    if not supports(cfg):
        raise ValueError("configuration outside fused_sweep.supports()")
    if cfg.eqn is Eqn.GLM and ch is None:
        ch = cfg.cfl * geom.dx / dt
    strong = None
    if Ph_pad.is_cuda and _uses_mask(cfg):
        strong = hlld_fallback_cells(Ph_pad, cfg, geom.dx)
    dU = None
    for axis in range(cfg.ndim):
        contrib = sweep_axis(Ph_pad, cfg, geom, axis, order, dt, ch=ch,
                             scma=scma, strong=strong)
        dU = contrib if dU is None else dU.add_(contrib)
    return dU


def advance_dynamics(P: torch.Tensor, Ph_pad: torch.Tensor, cfg: SimConfig,
                     geom: Geometry, dt, order: int, ch=None) -> torch.Tensor:
    """One fused pure-dynamics partial update: ``P + dt*dU[Ph] -> P-new``.

    The transverse axes run :func:`sweep_axis`; the axis-0 launch of
    :func:`final_axis` also applies the conserved update, the floors and the
    GLM psi damping.  The fallback mask is one plain pass shared by the
    launches.  Only valid when no microphysics or conduction term joins the
    update."""
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
