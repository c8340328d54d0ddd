"""Fused MPv3 kernels: wrappers and plain versions.

Two CUDA kernels (sources in ``csrc/mpv3.cu``) take the place of the two TPU
kernels of ``pion_tpu/microphysics/pallas_mpv3.py``:

- :func:`ydot` replaces ``ydot_pallas``: the ODE right-hand side of every cell.
- :func:`update` replaces ``update_pallas``: every cell advanced by ``dt`` —
  forward Euler where the relative change stays below ``EULER_CUTOFF``, a
  backward-Euler Newton ladder elsewhere.

The ladder's unit of adaptivity is a TILE of 1024 consecutive cells of the
flattened grid: a tile takes its substep count from its own largest relative
change among its cells past the cutoff, skips the ladder when it has none, and
stops each Newton iteration on its own largest correction.  Cells that pad the
last tile take part with benign values.  (The ladder of
:meth:`..mpv3.MPv3._update_impl` shares one count and one stopping test over
the whole grid instead; the two are different integrators and agree only
loosely.)

Beside each kernel stands its plain PyTorch version (:func:`ydot_plain`,
:func:`update_plain`).  A wrapper takes the plain version only because the
tensor it was given lies on the CPU; for a CUDA tensor it launches the kernel
or raises.  Each wrapper counts its launches in its ``launches`` attribute.
What bounds the kernels on an H100 is written at the head of ``csrc/mpv3.cu``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import jvp

from ..constants import K_B
from . import tables as TB

TILE = 1024      # cells a tile holds: the unit of adaptivity
_ION_MODE = {None: 0, "mono": 1, "mfion": 2}


def flops_per_ydot(mp, k: int) -> int:
    """Floating-point operations of one ``ydot`` evaluation of one cell,
    counted by hand from the formulas (an add, multiply, divide, compare and
    a transcendental each count one): the operations side of the kernels'
    roofline bound.  ``k``: ionizing sources.  A Newton iteration evaluates
    the value and two tangents, about three times as much."""
    n = 17 + 10 * 6 + 38 + 62       # state, 10 curves, Wolfire forms, terms
    if mp.mpc.ion_src == "mono":
        n += k * 16
    elif mp.mpc.ion_src == "mfion":
        n += k * 58                 # two table coordinates, four curves
    if mp.mpc.n_diff_srcs:
        n += 14
    return n


def _entries(rt: Optional[Dict]) -> Tuple[Dict, ...]:
    """The per-source column sets of an rt dict; a dict without ``"ion"`` is
    one source."""
    entries = rt.get("ion") if rt is not None else None
    if not entries:
        entries = (rt,) if rt is not None else ({},)
    return tuple(entries)


def supports(mp, rt: Optional[Dict], dtype) -> bool:
    """Whether the kernels cover this module: a known rate model, float32 or
    float64.  Any number of ionizing sources in ``rt`` is taken (their planes
    reach the kernel through a table of pointers)."""
    return (mp.mpc.ion_src in _ION_MODE
            and dtype in (torch.float32, torch.float64))


def _planes(mp, rt: Optional[Dict], like: torch.Tensor):
    """The rt dict as flat planes of ``like``'s shape, dtype and device:
    per source ``(tau0, ds, nvsv, the entry's own tau table or None)``, then
    ``g0_uv`` and
    ``g0_ir`` (None without UV-heating sources).  Scalars are broadcast.
    ``nvsv`` is ``nv`` for a monochromatic source and ``sv`` for a
    multifrequency one, computed from ``n_idot``/``vshell`` when the entry
    lacks it."""
    c = mp.mpc
    shape = like.shape

    def plane(v):
        t = torch.as_tensor(v, dtype=like.dtype, device=like.device)
        return t.expand(shape).contiguous().reshape(-1)

    z = torch.zeros((), dtype=like.dtype, device=like.device)
    srcs: List[tuple] = []
    if c.ion_src is not None:
        for e in _entries(rt):
            tau0 = plane(e.get("tau0", z + 1.0e6))
            ds = plane(e.get("ds", z))
            tab = None
            if c.ion_src == "mono":
                nv = e.get("nv", None)
                if nv is None:
                    nv = e["n_idot"] / e["vshell"]
            else:
                nv = e.get("sv", None)
                if nv is None:
                    nv = float(np.exp(TB.LOGTEN * mp.rate_scale_log)) \
                        / e["vshell"]
                tab = e.get("tau_stack")
                if tab is not None:
                    tab = torch.as_tensor(tab, dtype=like.dtype,
                                          device=like.device)
            srcs.append((tau0, ds, plane(nv), tab))
    g0uv = g0ir = None
    if c.n_diff_srcs:
        g0uv = plane(rt.get("g0_uv", z) if rt else z)
        g0ir = plane(rt.get("g0_ir", z) if rt else z)
    return srcs, g0uv, g0ir


def _plane_rt(mp, srcs, g0uv, g0ir) -> Dict:
    """Planes back as the rt dict ``MPv3.ydot`` reads."""
    key = "nv" if mp.mpc.ion_src == "mono" else "sv"
    rt: Dict = {"ion": tuple(
        {"tau0": t0, "ds": ds, key: nv, **({} if tab is None
                                            else {"tau_stack": tab})}
        for t0, ds, nv, tab in srcs)}
    if g0uv is not None:
        rt.update(g0_uv=g0uv, g0_ir=g0ir)
    return rt


def _check(name: str, a: torch.Tensor, like: torch.Tensor):
    if (a.shape != like.shape or a.dtype != like.dtype
            or a.device != like.device):
        raise ValueError(
            f"{name} is {tuple(a.shape)} {a.dtype} on {a.device}, expected "
            f"{tuple(like.shape)} {like.dtype} on {like.device}")


def _launch_args(mp, omx, Eint, nH, rt):
    """What both launches share: checks, the library, flat inputs, the table
    of source pointers on the device and the host array of constants.  The
    returned ``keep`` list holds every tensor a pointer was taken of until
    the launch is queued."""
    from .. import _build
    from .mpv3 import E_MONO

    c = mp.mpc
    if not supports(mp, rt, omx.dtype):
        raise ValueError("module or rt dict outside fused_mpv3.supports()")
    _check("Eint", Eint, omx)
    _check("nH", nH, omx)
    dtype_name = "float32" if omx.dtype == torch.float32 else "float64"
    lib = _build.get_mpv3_lib(dtype_name)
    flat = [a.contiguous().reshape(-1) for a in (omx, Eint, nH)]
    srcs, g0uv, g0ir = _planes(mp, rt, omx)
    # (11, NT): the T grid, then the ten curves, each contiguous
    t1 = mp.table("t1_rows", omx)
    ptrs = []
    for t0, ds, nv, tab in srcs:
        if tab is not None:
            if tuple(tab.shape) != (mp._n_tau, 4):
                raise ValueError(f"tau table has shape {tuple(tab.shape)}, "
                                 f"expected {(mp._n_tau, 4)}")
            tab = tab.t().contiguous()      # (4, NTAU)
        elif c.ion_src == "mfion":
            tab = mp.table("tau_rows", omx)
        ptrs += [t0.data_ptr(), ds.data_ptr(), nv.data_ptr(),
                 0 if tab is None else tab.data_ptr()]
        flat.append(tab)         # a transposed copy outlives the launch
    # 4 pointers a source, read by the kernel from device memory; copied
    # from pinned memory in stream order, so that the host does not wait for
    # the card
    ptr_arr = None
    if ptrs:
        ptr_arr = torch.tensor(ptrs, dtype=torch.int64).pin_memory().to(
            omx.device, non_blocking=True)
    mfion = c.ion_src == "mfion"
    consts = (ctypes.c_double * 14)(
        c.gamma - 1.0, K_B, c.n_ion, c.n_elec, c.metallicity,
        c.min_temperature, c.max_temperature, mp._lt0, mp._inv_dlt,
        mp._ltau0 if mfion else 0.0, mp._inv_dltau if mfion else 0.0,
        mp.tau_bounds[0], mp.tau_bounds[1],
        float(TB.hi_xsection_fractional(E_MONO)))
    keep = [flat, srcs, g0uv, g0ir, t1, ptr_arr, consts]
    head = (flat[0].data_ptr(), flat[1].data_ptr(), flat[2].data_ptr(),
            None if ptr_arr is None else ptr_arr.data_ptr(), len(srcs),
            None if g0uv is None else g0uv.data_ptr(),
            None if g0ir is None else g0ir.data_ptr(), t1.data_ptr())
    tail = (omx.numel(), _ION_MODE[c.ion_src], 1 if c.n_diff_srcs else 0,
            consts, c.n_table, mp._n_tau if mfion else 0)
    return lib, head, tail, keep


def ydot(mp, omx: torch.Tensor, Eint: torch.Tensor, nH: torch.Tensor,
         rt: Optional[Dict]):
    """``(d(1-x)/dt, dE/dt)`` of every cell, the same function as
    ``MPv3.ydot``.  A CPU tensor takes :func:`ydot_plain`; a CUDA tensor
    launches the kernel or raises."""
    if not omx.is_cuda:
        return ydot_plain(mp, omx, Eint, nH, rt)
    lib, head, tail, keep = _launch_args(mp, omx, Eint, nH, rt)
    d_o = torch.empty_like(omx, memory_format=torch.contiguous_format)
    d_e = torch.empty_like(omx, memory_format=torch.contiguous_format)
    err = lib.pion_mpv3_ydot(
        *head, d_o.data_ptr(), d_e.data_ptr(), *tail,
        torch.cuda.current_stream(omx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mpv3 ydot kernel launch failed: CUDA error {err}")
    ydot.launches += 1
    del keep
    return d_o, d_e


ydot.launches = 0


def ydot_plain(mp, omx, Eint, nH, rt: Optional[Dict]):
    """The plain PyTorch version of :func:`ydot`: ``MPv3.ydot`` on the planes
    the kernel is given."""
    from .mpv3 import MPv3

    srcs, g0uv, g0ir = _planes(mp, rt, omx)
    shape = omx.shape
    d_o, d_e = MPv3.ydot(mp, omx.reshape(-1), Eint.reshape(-1),
                         nH.reshape(-1), _plane_rt(mp, srcs, g0uv, g0ir))
    return d_o.reshape(shape), d_e.reshape(shape)


def _tol(dtype) -> float:
    """Newton stopping tolerance: 1e-11 is below float32 resolution and
    would force every Newton loop to its cap."""
    return 1.0e-11 if dtype == torch.float64 else 1.0e-6


def update(mp, omx0: torch.Tensor, Eint0: torch.Tensor, nH: torch.Tensor, dt,
           rt: Optional[Dict], n_sub: int = 32, n_newton: int = 8, f0=None,
           stats: Optional[torch.Tensor] = None):
    """Advance ``(1-x, E)`` of every cell by ``dt``; returns ``(omx1, E1)``.

    ``dt`` is a number or a 0-d tensor on the state's device (it is not read
    back).  ``f0``: the caller's ``ydot`` of this very state, which then
    seeds the first evaluation.  ``stats``: two int32 on the state's device
    to which the kernel adds the number of tiles that ran the ladder and the
    Newton iterations they took in all (diagnostics).  A CPU tensor takes
    :func:`update_plain`; a CUDA tensor launches the kernel or raises."""
    if not omx0.is_cuda:
        return update_plain(mp, omx0, Eint0, nH, dt, rt, n_sub=n_sub,
                            n_newton=n_newton, f0=f0)
    lib, head, tail, keep = _launch_args(mp, omx0, Eint0, nH, rt)
    dt_t = torch.as_tensor(dt, dtype=omx0.dtype,
                           device=omx0.device).reshape(())
    f0p = (None, None)
    if f0 is not None:
        f0 = [f.to(omx0.dtype).contiguous() for f in f0]
        for f in f0:
            _check("f0", f, omx0)
        f0p = (f0[0].data_ptr(), f0[1].data_ptr())
    if stats is not None and (
            stats.dtype != torch.int32 or tuple(stats.shape) != (2,)
            or stats.device != omx0.device or not stats.is_contiguous()):
        raise ValueError("stats must be two int32 on the state's device")
    o1 = torch.empty_like(omx0, memory_format=torch.contiguous_format)
    e1 = torch.empty_like(omx0, memory_format=torch.contiguous_format)
    err = lib.pion_mpv3_update(
        *head, dt_t.data_ptr(), f0p[0], f0p[1], o1.data_ptr(), e1.data_ptr(),
        None if stats is None else stats.data_ptr(), *tail,
        n_sub, n_newton, _tol(omx0.dtype),
        torch.cuda.current_stream(omx0.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"mpv3 update kernel launch failed: CUDA error {err}")
    update.launches += 1
    if f0 is not None:
        update.launches_seeded += 1
    del keep
    return o1, e1


update.launches = 0
# of those, the launches that were given the caller's first evaluation
update.launches_seeded = 0


def _pad(a: torch.Tensor, n_pad: int, fill: float) -> torch.Tensor:
    """Flat, padded to ``n_pad`` with ``fill``, as ``(ntile, TILE)``."""
    f = a.reshape(-1)
    if n_pad > f.numel():
        f = torch.cat([f, f.new_full((n_pad - f.numel(),), fill)])
    return f.reshape(-1, TILE)


def update_plain(mp, omx0, Eint0, nH, dt, rt: Optional[Dict],
                 n_sub: int = 32, n_newton: int = 8, f0=None,
                 return_stats: bool = False):
    """The plain PyTorch version of :func:`update`, tile by tile as the
    kernel: the grid is flattened, padded to whole tiles of 1024 cells
    (1-x 0.5, E 1, nH 1, tau0 1e6, ds 0) and laid out ``(ntile, 1024)``;
    every reduction runs along a tile.  Tiles whose Newton iteration has
    stopped are masked, not dropped.  Reads the stopping tests back to the
    host every iteration.  ``return_stats``: also return ``(tiles that ran
    the ladder, Newton iterations they took in all)``."""
    from .mpv3 import EULER_CUTOFF, MIN_NEUTRAL, MPv3

    shape = omx0.shape
    dtype = omx0.dtype
    n = omx0.numel()
    n_pad = -(-n // TILE) * TILE
    tol = _tol(dtype)
    dt = torch.as_tensor(dt, dtype=dtype, device=omx0.device)
    srcs, g0uv, g0ir = _planes(mp, rt, omx0)
    omx = _pad(omx0, n_pad, 0.5)
    E = _pad(Eint0, n_pad, 1.0)
    nHp = _pad(nH, n_pad, 1.0)
    srcs = [(_pad(t0, n_pad, 1.0e6), _pad(ds, n_pad, 0.0),
             _pad(nv, n_pad, 0.0), tab) for t0, ds, nv, tab in srcs]
    if g0uv is not None:
        g0uv, g0ir = _pad(g0uv, n_pad, 0.0), _pad(g0ir, n_pad, 0.0)

    def rhs_on(tiles):
        """ydot restricted to a set of tiles (an index tensor, or None)."""
        def pick(a):
            return a if tiles is None or a is None else a[tiles]

        rt_t = _plane_rt(mp, [(pick(t0), pick(ds), pick(nv), tab)
                              for t0, ds, nv, tab in srcs],
                         pick(g0uv), pick(g0ir))
        nH_t = pick(nHp)
        return lambda o, e: MPv3.ydot(mp, o, e, nH_t, rt_t)

    if f0 is not None:
        f0v = _pad(f0[0].to(dtype), n_pad, 0.0)
        f1v = _pad(f0[1].to(dtype), n_pad, 0.0)
    else:
        f0v, f1v = rhs_on(None)(omx, E)
    maxdelta = torch.maximum(torch.abs(f0v * dt / omx),
                             torch.abs(f1v * dt / E))
    omx_eul = omx + dt * f0v
    E_eul = E + dt * f1v
    use_euler = maxdelta < EULER_CUTOFF
    stiffness = torch.where(use_euler, torch.zeros_like(maxdelta),
                            maxdelta).amax(dim=1)
    tiles = torch.nonzero(stiffness > 0.0).reshape(-1)
    omx_st, E_st = omx, E
    newton_its = 0
    if tiles.numel():
        rhs = rhs_on(tiles)
        # clipped as a real, so that an infinite stiffness takes the most
        # substeps
        n_eff = torch.clamp(torch.ceil(4.0 * stiffness[tiles]), 2, n_sub)
        h = (dt / n_eff)[:, None]
        o, e = omx[tiles], E[tiles]

        def newton_step(o, e, op, ep):
            one, zero = torch.ones_like(o), torch.zeros_like(o)
            (g0f, g1f), (j00, j10) = jvp(rhs, (o, e), (one, zero))
            _, (j01, j11) = jvp(rhs, (o, e), (zero, one))
            g0 = o - op - h * g0f
            g1 = e - ep - h * g1f
            a = 1.0 - h * j00
            b = -h * j01
            cc = -h * j10
            d = 1.0 - h * j11
            det = a * d - b * cc
            det = torch.where(torch.abs(det) > 1e-300, det,
                              torch.ones_like(det))
            d_o = (d * g0 - b * g1) / det
            d_e = (a * g1 - cc * g0) / det
            d_o = torch.clamp(d_o, -0.3, 0.3)
            d_e = torch.minimum(torch.maximum(d_e, -0.6 * e), 0.6 * e)
            o_n = torch.clamp(o - d_o, MIN_NEUTRAL, 1.0 - MIN_NEUTRAL)
            e_n = torch.maximum(e - d_e, 1.0e-10 * ep)
            return o_n, e_n

        for k in range(int(n_eff.max())):
            run = k < n_eff                       # tiles still stepping
            op, ep = o, e
            it = 0
            while it < n_newton and bool(run.any()):
                o_n, e_n = newton_step(o, e, op, ep)
                err = torch.maximum(
                    torch.abs(o_n - o).amax(dim=1),
                    torch.abs((e_n - e)
                              / torch.clamp(e, min=1e-300)).amax(dim=1))
                o = torch.where(run[:, None], o_n, o)
                e = torch.where(run[:, None], e_n, e)
                newton_its += int(run.sum())
                run = run & (err > tol)
                it += 1
        omx_st, E_st = omx.clone(), E.clone()
        omx_st[tiles] = o
        E_st[tiles] = e
    omx1 = torch.where(use_euler, omx_eul, omx_st).reshape(-1)[:n]
    E1 = torch.where(use_euler, E_eul, E_st).reshape(-1)[:n]
    out = (omx1.reshape(shape), E1.reshape(shape))
    if return_stats:
        return out + ((int(tiles.numel()), newton_its),)
    return out
