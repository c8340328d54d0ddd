"""Thermal conduction (Slavin & Cox 1992) in the port against the JAX package
on the same seeded inputs: ``conduction_Edot`` and ``conduction_dt`` on 3D
Cartesian and 2D cylindrical grids (the state in which no cell passes the
pressure test too, in float64 and float32), two steps of a hot bubble
without physics and with the cooling-only module, through the plain sweep
and through the kernels' branch (their plain versions on the CPU), and the
hierarchy, which ignores the flag in both packages.  CPU, float64 unless a
test says otherwise."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.boundaries import BoundaryData as RefBoundaryData
from pion_tpu.boundaries import apply_bcs as ref_apply_bcs
from pion_tpu.microphysics import cooling as ref_cooling
from pion_tpu.ops import conduction as ref_conduction
from pion_tpu.physics import Physics as RefPhysics
from pion_tpu.stepper import make_step_fns as ref_make_step_fns

import pion_tpu_torch
from pion_tpu_torch import Simulation, convert
from pion_tpu_torch.boundaries import apply_bcs
from pion_tpu_torch.constants import K_B, M_P, PG, RO
from pion_tpu_torch.ops import conduction
from pion_tpu_torch.stepper import make_step_fns

from test_torch_eqns import to_port
from test_torch_ng import hier_pair

torch.set_num_threads(1)

L = 3.0e17


def bubble_config(ndim=2, coords="cartesian", dtype="float64", **kw):
    """A box of 3e17 cm (0.1 pc) a side; with ``coords="cylindrical"`` R
    from the axis and z centred on 0."""
    n = (12, 16, 16)[:ndim] if ndim == 3 else (16, 16)
    if coords == "cylindrical":
        xmin, xmax = (0.0, -0.5 * L), (L, 0.5 * L)
        bcs = (("axisymmetric", "outflow"), ("outflow", "outflow"))
    else:
        xmin, xmax = (0.0,) * ndim, tuple(L * m / n[-1] for m in n)
        bcs = (("outflow", "outflow"),) * ndim
    base = dict(ndim=ndim, eqn="euler", solver="hll", av="falle", etav=0.1,
                shape=n, coords=coords, xmin=xmin, xmax=xmax, bcs=bcs,
                cfl=0.3, ooa=2, conduction=True, p_ref=1.0e-12, tmax=1.0e20,
                dtype=dtype, gamma=5.0 / 3.0)
    base.update(kw)
    return pion_tpu.SimConfig(**base)


def hot_bubble(rcfg, seed, T_in=1.0e7, T_out=1.0e4, nH=1.0):
    """A hot bubble (1e7 K) in 1e4 K gas at n_H ~ 1 cm^-3, in pressure
    balance neither inside nor out, with seeded noise on the density and
    the velocities so that every face has its own gradient."""
    rng = np.random.default_rng(seed)
    r2 = 0.0
    for ax in range(rcfg.ndim):
        x = rcfg.cell_centers(ax)
        c = 0.0 if (rcfg.coords.value == "cylindrical" and ax == 0) \
            else 0.5 * (rcfg.xmin[ax] + rcfg.xmax[ax])
        shape = [1] * rcfg.ndim
        shape[ax] = -1
        r2 = r2 + ((x - c) / L).reshape(shape) ** 2
    T = T_out + (T_in - T_out) * np.exp(-r2 / 0.15 ** 2)
    P = np.zeros((rcfg.nvar,) + rcfg.shape)
    P[RO] = nH * M_P * (1.0 + 0.1 * rng.random(rcfg.shape))
    P[PG] = P[RO] / M_P * K_B * T
    P[2:2 + rcfg.ndim] = 1.0e5 * rng.standard_normal((rcfg.ndim,)
                                                      + rcfg.shape)
    return P.astype(rcfg.np_dtype)


def temperatures(P, Ppad_ref):
    return (P[PG] / P[RO] * (M_P / K_B),
            Ppad_ref[PG] / Ppad_ref[RO] * (M_P / K_B))


@pytest.mark.parametrize("ndim,coords", [(3, "cartesian"),
                                         (2, "cylindrical")])
def test_edot_and_dt_match_reference(ndim, coords):
    rcfg = bubble_config(ndim, coords)
    P = hot_bubble(rcfg, 1)
    cfg, Pt, bd = to_port(rcfg, P)
    geom = pion_tpu_torch.make_geometry(cfg)
    rgeom = pion_tpu.make_geometry(rcfg)
    Ppad = apply_bcs(Pt, cfg, bd)
    rPpad = ref_apply_bcs(jnp.asarray(P), rcfg, RefBoundaryData())
    Tpad, rTpad = temperatures(Ppad, rPpad)
    np.testing.assert_array_equal(Tpad.numpy(), np.asarray(rTpad))
    Edot = conduction.conduction_Edot(Ppad, Tpad, cfg, geom)
    rEdot = ref_conduction.conduction_Edot(rPpad, rTpad, rcfg, rgeom)
    assert tuple(Edot.shape) == cfg.shape
    scale = np.abs(np.asarray(rEdot)).max()
    assert scale > 0.0
    np.testing.assert_allclose(Edot.numpy(), np.asarray(rEdot), rtol=1e-10,
                               atol=1e-12 * scale)
    dt = conduction.conduction_dt(Pt, Edot, cfg)
    rdt = ref_conduction.conduction_dt(jnp.asarray(P), rEdot, rcfg)
    assert dt.ndim == 0 and 0.0 < float(dt) < 1.0e199
    np.testing.assert_allclose(float(dt), float(rdt), rtol=1e-10)
    # a uniform temperature: no face has a gradient (the 0/0 guard)
    zero = conduction.conduction_Edot(Ppad, torch.full_like(Tpad, 1.0e6),
                                      cfg, geom)
    assert bool((zero == 0.0).all())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dt_with_no_cell_above_the_pressure_floor(dtype):
    """With the default ``p_ref`` = 1 no cell of a cgs state passes the
    pressure test: the limit is 0.1 * 1e200 in float64 and ``inf`` in
    float32, as the JAX package gives it (its literal leaves float32); no
    exception, no dt of 0 or NaN, and the dynamical dt stands."""
    rcfg = bubble_config(2, dtype=dtype, p_ref=1.0)
    P = hot_bubble(rcfg, 2)
    cfg, Pt, bd = to_port(rcfg, P)
    geom = pion_tpu_torch.make_geometry(cfg)
    Ppad = apply_bcs(Pt, cfg, bd)
    Edot = conduction.conduction_Edot(Ppad, temperatures(Ppad, Ppad)[0], cfg,
                                      geom)
    dt = conduction.conduction_dt(Pt, Edot, cfg)
    rPpad = ref_apply_bcs(jnp.asarray(P), rcfg, RefBoundaryData())
    rEdot = ref_conduction.conduction_Edot(
        rPpad, temperatures(rPpad, rPpad)[0], rcfg, pion_tpu.make_geometry(
            rcfg))
    rdt = float(ref_conduction.conduction_dt(jnp.asarray(P), rEdot, rcfg))
    if dtype == "float64":
        assert float(dt) == rdt == pytest.approx(1.0e199, rel=1e-15)
    else:
        assert np.isinf(float(dt)) and np.isinf(rdt)
    assert dt.dtype == cfg.torch_dtype
    fns = make_step_fns(cfg, geom, bd, device="cpu")
    rfns = ref_make_step_fns(rcfg, pion_tpu.make_geometry(rcfg))
    got, want = float(fns.calc_dt(Pt)), float(rfns.calc_dt(jnp.asarray(P)))
    assert np.isfinite(got) and got > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6 if dtype == "float32"
                               else 1e-12)
    nocond = dataclasses.replace(cfg, conduction=False)
    assert got == float(make_step_fns(nocond, geom, bd,
                                      device="cpu").calc_dt(Pt))


def cooling_pair():
    ref = ref_cooling.MPOnlyCooling(ref_cooling.CoolingConfig(
        curve="SD93_CIE", min_temperature=100.0))
    phys = convert.physics_from_reference(dataclasses.asdict(ref.mpc),
                                          dt_limit=1)
    return RefPhysics(mp=ref, dt_limit=1), phys


@pytest.mark.parametrize("kernels", ["off", "auto"])
@pytest.mark.parametrize("with_physics", [False, True])
def test_two_steps_match_reference(with_physics, kernels):
    """Two steps of the hot bubble with conduction, the dt limit included.
    ``kernels="auto"`` takes the kernels' branch of the update (their plain
    versions on the CPU): without physics it must compose the update
    (dU, then dt*Edot, then the conserved update), not take the fused
    pure-dynamics update, which has no place for the conduction term."""
    rcfg = bubble_config(2, pallas="off")
    P = hot_bubble(rcfg, 3)
    rphys, phys = cooling_pair() if with_physics else (None, None)
    ref = pion_tpu.Simulation(rcfg, jnp.asarray(P), physics=rphys)
    ref.run(max_steps=2)
    cfg, Pt, _ = to_port(rcfg, P)
    cfg = dataclasses.replace(cfg, kernels=kernels)
    sim = Simulation(cfg, Pt, physics=phys, device="cpu").run(max_steps=2)
    assert sim.step_count == ref.step_count == 2
    np.testing.assert_allclose(sim.t, ref.t, rtol=1e-12)
    want = np.asarray(ref.P)
    scale = np.abs(want).reshape(cfg.nvar, -1).max(axis=1)[:, None, None]
    err = np.abs(sim.P.numpy() - want) / np.maximum(scale, 1e-300)
    assert err.max() <= 1e-9, err.max()
    # the conduction term is in the run: without it the state differs
    off = Simulation(dataclasses.replace(cfg, conduction=False), Pt,
                     physics=cooling_pair()[1] if with_physics else None,
                     device="cpu").run(max_steps=2)
    T = sim.P[PG] / sim.P[RO]
    T_off = off.P[PG] / off.P[RO]
    assert float(T.max()) < float(T_off.max())


def test_hierarchy_ignores_the_flag():
    """Neither package's hierarchy reads ``cfg.conduction``: two steps of a
    2-level blast give the same state with the flag on and off, bit for
    bit in each package, and the two packages agree."""
    runs = {}
    for flag in (False, True):
        ref, hier, _ = hier_pair("2d-centred", seed=8, conduction=flag)
        for _ in range(2):
            ref.step()
            hier.step()
        runs[flag] = ([np.asarray(p) for p in ref.P], list(hier.P))
    for l in range(2):
        np.testing.assert_array_equal(runs[True][0][l], runs[False][0][l])
        assert torch.equal(runs[True][1][l], runs[False][1][l])
        want = runs[True][0][l]
        scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1)
        err = np.abs(runs[True][1][l].numpy() - want).reshape(
            want.shape[0], -1).max(axis=1) / scale
        assert err.max() <= 1e-9, err.max()
