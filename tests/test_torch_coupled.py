"""The coupled flagship as a whole: a 2-level nested grid with GLM-MHD (HLLD),
MPv3 multifrequency photoionisation from a central point source and a
magnetised stellar wind, through ``NGHierarchy.step``, against the JAX
package from the same converted set-up; and the single-grid run with a wind
through ``Simulation``.  Small grids on the CPU."""
import dataclasses
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.constants import MSUN, RSUN, YEAR
from pion_tpu.microphysics import MPv3 as RefMPv3
from pion_tpu.microphysics import MPv3Config as RefMPv3Config
from pion_tpu.ng import NGHierarchy as RefHierarchy
from pion_tpu.physics import Physics as RefPhysics
from pion_tpu.raytracing import Source as RefSource
from pion_tpu.winds import WindSource as RefWindSource

from pion_tpu_torch import Simulation, convert
from pion_tpu_torch.constants import BX, K_B, PG, RO
from pion_tpu_torch.microphysics import fused_mpv3

torch.set_num_threads(1)

N = 12
L = 6.0e18


def reference_setup(dtype="float64", pallas="off", nlevels=2):
    """The coupled benchmark configuration at N^3 a level: config,
    chemistry, radiation source, wind source, and one state per level."""
    rcfg = pion_tpu.SimConfig(
        ndim=3, eqn="glm", solver="hlld", ntracer=1, shape=(N,) * 3,
        xmin=(0.0,) * 3, xmax=(L,) * 3, bcs=(("outflow", "outflow"),) * 3,
        nlevels=nlevels, cfl=0.3, ooa=2, av="falle", etav=0.1, dtype=dtype,
        min_temperature=50.0, max_temperature=1.0e9, tmax=1.0e16,
        pallas=pallas)
    mpc = RefMPv3Config(tracer_slot=rcfg.eqn.nbase, ion_src="mfion",
                        n_idot=1.0e48, tstar=3.75e4, rstar_cm=10.0 * RSUN,
                        min_temperature=50.0)
    ctr = (0.5 * L,) * 3
    fine_dx = rcfg.dx / 2 ** (nlevels - 1)
    src = RefSource(position=ctr, strength=1.0e48, effect="mfion")
    wind = RefWindSource(position=ctr, radius=6.0 * fine_dx,
                         mdot=1.0e-6 * MSUN / YEAR, vinf=2.0e8, t_wind=3.0e4,
                         b_star=10.0, tracers=(1.0,))
    nH = 100.0
    P0 = np.zeros((rcfg.nvar,) + rcfg.shape)
    P0[RO] = nH * mpc.mean_mass_per_h
    P0[PG] = 1.1 * nH * K_B * 300.0
    P0[rcfg.eqn.nbase] = 1.0e-6
    P0[BX] = 4.0e-6 / np.sqrt(4.0 * np.pi)
    return rcfg, mpc, src, wind, [P0.copy() for _ in range(nlevels)]


def port_physics(mpc, src, wind):
    return convert.physics_from_reference(
        dataclasses.asdict(mpc), [dataclasses.asdict(src)], dt_limit=True,
        wind_sources=[dataclasses.asdict(wind)])


def port_hierarchy(rcfg, mpc, src, wind, states, kernels=None):
    fields = dataclasses.asdict(rcfg)
    if kernels is not None:
        fields["pallas"] = kernels
    return convert.hierarchy_from_reference(
        fields, states, physics=port_physics(mpc, src, wind), device="cpu")


def field_scales(P, dx_over_dt):
    """One scale per variable: its own largest value, for the vector
    components the largest of the whole vector, and for psi the field times
    the cleaning speed."""
    s = np.abs(P).reshape(P.shape[0], -1).max(axis=1)
    s[2:5] = s[2:5].max()
    s[5:8] = s[5:8].max()
    s[8] = max(s[8], s[5] * dx_over_dt)
    return s


@pytest.fixture(scope="module")
def off_run():
    rcfg, mpc, src, wind, states = reference_setup()
    hier = port_hierarchy(rcfg, mpc, src, wind, states)
    first = [p.numpy().copy() for p in hier.P]
    dts = [hier.step(), hier.step()]
    return hier, dts, first


def test_coupled_hierarchy_matches_reference(off_run):
    """Two hierarchy steps (two, so that a state written in place would
    show): every dt to 1e-9, the fields of both levels to 1e-7 of each
    variable's range — the tolerances of the single-grid H II run, for the
    same reason (the Newton ladder stops on a 1e-11 tolerance)."""
    rcfg, mpc, src, wind, states = reference_setup()
    ref = RefHierarchy(rcfg, 2, physics=RefPhysics(
        mp=RefMPv3(mpc), sources=[src], wind_sources=[wind], dt_limit=True))
    ref.set_states([jnp.asarray(s) for s in states])
    hier, dts, first = off_run
    # the wind is carved into the initial state on both levels
    for l in range(2):
        np.testing.assert_allclose(first[l], np.asarray(ref.P[l]), rtol=1e-12)
        assert (first[l][RO] != states[l][RO]).any()
    rdts = [ref.step(), ref.step()]
    assert hier.cfg0.kernels == "off"
    np.testing.assert_allclose(dts, rdts, rtol=1e-9)
    np.testing.assert_allclose(hier.t, ref.t, rtol=1e-9)
    for l in range(2):
        got, want = hier.P[l].numpy(), np.asarray(ref.P[l])
        sc = field_scales(want, hier.geoms[l].dx / (dts[-1] / 2 ** l))
        for v in range(rcfg.nvar):
            assert np.abs(got[v] - want[v]).max() <= 1e-7 * sc[v], (l, v)
    # the first step is held by the wind's first-step cap, the second by
    # the chemistry; both far below the CFL step of the ambient medium
    fine = hier.n_levels - 1
    cap = hier.phys[fine].wind_dt_cap(hier.cfgs[fine], hier.geoms[fine]) * 2
    assert dts[0] <= cap * (1 + 1e-12)
    assert dts[1] <= hier.cfgs[0].max_dt_growth * dts[0] * (1 + 1e-12)


def test_coupled_hierarchy_invariants(off_run):
    hier, dts, _ = off_run
    xs = hier.cfg0.eqn.nbase
    for l in range(2):
        P = hier.P[l]
        assert bool(torch.isfinite(P).all())
        x = P[xs]
        assert 0.0 <= float(x.min()) and float(x.max()) <= 1.0
        T = hier.phys[l].mp.temperature(P, hier.cfgs[l])
        # the inert cells deep inside the wind region carry rho = p = 1e-31
        m = ~hier.phys[l].wind_exclude_mask(P)
        assert 50.0 * (1 - 1e-9) <= float(T[m].min())
        assert float(T[m].max()) <= 1.0e9
    # the wind region of the finest level holds the free-wind state after a
    # step (level 0's lies under level 1 and holds its restriction)
    w = hier.phys[1].winds[0]
    W = w.wind_state(hier.P[1], hier.t)
    assert torch.equal(hier.P[1][:, w.mask], W[:, w.mask])
    # free wind: rho r^2 is constant in the shell that is not inert
    w = hier.phys[1].winds[0]
    geo = w._geo_np
    shell = geo["mask"] & ~geo["inner"]
    assert shell.sum() > 20
    rr = hier.P[1][RO].numpy()[shell] * geo["dist"][shell] ** 2
    np.testing.assert_allclose(rr, rr[0], rtol=1e-12)
    # the covered level-0 cells are the restriction of level 1
    assert torch.equal(hier._restrict(hier.P[0], hier.P[1], 1), hier.P[0])


def test_coupled_hierarchy_float32_kernels_auto():
    """float32 with ``kernels="auto"`` on the CPU: every sweep, trace, ydot
    and update through the wrappers' plain versions — the first predictor of
    each level with the dt limit's ydot as its first evaluation — with every
    warning an error.  Finite, and the same run as the ``kernels="off"``
    one to float32 rounding."""
    rcfg, mpc, src, wind, states = reference_setup(dtype="float32",
                                                   pallas="auto")
    seeded = []
    plain = fused_mpv3.update_plain

    def spy(mp, omx, E, nH, dt, rt, f0=None, **kw):
        seeded.append(f0 is not None)
        return plain(mp, omx, E, nH, dt, rt, f0=f0, **kw)

    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(fused_mpv3, "update_plain", spy)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            # PyTorch's own, at the first forward-mode derivative of a process
            warnings.filterwarnings("ignore", message=".*torch.jit.script.*",
                                    category=DeprecationWarning)
            with np.errstate(over="raise", invalid="raise"):
                hier = port_hierarchy(rcfg, mpc, src, wind, states)
                dts = [hier.step(), hier.step()]
    assert hier.cfg0.kernels == "auto" and hier.P[0].dtype == torch.float32
    # six updates a hierarchy step, in the order of the recursion: level 0's
    # predictor, level 1's first substep, level 0's corrector, level 1's
    # second substep; the first predictor of each level takes the dt
    # limit's ydot
    assert seeded == [True, True, False, False, False, False] * 2
    for l in range(2):
        assert bool(torch.isfinite(hier.P[l]).all())
    # The same run through the port's ``kernels="off"`` path, to float32
    # rounding.  (The float64 run takes another step: there the inert cells
    # deep inside the wind region, rho = p = 1e-31, have a finite chemistry
    # timescale that sets dt — in both packages — while in float32 their
    # rates underflow to zero and the ambient medium sets it.)
    off = port_hierarchy(rcfg, mpc, src, wind, states, kernels="off")
    odts = [off.step(), off.step()]
    np.testing.assert_allclose(dts, odts, rtol=1e-4)
    assert dts[1] == pytest.approx(hier.cfg0.max_dt_growth * dts[0], rel=1e-6)
    for l in range(2):
        m = ~hier.phys[l].wind_exclude_mask(hier.P[l])
        np.testing.assert_allclose(hier.P[l][RO][m].numpy(),
                                   off.P[l][RO][m].numpy(), rtol=1e-4)
        np.testing.assert_allclose(hier.P[l][PG][m].numpy(),
                                   off.P[l][PG][m].numpy(), rtol=1e-3)


def test_single_grid_wind_matches_reference():
    """``Simulation(physics=Physics(wind_sources=...))``: the wind carved
    into the initial state, the first-step cap, the exclusion mask in the
    CFL reduction and the overwrite after each partial update, three
    steps."""
    rcfg, mpc, src, wind, states = reference_setup(nlevels=1)
    wind = dataclasses.replace(wind, radius=3.0 * rcfg.dx)
    rdts = []
    ref = pion_tpu.Simulation(rcfg, states[0].copy(), physics=RefPhysics(
        mp=RefMPv3(mpc), sources=[src], wind_sources=[wind], dt_limit=True))
    ref.run(max_steps=3, callback=lambda s: rdts.append(s.last_dt))
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    dts = []
    sim = Simulation(cfg, states[0].copy(), device="cpu",
                     physics=port_physics(mpc, src, wind))
    assert (sim.P.numpy()[RO] != states[0][RO]).any()
    sim.run(max_steps=3, callback=lambda s: dts.append(s.last_dt))
    np.testing.assert_allclose(dts, rdts, rtol=1e-9)
    np.testing.assert_allclose(sim.t, ref.t, rtol=1e-9)
    got, want = sim.P.numpy(), np.asarray(ref.P)
    sc = field_scales(want, sim.geom.dx / dts[-1])
    for v in range(rcfg.nvar):
        assert np.abs(got[v] - want[v]).max() <= 1e-7 * sc[v], v
    # the chemistry limit, not the wind's first-step cap, holds this step
    assert dts[0] < sim.physics.wind_dt_cap(cfg, sim.geom)
    assert sim.physics.wind_dt_cap(cfg, sim.geom) == pytest.approx(
        0.1 * 0.3 * cfg.dx / 2.0e8, rel=1e-12)


def test_point_source_must_lie_inside_the_finest_level():
    rcfg, mpc, src, wind, states = reference_setup()
    far = dataclasses.replace(src, position=(0.1 * L,) * 3)
    with pytest.raises(ValueError, match="finest level"):
        port_hierarchy(rcfg, mpc, far, wind, states)
