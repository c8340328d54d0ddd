"""pion_tpu_torch.physics.Physics against the JAX package: the rt dict the
raytrace assembles (every key), the chemistry increment and the chemistry
time-step limit, from the same seeded state.  CPU, float64, both sides on
their plain paths (``kernels="off"`` / the JAX CPU path)."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.constants import RSUN
from pion_tpu.microphysics import MPv3 as RefMPv3
from pion_tpu.microphysics import MPv3Config as RefMPv3Config
from pion_tpu.physics import Physics as RefPhysics
from pion_tpu.raytracing import Source as RefSource
from pion_tpu.raytracing import StarEvolution as RefStarEvolution

from pion_tpu_torch import Simulation, convert, make_geometry
from pion_tpu_torch.constants import BX, K_B, PG, RO, VX
from pion_tpu_torch.physics import Physics
from pion_tpu_torch.raytracing import Source

torch.set_num_threads(1)

SHAPE = (8, 10, 12)
BOX = 6.0e18 * 12 / 16
SLOT = 9
RTOL = 1.0e-11     # the same sums on both sides; exp/log may differ by an ulp
DT = 3.0e4         # a chemistry step that is stiff for part of the grid


def configs(kernels="off"):
    rcfg = pion_tpu.SimConfig(
        ndim=3, eqn="glm", solver="hlld", ntracer=1, shape=SHAPE,
        xmin=(0.0,) * 3, xmax=tuple(BOX * n / 12 for n in SHAPE),
        bcs=(("outflow", "outflow"),) * 3, av="falle", min_temperature=50.0,
        max_temperature=1.0e9, tmax=1.0e16,
        pallas="off" if kernels == "off" else "auto")
    return rcfg, convert.config_from_reference(dataclasses.asdict(rcfg))


def state(mpc, seed):
    """A clumpy, partly ionised medium around nH = 100."""
    rng = np.random.default_rng(seed)
    nH = 100.0 * 10 ** rng.uniform(-0.5, 0.5, SHAPE)
    x = 10 ** rng.uniform(-6, -0.01, SHAPE)
    T = 10 ** rng.uniform(2, 4, SHAPE)
    P = np.zeros((10,) + SHAPE)
    P[RO] = nH * mpc.mean_mass_per_h
    P[PG] = (mpc.n_ion + mpc.n_elec * x) * nH * K_B * T
    P[VX:VX + 3] = 1.0e5 * rng.standard_normal((3,) + SHAPE)
    P[BX] = 4.0e-6 / np.sqrt(4 * np.pi)
    P[SLOT] = x
    return P


def physics_pair(sources, n_diff=0, dt_limit=2, kernels="off"):
    """(reference physics, port physics, configs) set up on the same grid;
    the port's is built from the reference's through ``convert``."""
    rcfg, cfg = configs(kernels)
    mpc = RefMPv3Config(tracer_slot=SLOT, ion_src="mfion", n_idot=1e48,
                        tstar=3.75e4, rstar_cm=10 * RSUN,
                        min_temperature=50.0, n_diff_srcs=n_diff)
    ref = RefPhysics(mp=RefMPv3(mpc), sources=list(sources),
                     dt_limit=dt_limit).setup(rcfg,
                                              pion_tpu.make_geometry(rcfg))
    phys = convert.physics_from_reference(
        dataclasses.asdict(mpc), [dataclasses.asdict(s) for s in sources],
        dt_limit=dt_limit).setup(cfg, make_geometry(cfg))
    return ref, phys, rcfg, cfg


def star(pos, **kw):
    return RefSource(position=pos, strength=1.0e48, effect="mfion", **kw)


CENTRE = (0.5 * BOX * 8 / 12, 0.5 * BOX * 10 / 12, 0.5 * BOX)


def assert_rt_equal(got, want):
    """Every key of the rt dict, entry by entry."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if k == "ion":
            assert len(g) == len(w)
            for ge, we in zip(g, w):
                assert set(ge) == set(we)
                for kk in we:
                    np.testing.assert_allclose(
                        np.asarray(ge[kk]), np.asarray(we[kk]), rtol=RTOL,
                        atol=1e-300, err_msg=f"ion.{kk}")
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=RTOL, atol=1e-300, err_msg=k)


@pytest.mark.parametrize("case", ["one", "two", "own_table", "uv_infinity"])
def test_raytrace_matches_reference(case):
    other = (0.2 * BOX * 8 / 12, 0.7 * BOX * 10 / 12, 0.3 * BOX)
    sources = {
        "one": [star(CENTRE)],
        "two": [star(CENTRE), star(other)],
        # a second star with its own spectrum: its own tau table
        "own_table": [star(CENTRE), star(other, tstar=3.0e4,
                                         rstar_cm=8 * RSUN)],
        "uv_infinity": [star(CENTRE),
                        RefSource(at_infinity=True, axis=2, sign=-1,
                                  strength=1.0e9, effect="uv_heating"),
                        RefSource(position=other, strength=1.0e47,
                                  effect="uv_heating")],
    }[case]
    ref, phys, rcfg, cfg = physics_pair(
        sources, n_diff=2 if case == "uv_infinity" else 0)
    P = state(ref.mp.mpc, 31)
    want = ref.raytrace(jnp.asarray(P))
    got = phys.raytrace(torch.from_numpy(P))
    assert_rt_equal(got, want)
    assert len(got["ion"]) == sum(s.effect == "mfion" for s in sources)
    assert ("tau_stack" in got["ion"][-1]) == (case == "own_table")
    if case == "uv_infinity":
        assert float(got["g0_uv"].max()) > 0
    # columns handed down to a nested level, with an upstream offset
    tau_in = {0: np.full(SHAPE, 0.25)}
    wt = ref.trace_taus(jnp.asarray(P), {0: jnp.asarray(tau_in[0])})
    gt = phys.trace_taus(torch.from_numpy(P),
                         {0: torch.from_numpy(tau_in[0])})
    assert set(gt) == set(wt)
    for i in wt:
        np.testing.assert_allclose(gt[i].numpy(), np.asarray(wt[i]),
                                   rtol=RTOL, atol=1e-15)


def test_evolving_source_matches_reference():
    """A star that brightens and heats up: ``update_sources`` re-integrates
    its tau table when L or T move by more than 1 % and rescales ``sv``."""
    evo = RefStarEvolution(
        time=np.array([0.0, 1.0e13, 2.0e13]),
        log_L=np.log10(np.array([1.0e38, 2.0e38, 5.0e38])),
        log_T=np.log10(np.array([3.0e4, 3.3e4, 4.0e4])),
        log_R=np.log10(np.array([8.0, 9.0, 10.0]) * RSUN))
    ref, phys, rcfg, cfg = physics_pair([star(CENTRE, evolution=evo)])
    P = state(ref.mp.mpc, 32)
    for t in (0.0, 1.0e10, 0.9e13):     # first use, held (<1 %), re-applied
        rsp = ref.update_sources(t)
        sp = phys.update_sources(t)
        assert set(sp) == set(rsp) == {"0"}
        np.testing.assert_allclose(sp["0"]["rel"], float(rsp["0"]["rel"]),
                                   rtol=1e-13)
        np.testing.assert_allclose(sp["0"]["tau_stack"],
                                   np.asarray(rsp["0"]["tau_stack"]),
                                   rtol=1e-13, atol=1e-13)
        assert_rt_equal(phys.raytrace(torch.from_numpy(P), sp=sp),
                        ref.raytrace(jnp.asarray(P), sp=rsp))
    assert physics_pair([star(CENTRE)])[1].update_sources(0.0) is None


def test_mp_delta_U_matches_reference():
    """The chemistry's conserved increment: base state P, columns traced
    through another state Ph.  dt = 3e4 s, where part of the grid takes the
    ladder and Newton converges on this mild state; 1e-9."""
    ref, phys, rcfg, cfg = physics_pair([star(CENTRE)])
    P, Ph = state(ref.mp.mpc, 33), state(ref.mp.mpc, 34)
    want = np.asarray(ref.mp_delta_U(jnp.asarray(P), jnp.asarray(Ph), DT,
                                     rcfg))
    got = phys.mp_delta_U(torch.from_numpy(P), torch.from_numpy(Ph), DT,
                          cfg).numpy()
    assert np.abs(want[PG]).max() > 0 and np.abs(want[SLOT]).max() > 0
    for v in range(10):
        scale = np.abs(want[v]).max()
        assert np.abs(got[v] - want[v]).max() <= 1e-9 * scale, v
    # with the columns handed in, and with no sources at all
    rt = phys.raytrace(torch.from_numpy(Ph))
    again = phys.mp_delta_U(torch.from_numpy(P), None, DT, cfg, rt=rt)
    assert np.array_equal(again.numpy(), got)
    rdark, dark, _, _ = physics_pair([])
    np.testing.assert_allclose(
        dark.mp_delta_U(torch.from_numpy(P), torch.from_numpy(P), DT,
                        cfg).numpy()[PG],
        np.asarray(rdark.mp_delta_U(jnp.asarray(P), jnp.asarray(P), DT,
                                    rcfg))[PG], rtol=1e-9, atol=1e-30)


@pytest.mark.parametrize("dt_limit", [True, 3, 7])
def test_timescale_matches_reference(dt_limit):
    """Modes 1-4 give MPv3's own limit; a mode that is none of 0-4 silently
    disables it (1e99), as in the JAX package."""
    ref, phys, rcfg, cfg = physics_pair([star(CENTRE)], dt_limit=dt_limit)
    P = state(ref.mp.mpc, 35)
    want = ref.timescale(jnp.asarray(P), rcfg)
    got = phys.timescale(torch.from_numpy(P), cfg)
    assert got.ndim == 0 and got.dtype == torch.float64
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    assert (float(got) == 1.0e99) == (dt_limit == 7)
    gts, f = phys.timescale(torch.from_numpy(P), cfg, with_ydot=True)
    wts, wf = ref.timescale(jnp.asarray(P), rcfg, with_ydot=True)
    assert float(gts) == float(got) and (f is None) == (wf is None)
    if f is not None:
        for g, w in zip(f, wf):
            scale = np.abs(np.asarray(w)).max()
            assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-10 * scale


def test_what_is_not_ported_raises():
    rcfg, cfg = configs()
    geom = make_geometry(cfg)
    mixed = [Source(position=CENTRE, effect="mono"),
             Source(position=CENTRE, effect="mfion")]
    with pytest.raises(NotImplementedError, match="mixed"):
        Physics(sources=mixed).setup(cfg, geom)
    phys = physics_pair([star(CENTRE)])[1]
    with pytest.raises(ValueError, match="effect"):
        phys.dtau_for(Source(effect="xray"), torch.zeros((10,) + SHAPE), 1.0)
    # without a wind source the wind hooks do nothing
    assert phys.wind_exclude_mask() is None
    assert phys.wind_dt_cap(cfg, geom) == float("inf")
    P = torch.zeros((10,) + SHAPE)
    assert phys.apply_internal_bcs(P, 0.0) is P
    lvl = phys.for_level(cfg, geom)
    assert lvl.mp is phys.mp and lvl.raytracer is not phys.raytracer
    # several steps in one dispatch are not ported: no silent stepping
    from pion_tpu_torch.ng import NGHierarchy
    with pytest.raises(NotImplementedError, match="item 21"):
        NGHierarchy(cfg, 1, device="cpu").run(chunk=4)
    import pion_tpu_torch.microphysics as mph
    with pytest.raises(ImportError, match="ROADMAP"):
        mph.MPv5
