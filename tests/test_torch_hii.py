"""The radiation-chemistry slice as a whole: a magnetised H II region around
an O star (MPv3 multifrequency chemistry, point-source raytrace, GLM-MHD with
HLLD) through ``Simulation(cfg, P0, physics=...)``, five steps at 16^3,
against the JAX package from the same converted set-up."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import pion_tpu
from pion_tpu.constants import RSUN
from pion_tpu.microphysics import MPv3 as RefMPv3
from pion_tpu.microphysics import MPv3Config as RefMPv3Config
from pion_tpu.physics import Physics as RefPhysics
from pion_tpu.raytracing import Source as RefSource

from pion_tpu_torch import Simulation, convert
from pion_tpu_torch.constants import BX, K_B, PG, RO
from pion_tpu_torch.microphysics import fused_mpv3
from pion_tpu_torch.ops import fused_sweep
from pion_tpu_torch.raytracing import fused_trace

torch.set_num_threads(1)

N = 16
STEPS = 5


def reference_setup(dtype="float64", pallas="off"):
    """The run of the H100 smoke test, at 16^3: the reference's config,
    chemistry, source and initial state."""
    rcfg = pion_tpu.SimConfig(
        ndim=3, eqn="glm", solver="hlld", ntracer=1, shape=(N,) * 3,
        xmin=(0.0,) * 3, xmax=(6.0e18,) * 3,
        bcs=(("outflow", "outflow"),) * 3, cfl=0.3, ooa=2, av="falle",
        etav=0.1, dtype=dtype, min_temperature=50.0, max_temperature=1.0e9,
        tmax=1.0e16, pallas=pallas)
    mpc = RefMPv3Config(tracer_slot=rcfg.eqn.nbase, ion_src="mfion",
                        n_idot=1.0e48, tstar=3.75e4, rstar_cm=10 * RSUN,
                        min_temperature=50.0)
    src = RefSource(position=(3.0e18,) * 3, strength=1.0e48, effect="mfion")
    nH = 100.0
    P0 = np.zeros((rcfg.nvar,) + rcfg.shape)
    P0[RO] = nH * mpc.mean_mass_per_h
    P0[PG] = 1.1 * nH * K_B * 300.0
    P0[BX] = 4.0e-6 / np.sqrt(4.0 * np.pi)
    P0[rcfg.eqn.nbase] = 1.0e-6
    return rcfg, mpc, src, P0


def field_scales(P, dx_over_dt):
    """One scale per variable: its own largest value, but for the vector
    components the largest of the whole vector, and for psi the field times
    the cleaning speed — By, Bz and psi start at zero here and only ever
    hold rounding noise."""
    s = np.abs(P).reshape(P.shape[0], -1).max(axis=1)
    s[2:5] = s[2:5].max()
    s[5:8] = s[5:8].max()
    s[8] = max(s[8], s[5] * dx_over_dt)
    return s


def port_run(rcfg, mpc, src, P0, steps=STEPS, kernels=None):
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    if kernels is not None:
        cfg = dataclasses.replace(cfg, kernels=kernels)
    phys = convert.physics_from_reference(
        dataclasses.asdict(mpc), [dataclasses.asdict(src)], dt_limit=True)
    dts = []
    sim = Simulation(cfg, P0.copy(), physics=phys, device="cpu")
    sim.run(max_steps=steps, callback=lambda s: dts.append(s.last_dt))
    return sim, dts


@pytest.fixture(scope="module")
def off_run():
    rcfg, mpc, src, P0 = reference_setup()
    return port_run(rcfg, mpc, src, P0)


def test_hii_run_matches_reference(off_run):
    """``kernels="off"`` against the JAX CPU path: state, clock and every dt.

    The dynamics alone agree to 1e-8 after five steps.  Chemistry adds the
    Newton ladder of the ionization front's cells, which stops on a 1e-11
    tolerance, so two correct runs may differ by that much per substep; the
    step itself is set by the chemistry limit, a ratio of those rates.
    Held: dt and t to 1e-9, the fields to 1e-7 of each variable's range."""
    rcfg, mpc, src, P0 = reference_setup()
    rdts = []
    ref = pion_tpu.Simulation(
        rcfg, P0.copy(), physics=RefPhysics(mp=RefMPv3(mpc), sources=[src],
                                            dt_limit=True))
    ref.run(max_steps=STEPS, callback=lambda s: rdts.append(s.last_dt))
    sim, dts = off_run
    assert sim.step_count == ref.step_count == STEPS
    assert sim.cfg.kernels == "off"
    np.testing.assert_allclose(dts, rdts, rtol=1e-9)
    np.testing.assert_allclose(sim.t, ref.t, rtol=1e-9)
    got, want = sim.P.numpy(), np.asarray(ref.P)
    scales = field_scales(want, sim.geom.dx / dts[-1])
    for v in range(rcfg.nvar):
        assert np.abs(got[v] - want[v]).max() <= 1e-7 * scales[v], v
    # the run did something: the chemistry sets the step, the star ionises
    xs = rcfg.eqn.nbase
    assert dts[0] < 1e-3 * float(pion_tpu.Simulation(
        rcfg, P0.copy()).compute_dt())
    assert got[xs].max() > 10 * P0[xs].max()


def test_hii_run_kernels_auto_on_cpu(off_run):
    """``kernels="auto"`` on the CPU — the plain versions of all four
    kernels on the path, the ladder per 1024-cell tile — against the port's
    own ``off`` run.  The two ladders are different integrators (the JAX
    package's own test allows a median of 5 % between them); here the
    chemistry limit keeps every ladder at its two-substep minimum, so they
    differ only in where Newton stops: 1e-6."""
    rcfg, mpc, src, P0 = reference_setup()
    counts = [w.launches for w in (fused_sweep.sweep_axis, fused_mpv3.update,
                                   fused_mpv3.ydot, fused_trace.octant_trace)]
    sim, dts = port_run(rcfg, mpc, src, P0, kernels="auto")
    off, off_dts = off_run
    assert counts == [w.launches for w in (
        fused_sweep.sweep_axis, fused_mpv3.update, fused_mpv3.ydot,
        fused_trace.octant_trace)]                 # no card, no launch
    np.testing.assert_allclose(dts, off_dts, rtol=1e-6)
    got, want = sim.P.numpy(), off.P.numpy()
    scales = field_scales(want, sim.geom.dx / dts[-1])
    for v in range(rcfg.nvar):
        err = np.abs(got[v] - want[v])
        assert err.max() <= 1e-6 * scales[v], v
        assert np.median(err) <= 0.05 * scales[v]


def test_hii_run_float32_without_overflow_warnings():
    """float32, with every warning an error on the port's side: no cast
    overflows (Ndot ~1e48 and the shell volumes ~1e51 never reach float32;
    their ratio does).  Finite, x in [0, 1], T in [Tmin, Tmax]."""
    rcfg, mpc, src, P0 = reference_setup(dtype="float32", pallas="auto")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with np.errstate(over="raise", invalid="raise"):
            sim, dts = port_run(rcfg, mpc, src, P0)
    assert sim.P.dtype == torch.float32 and sim.step_count == STEPS
    assert bool(torch.isfinite(sim.P).all()) and all(d > 0 for d in dts)
    x = sim.P[rcfg.eqn.nbase]
    assert 0.0 <= float(x.min()) and float(x.max()) <= 1.0
    T = sim.physics.mp.temperature(sim.P, sim.cfg)
    assert 50.0 * (1 - 1e-5) <= float(T.min())
    assert float(T.max()) <= 1.0e9
    # and it is the same run as the float64 one, to float32 rounding
    ref, rdts = port_run(*reference_setup(), kernels="auto")
    np.testing.assert_allclose(dts, rdts, rtol=1e-4)


def test_hii_entry_point_needs_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    rcfg, mpc, src, P0 = reference_setup()
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    phys = convert.physics_from_reference(dataclasses.asdict(mpc),
                                          [dataclasses.asdict(src)])
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(cfg, P0, physics=phys)
