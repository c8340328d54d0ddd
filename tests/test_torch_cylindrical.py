"""2D axisymmetric (cylindrical) and 1D spherical grids in the port against
the JAX package on the same seeded inputs: the plain radial sweep, the
plain versions of B1/B2 against the TPU kernels' radial branch in interpret
mode, uniform gas at rest, the geometry pack and the radial launch plan,
the wind region on the axis, and whole runs -- the axisymmetric blast, a
cooling GLM-MHD wind bubble through ``Simulation`` and a 3-level wind
hierarchy through ``NGHierarchy``.  CPU, float64."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.boundaries import BoundaryData as RefBoundaryData
from pion_tpu.boundaries import apply_bcs as ref_apply_bcs
from pion_tpu.constants import MSUN, PARSEC as PC, YEAR
from pion_tpu.microphysics import cooling as ref_cooling
from pion_tpu.ng import NGHierarchy as RefHierarchy
from pion_tpu.ops import pallas_sweep as ref_pallas
from pion_tpu.ops import sweep as ref_sweep
from pion_tpu.physics import Physics as RefPhysics
from pion_tpu.winds import WindSource as RefWindSource

import pion_tpu_torch
from pion_tpu_torch import Simulation, convert
from pion_tpu_torch.boundaries import apply_bcs
from pion_tpu_torch.constants import BX, K_B, M_P, PG, RO, VX, VY
from pion_tpu_torch.ops import fused_sweep, sweep

from test_torch_eqns import close, noisy_state, to_port

torch.set_num_threads(1)

DT = 1.0e-3
AXIS_BCS = (("axisymmetric", "outflow"), ("outflow", "outflow"))
# every (system, solver) the kernels' gate takes, and the fallback mask
GATED = [("euler", "hll"), ("euler", "linear"), ("euler", "roe"),
         ("euler", "roe_pv"), ("mhd", "hll"), ("mhd", "linear"),
         ("mhd", "roe"), ("glm", "hlld"), ("glm", "hll")]


def cyl_config(eqn, solver, shape=(16, 32), **kw):
    """A 2D axisymmetric box, R on axis 0 from the axis, z centred on 0,
    so that the blast wave sits on the axis."""
    base = dict(ndim=2, eqn=eqn, solver=solver, ntracer=1, shape=shape,
                coords="cylindrical", xmin=(0.0, -0.5 * shape[1] / shape[0]),
                xmax=(1.0, 0.5 * shape[1] / shape[0]), bcs=AXIS_BCS,
                av="falle", etav=0.1, cfl=0.3, ooa=2, dtype="float64",
                gamma=1.4 if eqn == "euler" else 5.0 / 3.0)
    base.update(kw)
    return pion_tpu.SimConfig(**base)


def setup(rcfg, seed=0):
    P = noisy_state(rcfg, seed)
    cfg, Pt, bd = to_port(rcfg, P)
    rgeom = pion_tpu.make_geometry(rcfg)
    geom = pion_tpu_torch.make_geometry(cfg)
    rPpad = ref_apply_bcs(jnp.asarray(P), rcfg, RefBoundaryData())
    Ppad = apply_bcs(Pt, cfg, bd)
    assert np.array_equal(Ppad.numpy(), np.asarray(rPpad))
    return cfg, rgeom, geom, P, Pt, rPpad, Ppad


def held(out, ref, rtol):
    """|out - ref| <= rtol times each variable's largest |ref|."""
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1)
    err = np.abs(out - ref).reshape(ref.shape[0], -1).max(axis=1)
    assert (err <= rtol * scale).all(), (err / scale).max()


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("eqn,solver", GATED)
def test_radial_sweep_matches_xla_sweep(eqn, solver, order):
    """dU and both axes' face fluxes on the axisymmetric noisy blast, every
    solver of the kernels' gate; the same formulas in the same order, held
    at 1e-12 of each variable's range (the MHD linear and Roe solvers sum
    seven waves that cancel)."""
    rcfg = cyl_config(eqn, solver)
    cfg, rgeom, geom, P, Pt, rPpad, Ppad = setup(rcfg)
    assert fused_sweep.supports(cfg) == ref_pallas.supports(rcfg) is True
    dU, faces = sweep.dynamics_dU(Ppad, cfg, geom, DT, order)
    rdU, rfaces = ref_sweep.dynamics_dU(rPpad, rcfg, rgeom, DT, order)
    held(dU, rdU, 1e-12)
    for f, rf in zip(faces, rfaces):
        held(f, rf, 1e-12)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("eqn,solver", [("glm", "hlld"), ("euler", "hll"),
                                        ("mhd", "roe")])
def test_radial_kernels_plain_match_pallas_interpret(eqn, solver, order):
    """B1's plain version summed over both axes against
    ``dynamics_dU_pallas``, and B2's (the fused partial update, the radial
    axis in the final kernel) against ``advance_dynamics_pallas``, the TPU
    kernels in interpret mode with their geometry pack.  rtol 1e-10: on
    axis 1 the TPU kernel divides by dx where the plain sweep uses the
    centre-of-volume spacing."""
    rcfg = cyl_config(eqn, solver)
    cfg, rgeom, geom, P, Pt, rPpad, Ppad = setup(rcfg, seed=3)
    ref = ref_pallas.dynamics_dU_pallas(rPpad, rcfg, rgeom, DT, order,
                                        interpret=True)
    out = sum(fused_sweep.sweep_axis_plain(Ppad, cfg, geom, a, order, DT)
              for a in range(2))
    held(out, ref, 1e-10)
    P_base = noisy_state(rcfg, 5)
    _, Pb, _ = to_port(rcfg, P_base)
    ref = ref_pallas.advance_dynamics_pallas(jnp.asarray(P_base), rPpad,
                                             rcfg, rgeom, DT, order,
                                             interpret=True)
    out = fused_sweep.advance_dynamics(Pb, Ppad, cfg, geom, DT, order)
    held(out, ref, 1e-10)


@pytest.mark.parametrize("order", [1, 2])
def test_spherical_1d_matches_reference(order):
    """The 1D spherical sweep (metric divergence and 2p/R3) on a noisy
    blast centred at the origin."""
    rcfg = pion_tpu.SimConfig(
        ndim=1, eqn="euler", solver="hll", ntracer=1, shape=(64,),
        coords="spherical", xmin=(0.0,), xmax=(1.0,),
        bcs=(("reflecting", "outflow"),), av="falle", etav=0.1, cfl=0.3,
        dtype="float64", gamma=1.4)
    cfg, rgeom, geom, P, Pt, rPpad, Ppad = setup(rcfg, seed=2)
    dU, faces = sweep.dynamics_dU(Ppad, cfg, geom, DT, order)
    rdU, rfaces = ref_sweep.dynamics_dU(rPpad, rcfg, rgeom, DT, order)
    held(dU, rdU, 1e-12)
    held(faces[0], rfaces[0], 1e-12)
    assert not fused_sweep.supports(cfg) and not ref_pallas.supports(rcfg)


@pytest.mark.parametrize("coords,shape", [("cylindrical", (16, 16)),
                                          ("spherical", (64,))])
def test_uniform_gas_stays_static(coords, shape):
    """Static uniform gas on a curvilinear grid stays static: the
    geometric pressure source cancels the metric flux divergence
    (tests/test_multid.py's check, in the port)."""
    nd = len(shape)
    bcs = ((("reflecting", "outflow"), ("outflow", "outflow")) if nd == 2
           else (("reflecting", "outflow"),))
    cfg = pion_tpu_torch.SimConfig(
        ndim=nd, eqn="euler", solver="hll", coords=coords, shape=shape,
        xmin=(0.0,) * nd, xmax=(1.0,) * nd, bcs=bcs, cfl=0.3, ooa=2,
        av="falle", etav=0.1, tmax=0.1, dtype="float64")
    P0 = np.zeros((cfg.nvar,) + cfg.shape)
    P0[RO] = 1.7
    P0[PG] = 0.83
    sim = Simulation(cfg, P0, device="cpu")
    for _ in range(20):
        sim.last_dt = 0.0
        sim.t = 0.0
        sim.step()
    out = sim.P.numpy()
    np.testing.assert_allclose(out[RO], 1.7, rtol=1e-11)
    np.testing.assert_allclose(out[PG], 0.83, rtol=1e-11)
    assert np.abs(out[VX:VX + nd]).max() < 1e-11


def test_radial_geo_pack_and_plan():
    """The pack's layout (the TPU kernel's ``_radial_geo``), kept per
    dtype and device, and the radial launch plan: the pack's rows of the
    staged cells in shared memory, the tiles of the Cartesian plan."""
    rcfg = cyl_config("glm", "hlld", shape=(20, 36))
    cfg, _, geom, *_ = setup(rcfg)
    pack = fused_sweep.radial_geo(cfg, geom, torch.float64, "cpu")
    want = np.asarray(ref_pallas._radial_geo(rcfg, pion_tpu.make_geometry(
        rcfg)))
    assert tuple(pack.shape) == (fused_sweep.GEO_ROWS, 24) == want.shape
    np.testing.assert_array_equal(pack.numpy(), want)
    assert fused_sweep.radial_geo(cfg, geom, torch.float64, "cpu") is pack
    # rows com, del_n, del_p, pos; the ghosts mirror the axis
    g = geom.axes[0]
    assert pack[3, 1] == -pack[3, 2] and pack[0, 0] < 0 < pack[0, 2]
    np.testing.assert_array_equal(pack[4, :20].numpy(), g.div_cn)
    assert (pack[5, 20:] == 1.0 / geom.dx).all()
    p32 = fused_sweep.radial_geo(cfg, geom, torch.float32, "cpu")
    assert p32.dtype == torch.float32
    np.testing.assert_array_equal(p32.numpy(), want.astype(np.float32))
    for itemsize in (4, 8):
        for order in (1, 2):
            cart = fused_sweep.sweep_plan((20, 36), 0, 10, 9, itemsize,
                                          order, True)
            rad = fused_sweep.sweep_plan((20, 36), 0, 10, 9, itemsize, order,
                                         True, True)
            assert rad["geo"] and not cart["geo"]
            assert (rad["T"], rad["W"], rad["blocks"]) == \
                (cart["T"], cart["W"], cart["blocks"])
            assert rad["smem"] == cart["smem"] + fused_sweep.GEO_ROWS * (
                rad["T"] + 2 * order) * itemsize
            assert rad["smem"] == fused_sweep.tile_bytes(
                10, 9, order, rad["T"], rad["W"], True, itemsize, geo=True)
    with pytest.raises(ValueError, match="geometry pack"):
        fused_sweep.sweep_plan((20, 36), 1, 10, 9, 8, 2, True, True)
    with pytest.raises(ValueError, match="geometry pack"):
        fused_sweep.sweep_plan((8, 20, 36), 0, 10, 9, 8, 2, True, True)
    # the operations of a radial interface count the geometric sources
    assert fused_sweep.flops_per_interface(cfg, 2, radial=True) > \
        fused_sweep.flops_per_interface(cfg, 2)


def test_kernel_gate_matches_pallas_gate():
    """``fused_sweep.supports`` admits a cylindrical grid exactly where
    ``pallas_sweep.supports`` does: 2D, the same solvers and viscosities."""
    for coords, nd in (("cylindrical", 2), ("spherical", 1),
                       ("cartesian", 2), ("cartesian", 3)):
        for eqn in ("euler", "mhd", "glm"):
            for solver in ("hll", "hlld", "linear", "roe", "roe_pv", "lf",
                           "exact", "hybrid", "fvs"):
                if eqn == "euler" and solver == "hlld":
                    continue
                if eqn != "euler" and solver in ("exact", "hybrid", "fvs"):
                    continue
                for av in ("none", "falle", "hcorr"):
                    kw = dict(ndim=nd, eqn=eqn, solver=solver, av=av,
                              coords=coords, shape=(8,) * nd,
                              xmin=(0.0,) * nd, xmax=(1.0,) * nd,
                              bcs=(("outflow", "outflow"),) * nd)
                    rcfg = pion_tpu.SimConfig(**kw)
                    cfg = pion_tpu_torch.SimConfig(**kw)
                    assert fused_sweep.supports(cfg) == \
                        ref_pallas.supports(rcfg), kw


def _split_monopole(eqn):
    """The split-monopole wind of tests/test_winds.py on the axis."""
    rmax = 0.5 * PC
    n = 32
    rcfg = pion_tpu.SimConfig(
        ndim=2, eqn=eqn, solver="hll", coords="cylindrical",
        shape=(n // 2, n), xmin=(0.0, -rmax / 2), xmax=(rmax / 2, rmax / 2),
        bcs=AXIS_BCS, cfl=0.3, tmax=1.0, dtype="float64")
    src = RefWindSource(position=(0.0, 0.0), radius=5.0 * rmax / n,
                        mdot=1.0e-6 * MSUN / YEAR, vinf=2.0e8, b_star=1.0,
                        rstar=7.0e11, t_wind=3.0e4)
    return rcfg, src


@pytest.mark.parametrize("eqn", ["euler", "glm"])
def test_wind_region_on_the_axis_matches_reference(eqn):
    """The wind region on R = 0 of a 2D cylindrical grid: mask, distances
    and the wind state (the split monopole for GLM-MHD), then the region
    written into a state."""
    rcfg, src = _split_monopole(eqn)
    P0 = np.zeros((rcfg.nvar,) + rcfg.shape)
    P0[RO] = 100.0 * M_P
    P0[PG] = 1.0e-10
    ref = pion_tpu.Simulation(rcfg, jnp.asarray(P0), physics=RefPhysics(
        wind_sources=[src]))
    cfg, Pt, _ = to_port(rcfg, P0)
    phys = convert.physics_from_reference(
        None, dt_limit=0, wind_sources=[dataclasses.asdict(src)])
    sim = Simulation(cfg, Pt, physics=phys, device="cpu")
    rw, w = ref.physics.winds[0], sim.physics.winds[0]
    assert np.array_equal(w.mask.numpy(), np.asarray(rw.mask))
    assert w.mask.numpy()[0].any()         # the region touches the axis
    close(w.wind_state(sim.P, 0.0), rw.wind_state(ref.P, 0.0), rtol=1e-12,
          atol=1e-300)
    close(sim.P, ref.P, rtol=1e-12, atol=1e-300)


def wind_bubble(eqn="glm", solver="hll", n=32, curve=None):
    """The Ostar2 class at a small size: a wind on the axis into a
    uniform medium with a field along z of 10 muG (GLM-MHD), the
    cooling-only module with the cooling dt limit when ``curve`` is given."""
    rmax = 2.0 * PC
    rcfg = pion_tpu.SimConfig(
        ndim=2, eqn=eqn, solver=solver, coords="cylindrical",
        shape=(n // 2, n), xmin=(0.0, -rmax / 2), xmax=(rmax / 2, rmax / 2),
        bcs=AXIS_BCS, cfl=0.3, ooa=2, av="falle", etav=0.15,
        min_temperature=10.0, max_temperature=1.0e9, tmax=1.0e20,
        dtype="float64")
    src = RefWindSource(position=(0.0, 0.0), radius=4.0 * rcfg.dx,
                        mdot=1.0e-6 * MSUN / YEAR, vinf=2.0e8, b_star=1.0,
                        rstar=7.0e11, t_wind=3.0e4)
    P0 = np.zeros((rcfg.nvar,) + rcfg.shape)
    P0[RO] = 2.0 * M_P
    P0[PG] = 2.0 * K_B * 8.0e3 / 0.61
    if rcfg.eqn.is_mhd:
        P0[BX] = 1.0e-5 / np.sqrt(4.0 * np.pi)   # along z: array axis 1
    mpc = (None if curve is None
           else ref_cooling.CoolingConfig(curve=curve))
    return rcfg, src, mpc, P0


def test_axisymmetric_blast_run_matches_reference():
    """Five steps of ``Simulation.run`` on the axisymmetric GLM-MHD blast
    (HLLD with fallback, Falle AV, a tracer): the pure-dynamics route, B2
    taking the radial axis; t to 1e-12 and the fields to 1e-8."""
    rcfg = cyl_config("glm", "hlld", shape=(16, 32))
    P = noisy_state(rcfg, 13)
    ref = pion_tpu.Simulation(rcfg, P.copy()).run(max_steps=5)
    cfg, Pt, _ = to_port(rcfg, P)
    sim = Simulation(cfg, Pt, device="cpu").run(max_steps=5)
    assert sim.step_count == ref.step_count == 5
    np.testing.assert_allclose(sim.t, ref.t, rtol=1e-12)
    close(sim.P, ref.P, rtol=1e-8, atol=1e-11)


def test_cooling_glm_wind_run_matches_reference():
    """Five steps of the cooling GLM-MHD wind bubble through
    ``Simulation(physics=...)`` (the route with physics: B1 on both axes,
    the geometry pack on the radial one): MPOnlyCooling with
    WSS09_CIE_LINE_HEAT_COOL and its dt limit, the split-monopole wind.
    dt to 1e-9, fields to 1e-8 of each variable's range."""
    rcfg, src, mpc, P0 = wind_bubble(curve="WSS09_CIE_LINE_HEAT_COOL")
    ref = pion_tpu.Simulation(rcfg, jnp.asarray(P0), physics=RefPhysics(
        mp=ref_cooling.MPOnlyCooling(mpc), wind_sources=[src],
        dt_limit=True))
    ref.run(max_steps=5)
    cfg, Pt, _ = to_port(rcfg, P0)
    phys = convert.physics_from_reference(
        dataclasses.asdict(mpc), dt_limit=True,
        wind_sources=[dataclasses.asdict(src)])
    sim = Simulation(cfg, Pt, physics=phys, device="cpu").run(max_steps=5)
    assert sim.step_count == ref.step_count == 5
    np.testing.assert_allclose(sim.t, ref.t, rtol=1e-9)
    np.testing.assert_allclose(sim.last_dt, ref.last_dt, rtol=1e-9)
    held(sim.P, ref.P, 1e-8)
    # outside the wind region (whose inner cells hold rho = p = 1e-31) the
    # temperature stays within the module's floor and ceiling
    T = phys.mp.temperature(sim.P, cfg)[~sim.physics.winds[0].mask]
    assert bool(torch.isfinite(sim.P).all())
    assert 10.0 * (1 - 1e-12) <= float(T.min()) <= float(T.max()) <= 1.0e9


def test_cylindrical_wind_hierarchy_matches_reference():
    """A 3-level Euler + HLL wind hierarchy on the axis (the Wind2D class)
    against the JAX package over two hierarchy steps: dt to 1e-9 and every
    level's fields to 1e-9 of each variable's range.  The predictor takes
    the plain version of B1 with the geometry pack, the corrector the plain
    sweep with its faces; the glue weighs by the cylindrical volumes and
    face areas."""
    rcfg, src, _, P0 = wind_bubble(eqn="euler", n=32)
    rcfg = dataclasses.replace(rcfg, nlevels=3, ng_centre=(0.0, 0.0))
    P0[VX] = -25.0e5
    ref = RefHierarchy(rcfg, 3, physics=RefPhysics(wind_sources=[src]))
    ref.set_states([jnp.asarray(P0)] * 3)
    phys = convert.physics_from_reference(
        None, dt_limit=0, wind_sources=[dataclasses.asdict(src)])
    hier = convert.hierarchy_from_reference(
        dataclasses.asdict(rcfg), [P0] * 3, physics=phys, device="cpu")
    dts = [hier.step(), hier.step()]
    rdts = [ref.step(), ref.step()]
    np.testing.assert_allclose(dts, rdts, rtol=1e-9)
    for level in range(3):
        held(hier.P[level], ref.P[level], 1e-9)
        assert bool(torch.isfinite(hier.P[level]).all())
    # level 0 holds level 1's restriction where level 1 covers it
    assert torch.equal(hier._restrict(hier.P[0], hier.P[1], 1), hier.P[0])
    assert float(hier.P[2][VY].abs().max()) > 0.0
