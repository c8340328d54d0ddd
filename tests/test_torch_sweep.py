"""The module that holds the kernels: pion_tpu_torch.ops.sweep and the plain
versions in ops.fused_sweep, against pion_tpu's XLA sweep and against its
Pallas kernels in interpret mode."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.boundaries import BoundaryData as RefBoundaryData
from pion_tpu.boundaries import apply_bcs as ref_apply_bcs
from pion_tpu.ops import pallas_sweep as ref_pallas
from pion_tpu.ops import sweep as ref_sweep
from pion_tpu.ops.timestep import dynamics_dt as ref_dynamics_dt

import pion_tpu_torch
from pion_tpu_torch.boundaries import apply_bcs
from pion_tpu_torch.ops import fused_sweep, sweep
from pion_tpu_torch.ops.timestep import dynamics_dt

from test_torch_eqns import close, noisy_state, ref_config, to_port

torch.set_num_threads(1)

CASES = ["glm3d", "mhd2d", "glm2d"]
DT = 1.0e-3


def _setup(case, seed=0, **kw):
    rcfg = ref_config(case, **kw)
    P = noisy_state(rcfg, seed)
    cfg, Pt, bd = to_port(rcfg, P)
    rgeom = pion_tpu.make_geometry(rcfg)
    geom = pion_tpu_torch.make_geometry(cfg)
    rPpad = ref_apply_bcs(jnp.asarray(P), rcfg, RefBoundaryData())
    Ppad = apply_bcs(Pt, cfg, bd)
    assert np.array_equal(Ppad.numpy(), np.asarray(rPpad))
    return rcfg, cfg, rgeom, geom, P, Pt, rPpad, Ppad


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_dynamics_dU_matches_xla_sweep(case, order):
    """dU and every face flux; same formulas in the same order, so only
    the last bits of libm and of the stacking differ."""
    rcfg, cfg, rgeom, geom, P, Pt, rPpad, Ppad = _setup(case)
    before = Ppad.clone()
    dU, faces = sweep.dynamics_dU(Ppad, cfg, geom, DT, order)
    rdU, rfaces = ref_sweep.dynamics_dU(rPpad, rcfg, rgeom, DT, order)
    close(dU, rdU, rtol=1e-12, atol=1e-14)
    assert len(faces) == cfg.ndim
    for f, rf in zip(faces, rfaces):
        assert f.shape == tuple(rf.shape)
        close(f, rf, rtol=1e-12, atol=1e-14)
    assert torch.equal(Ppad, before)
    # one axis alone: the other faces are None, dU is that axis's share
    dU1, faces1 = sweep.dynamics_dU(Ppad, cfg, geom, DT, order, axes=[1])
    rdU1, _ = ref_sweep.dynamics_dU(rPpad, rcfg, rgeom, DT, order, axes=[1])
    close(dU1, rdU1, rtol=1e-12, atol=1e-14)
    assert faces1[0] is None and faces1[1] is not None


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_sweep_axis_plain_matches_pallas_interpret(case, order):
    """The per-axis plain versions summed over the axes against the fused
    TPU kernel run in interpret mode.  rtol=1e-10: the kernel's tile math
    divides by dx and uses +-dx/2 where the plain sweep uses the
    centre-of-volume spacing and del_n/del_p."""
    rcfg, cfg, rgeom, geom, P, Pt, rPpad, Ppad = _setup(case)
    ref = ref_pallas.dynamics_dU_pallas(rPpad, rcfg, rgeom, DT, order,
                                        interpret=True)
    out = sum(fused_sweep.sweep_axis_plain(Ppad, cfg, geom, a, order, DT)
              for a in range(cfg.ndim))
    close(out, ref, rtol=1e-10, atol=1e-13)
    # on a CPU tensor the wrapper takes the plain version and counts nothing
    n0 = fused_sweep.sweep_axis.launches
    via = sum(fused_sweep.sweep_axis(Ppad, cfg, geom, a, order, DT)
              for a in range(cfg.ndim))
    assert torch.equal(via, out) and fused_sweep.sweep_axis.launches == n0


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_final_axis_plain_matches_pallas_interpret(case, order):
    """The fused partial update P + dt*dU[Ph] -> P-new through the plain
    versions against advance_dynamics_pallas in interpret mode; the base
    state P differs from the flux state Ph as in the corrector."""
    rcfg, cfg, rgeom, geom, P, Pt, rPpad, Ppad = _setup(case)
    P_base = noisy_state(rcfg, 5)
    _, Pb, _ = to_port(rcfg, P_base)
    ref = ref_pallas.advance_dynamics_pallas(jnp.asarray(P_base), rPpad, rcfg,
                                             rgeom, DT, order, interpret=True)
    before = Pb.clone()
    out = fused_sweep.advance_dynamics(Pb, Ppad, cfg, geom, DT, order)
    close(out, ref, rtol=1e-9, atol=1e-12)
    assert torch.equal(Pb, before)
    contribs = [fused_sweep.sweep_axis_plain(Ppad, cfg, geom, a, order, DT)
                for a in range(1, cfg.ndim)]
    direct = fused_sweep.final_axis_plain(Pb, Ppad, contribs, cfg, geom,
                                          order, DT)
    assert torch.equal(direct, out)


@pytest.mark.parametrize("case", ["glm3d", "glm2d"])
def test_hlld_fallback_cells_exact(case):
    rcfg, cfg, rgeom, geom, P, Pt, rPpad, Ppad = _setup(case, seed=3)
    mask = sweep.hlld_fallback_cells(Ppad, cfg, geom.dx)
    ref = ref_sweep.hlld_fallback_cells(rPpad, rcfg, rgeom.dx)
    assert mask.dtype == torch.bool and mask.shape == Ppad.shape[1:]
    assert np.array_equal(mask.numpy(), np.asarray(ref))
    assert 0 < int(mask.sum()) < mask.numel()       # neither empty nor full
    # and the sweep with the fallback differs from the one without
    no_fb = dataclasses.replace(cfg, hlld_fallback=False)
    a, _ = sweep.dynamics_dU(Ppad, cfg, geom, DT, 2)
    c, _ = sweep.dynamics_dU(Ppad, no_fb, geom, DT, 2)
    assert not torch.equal(a, c)
    rc, _ = ref_sweep.dynamics_dU(
        rPpad, dataclasses.replace(rcfg, hlld_fallback=False), rgeom, DT, 2)
    close(c, rc, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("order,scma", [(2, True), (2, (10, 11)),
                                        (1, (9, 11))])
def test_scma_variants(order, scma):
    """sCMA clamp and element renormalisation; tracers pushed above 1 and
    below 0 so that the clamps act."""
    rcfg = ref_config("glm3d", ntracer=3)
    P = noisy_state(rcfg, 4)
    P[9:] = 1.6 * P[9:] - 0.3
    cfg, Pt, bd = to_port(rcfg, P)
    rgeom = pion_tpu.make_geometry(rcfg)
    geom = pion_tpu_torch.make_geometry(cfg)
    rPpad = ref_apply_bcs(jnp.asarray(P), rcfg, RefBoundaryData())
    Ppad = apply_bcs(Pt, cfg, bd)
    dU, faces = sweep.dynamics_dU(Ppad, cfg, geom, DT, order, scma=scma)
    rdU, rfaces = ref_sweep.dynamics_dU(rPpad, rcfg, rgeom, DT, order,
                                        scma=scma)
    close(dU, rdU, rtol=1e-12, atol=1e-14)
    for f, rf in zip(faces, rfaces):
        close(f, rf, rtol=1e-12, atol=1e-14)
    plain, _ = sweep.dynamics_dU(Ppad, cfg, geom, DT, order)
    assert not torch.equal(plain[9:], dU[9:])
    pal = ref_pallas.dynamics_dU_pallas(rPpad, rcfg, rgeom, DT, order,
                                        interpret=True, scma=scma)
    close(dU, pal, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("case", CASES)
def test_dynamics_dt(case):
    rcfg, cfg, rgeom, geom, P, Pt, rPpad, Ppad = _setup(case)
    dt = dynamics_dt(Pt, cfg, geom)
    assert dt.ndim == 0
    close(dt, ref_dynamics_dt(jnp.asarray(P), rcfg, rgeom), rtol=1e-13)
    excl = np.zeros(rcfg.shape, dtype=bool)
    excl[..., :4] = True
    close(dynamics_dt(Pt, cfg, geom, exclude=torch.from_numpy(excl)),
          ref_dynamics_dt(jnp.asarray(P), rcfg, rgeom,
                          exclude=jnp.asarray(excl)), rtol=1e-13)


def test_float32_state_stays_float32():
    """Geometry arrays are numpy; a bare conversion would promote a float32
    state to float64 inside the reconstruction."""
    rcfg, cfg, rgeom, geom, P, Pt, rPpad, Ppad = _setup("glm3d",
                                                        dtype="float32")
    assert Ppad.dtype == torch.float32
    dU, faces = sweep.dynamics_dU(Ppad, cfg, geom, DT, 2)
    assert dU.dtype == torch.float32
    assert all(f.dtype == torch.float32 for f in faces)
    rdU, _ = ref_sweep.dynamics_dU(rPpad, rcfg, rgeom, DT, 2)
    assert np.asarray(rdU).dtype == np.float32
    scale = np.abs(np.asarray(rdU)).reshape(cfg.nvar, -1).max(axis=1)
    err = np.abs(dU.numpy() - np.asarray(rdU)).reshape(cfg.nvar, -1).max(axis=1)
    # float32 rounding of the same formulas, scaled per variable
    assert float((err / scale).max()) < 2e-5


def test_supports_and_unported_configs():
    """The kernels' scope is the Cartesian scope of the Pallas gate: Euler
    with HLL/linear/Roe-CV/Roe-PV, MHD and GLM with those and HLLD; the
    other solvers, cylindrical grids, the H-correction and 1D stay out.
    Cylindrical grids and the H-correction still raise in the plain sweep;
    Euler with HLLD raises the reference's ``ValueError``."""
    cfg = to_port(*(lambda r: (r, noisy_state(r, 0)))(ref_config("glm3d")))[0]
    assert fused_sweep.supports(cfg)
    S = pion_tpu_torch.SimConfig
    box2 = dict(ndim=2, shape=(8, 8), xmin=(0, 0), xmax=(1, 1),
                bcs=(("outflow", "outflow"),) * 2)
    for solver in ("hll", "linear", "roe", "roe_pv"):
        assert fused_sweep.supports(S(eqn="euler", solver=solver, **box2))
        assert fused_sweep.supports(S(eqn="mhd", solver=solver, **box2))
        assert fused_sweep.supports(S(eqn="glm", solver=solver, av="falle",
                                      **box2))
    assert not fused_sweep.supports(S(eqn="euler", solver="hlld", **box2))
    for solver in ("lf", "exact", "hybrid", "fvs"):
        assert not fused_sweep.supports(S(eqn="euler", solver=solver, **box2))
        assert not fused_sweep.supports(S(eqn="mhd", solver=solver, **box2))
    # roe_pv runs the linear solver for MHD (the same kernel build), and the
    # distinct Roe-mean solver for Euler
    assert fused_sweep.kernel_solver(S(eqn="mhd", solver="roe_pv", **box2)) \
        is pion_tpu_torch.Solver.LINEAR
    assert fused_sweep.kernel_solver(S(eqn="euler", solver="roe_pv",
                                       **box2)) is pion_tpu_torch.Solver.RPV
    assert not fused_sweep.supports(S(eqn="mhd", solver="hll",
                                      coords="cylindrical", **box2))
    assert not fused_sweep.supports(S(eqn="euler", solver="hll", av="hcorr",
                                      **box2))
    assert not fused_sweep.supports(
        S(ndim=1, eqn="euler", solver="hll", shape=(8,), xmin=(0,),
          xmax=(1,), bcs=(("outflow", "outflow"),)))
    euler_hlld = S(eqn="euler", solver="hlld", **box2)
    with pytest.raises(ValueError, match="hydro solver"):
        sweep.dynamics_dU(torch.ones((5, 12, 12), dtype=torch.float64),
                          euler_hlld, pion_tpu_torch.make_geometry(euler_hlld),
                          DT, 1)
    cyl = S(eqn="mhd", solver="hll", coords="cylindrical", **box2)
    with pytest.raises(NotImplementedError):
        sweep.dynamics_dU(torch.ones((8, 12, 12), dtype=torch.float64), cyl,
                          pion_tpu_torch.make_geometry(cyl), DT, 1)
    hc = S(eqn="euler", solver="roe", av="hcorr", **box2)
    with pytest.raises(NotImplementedError):
        sweep.dynamics_dU(torch.ones((5, 12, 12), dtype=torch.float64), hc,
                          pion_tpu_torch.make_geometry(hc), DT, 1)
    with pytest.raises(ValueError):
        S(kernels="interpret", **box2)
