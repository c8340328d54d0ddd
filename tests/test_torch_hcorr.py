"""The H-correction (Sanders, Morano & Druguet 1998) of the port's plain sweep
against the JAX package on the same seeded inputs: the per-cell eta, the
eta of each interface's H-stencil and the sweep's dU and face fluxes on
every axis, for Euler and MHD Roe-CV at orders 1 and 2 on Cartesian 2D/3D
and 2D cylindrical grids; two steps of a 2-level hierarchy with
``hcorr_falle``; and HLL, which reads no eta, with ``hcorr_falle`` equal to
HLL with ``falle`` bit for bit.  CPU, float64."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.boundaries import BoundaryData as RefBoundaryData
from pion_tpu.boundaries import apply_bcs as ref_apply_bcs
from pion_tpu.ops import sweep as ref_sweep

import pion_tpu_torch
from pion_tpu_torch import Simulation
from pion_tpu_torch.boundaries import apply_bcs
from pion_tpu_torch.ops import fused_sweep, sweep

from test_torch_eqns import noisy_state, to_port
from test_torch_ng import hier_pair, scales

torch.set_num_threads(1)

DT = 1.0e-3
RTOL = 1e-10

GRIDS = {
    "cart2d": dict(ndim=2, shape=(12, 16), xmin=(0.0, 0.0),
                   xmax=(0.75, 1.0), bcs=(("outflow", "outflow"),) * 2),
    "cart3d": dict(ndim=3, shape=(6, 8, 10), xmin=(0.0, 0.0, 0.0),
                   xmax=(0.6, 0.8, 1.0), bcs=(("outflow", "outflow"),) * 3),
    "cyl2d": dict(ndim=2, shape=(12, 16), coords="cylindrical",
                  xmin=(0.0, -0.5), xmax=(0.75, 0.5),
                  bcs=(("axisymmetric", "outflow"), ("outflow", "outflow"))),
}


def ref_config(grid, eqn, av="hcorr", **kw):
    base = dict(eqn=eqn, solver="roe", ntracer=1, av=av, etav=0.15,
                cfl=0.3, ooa=2, dtype="float64",
                gamma=1.4 if eqn == "euler" else 5.0 / 3.0)
    base.update(GRIDS[grid])
    base.update(kw)
    return pion_tpu.SimConfig(**base)


def setup(rcfg, seed):
    P = noisy_state(rcfg, seed)
    cfg, Pt, bd = to_port(rcfg, P)
    rPpad = ref_apply_bcs(jnp.asarray(P), rcfg, RefBoundaryData())
    Ppad = apply_bcs(Pt, cfg, bd)
    assert np.array_equal(Ppad.numpy(), np.asarray(rPpad))
    return (cfg, pion_tpu.make_geometry(rcfg),
            pion_tpu_torch.make_geometry(cfg), rPpad, Ppad)


def held(out, ref, rtol=RTOL):
    """|out - ref| <= rtol times the largest |ref| of each variable."""
    out = out.numpy()
    ref = np.asarray(ref)
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1)
    err = np.abs(out - ref).reshape(ref.shape[0], -1).max(axis=1)
    assert (err <= rtol * np.maximum(scale, 1e-300)).all(), \
        (err / scale).max()


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("eqn", ["euler", "mhd"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_eta_and_sweep_match_reference(grid, eqn, order):
    """Roe-CV with the H-correction: the padded per-cell eta of every axis,
    the interface eta of every axis's H-stencil (laid out as the port's
    interfaces are: the sweep axis in its own position), and dU with every
    axis's face fluxes."""
    av = "hcorr_falle" if grid == "cart3d" else "hcorr"
    rcfg = ref_config(grid, eqn, av=av)
    cfg, rgeom, geom, rPpad, Ppad = setup(rcfg, 3)
    etas = sweep.calc_hcorr_eta(Ppad, cfg, geom, order)
    retas = ref_sweep.calc_hcorr_eta(rPpad, rcfg, rgeom, order)
    assert len(etas) == len(retas) == cfg.ndim
    for axis in range(cfg.ndim):
        assert tuple(etas[axis].shape) == tuple(Ppad.shape[1:])
        np.testing.assert_allclose(etas[axis].numpy(),
                                   np.asarray(retas[axis]), rtol=RTOL,
                                   atol=1e-14)
        n = cfg.shape[axis]
        sel = sweep._select_hcorr_eta(etas, cfg, axis, n)
        rsel = ref_sweep._select_hcorr_eta(retas, rcfg, axis, n)
        want = list(cfg.shape)
        want[axis] = n + 1
        assert tuple(sel.shape) == tuple(want)
        np.testing.assert_allclose(sel.numpy(), np.asarray(rsel), rtol=RTOL,
                                   atol=1e-14)
    dU, faces = sweep.dynamics_dU(Ppad, cfg, geom, DT, order, ch=1.0)
    rdU, rfaces = ref_sweep.dynamics_dU(rPpad, rcfg, rgeom, DT, order, ch=1.0)
    held(dU, rdU)
    for f, rf in zip(faces, rfaces):
        held(f, rf)
    # the eta is active: without the H-correction the Roe fluxes differ
    plain = dataclasses.replace(
        cfg, av="falle" if av == "hcorr_falle" else "none")
    dU0, _ = sweep.dynamics_dU(Ppad, plain, geom, DT, order, ch=1.0)
    assert not torch.equal(dU, dU0)


def test_hll_reads_no_eta():
    """HLL with ``hcorr_falle`` is HLL with ``falle`` bit for bit (only the
    Roe-CV solvers read the eta), in the sweep and through two steps of a
    run on the plain sweep.  ``fused_sweep.supports`` keeps the
    H-correction out of the kernels, as the Pallas gate does, so with
    ``kernels="auto"`` the run is the one with ``kernels="off"``, bit for
    bit."""
    rcfg = ref_config("cart2d", "glm", av="hcorr_falle", solver="hll")
    cfg, _, geom, _, Ppad = setup(rcfg, 4)
    assert not fused_sweep.supports(cfg) and cfg.kernels == "auto"
    falle = dataclasses.replace(cfg, av="falle", kernels="off")
    a, fa = sweep.dynamics_dU(Ppad, cfg, geom, DT, 2, ch=1.0)
    b, fb = sweep.dynamics_dU(Ppad, falle, geom, DT, 2, ch=1.0)
    assert torch.equal(a, b) and all(torch.equal(x, y)
                                     for x, y in zip(fa, fb))
    P = torch.from_numpy(noisy_state(rcfg, 5))
    runs = [Simulation(c, P, device="cpu").run(max_steps=2)
            for c in (cfg, dataclasses.replace(cfg, kernels="off"), falle)]
    assert all(r.step_count == 2 and r.t == runs[0].t for r in runs)
    assert all(torch.equal(r.P, runs[0].P) for r in runs[1:])


def test_simulation_with_hcorrection_matches_reference():
    """A Roe-CV + ``hcorr_falle`` run is built and takes two steps equal to
    the JAX package's ``Simulation`` (which raised at build time in the
    earlier slices of the port)."""
    rcfg = ref_config("cart2d", "euler", av="hcorr_falle", tmax=1.0)
    P = noisy_state(rcfg, 6)
    ref = pion_tpu.Simulation(rcfg, jnp.asarray(P)).run(max_steps=2)
    cfg, Pt, _ = to_port(rcfg, P)
    sim = Simulation(cfg, Pt, device="cpu").run(max_steps=2)
    assert sim.step_count == ref.step_count == 2
    np.testing.assert_allclose(sim.t, ref.t, rtol=1e-12)
    held(sim.P, ref.P, rtol=1e-9)


def test_hierarchy_with_hcorrection_two_steps():
    """Two steps of a 2-level GLM-MHD Roe-CV hierarchy with ``hcorr_falle``
    against the JAX package's: every level takes the plain sweep, which
    keeps its face fluxes for BC89."""
    ref, hier, _ = hier_pair("2d-centred", seed=7, solver="roe",
                             av="hcorr_falle", etav=0.15)
    dts = [hier.step() for _ in range(2)]
    rdts = [ref.step() for _ in range(2)]
    np.testing.assert_allclose(dts, rdts, rtol=1e-12)
    for l in range(2):
        want = np.asarray(ref.P[l])
        err = np.abs(hier.P[l].numpy() - want) / scales(want)
        assert err.max() <= 1e-9, (l, err.max())
