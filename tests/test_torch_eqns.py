"""pion_tpu_torch.ops.eqns against pion_tpu.ops.eqns on the same inputs.

Also holds the helpers the other ``test_torch_*`` files share: seeded numpy
inputs that go through the JAX package as they are and reach the port through
``convert.from_reference``.  Everything runs on the CPU in float64 unless a
test says otherwise.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.ics.blast import blast_wave as ref_blast_wave
from pion_tpu.ops import eqns as ref_eqns

from pion_tpu_torch import convert
from pion_tpu_torch.ops import eqns

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def ref_config(case: str, dtype: str = "float64", **kw) -> pion_tpu.SimConfig:
    """The reference package's config of a named small case."""
    if case == "glm3d":      # the flagship config, narrow
        base = dict(ndim=3, eqn="glm", solver="hlld", ntracer=1,
                    shape=(8, 8, 32), xmin=(0, 0, 0),
                    xmax=(8 / 32, 8 / 32, 1), av="falle", etav=0.1)
    elif case == "mhd2d":
        base = dict(ndim=2, eqn="mhd", solver="hll", ntracer=0,
                    shape=(16, 32), xmin=(0, 0), xmax=(16 / 32, 1),
                    av="falle")
    elif case == "glm2d":
        base = dict(ndim=2, eqn="glm", solver="hlld", ntracer=2,
                    shape=(16, 32), xmin=(0, 0), xmax=(16 / 32, 1),
                    av="none")
    else:
        raise ValueError(case)
    base.update(bcs=(("outflow", "outflow"),) * base["ndim"], cfl=0.3, ooa=2,
                dtype=dtype)
    base.update(kw)
    return pion_tpu.SimConfig(**base)


def noisy_state(rcfg, seed: int) -> np.ndarray:
    """Blast wave plus seeded noise on velocities, field and psi, tracers
    random in [0, 1]: the plain blast hides the tracer flux, the viscosity
    and the upwind branches."""
    rng = np.random.default_rng(seed)
    P = ref_blast_wave(rcfg, B0=(0.1, 0.05, 0.02))
    P[2:5] += 0.1 * rng.standard_normal((3,) + rcfg.shape)
    if rcfg.eqn.is_mhd:
        P[5:8] += 0.02 * rng.standard_normal((3,) + rcfg.shape)
    if rcfg.eqn.value == "glm":
        P[8] = 0.01 * rng.standard_normal(rcfg.shape)
    for v in range(rcfg.eqn.nbase, rcfg.nvar):
        P[v] = rng.random(rcfg.shape)
    return P.astype(rcfg.np_dtype)


def to_port(rcfg, P: np.ndarray, fixed=None):
    """(cfg, tensor, bdata) of the port from the reference's config and a
    numpy state, on the CPU."""
    return convert.from_reference(dataclasses.asdict(rcfg), P, fixed=fixed,
                                  device="cpu")


def close(out, ref, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _random_prim(rcfg, n, seed):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((rcfg.nvar, n))
    P[0] = rng.uniform(0.1, 2.0, n)
    P[1] = rng.uniform(0.05, 3.0, n)
    return P


def _eqn_cfg(eqn):
    return pion_tpu.SimConfig(ndim=1, eqn=eqn, ntracer=2, shape=(64,),
                              xmin=(0.0,), xmax=(1.0,),
                              bcs=(("outflow", "outflow"),), rho_ref=0.7,
                              p_ref=0.3)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eqn", ["euler", "mhd", "glm"])
def test_prim_cons_round_trip_and_floors(eqn):
    rcfg = _eqn_cfg(eqn)
    P = _random_prim(rcfg, 64, 1)
    cfg, Pt, _ = to_port(rcfg, P)
    U = eqns.prim_to_cons(Pt, cfg)
    U_ref = ref_eqns.prim_to_cons(jnp.asarray(P), rcfg)
    close(U, U_ref, rtol=1e-13)
    close(eqns.cons_to_prim(U, cfg), P, rtol=1e-11, atol=1e-13)
    # a cell with negative density and one with negative pressure
    Ub = np.asarray(U_ref).copy()
    Ub[0, 3] = -1.0
    Ub[1, 5] = -5.0
    back = eqns.cons_to_prim(torch.from_numpy(Ub), cfg)
    back_ref = ref_eqns.cons_to_prim(jnp.asarray(Ub), rcfg)
    close(back, back_ref, rtol=1e-13)
    assert back[0, 3] > 0 and back[1, 5] > 0 and back[1, 3] > 0


@pytest.mark.parametrize("eqn", ["euler", "mhd", "glm"])
def test_flux_and_wave_speeds(eqn):
    rcfg = _eqn_cfg(eqn)
    P = _random_prim(rcfg, 64, 2)
    P[5, :8] = 0.0          # bx == 0 cells
    cfg, Pt, _ = to_port(rcfg, P)
    Pj = jnp.asarray(P)
    U, Uj = eqns.prim_to_cons(Pt, cfg), ref_eqns.prim_to_cons(Pj, rcfg)
    close(eqns.flux_from_pu(Pt, U, cfg), ref_eqns.flux_from_pu(Pj, Uj, rcfg),
          rtol=1e-13)
    close(eqns.flux_from_prim(Pt, cfg), ref_eqns.flux_from_prim(Pj, rcfg),
          rtol=1e-13)
    close(eqns.maxspeed(Pt, cfg), ref_eqns.maxspeed(Pj, rcfg), rtol=1e-13)
    close(eqns.sound_speed(Pt, cfg), ref_eqns.sound_speed(Pj, rcfg),
          rtol=1e-13)
    close(eqns.e_total(Pt, cfg), ref_eqns.e_total(Pj, rcfg), rtol=1e-13)
    close(eqns.p_total(Pt, cfg), ref_eqns.p_total(Pj, rcfg), rtol=1e-13)
    if eqn != "euler":
        close(eqns.cfast_components(Pt[0], Pt[1], Pt[5], Pt[6], Pt[7],
                                    cfg.gamma),
              ref_eqns.cfast_components(Pj[0], Pj[1], Pj[5], Pj[6], Pj[7],
                                        rcfg.gamma), rtol=1e-13)
        close(eqns.cfast(Pt, cfg), ref_eqns.cfast(Pj, rcfg), rtol=1e-13)
        close(eqns.cslow(Pt, cfg), ref_eqns.cslow(Pj, rcfg), rtol=1e-13,
              atol=1e-150)


def test_wave_speeds_float32_keep_the_vanishing_guard():
    """MACHINE_EPS is 0 in float32 in both packages: where the slow speed
    vanishes both give exactly 0, not a floor."""
    rcfg = dataclasses.replace(_eqn_cfg("mhd"), dtype="float32")
    P = _random_prim(rcfg, 64, 3).astype(np.float32)
    P[6:8] = 0.0
    P[5] = 0.0               # no field at all: c_slow == 0
    cfg, Pt, _ = to_port(rcfg, P)
    out = eqns.cslow(Pt, cfg)
    ref = ref_eqns.cslow(jnp.asarray(P), rcfg)
    assert out.dtype == torch.float32
    close(out, ref, rtol=1e-6)
    assert float(out.abs().max()) == 0.0


@pytest.mark.parametrize("ndim,axis", [(1, 0), (2, 0), (2, 1), (3, 0),
                                       (3, 1), (3, 2)])
@pytest.mark.parametrize("eqn", ["euler", "glm"])
def test_sweep_perm(eqn, ndim, axis):
    rcfg = pion_tpu.SimConfig(ndim=ndim, eqn=eqn, ntracer=1,
                              shape=(8,) * ndim, xmin=(0.0,) * ndim,
                              xmax=(1.0,) * ndim,
                              bcs=(("outflow", "outflow"),) * ndim)
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    perm = eqns.sweep_perm(cfg, axis)
    assert np.array_equal(perm, ref_eqns.sweep_perm(rcfg, axis))
    inv = eqns.inverse_perm(perm)
    assert np.array_equal(inv, ref_eqns.inverse_perm(perm))
    A = torch.arange(cfg.nvar * 3, dtype=torch.float64).reshape(cfg.nvar, 3)
    assert torch.equal(eqns.permute(eqns.permute(A, perm), inv), A)


def test_convert_round_trip_and_rejects_unknown_keys():
    rcfg = ref_config("glm3d", pallas="off")
    P = noisy_state(rcfg, 0)
    cfg, Pt, bd = to_port(rcfg, P)
    assert cfg.kernels == "off" and cfg.eqn.value == "glm"
    assert to_port(ref_config("glm3d", pallas="interpret"), P)[0].kernels == "auto"
    d, P_back, fixed = convert.to_reference(cfg, Pt, bd)
    assert d["pallas"] == "off" and "kernels" not in d
    assert pion_tpu.SimConfig(**d) == rcfg
    assert np.array_equal(P_back, P) and fixed == {}
    with pytest.raises(ValueError, match="no_such_key"):
        convert.from_reference(dict(dataclasses.asdict(rcfg), no_such_key=1), P)
    with pytest.raises(ValueError, match="shape"):
        convert.from_reference(dataclasses.asdict(rcfg), P[:, :4])
