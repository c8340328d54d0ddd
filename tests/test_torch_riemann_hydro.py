"""pion_tpu_torch.ops.riemann_hydro against pion_tpu.ops.riemann_hydro."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.constants import PG, RO
from pion_tpu.ops import riemann_hydro as ref_rh

from pion_tpu_torch.ops import riemann_hydro as rh

from test_torch_eqns import close, to_port

torch.set_num_threads(1)

RTOL = 1e-12   # same formulas in the same order; only libm differs


def _interfaces(nvar, seed, n=2048):
    """Random left/right states from strongly supersonic to the left to
    strongly supersonic to the right, with pressure jumps of up to 20 (so
    that shocks and rarefactions, the hybrid switch and both sides of the
    contact all occur)."""
    rng = np.random.default_rng(seed)

    def side():
        P = 0.5 * rng.standard_normal((nvar, n))
        P[RO] = rng.uniform(0.2, 2.0, n)
        P[PG] = rng.uniform(0.1, 2.0, n)
        return P

    Pl, Pr = side(), side()
    drift = np.linspace(-6.0, 6.0, n)
    Pl[2] += drift
    Pr[2] += drift
    return Pl, Pr


def _cfg(n=2048):
    return pion_tpu.SimConfig(ndim=1, eqn="euler", solver="hll", ntracer=1,
                              shape=(n,), xmin=(0.0,), xmax=(1.0,),
                              bcs=(("outflow", "outflow"),), gamma=1.4,
                              rho_ref=0.7, p_ref=0.3)


def _both(seed):
    rcfg = _cfg()
    Pl, Pr = _interfaces(rcfg.nvar, seed)
    cfg, Plt, _ = to_port(rcfg, Pl)
    return rcfg, cfg, Pl, Pr, Plt, torch.from_numpy(Pr)


SOLVERS = ["hll", "roe_cv", "linear_pv", "roe_pv", "exact", "hybrid", "fvs",
           "lax_friedrichs"]


@pytest.mark.parametrize("name", SOLVERS)
def test_solver(name):
    """Flux and interface state of every Euler solver at 1e-12."""
    rcfg, cfg, Pl, Pr, Plt, Prt = _both(SOLVERS.index(name))
    args = (3.7,) if name == "lax_friedrichs" else ()
    f, p = getattr(rh, name)(Plt, Prt, cfg, *args)
    fr, pr = getattr(ref_rh, name)(jnp.asarray(Pl), jnp.asarray(Pr), rcfg,
                                   *args)
    assert f.shape == tuple(fr.shape) and p.shape == tuple(pr.shape)
    assert torch.isfinite(f).all() and torch.isfinite(p).all()
    close(f, fr, rtol=RTOL, atol=1e-12)
    close(p, pr, rtol=RTOL, atol=1e-12)


def test_exact_pstar():
    rcfg, cfg, Pl, Pr, Plt, Prt = _both(11)
    p, v = rh.exact_pstar(Plt, Prt, cfg)
    pr, vr = ref_rh.exact_pstar(jnp.asarray(Pl), jnp.asarray(Pr), rcfg)
    close(p, pr, rtol=RTOL, atol=1e-14)
    close(v, vr, rtol=RTOL, atol=1e-12)
    assert bool((p > 0).all())
    # both wave branches of f_K are taken
    assert int((p > Plt[PG]).sum()) > 100 and int((p < Plt[PG]).sum()) > 100


def test_roe_cv_with_hcorrection_floor():
    """The H-correction's eigenvalue floor (``hc_eta``), which the sweep
    passes once the H-correction is ported."""
    rcfg, cfg, Pl, Pr, Plt, Prt = _both(12)
    eta = np.random.default_rng(13).uniform(0.0, 2.0, Pl.shape[1])
    f, p = rh.roe_cv(Plt, Prt, cfg, torch.from_numpy(eta))
    fr, pr = ref_rh.roe_cv(jnp.asarray(Pl), jnp.asarray(Pr), rcfg,
                           jnp.asarray(eta))
    close(f, fr, rtol=RTOL, atol=1e-12)
    close(p, pr, rtol=RTOL, atol=1e-12)
    assert not torch.equal(f, rh.roe_cv(Plt, Prt, cfg)[0])


def test_exact_solver_cavitation_branch():
    """Vacuum-generating data (u_R - u_L >= 2(c_L+c_R)/(g-1)) through the
    exact solver, as ``tests/test_shocktube.py`` builds them, beside
    supersonic and fan-sampled cavitating pairs: every arm of
    ``_sample_cavitation``."""
    cases = [(-4.0, 4.0), (5.0, 20.0), (-20.0, -5.0), (-1.0, 8.0),
             (-8.0, 1.0), (-2.0, 6.0)]
    rcfg = _cfg(len(cases))
    Pl = np.zeros((rcfg.nvar, len(cases)))
    Pr = np.zeros_like(Pl)
    Pl[RO] = Pr[RO] = 1.0
    Pl[PG] = Pr[PG] = 0.4
    Pl[2] = [c[0] for c in cases]
    Pr[2] = [c[1] for c in cases]
    Pl[3], Pr[3] = 0.3, -0.2
    Pl[5], Pr[5] = 0.25, 0.75
    cfg, Plt, _ = to_port(rcfg, Pl)
    Prt = torch.from_numpy(Pr)
    f, p = rh.exact(Plt, Prt, cfg)
    fr, pr = ref_rh.exact(jnp.asarray(Pl), jnp.asarray(Pr), rcfg)
    assert torch.isfinite(f).all() and torch.isfinite(p).all()
    close(f, fr, rtol=RTOL, atol=1e-14)
    close(p, pr, rtol=RTOL, atol=1e-14)
    cav = rh._sample_cavitation(Plt, Prt, cfg)
    close(cav, ref_rh._sample_cavitation(jnp.asarray(Pl), jnp.asarray(Pr),
                                         rcfg), rtol=RTOL, atol=1e-14)
    # the cavity over the interface holds the vacuum floor
    assert float(p[RO, 0]) == pytest.approx(1.0e-5 * 0.7)
    assert float(p[PG, 0]) == pytest.approx(1.0e-5 * 0.3)
    # everything moving right: the left input state
    close(p[:5, 1], Pl[:5, 1], rtol=1e-12)


def test_roe_average_state():
    rcfg, cfg, Pl, Pr, Plt, Prt = _both(14)
    got = rh.roe_average_state(Plt, Prt, cfg)
    ref = ref_rh.roe_average_state(jnp.asarray(Pl), jnp.asarray(Pr), rcfg)
    for a, b in zip(got, ref):
        close(a, b, rtol=RTOL, atol=1e-14)
