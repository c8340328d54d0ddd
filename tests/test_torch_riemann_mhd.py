"""pion_tpu_torch.ops.riemann_mhd against pion_tpu.ops.riemann_mhd."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.ops import riemann_mhd as ref_rm

from pion_tpu_torch.ops import riemann_mhd as rm

from test_torch_eqns import close, to_port

torch.set_num_threads(1)

RTOL = 1e-12   # same formulas in the same order; only libm differs


def _interfaces(nvar, seed, n=4096):
    """Random left/right states covering every HLLD region: normal
    velocities from strongly supersonic to the left to strongly supersonic
    to the right, and a block of bx == 0 interfaces."""
    rng = np.random.default_rng(seed)

    def side():
        P = 0.5 * rng.standard_normal((nvar, n))
        P[0] = rng.uniform(0.2, 2.0, n)
        P[1] = rng.uniform(0.1, 2.0, n)
        return P

    Pl, Pr = side(), side()
    drift = np.linspace(-6.0, 6.0, n)
    Pl[2] += drift
    Pr[2] += drift
    Pl[5, :256] = 0.0
    Pr[5, :256] = 0.0
    if nvar > 8:             # the sweep zeroes psi before the solve
        Pl[8] = 0.0
        Pr[8] = 0.0
    return Pl, Pr


def _cfg(eqn):
    return pion_tpu.SimConfig(ndim=1, eqn=eqn, solver="hlld", ntracer=1,
                              shape=(4096,), xmin=(0.0,), xmax=(1.0,),
                              bcs=(("outflow", "outflow"),))


@pytest.mark.parametrize("eqn", ["mhd", "glm"])
def test_hll(eqn):
    rcfg = _cfg(eqn)
    Pl, Pr = _interfaces(rcfg.nvar, 0)
    cfg, Plt, _ = to_port(rcfg, Pl)
    Prt = torch.from_numpy(Pr)
    f, u = rm.hll(Plt, Prt, cfg)
    fr, ur = ref_rm.hll(jnp.asarray(Pl), jnp.asarray(Pr), rcfg)
    close(f, fr, rtol=RTOL, atol=1e-13)
    close(u, ur, rtol=RTOL, atol=1e-13)


@pytest.mark.parametrize("eqn", ["mhd", "glm"])
def test_hlld_every_region(eqn):
    rcfg = _cfg(eqn)
    Pl, Pr = _interfaces(rcfg.nvar, 1)
    cfg, Plt, _ = to_port(rcfg, Pl)
    Prt = torch.from_numpy(Pr)
    sl, sr = rm._signal_speeds(Plt, Prt, cfg)
    slr, srr = ref_rm._signal_speeds(jnp.asarray(Pl), jnp.asarray(Pr), rcfg)
    close(sl, slr, rtol=RTOL)
    close(sr, srr, rtol=RTOL)
    # supersonic to the right, to the left, and the subsonic fan between
    assert int((sl > 0).sum()) > 50 and int((sr < 0).sum()) > 50
    assert int(((sl < 0) & (sr > 0)).sum()) > 500
    f, u = rm.hlld(Plt, Prt, cfg)
    fr, ur = ref_rm.hlld(jnp.asarray(Pl), jnp.asarray(Pr), rcfg)
    assert torch.isfinite(f).all() and torch.isfinite(u).all()
    close(f, fr, rtol=RTOL, atol=1e-12)
    close(u, ur, rtol=RTOL, atol=1e-12)
    # the six regions give six different fluxes: the select is exercised
    fl = rm.flux_from_prim(Plt, cfg)
    assert int(((f - fl).abs().amax(dim=0) == 0).sum()) == int((sl > 0).sum())


@pytest.mark.parametrize("eqn", ["mhd", "glm"])
def test_hlld_with_hll_fallback_random_mask(eqn):
    rcfg = _cfg(eqn)
    Pl, Pr = _interfaces(rcfg.nvar, 2)
    mask = np.random.default_rng(3).random(Pl.shape[1]) < 0.4
    cfg, Plt, _ = to_port(rcfg, Pl)
    Prt = torch.from_numpy(Pr)
    f, u = rm.hlld_with_hll_fallback(Plt, Prt, cfg, torch.from_numpy(mask))
    fr, ur = ref_rm.hlld_with_hll_fallback(jnp.asarray(Pl), jnp.asarray(Pr),
                                           rcfg, jnp.asarray(mask))
    close(f, fr, rtol=RTOL, atol=1e-12)
    close(u, ur, rtol=RTOL, atol=1e-12)
    # flagged interfaces carry the HLL flux, the others the HLLD flux
    fh, _ = rm.hll(Plt, Prt, cfg)
    fd, _ = rm.hlld(Plt, Prt, cfg)
    m = torch.from_numpy(mask)
    assert torch.equal(f[:, m], fh[:, m]) and torch.equal(f[:, ~m], fd[:, ~m])
    f0, u0 = rm.hlld_with_hll_fallback(Plt, Prt, cfg, None)
    assert torch.equal(f0, fd)
