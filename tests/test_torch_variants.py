"""pion_tpu_torch.microphysics.variants (MPv5, MPv6) against the JAX
package's, CPU, float64, seeded numpy inputs.

MPv5 overrides ``ydot`` (Henney+09 molecular terms), so both packages keep it
off the kernels built from MPv3's formulas and integrate it with the
whole-grid ladder; MPv6 is MPv3 with He = Z = 0 and takes the kernels, so its
plain kernel versions are held against the Pallas kernels in interpret mode
as well.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pion_tpu.constants import RSUN
from pion_tpu.microphysics import MPv3Config as RefMPv3Config
from pion_tpu.microphysics import MPv5 as RefMPv5
from pion_tpu.microphysics import MPv6 as RefMPv6
from pion_tpu.microphysics.pallas_mpv3 import update_pallas, ydot_pallas

from pion_tpu_torch import convert
from pion_tpu_torch.constants import PG
from pion_tpu_torch.microphysics import MPv5, MPv6, fused_mpv3

from test_torch_mpv3 import (SLOT, SMALL, _cfgs, both, cells, prim_state,
                             soft_err)

torch.set_num_threads(1)

PAIRS = {"MPv5": (RefMPv5, MPv5), "MPv6": (RefMPv6, MPv6)}
TOL = 1e-10


def pair(name, ion, n_diff=0):
    """The reference module and the port's, from the same config."""
    ref_cls, cls = PAIRS[name]
    mf = ion == "mfion"
    ref = ref_cls(RefMPv3Config(
        tracer_slot=SLOT, ion_src=ion, n_idot=1e48,
        tstar=3.75e4 if mf else 0.0, rstar_cm=10 * RSUN if mf else 0.0,
        min_temperature=50.0, n_diff_srcs=n_diff))
    mp = cls(convert.mp_config_from_reference(
        "MPv3", dataclasses.asdict(ref.mpc)))
    return ref, mp


@pytest.mark.parametrize("name", ["MPv5", "MPv6"])
@pytest.mark.parametrize("ion,k,n_diff", [
    (None, 1, 1), ("mono", 2, 1), ("mfion", 1, 0), ("mfion", 2, 1)])
def test_ydot_matches_reference(name, ion, k, n_diff):
    """ydot against the JAX package's: the same formulas in the same order,
    1e-10."""
    ref, mp = pair(name, ion, n_diff)
    (jo, je, jn, jrt), (to, te, tn, trt) = both(cells(mp.mpc, SMALL, k, 31))
    r0, r1 = ref.ydot(jo, je, jn, jrt)
    g0, g1 = mp.ydot(to, te, tn, trt)
    assert g0.dtype == torch.float64 and g0.shape == SMALL
    assert soft_err(g0, r0) < TOL and soft_err(g1, r1) < TOL


@pytest.mark.parametrize("name", ["MPv5", "MPv6"])
@pytest.mark.parametrize("ion", ["mono", "mfion"])
def test_update_matches_reference(name, ion):
    """``update`` at dt = 1e3 s (Newton converges) through the whole-grid
    ladder in both packages (MPv6 with ``kernels="off"``, MPv5 whatever the
    setting), 1e-10; the other variables are passed through exactly."""
    ref, mp = pair(name, ion)
    rcfg, cfg = _cfgs((4, 8, 16))
    P, rt = prim_state(mp.mpc, (4, 8, 16), 32)
    jrt, trt = both(rt)
    r = np.asarray(ref.update(jnp.asarray(P), 1.0e3, rcfg, jrt))
    g = mp.update(torch.from_numpy(P.copy()), 1.0e3, cfg, trt)
    assert soft_err(g[SLOT], r[SLOT]) < TOL and soft_err(g[PG], r[PG]) < TOL
    for v in range(10):
        if v not in (PG, SLOT):
            assert np.array_equal(g[v].numpy(), r[v])
    if name == "MPv5":
        # no kernel of MPv3's formulas for MPv5: "auto" is the same ladder
        auto = dataclasses.replace(cfg, kernels="auto")
        assert torch.equal(mp.update(torch.from_numpy(P.copy()), 1.0e3,
                                     auto, trt), g)


@pytest.mark.parametrize("name", ["MPv5", "MPv6"])
def test_timescales_match_reference(name):
    ref, mp = pair(name, "mfion", 1)
    rcfg, cfg = _cfgs((4, 8, 16))
    P, rt = prim_state(mp.mpc, (4, 8, 16), 33)
    rt["g0_uv"], rt["g0_ir"] = rt["g0_uv"] * 0 + 5.0, rt["g0_ir"] * 0 + 3.0
    jrt, trt = both(rt)
    r = float(ref.timescales(jnp.asarray(P), rcfg, jrt))
    g = mp.timescales(torch.from_numpy(P), cfg, trt)
    assert g.ndim == 0
    np.testing.assert_allclose(float(g), r, rtol=TOL)


def test_the_gate_and_mpv6_on_the_kernels_plain_versions():
    """MPv6 keeps MPv3's rate assembly and takes B3/B4 (the kernels read its
    n_ion = n_elec = 1 and zero metallicity from its config); MPv5 does not.
    The kernels' plain versions on MPv6 against the Pallas kernels in
    interpret mode: ydot 1e-9, update at dt = 1e3 s 1e-9 (the tolerances of
    the MPv3 tests, the TPU kernel interpolating on its hat basis)."""
    _, cfg = _cfgs((4, 8, 16))
    auto = dataclasses.replace(cfg, kernels="auto")
    ref, mp = pair("MPv6", "mfion")
    assert mp._use_fused(auto) and not mp._use_fused(cfg)
    assert not pair("MPv5", "mfion")[1]._use_fused(auto)
    c = mp.mpc
    assert (c.helium_mass_frac, c.metal_mass_frac) == (0.0, 0.0)
    assert (c.n_ion, c.n_elec, c.metallicity) == (1.0, 1.0, 0.0)
    (jo, je, jn, jrt), (to, te, tn, trt) = both(cells(c, SMALL, 1, 34))
    r0, r1 = ydot_pallas(ref, jo, je, jn, jrt, interpret=True)
    g0, g1 = fused_mpv3.ydot_plain(mp, to, te, tn, trt)
    assert soft_err(g0, r0) < 1e-9 and soft_err(g1, r1) < 1e-9
    ro, re = update_pallas(ref, jo, je, jn, jnp.float64(1.0e3), jrt,
                           interpret=True)
    go, ge = fused_mpv3.update_plain(mp, to, te, tn, 1.0e3, trt)
    assert soft_err(go, ro) < 1e-9 and soft_err(ge, re) < 1e-9
