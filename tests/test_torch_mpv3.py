"""pion_tpu_torch.microphysics (MPv3 and the fused kernels' plain versions)
against the JAX package on the same seeded inputs, CPU, float64.

Two integrators are held apart, as in the JAX package: the port's
``kernels="off"`` path against the JAX CPU path (one ladder for the whole
grid), and the plain versions of the CUDA kernels against the Pallas kernels
in interpret mode (one ladder per 1024-cell tile).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.constants import RSUN
from pion_tpu.microphysics import MPv3 as RefMPv3
from pion_tpu.microphysics import MPv3Config as RefMPv3Config
from pion_tpu.microphysics.pallas_mpv3 import update_pallas, ydot_pallas

from pion_tpu_torch import convert
from pion_tpu_torch.constants import K_B, PG, RO
from pion_tpu_torch.microphysics import MPv3, fused_mpv3
from pion_tpu_torch.microphysics.mpv3 import dtlimit_tier_params

torch.set_num_threads(1)

SLOT = 9           # x(H+) in a GLM state with one tracer
SMALL = (3, 20, 21)    # 1260 cells: two tiles, the second mostly padding


def pair(ion, n_diff=0, tier=6):
    """The reference module and the port's, built from its config dict."""
    mf = ion == "mfion"
    ref = RefMPv3(RefMPv3Config(
        tracer_slot=SLOT, ion_src=ion, n_idot=1e48,
        tstar=3.75e4 if mf else 0.0, rstar_cm=10 * RSUN if mf else 0.0,
        min_temperature=50.0, n_diff_srcs=n_diff, dtlimit_tier=tier))
    mp = MPv3(convert.mpv3_config_from_reference(dataclasses.asdict(ref.mpc)))
    return ref, mp


def cells(mpc, shape, k, seed):
    """Seeded numpy cell states and an rt dict with ``k`` ionizing sources
    (the inputs of the JAX package's own kernel tests, at float64)."""
    rng = np.random.default_rng(seed)
    nH = 10 ** rng.uniform(0, 4, shape)
    T = 10 ** rng.uniform(1.8, 6, shape)
    x = rng.uniform(1e-6, 1 - 1e-6, shape)
    E = (mpc.n_ion + mpc.n_elec * x) * nH * K_B * T / (mpc.gamma - 1.0)
    tau0 = 10 ** rng.uniform(-3, 2, shape)
    z = np.zeros(shape)
    ents = tuple({"tau0": tau0 * (1.0 + j), "ds": z + 3e16,
                  "nv": z + 1e-3 / (1 + j), "sv": z + 1e-3 / (1 + j)}
                 for j in range(k))
    rt = {"ion": ents, "g0_uv": rng.uniform(0, 50, shape),
          "g0_ir": rng.uniform(0, 50, shape)}
    return 1.0 - x, E, nH, rt


def both(tree):
    """A numpy tree as (jax tree, torch tree)."""
    def conv(f, v):
        if isinstance(v, dict):
            return {k: conv(f, w) for k, w in v.items()}
        if isinstance(v, tuple):
            return tuple(conv(f, w) for w in v)
        return f(v)
    return (conv(jnp.asarray, tree),
            conv(lambda a: torch.from_numpy(np.array(a)), tree))


def soft_err(out, ref):
    """max |out-ref| / max(|ref|, 1e-6 max|ref|): summed rates pass through
    zero, so a pointwise relative error means nothing there."""
    out, ref = np.asarray(out), np.asarray(ref)
    sc = np.maximum(np.abs(ref), np.abs(ref).max() * 1e-6)
    return float((np.abs(out - ref) / sc).max())


def prim_state(mpc, shape, seed, stiff_frac=None):
    """A primitive state (10 variables) from seeded cell values."""
    omx, E, nH, rt = cells(mpc, shape, 1, seed)
    P = np.zeros((10,) + shape)
    P[RO] = nH * mpc.mean_mass_per_h
    P[PG] = E * (mpc.gamma - 1.0)
    P[SLOT] = 1.0 - omx
    if stiff_frac is not None:
        # most of the grid shielded from the source: few cells are stiff
        far = np.random.default_rng(seed + 1).random(shape) > stiff_frac
        rt["ion"][0]["tau0"][far] = 1.0e6
    return P, rt


# ---------------------------------------------------------------------------
# the right-hand side
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ion,k,n_diff", [
    (None, 1, 0), (None, 1, 1), ("mono", 1, 0), ("mono", 2, 1),
    ("mfion", 1, 0), ("mfion", 2, 1)])
def test_ydot_matches_reference(ion, k, n_diff):
    """MPv3.ydot against the JAX package's (its gather branch on the CPU):
    the same formulas in the same order, 1e-11."""
    ref, mp = pair(ion, n_diff)
    (jo, je, jn, jrt), (to, te, tn, trt) = both(cells(mp.mpc, SMALL, k, 7))
    r0, r1 = ref.ydot(jo, je, jn, jrt)
    g0, g1 = mp.ydot(to, te, tn, trt)
    assert g0.dtype == torch.float64 and g0.shape == SMALL
    assert soft_err(g0, r0) < 1e-11 and soft_err(g1, r1) < 1e-11
    # a dict without "ion" is one source
    flat = dict(trt["ion"][0], g0_uv=trt["g0_uv"], g0_ir=trt["g0_ir"])
    if k == 1:
        h0, h1 = mp.ydot(to, te, tn, flat)
        assert torch.equal(h0, g0) and torch.equal(h1, g1)


@pytest.mark.parametrize("ion,k", [(None, 1), ("mono", 1), ("mono", 2),
                                   ("mfion", 1), ("mfion", 2)])
def test_ydot_plain_matches_pallas_interpret(ion, k):
    """The ydot kernel's plain version against ``ydot_pallas`` in interpret
    mode.  1e-9: the TPU kernel interpolates with hat functions on the grid
    exp(lnT0 + r dlnT), the port reads two rows of the stored grid."""
    ref, mp = pair(ion, 1)
    (jo, je, jn, jrt), (to, te, tn, trt) = both(cells(mp.mpc, SMALL, k, 8))
    r0, r1 = ydot_pallas(ref, jo, je, jn, jrt, interpret=True)
    g0, g1 = fused_mpv3.ydot_plain(mp, to, te, tn, trt)
    assert soft_err(g0, r0) < 1e-9 and soft_err(g1, r1) < 1e-9
    # on a CPU tensor the wrapper takes the plain version and counts nothing
    before = fused_mpv3.ydot.launches
    w0, w1 = fused_mpv3.ydot(mp, to, te, tn, trt)
    assert torch.equal(w0, g0) and torch.equal(w1, g1)
    assert fused_mpv3.ydot.launches == before


def test_per_source_tau_table_and_scalar_fields():
    """An entry's own tau table (an evolving star) and scalar rt fields go
    through the plain version as through the reference kernel."""
    ref, mp = pair("mfion")
    omx, E, nH, rt = cells(mp.mpc, SMALL, 1, 9)
    stack, _ = mp.set_multifreq_source_properties(3.0e4, 8 * RSUN)
    rt["ion"][0]["tau_stack"] = stack
    rt["ion"][0]["sv"] = 2.0e-3          # a scalar, broadcast
    (jo, je, jn, jrt), (to, te, tn, trt) = both((omx, E, nH, rt))
    r0, r1 = ydot_pallas(ref, jo, je, jn, jrt, interpret=True)
    g0, g1 = fused_mpv3.ydot_plain(mp, to, te, tn, trt)
    assert soft_err(g0, r0) < 1e-9 and soft_err(g1, r1) < 1e-9
    h0, _ = fused_mpv3.ydot_plain(mp, to, te, tn, both(cells(
        mp.mpc, SMALL, 1, 9))[1][3])
    assert not torch.allclose(h0, g0)


# ---------------------------------------------------------------------------
# the per-tile update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ion,dt,seed_f0,tol", [
    ("mfion", 1.0e9, False, 1e-5), ("mfion", 1.0e3, True, 1e-9),
    ("mono", 1.0e3, False, 1e-9)])
def test_update_plain_matches_pallas_interpret(ion, dt, seed_f0, tol):
    """The update kernel's plain version against ``update_pallas`` in
    interpret mode, on 1260 cells (two tiles, the second padded).

    At dt = 1e3 s the tiles take between 2 and 32 substeps and Newton
    converges: 1e-9.  At dt = 1e9 s every tile takes 32 substeps of 8 Newton
    iterations that do not converge, and that iterated map amplifies the
    last-bit differences of the two table lookups about 1e9 times: 1e-5."""
    ref, mp = pair(ion)
    (jo, je, jn, jrt), (to, te, tn, trt) = both(cells(mp.mpc, SMALL, 1, 44))
    jf0 = tf0 = None
    if seed_f0:
        tf0 = fused_mpv3.ydot_plain(mp, to, te, tn, trt)
        jf0 = tuple(jnp.asarray(f.numpy()) for f in tf0)
    ro, re = update_pallas(ref, jo, je, jn, jnp.float64(dt), jrt,
                           interpret=True, f0=jf0)
    go, ge, (tiles, newton) = fused_mpv3.update_plain(
        mp, to, te, tn, dt, trt, f0=tf0, return_stats=True)
    assert tiles == 2 and newton >= 2 * 2
    assert go.shape == SMALL and bool(torch.isfinite(ge).all())
    assert soft_err(go, ro) < tol and soft_err(ge, re) < tol
    if seed_f0:
        # the seeded first evaluation is the one the update would make
        ho, he = fused_mpv3.update_plain(mp, to, te, tn, dt, trt)
        assert torch.equal(ho, go) and torch.equal(he, ge)
        before = fused_mpv3.update.launches
        wo, we = fused_mpv3.update(mp, to, te, tn, dt, trt, f0=tf0)
        assert torch.equal(wo, go) and torch.equal(we, ge)
        assert fused_mpv3.update.launches == before


def test_quiescent_tiles_skip_the_ladder():
    """A tile with no cell past the Euler cutoff takes forward Euler alone;
    its neighbour's stiffness does not reach it."""
    _, mp = pair("mfion")
    omx, E, nH, rt = cells(mp.mpc, (2, 1024), 1, 12)
    rt["ion"][0]["tau0"][0] = 1.0e6          # first tile: shielded
    _, (to, te, tn, trt) = both((omx, E, nH, rt))
    f0, f1 = fused_mpv3.ydot_plain(mp, to, te, tn, trt)
    rate = torch.maximum((f0 / to).abs(), (f1 / te).abs()).amax(dim=1)
    dt = float(0.04 / rate[0])           # the first tile stays below 0.05
    assert float(rate[1]) * dt > 0.05
    go, ge, (tiles, _) = fused_mpv3.update_plain(mp, to, te, tn, dt, trt,
                                                 return_stats=True)
    assert tiles == 1
    assert torch.equal(go[0], (to + dt * f0)[0])
    assert torch.equal(ge[0], (te + dt * f1)[0])


# ---------------------------------------------------------------------------
# kernels="off": the whole-grid ladder, through update and timescales
# ---------------------------------------------------------------------------

def _cfgs(shape):
    rcfg = pion_tpu.SimConfig(
        ndim=3, eqn="glm", solver="hlld", ntracer=1, shape=shape,
        xmin=(0.0,) * 3, xmax=tuple(float(n) for n in shape),
        bcs=(("outflow", "outflow"),) * 3, pallas="off")
    return rcfg, convert.config_from_reference(dataclasses.asdict(rcfg))


@pytest.mark.parametrize("shape,stiff_frac", [
    ((4, 8, 16), None),        # 512 cells: the dense ladder
    ((8, 24, 24), 0.05),       # 4608 cells, ~5 % stiff: the compaction
])
def test_update_off_matches_reference(shape, stiff_frac):
    """``MPv3.update`` with ``kernels="off"`` against the JAX CPU path: one
    substep count and one Newton stopping test for the whole grid, the stiff
    cells compacted when the grid has more than 4096 cells (its pad lanes
    integrate a copy of the last cell).  dt = 1e3 s: Newton converges, 1e-9."""
    ref, mp = pair("mfion")
    rcfg, cfg = _cfgs(shape)
    assert cfg.kernels == "off"
    P, rt = prim_state(mp.mpc, shape, 21, stiff_frac)
    jrt, trt = both(rt)
    Pt = torch.from_numpy(P.copy())
    r = np.asarray(ref.update(jnp.asarray(P), 1.0e3, rcfg, jrt))
    g = mp.update(Pt, 1.0e3, cfg, trt)
    assert torch.equal(Pt, torch.from_numpy(P))      # the input is not written
    if stiff_frac is not None:
        # the test reaches the compaction: some cells stiff, fewer than 4096
        f0, f1 = mp.ydot(*mp.local_state(Pt), trt)
        o, e, _ = mp.local_state(Pt)
        n_stiff = int((torch.maximum((f0 * 1e3 / o).abs(),
                                     (f1 * 1e3 / e).abs()) >= 0.05).sum())
        assert 0 < n_stiff < 4096 < Pt[0].numel()
    assert soft_err(g[SLOT], r[SLOT]) < 1e-9
    assert soft_err(g[PG], r[PG]) < 1e-9
    for v in range(10):
        if v not in (PG, SLOT):
            assert np.array_equal(g[v].numpy(), r[v])


def test_update_without_sources_matches_reference():
    """No rt dict: the module's own defaults (no radiation), Euler only."""
    ref, mp = pair(None)
    rcfg, cfg = _cfgs((4, 8, 16))
    P, _ = prim_state(mp.mpc, (4, 8, 16), 22)
    r = np.asarray(ref.update(jnp.asarray(P), 10.0, rcfg))
    g = mp.update(torch.from_numpy(P), 10.0, cfg)
    assert soft_err(g[PG], r[PG]) < 1e-12 and soft_err(g[SLOT], r[SLOT]) < 1e-12


@pytest.mark.parametrize("tier", [2, 6, 10])
def test_timescales_match_reference(tier):
    """One tier of each class of ``dtlimit_tier_params`` (x only, + energy,
    + relative neutral fraction), with the ydot the limit was taken from."""
    assert [dtlimit_tier_params(t)[1:] for t in (2, 6, 10)] == [
        (False, False), (True, False), (True, True)]
    ref, mp = pair("mfion", tier=tier)
    rcfg, cfg = _cfgs((4, 8, 16))
    P, rt = prim_state(mp.mpc, (4, 8, 16), 23)
    jrt, trt = both(rt)
    rts, (rf0, rf1) = ref.timescales(jnp.asarray(P), rcfg, jrt, with_ydot=True)
    gts, (gf0, gf1) = mp.timescales(torch.from_numpy(P), cfg, trt,
                                    with_ydot=True)
    assert gts.ndim == 0
    np.testing.assert_allclose(float(gts), float(rts), rtol=1e-11)
    assert soft_err(gf0, rf0) < 1e-11 and soft_err(gf1, rf1) < 1e-11
    # kernels="auto" on a CPU tensor: the ydot kernel's plain version
    auto = dataclasses.replace(cfg, kernels="auto")
    np.testing.assert_allclose(
        float(mp.timescales(torch.from_numpy(P), auto, trt)), float(rts),
        rtol=1e-9)
    with pytest.raises(ValueError, match="tier"):
        dtlimit_tier_params(13)


def test_temperature_and_set_temp_match_reference():
    ref, mp = pair("mfion")
    rcfg, cfg = _cfgs((4, 8, 16))
    P, _ = prim_state(mp.mpc, (4, 8, 16), 24)
    Pt = torch.from_numpy(P.copy())
    np.testing.assert_allclose(mp.temperature(Pt, cfg).numpy(),
                               np.asarray(ref.temperature(jnp.asarray(P),
                                                          rcfg)), rtol=1e-13)
    np.testing.assert_allclose(
        mp.set_temp(Pt, 8000.0, cfg).numpy(),
        np.asarray(ref.set_temp(jnp.asarray(P), 8000.0, rcfg)), rtol=1e-13)
    assert torch.equal(Pt, torch.from_numpy(P))
    np.testing.assert_allclose(
        mp.temperature(mp.set_temp(Pt, 8000.0, cfg), cfg).numpy(), 8000.0,
        rtol=1e-12)


def test_a_module_with_its_own_ydot_never_takes_the_kernel():
    """A kernel built from MPv3's formulas would run the wrong physics for
    a subclass that overrides ``ydot``."""
    class Other(MPv3):
        def ydot(self, one_minus_x, Eint, nH, rt):
            a, b = super().ydot(one_minus_x, Eint, nH, rt)
            return a, 2.0 * b

    _, cfg = _cfgs((4, 8, 16))
    auto = dataclasses.replace(cfg, kernels="auto")
    mp = pair("mono")[1]
    other = Other(mp.mpc)
    assert mp._use_fused(auto)
    assert not mp._use_fused(cfg)        # kernels="off"
    assert not other._use_fused(auto)
    # nothing else leads round the kernels: any number of sources is within
    # their scope, and outside it (a dtype) the wrappers raise on the card
    assert fused_mpv3.supports(mp, {"ion": ({},) * 5}, torch.float64)
    assert not fused_mpv3.supports(mp, {}, torch.float16)
