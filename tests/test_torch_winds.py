"""pion_tpu_torch.winds against pion_tpu.winds on the same inputs: the
latitude-dependence functions, the evolution table, the orbit, and the
free-wind state and its overwrite for the three wind models, in 2D and 3D,
MHD and GLM-MHD.  CPU, float64 unless a test says otherwise."""
import dataclasses
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu import winds as ref_winds
from pion_tpu.grid import make_geometry as ref_make_geometry

from pion_tpu_torch import convert, winds
from pion_tpu_torch.grid import make_geometry

torch.set_num_threads(1)

RTOL = 1e-12
RTOL_SIMPSON = 1e-10   # a 231- or 1001-term sum in another order


def close(out, ref, rtol=RTOL, atol=0.0):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------

THETA = np.linspace(0.0, 0.5 * np.pi, 37)


@pytest.mark.parametrize("omega,teff", [(0.0, 3.0e4), (0.3, 2.1e4),
                                        (0.95, 7.0e3), (0.6, 3.0e3)])
def test_model_functions(omega, teff):
    th = torch.from_numpy(THETA)
    jth = jnp.asarray(THETA)
    close(winds.beta_eldridge(teff), ref_winds.beta_eldridge(teff))
    close(winds.beta_eldridge(torch.tensor([teff, 1.2e4, 9.9e4], dtype=torch.float64)),
          ref_winds.beta_eldridge(jnp.asarray([teff, 1.2e4, 9.9e4])))
    close(winds.fn_phi(omega, th, teff), ref_winds.fn_phi(omega, jth, teff))
    close(winds.fn_alpha(omega, th, teff),
          ref_winds.fn_alpha(omega, jth, teff))
    close(winds.fn_v_inf(omega, 2.0e8, th),
          ref_winds.fn_v_inf(omega, 2.0e8, jth))
    close(winds.fn_delta(omega, teff, -0.43),
          ref_winds.fn_delta(omega, teff, -0.43), rtol=RTOL_SIMPSON)
    r = 1.0e17 * (1.0 + THETA)
    close(winds.fn_density_angle(omega, 2.0e8, 6.0e19, torch.from_numpy(r),
                                 th, teff, -0.43),
          ref_winds.fn_density_angle(omega, 2.0e8, 6.0e19, jnp.asarray(r),
                                     jth, teff, -0.43), rtol=RTOL_SIMPSON)
    close(winds.latdep_f(th, omega, -0.43),
          ref_winds.latdep_f(jth, omega, -0.43))
    close(winds.latdep_norm(omega, -0.43),
          ref_winds.latdep_norm(omega, -0.43), rtol=RTOL_SIMPSON)
    # the same with the scalars as 0-d tensors, as an evolving source has them
    om_t = torch.tensor(omega, dtype=torch.float64)
    te_t = torch.tensor(teff, dtype=torch.float64)
    close(winds.fn_delta(om_t, te_t, -0.43),
          ref_winds.fn_delta(omega, teff, -0.43), rtol=RTOL_SIMPSON)
    close(winds.fn_v_inf(om_t, 2.0e8, th),
          ref_winds.fn_v_inf(omega, 2.0e8, jth))
    assert isinstance(winds.fn_delta(omega, teff, -0.43), float)


def test_interp_is_numpy_interp():
    rng = np.random.default_rng(3)
    xp = np.sort(rng.uniform(0.0, 10.0, 12))
    fp = rng.standard_normal(12)
    x = np.concatenate([rng.uniform(-2.0, 12.0, 50), xp, [xp[0], xp[-1]]])
    close(winds.interp(torch.from_numpy(x), xp, fp), np.interp(x, xp, fp),
          rtol=1e-13, atol=1e-15)
    assert winds.interp(4.2, xp, fp) == float(np.interp(4.2, xp, fp))


# ---------------------------------------------------------------------------
# evolution table and orbit
# ---------------------------------------------------------------------------

def write_table(path, seed=5, rows=9):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(1.0e11, 5.0e11, rows))
    with open(path, "w") as f:
        f.write("# evolution table\n# time M L Teff Mdot vrot vcrit vinf\n")
        for i in range(rows):
            f.write(" ".join(f"{v:.12e}" for v in (
                t[i], 4.0e34, rng.uniform(1, 5) * 1.0e38,
                rng.uniform(2.0e4, 4.0e4), rng.uniform(1, 9) * 1.0e19,
                rng.uniform(1, 3) * 1.0e7, 6.0e7,
                rng.uniform(1, 3) * 1.0e8)) + "\n")
    return t


def test_evolution_table(tmp_path):
    path = str(tmp_path / "star.txt")
    t = write_table(path)
    evo, ref = winds.load_evolution_file(path), ref_winds.load_evolution_file(path)
    for f in dataclasses.fields(winds.WindEvolution):
        close(getattr(evo, f.name), getattr(ref, f.name), rtol=0)
    for tq in (t[0] - 1.0, 0.5 * (t[2] + t[3]), t[4], t[-1] + 7.0):
        want = ref.at(tq)
        got_host = evo.at(tq)
        got_dev = evo.at(torch.tensor(tq, dtype=torch.float64))
        assert set(got_host) == set(want) == set(got_dev)
        for k in want:
            assert isinstance(got_host[k], float)
            close(got_host[k], want[k])
            close(got_dev[k], want[k])
    with open(path, "w") as f:
        f.write("a\nb\n")
    with pytest.raises(ValueError, match="no data rows"):
        winds.load_evolution_file(path)
    # the table crosses through convert as numpy columns
    src = ref_winds.WindSource(position=(0.5, 0.5), radius=0.1, mdot=1e19,
                               vinf=1e8, evolution=ref)
    mine = convert.wind_source_from_reference(dataclasses.asdict(src))
    close(mine.evolution.rstar, ref.rstar, rtol=0)
    with pytest.raises(ValueError, match="unknown WindSource"):
        convert.wind_source_from_reference({"position": (0,), "colour": 1})


# ---------------------------------------------------------------------------
# the free-wind state and the overwrite
# ---------------------------------------------------------------------------

L = 6.0e18
MSUN_YR = 1.9891e33 / 3.1558150e7


def box(ndim, eqn, dtype="float64", coords="cartesian", n=12):
    shape = (n,) * ndim if coords == "cartesian" else (n, 2 * n)
    xmin = (0.0,) * ndim if coords == "cartesian" else (0.0, -L)
    xmax = (L,) * ndim if coords == "cartesian" else (L, L)
    bcs = (("outflow", "outflow"),) * ndim
    if coords == "cylindrical":
        bcs = (("axisymmetric", "outflow"), ("outflow", "outflow"))
    return dict(ndim=ndim, eqn=eqn, solver="hll", ntracer=2, shape=shape,
                xmin=xmin, xmax=xmax, bcs=bcs, coords=coords, dtype=dtype)


def source(ndim, coords="cartesian", **kw):
    pos = (0.4 * L,) * ndim if coords == "cartesian" else (0.0, 0.1 * L)
    base = dict(position=pos, radius=0.3 * L, mdot=1.0e-6 * MSUN_YR,
                vinf=2.0e8, t_wind=3.0e4, rstar=7.0e11, tracers=(1.0, 0.25))
    base.update(kw)
    return base


def pair(boxkw, srckw, evolution=None):
    """(reference WindBC, port WindBC, seeded state as numpy)."""
    rcfg = pion_tpu.SimConfig(**boxkw)
    rsrc = ref_winds.WindSource(evolution=evolution, **srckw)
    rbc = ref_winds.WindBC(rcfg, ref_make_geometry(rcfg), rsrc)
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    src = convert.wind_source_from_reference(dataclasses.asdict(rsrc))
    bc = winds.WindBC(cfg, make_geometry(cfg), src)
    rng = np.random.default_rng(8)
    P = rng.uniform(0.5, 2.0, (rcfg.nvar,) + rcfg.shape).astype(rcfg.np_dtype)
    return rbc, bc, P


ROT = dict(v_rot=2.0e7, vcrit=5.0e7)
CASES = [
    ("iso-3d-glm", box(3, "glm"), source(3, b_star=10.0)),
    ("iso-3d-mhd-rot", box(3, "mhd"), source(3, b_star=10.0, **ROT)),
    ("iso-2d-glm-rot", box(2, "glm"), source(2, b_star=3.0, **ROT)),
    ("iso-2d-cyl-mhd", box(2, "mhd", coords="cylindrical"),
     source(2, "cylindrical", b_star=10.0, **ROT)),
    ("angle-3d-glm", box(3, "glm"),
     source(3, model="angle", b_star=1.0, hplus=1, **ROT)),
    ("angle-2d-mhd", box(2, "mhd"),
     source(2, model="angle", t_wind=1.2e4, hplus=0, **ROT)),
    ("latdep-3d-mhd", box(3, "mhd"),
     source(3, model="latdep", md0=3.0e19, b_star=2.0, **ROT)),
    ("latdep-2d-glm", box(2, "glm"), source(2, model="latdep", **ROT)),
]


@pytest.mark.parametrize("name,boxkw,srckw", CASES, ids=[c[0] for c in CASES])
def test_wind_state_and_apply(name, boxkw, srckw):
    rbc, bc, P = pair(boxkw, srckw)
    simpson = "iso" not in name
    rtol = RTOL_SIMPSON if simpson else RTOL
    Pt = torch.from_numpy(P)
    t = 3.0e10
    assert np.array_equal(bc.mask.numpy(), np.asarray(rbc.mask))
    assert 0 < int(bc.mask.sum()) < bc.mask.numel()
    W = bc.wind_state(Pt, t)
    close(W, rbc.wind_state(jnp.asarray(P), t), rtol=rtol)
    out = bc.apply(Pt, t)
    close(out, rbc.apply(jnp.asarray(P), t), rtol=rtol)
    # the state given is not written, and the static state is kept
    assert np.array_equal(Pt.numpy(), P) and out is not Pt
    assert bc.wind_state(Pt, 9.0e10) is W
    # a time that lives on the device, as the nested-grid hierarchy has it
    close(bc.apply(Pt, torch.tensor(t, dtype=torch.float64)), out.numpy(),
          rtol=0)


def test_evolving_and_orbiting_source(tmp_path):
    path = str(tmp_path / "star.txt")
    times = write_table(path)
    evo = ref_winds.load_evolution_file(path)
    for model in ("iso", "angle", "latdep"):
        rbc, bc, P = pair(box(3, "glm"),
                          source(3, model=model, b_star=5.0, hplus=1),
                          evolution=evo)
        Pt = torch.from_numpy(P)
        for t in (0.5 * (times[1] + times[2]), times[-1] + 1.0):
            want = rbc.apply(jnp.asarray(P), t)
            close(bc.apply(Pt, t), want, rtol=RTOL_SIMPSON)
            close(bc.apply(Pt, torch.tensor(t, dtype=torch.float64)), want,
                  rtol=RTOL_SIMPSON)
    # an orbit: the region moves with the source
    orb = dict(orb_period=40.0, eccentricity_fac=1.2,
               periastron=(0.1 * L, 0.05 * L))
    for ndim in (2, 3):
        rbc, bc, P = pair(box(ndim, "mhd"), source(ndim, b_star=1.0, **orb))
        Pt = torch.from_numpy(P)
        masks = []
        for t in (0.0, 2.0e8, 6.0e8):
            close(np.asarray(bc.position_at(t), dtype=float),
                  np.asarray(rbc.position_at(t), dtype=float))
            close([float(v) for v in bc.position_at(torch.tensor(
                t, dtype=torch.float64))],
                np.asarray(rbc.position_at(t), dtype=float))
            want = np.asarray(rbc.apply(jnp.asarray(P), t))
            close(bc.apply(Pt, t), want)
            close(bc.apply(Pt, torch.tensor(t, dtype=torch.float64)), want)
            masks.append(want != P)
        assert (masks[0] != masks[2]).any()


def test_float32_wind_is_finite_and_close_to_float64():
    """float32: rho and p of the inner cells are 1e-31, nothing overflows
    (r^2 v ~ 1e43 cgs would), and the state agrees with the float64 one to
    float32 rounding."""
    for model in ("iso", "angle", "latdep"):
        kw = source(3, model=model, b_star=10.0, **ROT)
        _, bc64, P = pair(box(3, "glm"), kw)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with np.errstate(over="raise", invalid="raise"):
                _, bc32, P32 = pair(box(3, "glm", dtype="float32"), kw)
                W32 = bc32.wind_state(torch.from_numpy(P32), 0.0)
        assert W32.dtype == torch.float32 and bool(torch.isfinite(W32).all())
        inner = torch.as_tensor(bc32._geo_np["inner"])
        assert inner.any() and float(W32[0][inner].max()) == np.float32(1e-31)
        assert float(W32[0].min()) > 0.0 and float(W32[1].min()) > 0.0
        W64 = bc64.wind_state(torch.from_numpy(P), 0.0).numpy()
        m = bc64.mask.numpy()
        scale = np.abs(W64[:, m]).max(axis=1, keepdims=True)
        scale[2:5] = scale[2:5].max()
        scale[5:8] = max(scale[5:8].max(), 1e-300)
        err = np.abs(W32.numpy()[:, m] - W64[:, m]) / np.maximum(scale, 1e-300)
        assert err.max() <= 1e-5, (model, err.max())


def test_physics_hooks_with_winds():
    """``Physics.setup`` builds one region a source; the exclusion mask is
    the union of the static regions, the first-step cap follows the fastest
    wind."""
    from pion_tpu.physics import Physics as RefPhysics

    kw = box(3, "glm")
    rcfg = pion_tpu.SimConfig(**kw)
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    a = source(3, b_star=1.0)
    b = source(3, position=(0.8 * L,) * 3, radius=0.1 * L, vinf=3.0e8)
    c = source(3, position=(0.2 * L,) * 3, orb_period=10.0,
               periastron=(0.1 * L, 0.0))
    rsrcs = [ref_winds.WindSource(**s) for s in (a, b, c)]
    rphys = RefPhysics(wind_sources=rsrcs).setup(rcfg, ref_make_geometry(rcfg))
    phys = convert.physics_from_reference(
        None, wind_sources=[dataclasses.asdict(s) for s in rsrcs]).setup(
            cfg, make_geometry(cfg))
    assert len(phys.winds) == 3
    assert np.array_equal(phys.wind_exclude_mask().numpy(),
                          np.asarray(rphys.wind_exclude_mask()))
    geom = make_geometry(cfg)
    assert phys.wind_dt_cap(cfg, geom) == pytest.approx(
        rphys.wind_dt_cap(rcfg, ref_make_geometry(rcfg)), rel=1e-15)
    rng = np.random.default_rng(2)
    P = rng.uniform(0.5, 2.0, (rcfg.nvar,) + rcfg.shape)
    close(phys.apply_internal_bcs(torch.from_numpy(P), 1.0e8),
          rphys.apply_internal_bcs(jnp.asarray(P), 1.0e8))
    lvl = phys.for_level(cfg, geom)
    assert len(lvl.winds) == 3 and lvl.winds[0] is not phys.winds[0]
