"""The analysis and I/O tools of the port against the JAX package's on the
same seeded inputs: the projections (the full quantity menu along every
axis, the tilted line of sight with samples that leave the box, the
axisymmetric Abel projection, the emissivity cube, the X-ray tables below,
inside and above their temperatures and a table file written here), FITS
files across packages, snapshot comparison, the ASCII and VTK exports, the
cell inspector, and the run-time utilities (timers, the walltime guard, the
precision check).  CPU, float64."""
import dataclasses
import json
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.analysis import export as ref_export
from pion_tpu.analysis import projection as ref_proj
from pion_tpu.debug import CellInspector as RefInspector
from pion_tpu.io import compare as ref_compare
from pion_tpu.io import fits as ref_fits
from pion_tpu.io.snapshot import save_snapshot as ref_save_snapshot
from pion_tpu.microphysics import cooling as ref_cooling
from pion_tpu.utils import Timers as RefTimers

from pion_tpu_torch import Simulation, convert, utils
from pion_tpu_torch.analysis import export, projection
from pion_tpu_torch.constants import K_B, M_P, PG, RO
from pion_tpu_torch.debug import CellInspector, inspect_snapshot
from pion_tpu_torch.io import compare, fits
from pion_tpu_torch.io.snapshot import save_snapshot

from test_torch_eqns import noisy_state, ref_config, to_port

torch.set_num_threads(1)

RTOL = 1e-10
NONMAG = ("em", "halpha", "nii", "xray", "density", "neutral", "ionized",
          "brems6ghz")
MAG = ("stokes_q", "stokes_u", "bxabs", "byabs", "rm")


def cgs_state(rcfg, seed):
    """rho 1e-25..1e-21 g cm^-3 and T 3e2..3e9 K log-uniform (below, inside
    and above the X-ray tables' 1e4..1e9 K), velocities of 1e6 cm/s, a
    field of a few microgauss, the first tracer an ionised fraction."""
    rng = np.random.default_rng(seed)
    sh = rcfg.shape
    P = np.zeros((rcfg.nvar,) + sh)
    P[RO] = 10.0 ** rng.uniform(-25.0, -21.0, sh)
    nH = P[RO] / (M_P / 0.715)
    P[PG] = 2.2 * nH * K_B * 10.0 ** rng.uniform(2.5, 9.5, sh)
    P[2:5] = 1.0e6 * rng.standard_normal((3,) + sh)
    if rcfg.eqn.is_mhd:
        P[5:8] = 3.0e-6 * rng.standard_normal((3,) + sh)
    if rcfg.ntracer:
        P[rcfg.eqn.nbase] = rng.uniform(0.0, 1.0, sh)
    return P


def box3d(eqn="glm", shape=(8, 10, 12)):
    return pion_tpu.SimConfig(
        ndim=3, eqn=eqn, solver="hll", ntracer=1, shape=shape,
        xmin=(0.0,) * 3, xmax=tuple(3.0e18 * n / shape[-1] for n in shape),
        bcs=(("outflow", "outflow"),) * 3)


def mpv8_pair(rcfg):
    ref = ref_cooling.MPv8(ref_cooling.MPv8Config(tracer_slot=rcfg.eqn.nbase))
    mp = convert.MP_MODULES["MPv8"][0](convert.mp_config_from_reference(
        "MPv8", dataclasses.asdict(ref.mpc)))
    return ref, mp


def agree(got: dict, want: dict, rtol=RTOL):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.shape == w.shape, k
        scale = max(float(np.abs(w).max()), 1e-300)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-13 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("with_mp", [False, True])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_project_3d_full_menu(axis, with_mp):
    """Every quantity of the menu along each grid axis, with the gas read
    through a chemistry module (MPv8) and without one (fully ionised)."""
    rcfg = box3d()
    P = cgs_state(rcfg, axis)
    cfg, Pt, _ = to_port(rcfg, P)
    ref_mp, mp = mpv8_pair(rcfg) if with_mp else (None, None)
    q = NONMAG + MAG
    got = projection.project_3d(Pt, cfg, axis=axis, mp=mp, quantities=q)
    want = ref_proj.project_3d(jnp.asarray(P), rcfg, axis=axis, mp=ref_mp,
                               quantities=q)
    agree(got, want)
    assert got["xray"].device == Pt.device
    # a numpy state is taken as a CPU tensor; the magnetic menu needs MHD
    euler = box3d("euler")
    Pe = cgs_state(euler, 9)
    agree(projection.project_3d(Pe, to_port(euler, Pe)[0], axis=axis,
                                quantities=NONMAG),
          ref_proj.project_3d(jnp.asarray(Pe), euler, axis=axis,
                              quantities=NONMAG))
    with pytest.raises(ValueError, match="MHD"):
        projection.project_3d(Pe, to_port(euler, Pe)[0], quantities=("rm",))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_tilted_line_of_sight(axis):
    """The trilinear resampling of a line of sight tilted by 30 degrees
    (velocity and field rotated into the tilted frame, samples outside the
    box zero) against ``jax.scipy.ndimage.map_coordinates`` to 1e-12, and
    the projections of the tilted cube; theta = 0 is ``project_3d``."""
    rcfg = box3d()
    P = cgs_state(rcfg, 10 + axis)
    cfg, Pt, _ = to_port(rcfg, P)
    theta = np.deg2rad(30.0)
    rot = projection._rotate_cube(Pt, cfg, axis, theta)
    want = np.asarray(ref_proj._rotate_cube(jnp.asarray(P), rcfg, axis,
                                            theta))
    scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1)
    err = np.abs(rot.numpy() - want).reshape(want.shape[0], -1).max(axis=1)
    assert (err <= 1e-12 * scale).all(), (err / scale).max()
    # corners of the tilted cube sample outside the box: zero density there
    assert float(rot[RO].min()) == 0.0 and float(rot[RO].max()) > 0.0
    q = ("em", "halpha", "xray", "stokes_q", "rm")
    agree(projection.project_3d_los(Pt, cfg, axis=axis, theta=theta,
                                    quantities=q),
          ref_proj.project_3d_los(jnp.asarray(P), rcfg, axis=axis,
                                  theta=theta, quantities=q))
    # read through a chemistry module, the samples outside the box have a
    # temperature of 0/0: both packages give NaN in the same pixels
    ref_mp, mp = mpv8_pair(rcfg)
    got = projection.project_3d_los(Pt, cfg, axis, theta, mp, ("halpha",))
    want = ref_proj.project_3d_los(jnp.asarray(P), rcfg, axis, theta, ref_mp,
                                   ("halpha",))
    np.testing.assert_allclose(got["halpha"].numpy(),
                               np.asarray(want["halpha"]), rtol=RTOL)
    assert bool(torch.isnan(got["halpha"]).any())
    flat = projection.project_3d_los(Pt, cfg, axis=axis, quantities=q)
    direct = projection.project_3d(Pt, cfg, axis=axis, quantities=q)
    assert all(torch.equal(flat[k], direct[k]) for k in q)


def test_xray_interpolation_at_both_ends(tmp_path):
    """``xray_emissivity`` below the table (zero), inside it (log-log linear)
    and above it (extrapolated by the last segment's slope), on every band
    and between bands, with the built-in tables and with a table file in
    the reference's format written here."""
    T = np.concatenate([[1.0, 500.0, 9.99e3, 1.0e4], np.logspace(4, 9, 37),
                        [1.0e9, 1.2e9, 5.0e10]])
    ne = np.full_like(T, 2.0)
    nH = np.full_like(T, 1.5)
    rng = np.random.default_rng(3)
    logt = np.linspace(4.5, 8.5, 17)
    rows = [[lt, 10.0 ** lt, 0.0] + list(10.0 ** rng.uniform(-25, -22, 8))
            for lt in logt]
    path = tmp_path / "xray-table.txt"
    path.write_text("# log10(T) T(K) E(keV) j(E>0.1) ... j(E>10)\n"
                    + "\n".join(" ".join(f"{v:.10e}" for v in r)
                                for r in rows) + "\n")
    tabs = projection.XrayTables.from_file(str(path))
    rtabs = ref_proj.XrayTables.from_file(str(path))
    assert np.array_equal(tabs.logt, rtabs.logt)
    for tables, rtables in ((None, None), (tabs, rtabs)):
        for e in projection.XRAY_BANDS_KEV + (0.15, 0.7, 7.0):
            got = projection.xray_emissivity(
                torch.from_numpy(ne), torch.from_numpy(nH),
                torch.from_numpy(T), e, tables=tables)
            want = np.asarray(ref_proj.xray_emissivity(
                jnp.asarray(ne), jnp.asarray(nH), jnp.asarray(T), e,
                tables=rtables))
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                       atol=0.0)
            lo = T < 10.0 ** (tables or projection._XRAY_DEFAULT).logt[0]
            assert (got.numpy()[lo] == 0.0).all() and (got.numpy()[~lo]
                                                       > 0.0).all()


def test_axisymmetric_projection_and_emissivity_cube():
    """The Abel projection of a 2D cylindrical state (every quantity of its
    menu), and the emissivity cube of a 3D one."""
    rcfg = pion_tpu.SimConfig(
        ndim=2, eqn="mhd", solver="hll", ntracer=1, shape=(12, 20),
        coords="cylindrical", xmin=(0.0, -1.0e18), xmax=(1.2e18, 1.0e18),
        bcs=(("axisymmetric", "outflow"), ("outflow", "outflow")))
    P = cgs_state(rcfg, 4)
    cfg, Pt, _ = to_port(rcfg, P)
    np.testing.assert_array_equal(
        projection.abel_weights(cfg.cell_centers(0), cfg.dx),
        ref_proj.abel_weights(rcfg.cell_centers(0), rcfg.dx))
    ref_mp, mp = mpv8_pair(rcfg)
    for m, rm in ((None, None), (mp, ref_mp)):
        agree(projection.project_axisymmetric(Pt, cfg, mp=m,
                                              quantities=NONMAG),
              ref_proj.project_axisymmetric(jnp.asarray(P), rcfg, mp=rm,
                                            quantities=NONMAG))
    with pytest.raises(ValueError):
        projection.project_axisymmetric(Pt, cfg, quantities=("rm",))
    r3 = box3d()
    P3 = cgs_state(r3, 6)
    agree(projection.emissivity_cube(to_port(r3, P3)[1], to_port(r3, P3)[0]),
          ref_proj.emissivity_cube(jnp.asarray(P3), r3))


def state_and_cfg(seed=1):
    rcfg = ref_config("glm3d")
    P = noisy_state(rcfg, seed)
    cfg, Pt, _ = to_port(rcfg, P)
    return rcfg, cfg, P, Pt


def test_fits_across_packages(tmp_path):
    """A FITS file written by either package reads in the other, bit for
    bit, and the two files are the same size (the same cards and images);
    ``npz_to_fits`` converts the port's snapshot."""
    rcfg, cfg, P, Pt = state_and_cfg()
    a = fits.write_fits(str(tmp_path / "port"), Pt, cfg, t=0.25,
                        extra={"cycle": 3})
    b = ref_fits.write_fits(str(tmp_path / "ref"), P, rcfg, t=0.25,
                            extra={"cycle": 3})
    assert len(open(a, "rb").read()) == len(open(b, "rb").read())
    P2, cfg2, t2 = ref_fits.read_fits(a)
    assert cfg2 == rcfg and t2 == 0.25 and np.array_equal(P2, P)
    P3, cfg3, t3 = fits.read_fits(b)
    assert cfg3 == cfg and t3 == 0.25 and np.array_equal(P3, P)
    snap = save_snapshot(str(tmp_path / "s"), Pt, cfg, 0.5, 7)
    P4, cfg4, t4 = fits.read_fits(fits.npz_to_fits(snap))
    assert cfg4 == cfg and t4 == 0.5 and np.array_equal(P4, P)


def test_compare_snapshots(tmp_path, monkeypatch, capsys):
    """``compare_states`` equals the JAX package's norms, on tensors too;
    a snapshot against itself is zero; the command line prints the same."""
    rcfg, cfg, P, Pt = state_and_cfg(2)
    P1 = P.copy()
    P1[0] *= 1.001
    P1[3] += 1.0e-3
    got = compare.compare_states(Pt, torch.from_numpy(P1))
    want = ref_compare.compare_states(P, P1)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            for n in ("L1", "L2", "max"):
                assert got[k][n] == pytest.approx(want[k][n], rel=1e-12,
                                                  abs=1e-300)
        else:
            assert got[k] == pytest.approx(want[k], rel=1e-12)
    assert 0.0009 < got["rho"]["L1"] < 0.0011 and got["pg"]["max"] == 0.0
    a = save_snapshot(str(tmp_path / "a"), Pt, cfg, 0.5, 4)
    b = ref_save_snapshot(str(tmp_path / "b"), P, rcfg, 0.5, 4)
    res = compare.compare_snapshots(a, b)
    assert res["all_max"] == 0.0 and res["dt_sim"] == 0.0
    with pytest.raises(ValueError, match="shape"):
        compare.compare_states(P, P[:, :2])
    monkeypatch.setattr(sys, "argv", ["compare", a, b, "--absolute"])
    compare.main()
    assert json.loads(capsys.readouterr().out)["all_max"] == 0.0


def test_exports_write_the_reference_files(tmp_path):
    rcfg, cfg, P, Pt = state_and_cfg(3)
    for fn, rfn, name in ((export.to_ascii, ref_export.to_ascii, "s.txt"),
                          (export.to_vtk, ref_export.to_vtk, "s.vtk")):
        a = fn(str(tmp_path / ("port_" + name)), Pt, cfg, t=0.125)
        b = rfn(str(tmp_path / ("ref_" + name)), P, rcfg, t=0.125)
        assert open(a).read() == open(b).read()
    cols = np.loadtxt(str(tmp_path / "port_s.txt"))
    assert cols.shape == (P[0].size, cfg.ndim + cfg.nvar)
    np.testing.assert_allclose(cols[:, cfg.ndim], P[0].ravel(), rtol=1e-15)


def test_cell_inspector(tmp_path):
    """The walk and the dumps of the JAX package's inspector, from a tensor
    and from a snapshot."""
    rcfg, cfg, P, Pt = state_and_cfg(4)
    dbg, ref = CellInspector(Pt, cfg, 0.5), RefInspector(P, rcfg, 0.5)
    quiet = lambda *_: None
    for step in (("fpt",), ("end_of_col", "ZP"), ("next_point", "XP"),
                 ("next_point", "YP"), ("next_point", "ZN"), ("lpt",),
                 ("goto", 3, 4, 17)):
        assert getattr(dbg, step[0])(*step[1:]) == \
            getattr(ref, step[0])(*step[1:])
        assert dbg.position() == ref.position()
        assert dbg.print_cell(quiet) == ref.print_cell(quiet)
    assert dbg.minmax(quiet) == ref.minmax(quiet)
    snap = save_snapshot(str(tmp_path / "s"), Pt, cfg, 0.5, 1)
    again = inspect_snapshot(snap)
    assert again.goto(3, 4, 17) == (3, 4, 17) and again.t == 0.5
    assert again.print_cell(quiet) == dbg.print_cell(quiet)
    with pytest.raises(ValueError):
        dbg.next_point("WP")


def test_timers_and_walltime_guard():
    """``Timers`` as the JAX package's; the walltime guard ends a run at its
    next step once the deadline has passed; ``ensure_precision`` names the
    torch dtype."""
    for T in (utils.Timers(), RefTimers()):
        T.start("a")
        T.pause("a")
        first = T.read("a")
        T.start("a")
        assert T.read("a") >= first
        total = T.stop("a")
        assert total >= first and T.read("a") == total
        T.start("b")
        assert set(T.report()) == {"a", "b"}
    rcfg, cfg, P, Pt = state_and_cfg(5)
    guard = utils.WalltimeGuard(0.0)
    sim = Simulation(cfg, Pt, device="cpu").run(max_steps=5,
                                                callback=guard)
    assert guard.triggered and sim.step_count == 1
    free = Simulation(cfg, Pt, device="cpu").run(
        max_steps=3, callback=utils.WalltimeGuard(3600.0))
    assert free.step_count == 3
    assert utils.ensure_precision(cfg) is torch.float64
    assert utils.ensure_precision(dataclasses.replace(
        cfg, dtype="float32")) is torch.float32
    with pytest.raises(ValueError, match="float16"):
        utils.ensure_precision(type("C", (), {"dtype": "float16"})())
