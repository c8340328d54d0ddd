"""The parameter-file workflow of the port (``pion_tpu_torch.cli``: icgen,
run, restart) against the JAX package's (``pion_tpu.cli``), on parameter
files the tests write themselves, the port with ``--device cpu``.

Each case runs ``icgen`` and ``run`` in both packages: the IC snapshots are
equal bit for bit; after the run the fields agree to 1e-8 (each variable
scaled by its largest magnitude), the step counts are equal and the clocks
agree to 1e-12.  The chemistry cases set ``pallas off`` (the port reads it
as ``kernels off``): on the CPU both packages then integrate with the same
whole-grid ladder."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pion_tpu import cli as ref_cli
from pion_tpu.io.snapshot import load_snapshot_raw as ref_load

from pion_tpu_torch import cli
from pion_tpu_torch.io.snapshot import load_snapshot_raw

from test_cli import NG_PARAMS, PARAMS
from test_torch_params import JET

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-8

DMR = """\
# Woodward & Colella double Mach reflection, 64x16
ndim 2
coordinates cartesian
eqn euler
solver 8
OrderOfAccSpace 2
GAMMA 1.4
CFL 0.3
ArtificialViscosity 1
EtaViscosity 0.1
ics DoubleMachRef
ntracer 1
NGridX 64
NGridY 16
Xmin 0.0
Ymin 0.0
Xmax 4.0
Ymax 1.0
BC_XN inflow
BC_XP outflow
BC_YN dmach2
BC_YP dmach
FinishTime 0.2
OutputFile dmr
OutputPath {path}/
"""

EQUILIBRATE = """\
ics Uniform
ndim 2
coordinates cartesian
eqn euler
solver 4
GAMMA 1.666666666666667
CFL 0.3
ntracer 1
Tracer000 H1+
chem_code MPv3
EP_chemistry 1
EP_Min_Temperature 10.0
EP_Max_Temperature 1.0e9
UNIFORM_ambRO 2.34e-22
UNIFORM_ambPG 3.3e-12
UNIFORM_ambTR0 1.0e-6
OutputPath {path}/
OutputFile eqtest
NGridX 8
NGridY 8
Xmax {box}
Ymax {box}
FinishTime 1.0e14
pallas off
"""

# MPv3 chemistry, a monochromatic point source and a stellar wind, all from
# the parameter sections a restart rebuilds them from (the shape of the
# reference's RCW120 files: chem_code, RT_*, WIND_*)
RESTART = """\
ics Uniform
ndim 2
coordinates cartesian
eqn euler
solver 8
GAMMA 1.666666666666667
CFL 0.3
ArtificialViscosity 1
ntracer 2
Tracer000 H1+
Tracer001 WIND
chem_code MPv3
EP_chemistry 1
EP_MP_timestep_limit 1
EP_Min_Temperature 10.0
InitIons NO
UNIFORM_ambRO 2.34e-22
UNIFORM_ambPG 3.3e-12
UNIFORM_ambTR0 1.0e-6
NGridX 16
NGridY 16
Xmax 3.0e18
Ymax 3.0e18
FinishTime 1.0e14
RT_Nsources 1
RT_effect_0 2
RT_strength_0 1.0e48
RT_position_0_0 1.5e18
RT_position_0_1 1.5e18
WIND_NSRC 1
WIND_0_pos0 1.5e18
WIND_0_pos1 1.5e18
WIND_0_radius 4.0e17
WIND_0_mdot 1.0e-7
WIND_0_vinf 1000.0
WIND_0_temp 1.0e4
WIND_0_TR0 1.0
WIND_0_TR1 1.0
OutputPath {path}/
OutputFile rst
pallas off
"""

JET_TEXT = "\n".join(f"{k} {v}" for k, v in JET.items()) + """
OutputPath {path}/
OutputFile jet
"""


def _write(tmp_path, text, who):
    d = tmp_path / who
    d.mkdir(exist_ok=True)
    pf = d / "params.txt"
    pf.write_text(text.format(path=d))
    return str(pf), d


def _fields(P):
    return [np.asarray(p) for p in (P if isinstance(P, list) else [P])]


def _err(got, want):
    """max |got - want| over the cells, each variable scaled by its largest
    magnitude; the velocity components by the largest of the velocity and
    of sqrt(p/rho) (a gas at rest holds rounding noise there, which one
    package makes and the other does not)."""
    assert got.shape == want.shape and np.all(np.isfinite(got))
    scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1)
    scale[2:5] = max(scale[2:5].max(),
                     float(np.sqrt(np.abs(want[1] / want[0])).max()))
    scale = np.maximum(scale, 1e-300).reshape((-1,) + (1,) * (want.ndim - 1))
    return float((np.abs(got - want) / scale).max())


def _agree(sim, ref, what):
    """Fields to TOL, the same step count, the clock to 1e-12."""
    assert sim.step_count == ref.step_count, what
    assert sim.t == pytest.approx(ref.t, rel=1e-12, abs=0.0), what
    for got, want in zip(_fields(sim.P), _fields(ref.P)):
        got = got if isinstance(got, np.ndarray) else got.numpy()
        err = _err(got, want)
        assert err <= TOL, f"{what}: {err:.3e} > {TOL:.0e}"


def _icgen_both(tmp_path, text):
    """icgen in each package: the two IC snapshots, equal bit for bit."""
    rpf, rdir = _write(tmp_path, text, "ref")
    ppf, pdir = _write(tmp_path, text, "port")
    rsnap = ref_cli.icgen_main([rpf])
    assert cli.main(["icgen", ppf, "--device", "cpu"]) == 0
    psnap = os.path.join(pdir, os.path.basename(rsnap))
    rc, rP, rt, rs, rex = ref_load(rsnap)
    pc, pP, pt, ps, pex = load_snapshot_raw(psnap)
    assert np.array_equal(pP, rP) and (pt, ps) == (rt, rs)
    # the parameter section is the file's (each run writes into a
    # directory of its own), without the device flag
    drop = lambda d: {k: v for k, v in d.items() if k != "OutputPath"}
    assert drop(pex["params"]) == drop(rex["params"])
    assert not any("device" in k.lower() for k in pex["params"])
    return (rpf, rsnap, rdir), (ppf, psnap, pdir)


@pytest.mark.parametrize("case,text,run", [
    ("blast", PARAMS, ["max_steps=8"]),
    ("jet", JET_TEXT, ["max_steps=20", "log_freq=0"]),
    ("dmr", DMR, ["max_steps=20", "log_freq=0"]),
], ids=["blast", "jet", "dmr"])
def test_icgen_and_run_match_reference(tmp_path, case, text, run):
    """The blast of tests/test_cli.py, the jet (JET face, 32x16) and the
    double Mach reflection (DMACH + DMACH2, 64x16, 20 steps), run from the
    parameter file in each package."""
    (rpf, rsnap, _), (ppf, psnap, _) = _icgen_both(tmp_path, text)
    ref = ref_cli.run_main([rpf] + run)
    sim = cli.run_main([ppf, "--device", "cpu"] + run)
    assert sim.P.device.type == "cpu"
    _agree(sim, ref, case)
    if case == "jet":
        assert sim.bdata.jet is not None
        assert float(sim.P[2, :4, :4].max()) > 1.0, "the jet did not enter"
    if case in ("jet", "dmr"):
        # five steps at a time (the clock a float64 tensor, as in a CUDA
        # graph's chunk): bit for bit the single steps
        chunked = cli.run_main([ppf, "--device", "cpu", "chunk=5"] + run)
        assert torch.equal(chunked.P, sim.P)
        assert (chunked.t, chunked.step_count) == (sim.t, sim.step_count)
    if case == "blast":
        # each package restarts the other's IC snapshot, and the runs agree
        out = lambda d: f"OutputPath={d}"
        a = cli.run_main([rsnap, "max_steps=3", out(tmp_path / "port"),
                          "--device=cpu"])
        b = ref_cli.run_main([psnap, "max_steps=3", out(tmp_path / "ref")])
        _agree(a, b, "blast, restarted across packages")


def test_ng_toro1_hierarchy_matches_reference(tmp_path):
    """The 3-level cylindrical Toro-1 hierarchy of tests/test_cli.py:
    icgen writes every level, run restarts it and takes 4 hierarchy steps."""
    (_, rsnap, _), (_, psnap, _) = _icgen_both(tmp_path, NG_PARAMS)
    ref = ref_cli.run_main([rsnap, "max_steps=4", "log_freq=0"])
    sim = cli.run_main([psnap, "max_steps=4", "log_freq=0", "--device",
                        "cpu"])
    assert sim.n_levels == 3
    _agree(sim, ref, "Toro-1 hierarchy")


def _equilibrate_both(tmp_path, box):
    """icgen's chemistry equilibration in both packages on EQUILIBRATE with
    a box of ``box`` cm: the IC snapshots agree to TOL (two whole-grid
    ladders), the ions grow from their seed at fixed energy; then a run
    from it."""
    text = EQUILIBRATE.replace("{box}", box)
    rpf, rdir = _write(tmp_path, text, "ref")
    ppf, pdir = _write(tmp_path, text, "port")
    rsnap = ref_cli.icgen_main([rpf])
    psnap = cli.icgen_main([ppf, "--device", "cpu"])
    _, rP, *_ = ref_load(rsnap)
    _, pP, *_ = load_snapshot_raw(psnap)
    assert _err(pP, rP) <= TOL
    x = pP[5]
    assert 1.0e-5 < float(x.min()) and float(x.max()) < 0.5
    assert np.array_equal(pP[1], rP[1])
    ref = ref_cli.run_main([rsnap, "max_steps=3", "log_freq=0"])
    sim = cli.run_main([psnap, "max_steps=3", "log_freq=0", "--device",
                        "cpu"])
    _agree(sim, ref, "equilibrated chemistry run")


def test_equilibrate_mp_matches_reference(tmp_path):
    """icgen's chemistry equilibration: the case of tests/test_cli.py on a
    box of 3e14 cm for its 3e18 (each of the 100 updates is 50 cell-crossing
    times long, so this one takes a few substeps of the ladder where that
    one takes 32 of 8 Newton iterations: 20 s on the CPU, against 200 s,
    since the port's plain whole-grid ladder reads its Newton test back
    every iteration).  The reference's own box, and with it the stiff
    ladder, is the slow test below."""
    _equilibrate_both(tmp_path, "3.0e14")


@pytest.mark.slow
def test_equilibrate_mp_reference_box_matches_reference(tmp_path):
    """The same on the reference's box of 3e18 cm: every update takes the
    whole-grid ladder's 32 substeps of 8 Newton iterations."""
    _equilibrate_both(tmp_path, "3.0e18")


def test_restart_rebuilds_physics_from_the_header(tmp_path):
    """MPv3, a point source and a wind, written into the snapshot's
    parameter section by the run and rebuilt from it by the restart (in
    place of the reference's RCW120 file): 2 steps, then a restart for 2
    more, in each package."""
    from pion_tpu_torch.microphysics import MPv3
    from pion_tpu_torch.sim import Simulation

    (rpf, _, rdir), (ppf, _, pdir) = _icgen_both(tmp_path, RESTART)
    ref = ref_cli.run_main([rpf, "max_steps=2", "log_freq=0"])
    sim = cli.run_main([ppf, "max_steps=2", "log_freq=0", "--device", "cpu"])
    _agree(sim, ref, "first 2 steps")
    name = "rst.00000002.snap"
    again = Simulation.restart(str(pdir / name), device="cpu")
    phys = again.physics
    assert isinstance(phys.mp, MPv3) and phys.mp.mpc.ion_src == "mono"
    assert len(phys.sources) == 1 and len(phys.winds) == 1
    assert again.cfg.kernels == "off" and again.step_count == 2
    ref2 = ref_cli.run_main([str(rdir / name), "max_steps=4", "log_freq=0"])
    sim2 = cli.run_main([str(pdir / name), "max_steps=4", "log_freq=0",
                         "--device", "cpu"])
    assert sim2.physics.sources and sim2.physics.winds
    _agree(sim2, ref2, "restarted 2 more steps")


def test_entry_points_need_a_card_or_the_cpu(tmp_path):
    """Without a card and without ``--device cpu`` every entry point raises;
    a bad flag is refused; ``mesh on`` and ``halo explicit`` over several
    visible devices run sharded, as the one device runs; MPv7/MPv8 are
    built from the parameters; the usage text comes back with 2."""
    pf, _ = _write(tmp_path, PARAMS, "port")
    if not torch.cuda.is_available():
        for argv in (["icgen", pf], ["run", pf]):
            with pytest.raises(RuntimeError, match="device"):
                cli.main(argv)
    with pytest.raises(ValueError, match="--device"):
        cli.run_main([pf, "--device", "tpu"])
    # with one visible device mesh on runs the one device; with several
    # (two CPU devices standing in for two cards) mesh on and halo explicit
    # shard the run (ROADMAP A20.4), which ends as the one device's does
    from pion_tpu_torch.parallel import Sharded, mesh

    one = cli.run_main([pf, "mesh=on", "max_steps=3", "--device", "cpu"])
    assert not isinstance(one.P, Sharded)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh, "visible_devices",
                   lambda: [torch.device("cpu")] * 2)
        for key, val in (("mesh", "on"), ("halo", "explicit")):
            sim = cli.run_main([pf, f"{key}={val}", "max_steps=3",
                                "--device", "cpu"])
            assert isinstance(sim.P, Sharded) and sim.mesh.size == 2
            assert sim.t == one.t and torch.equal(sim.P.gather(), one.P)
    cfg = cli.config_from_params({"ndim": "1", "NGridX": "8", "ntracer": "1"})
    for chem in ("MPv7", "MPv8"):
        phys = cli.physics_from_params(cfg, {"chem_code": chem,
                                             "MPv7_Thi": "8000.0"})
        assert type(phys.mp).__name__ == chem
        assert phys.mp.mpc.tracer_slot == cfg.eqn.nbase
    assert phys.mp.mpc.max_temperature == 1.0e4
    assert cli.physics_from_params(cfg, {"chem_code": "MPv7", "MPv7_Thi":
                                         "8000.0"}).mp.mpc.t_hi == 8000.0
    assert cli.main(["help"]) == 2


def test_python_dash_m_runs_without_jax(tmp_path):
    """``python -m pion_tpu_torch run <file> --device cpu`` in a fresh
    process: it runs, and imports neither jax nor the JAX package."""
    pf, d = _write(tmp_path, PARAMS, "port")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "pion_tpu_torch", "run",
         pf, "max_steps=2", "log_freq=0", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "after 2 steps" in res.stdout
    mods = [line.rsplit("|", 1)[-1].strip()
            for line in res.stderr.splitlines() if "|" in line]
    assert "pion_tpu_torch.cli" in mods
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "pion_tpu")]
    assert not bad, bad
    assert os.path.exists(d / "cli_blast.00000002.snap")
