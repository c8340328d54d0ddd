"""MPv7 (the two-temperature isothermal module) and MPv8 (the StarBench
module) of the port against the JAX package on the same seeded inputs:
``update``, ``timescales``, ``temperature`` and ``set_temp`` with the
no-source columns and with traced ones (MPv7 with two sources), the configs
across ``convert``, and a run of each ``chem_code`` through the parameter
file workflow with its restart.  CPU, float64."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pion_tpu import cli as ref_cli
from pion_tpu.microphysics import cooling as ref_cooling
from pion_tpu.microphysics import mpv7 as ref_mpv7

from pion_tpu_torch import cli, convert
from pion_tpu_torch.constants import K_B, M_P, PG, RO
from pion_tpu_torch.microphysics import MPv7, MPv8

from test_torch_cli import _agree, _icgen_both

torch.set_num_threads(1)

RTOL = 1e-10
SLOT = 5


def pair(name, **kw):
    """The reference's module and the port's, from the same config."""
    if name == "MPv7":
        ref = ref_mpv7.MPv7(ref_mpv7.MPv7Config(tracer_slot=SLOT, **kw))
    else:
        ref = ref_cooling.MPv8(ref_cooling.MPv8Config(tracer_slot=SLOT, **kw))
    mpc = convert.mp_config_from_reference(name, dataclasses.asdict(ref.mpc))
    assert convert.mp_config_to_reference(mpc) == dataclasses.asdict(ref.mpc)
    return ref, convert.MP_MODULES[name][0](mpc)


def gas(seed, shape=(6, 10), nH=(1.0e-3, 1.0e3)):
    """n_H log-uniform over ``nH``, T of 50..2e4 K, x in (0, 1)."""
    rng = np.random.default_rng(seed)
    P = np.zeros((6,) + shape)
    n = 10.0 ** rng.uniform(np.log10(nH[0]), np.log10(nH[1]), shape)
    P[RO] = n * M_P / (1.0 - 0.2703)
    P[PG] = 2.0 * n * K_B * 10.0 ** rng.uniform(np.log10(50.0), 4.3, shape)
    P[2:5] = 1.0e5 * rng.standard_normal((3,) + shape)
    P[SLOT] = rng.uniform(1.0e-4, 0.9999, shape)
    return P


def columns(seed, shape, n):
    """``n`` sources' columns as the port's raytrace lays them out (the
    first one also at the top level), as numpy."""
    rng = np.random.default_rng(seed)
    ion = []
    for _ in range(n):
        ion.append({"tau0": 10.0 ** rng.uniform(-3.0, 1.5, shape),
                    "ds": 10.0 ** rng.uniform(17.0, 19.0, shape),
                    "nv": 10.0 ** rng.uniform(-5.0, 0.0, shape)})
    rt = dict(ion[0])
    rt["ion"] = tuple(ion)
    return rt


def as_jax(rt):
    return {k: (tuple(as_jax(e) for e in v) if k == "ion"
                else jnp.asarray(v)) for k, v in rt.items()}


def as_torch(rt):
    return {k: (tuple(as_torch(e) for e in v) if k == "ion"
                else torch.from_numpy(v)) for k, v in rt.items()}


def close(out, ref, rtol=RTOL):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=rtol,
                               atol=0.0)


@pytest.mark.parametrize("name,sources", [
    ("MPv7", 0), ("MPv7", 1), ("MPv7", 2), ("MPv8", 0), ("MPv8", 1)])
def test_module_matches_reference(name, sources):
    """The four entry points on 60 cells of mixed density, temperature and
    ionisation; ``sources`` 0 takes each module's no-source columns.  MPv8
    reads one column set (the top-level fields), MPv7 sums them all."""
    kw = dict(t_lo=100.0, t_hi=1.0e4) if name == "MPv7" else {}
    ref, mp = pair(name, **kw)
    P = gas(11 + sources)
    Pt, Pj = torch.from_numpy(P), jnp.asarray(P)
    cfg = None
    if sources:
        rt_np = columns(3, P.shape[1:], sources)
        rt, rrt = as_torch(rt_np), as_jax(rt_np)
    else:
        rt, rrt = None, None
    close(mp.temperature(Pt, cfg), ref.temperature(Pj, cfg))
    T = 10.0 ** np.random.default_rng(5).uniform(1.5, 4.5, P.shape[1:])
    close(mp.set_temp(Pt, torch.from_numpy(T), cfg),
          ref.set_temp(Pj, jnp.asarray(T), cfg))
    dt = 1.0e10 if name == "MPv7" else 1.0e8
    out = mp.update(Pt, dt, cfg, rt)
    want = ref.update(Pj, dt, cfg, rrt)
    close(out, want)
    assert not torch.equal(out[SLOT], Pt[SLOT])
    close(mp.timescales(Pt, cfg, rt), ref.timescales(Pj, cfg, rrt))
    assert mp.timescales(Pt, cfg, rt).ndim == 0


def test_mpv7_pressure_is_slaved_to_x():
    """After an update the pressure is n_tot k T(x) in every cell, with
    T(x) = T_lo + x (T_hi - T_lo); ``set_temp`` ignores the temperature it
    is given."""
    _, mp = pair("MPv7", t_lo=100.0, t_hi=1.0e4)
    P = torch.from_numpy(gas(21))
    rt = as_torch(columns(4, P.shape[1:], 1))
    out = mp.update(P, 1.0e11, None, rt)
    x = out[SLOT]
    nH = mp.n_H(out[RO])
    want = mp.n_tot(nH, x) * K_B * (100.0 + x * (1.0e4 - 100.0))
    np.testing.assert_allclose(out[PG].numpy(), want.numpy(), rtol=1e-15)
    assert torch.equal(mp.set_temp(out, 5.0, None), out)


def test_configs_cross_and_unknown_keys_raise():
    for name in ("MPv7", "MPv8"):
        with pytest.raises(ValueError, match=f"unknown {name}Config keys"):
            convert.mp_config_from_reference(name, {"tracer_slot": 5,
                                                    "bogus": 1})
    ref, _ = pair("MPv7")
    phys = convert.physics_from_reference(dataclasses.asdict(ref.mpc),
                                          module="MPv7")
    assert isinstance(phys.mp, MPv7) and phys.mp.mpc.t_hi == 1.0e4
    ref, _ = pair("MPv8")
    phys = convert.physics_from_reference(dataclasses.asdict(ref.mpc),
                                          module="MPv8")
    assert isinstance(phys.mp, MPv8)
    assert phys.mp.eeq_hi == ref.eeq_hi and phys.mp.eeq_lo == ref.eeq_lo


# An H II region in a uniform medium, 16 x 16, a monochromatic source at the
# centre: Iliev et al. (2009) test 5 at n_H 1e-3 and 100 K with Q = 5e48 on
# a 15 kpc box (MPv7), and the StarBench-like set-up at n_H 1e3 and 100 K
# with Q = 1e49 on 9e18 cm (MPv8, equilibrated by icgen)
HII = """\
ics Uniform
ndim 2
coordinates cartesian
eqn euler
solver 4
GAMMA 1.666666666666667
CFL 0.3
ArtificialViscosity 1
ntracer 1
Tracer000 H1+
chem_code {chem}
EP_chemistry 1
EP_MP_timestep_limit 1
InitIons {init}
EP_Min_Temperature 100.0
UNIFORM_ambRO {rho}
UNIFORM_ambPG {pg}
UNIFORM_ambTR0 1.0e-6
NGridX 16
NGridY 16
Xmax {box}
Ymax {box}
FinishTime 1.0e20
OutputFrequency 2
RT_Nsources 1
RT_effect_0 2
RT_strength_0 {q}
RT_position_0_0 {c}
RT_position_0_1 {c}
OutputPath {{path}}/
OutputFile hii
pallas off
"""


def hii_text(chem):
    if chem == "MPv7":
        nH, box, q, init = 1.0e-3, 4.6e22, 5.0e48, "NO"
    else:
        nH, box, q, init = 1.0e3, 9.0e18, 1.0e49, "YES"
    return HII.format(chem=chem, init=init, rho=nH * M_P / (1.0 - 0.2703),
                      pg=2.0 * nH * K_B * 100.0, box=box, q=q, c=0.5 * box)


@pytest.mark.parametrize("chem", ["MPv7", "MPv8"])
def test_cli_run_and_restart_match_reference(tmp_path, chem):
    """icgen (MPv8 equilibrated), 3 steps, then a restart from the step-2
    snapshot, which rebuilds the module and the source from the header,
    for 2 more: each package's fields to 1e-8, the same step counts."""
    (rpf, _, rdir), (ppf, _, pdir) = _icgen_both(tmp_path, hii_text(chem))
    ref = ref_cli.run_main([rpf, "max_steps=3", "log_freq=0"])
    sim = cli.run_main([ppf, "max_steps=3", "log_freq=0", "--device", "cpu"])
    assert type(sim.physics.mp).__name__ == chem
    assert len(sim.physics.sources) == 1
    _agree(sim, ref, f"{chem}, 3 steps")
    x = sim.P[5]
    assert float(x.max()) > 1.0e-6 and float(x.min()) >= 0.0
    name = "hii.00000002.snap"
    ref2 = ref_cli.run_main([str(rdir / name), "max_steps=4", "log_freq=0"])
    sim2 = cli.run_main([str(pdir / name), "max_steps=4", "log_freq=0",
                         "--device", "cpu"])
    assert type(sim2.physics.mp).__name__ == chem
    _agree(sim2, ref2, f"{chem}, restarted 2 more steps")
