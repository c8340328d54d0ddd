"""The port end to end: pion_tpu_torch.stepper.advance and a short
Simulation.run against the JAX package, from the same converted state."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.boundaries import BoundaryData as RefBoundaryData
from pion_tpu.stepper import advance as ref_advance
from pion_tpu.utils import conservation_totals as ref_totals

import pion_tpu_torch
from pion_tpu_torch import Simulation
from pion_tpu_torch.stepper import advance, make_step_fns
from pion_tpu_torch.utils import StepLogger, conservation_totals

from test_torch_eqns import close, noisy_state, ref_config, to_port

torch.set_num_threads(1)

DT = 1.0e-3


@pytest.mark.parametrize("ref_pallas", ["off", "interpret"])
@pytest.mark.parametrize("ooa", [1, 2])
def test_advance_matches_reference(ooa, ref_pallas):
    """One full step on the flagship config at (8, 8, 32), float64, against
    the reference's XLA sweep and against its Pallas kernels in interpret
    mode.  rtol=1e-9: the port's default path sums the axes' dU like the
    fused kernels do, the XLA path in another order, and the kernels'
    reconstruction differs from the XLA one in the last bit."""
    rcfg = ref_config("glm3d", ooa=ooa, pallas=ref_pallas)
    P = noisy_state(rcfg, 11)
    cfg, Pt, bd = to_port(rcfg, P)
    assert cfg.kernels == ("off" if ref_pallas == "off" else "auto")
    before = Pt.clone()
    out = advance(Pt, DT, cfg, pion_tpu_torch.make_geometry(cfg), bd)
    ref = ref_advance(jnp.asarray(P), DT, rcfg, pion_tpu.make_geometry(rcfg),
                      RefBoundaryData())
    close(out, ref, rtol=1e-9, atol=1e-12)
    assert torch.equal(Pt, before)        # the corrector reads the old P
    assert not torch.equal(out, Pt)


def test_advance_takes_device_scalars():
    """dt as a 0-d tensor (as the fused step hands it over) gives the same
    state as dt as a number."""
    rcfg = ref_config("glm3d")
    cfg, Pt, bd = to_port(rcfg, noisy_state(rcfg, 12))
    geom = pion_tpu_torch.make_geometry(cfg)
    a = advance(Pt, DT, cfg, geom, bd)
    b = advance(Pt, torch.tensor(DT, dtype=torch.float64), cfg, geom, bd)
    close(a, b, rtol=1e-14)


def _run_both(dtype, steps=5):
    rcfg = ref_config("glm3d", dtype=dtype)
    P = noisy_state(rcfg, 13)
    ref = pion_tpu.Simulation(rcfg, P.copy()).run(max_steps=steps)
    cfg, Pt, _ = to_port(rcfg, P)
    sim = Simulation(cfg, Pt, device="cpu").run(max_steps=steps)
    return rcfg, cfg, ref, sim


def test_simulation_run_float64():
    rcfg, cfg, ref, sim = _run_both("float64")
    assert sim.step_count == ref.step_count == 5
    assert sim.P.dtype == torch.float64 and sim.P.device.type == "cpu"
    # dt comes from the same reduction over nearly identical states
    np.testing.assert_allclose(sim.t, ref.t, rtol=1e-12)
    np.testing.assert_allclose(sim.last_dt, ref.last_dt, rtol=1e-12)
    assert np.isfinite(sim.t) and sim.t > 0
    # five steps of last-bit differences in the reconstruction
    close(sim.P, ref.P, rtol=1e-8, atol=1e-11)
    tot = conservation_totals(sim.P, cfg, sim.geom)
    rtot = ref_totals(ref.P, rcfg, ref.geom)
    assert set(tot) == set(rtot)
    for k in tot:
        np.testing.assert_allclose(tot[k], rtot[k], rtol=1e-9, atol=1e-12)


def test_simulation_run_float32():
    """float32 reassociation over 5 steps: fields agree to 2e-4 of each
    variable's maximum."""
    rcfg, cfg, ref, sim = _run_both("float32")
    assert sim.P.dtype == torch.float32 and sim.step_count == 5
    np.testing.assert_allclose(sim.t, ref.t, rtol=1e-5)
    out, want = sim.P.numpy(), np.asarray(ref.P)
    assert want.dtype == np.float32 and np.isfinite(out).all()
    scale = np.abs(want).reshape(cfg.nvar, -1).max(axis=1)
    err = np.abs(out - want).reshape(cfg.nvar, -1).max(axis=1)
    assert float((err / scale).max()) < 2e-4


def test_run_callback_tmax_and_compute_dt(capsys):
    rcfg = ref_config("mhd2d")
    cfg, Pt, _ = to_port(rcfg, noisy_state(rcfg, 14))
    seen = []
    sim = Simulation(cfg, Pt, device="cpu", log_freq=2)
    dt0 = sim.compute_dt()
    ref = pion_tpu.Simulation(rcfg, noisy_state(rcfg, 14))
    np.testing.assert_allclose(dt0, ref.compute_dt(), rtol=1e-13)
    sim.run(tmax=2.5 * dt0, callback=lambda s: seen.append(s.t))
    # the last step is capped so that the run lands on tmax
    np.testing.assert_allclose(sim.t, 2.5 * dt0, rtol=1e-12)
    assert len(seen) == sim.step_count and seen[-1] == sim.t
    assert "New time" in capsys.readouterr().out
    logger = StepLogger(1)
    logger.log(1, 0.1, 0.01, torch.tensor([float("nan")]))
    assert "NON-FINITE" in capsys.readouterr().out


def test_no_silent_cpu_run():
    """Without a CUDA device the entry points raise unless the caller asks
    for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    rcfg = ref_config("glm3d")
    cfg, Pt, _ = to_port(rcfg, noisy_state(rcfg, 15))
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(cfg, Pt)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_step_fns(cfg, pion_tpu_torch.make_geometry(cfg))
    fns = make_step_fns(cfg, pion_tpu_torch.make_geometry(cfg), device="cpu")
    Pn, dt, dt_raw = fns.step(Pt, 0.0, 0.0, 1.0)
    assert dt.ndim == 0 and float(dt) == float(dt_raw) > 0
    # several steps in one dispatch run eagerly on the CPU: one of them is
    # the step above, bit for bit
    Pk, info = fns.multi_step(Pt, 0.0, 0.0, 1.0, K=1)
    assert torch.equal(Pk, Pn) and Pk.device.type == "cpu"
    assert info.tolist() == [[float(dt)], [float(dt_raw)], [1.0]]


@pytest.mark.parametrize("field,value", [
    ("nlevels", 2), ("conduction", True), ("halo", "explicit"),
    ("mesh", "on")])
def test_unported_options_raise(field, value):
    rcfg = ref_config("glm3d")
    P = noisy_state(rcfg, 16)
    cfg = dataclasses.replace(to_port(rcfg, P)[0], **{field: value})
    with pytest.raises(NotImplementedError):
        Simulation(cfg, torch.from_numpy(P), device="cpu")


def test_unported_io_and_physics_raise(tmp_path):
    """What was unported in the first slices now runs (snapshots, winds);
    what is left raises: a restart that would have to rebuild its physics
    from the header's parameter section, and conduction."""
    rcfg = ref_config("glm3d")
    cfg, Pt, _ = to_port(rcfg, noisy_state(rcfg, 17))
    sim = Simulation(cfg, Pt, device="cpu", outfile=str(tmp_path / "run"),
                     params={"EP_chemistry": "1"})
    path = sim.save()
    assert path.endswith("run.00000000.snap")
    # the header carries a parameter section and the caller gives no physics
    with pytest.raises(NotImplementedError, match="item 17"):
        Simulation.restart(path, device="cpu")
    with pytest.raises(ValueError, match="outfile"):
        Simulation(cfg, Pt, device="cpu").save()
    with pytest.raises(NotImplementedError, match="NGHierarchy"):
        Simulation(dataclasses.replace(cfg, nlevels=2), Pt, device="cpu")
    with pytest.raises(NotImplementedError):
        advance(Pt, DT, dataclasses.replace(cfg, conduction=True),
                pion_tpu_torch.make_geometry(cfg))
    with pytest.raises(ValueError, match="shape"):
        Simulation(cfg, Pt[:, :4], device="cpu")
