"""pion_tpu_torch.microphysics.cooling (the cooling-only module) against
pion_tpu.microphysics.cooling on the same seeded inputs: each of the six
Edot curves, the 8-substep update, the cooling timescale, the table data,
and the module inside Physics (the temperature clamp and the dt limit).
CPU, float64."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pion_tpu.microphysics import cooling as ref_cooling

from pion_tpu_torch import convert
from pion_tpu_torch.constants import K_B, M_P, PG, RO
from pion_tpu_torch.microphysics.cooling import CoolingConfig, MPOnlyCooling
from pion_tpu_torch.microphysics import cooling

torch.set_num_threads(1)

RTOL = 1e-12


def pair(curve, **kw):
    ref = ref_cooling.MPOnlyCooling(ref_cooling.CoolingConfig(curve=curve,
                                                              **kw))
    mp = MPOnlyCooling(convert.mp_config_from_reference(
        "MPOnlyCooling", dataclasses.asdict(ref.mpc)))
    return ref, mp


def gas(seed, shape=(16, 32), nvar=6):
    """Densities of 1e-26..1e-20 g/cm^3 and temperatures of 5..3e9 K (both
    ends of the table and beyond), log-uniform."""
    rng = np.random.default_rng(seed)
    P = np.zeros((nvar,) + shape)
    P[RO] = 10.0 ** rng.uniform(-26.0, -20.0, shape)
    T = 10.0 ** rng.uniform(np.log10(5.0), np.log10(3.0e9), shape)
    P[PG] = P[RO] / (0.61 * M_P) * K_B * T
    P[2:5] = 1.0e6 * rng.standard_normal((3,) + shape)
    P[5] = rng.random(shape)
    return P, T


def close(out, ref, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("curve", cooling.COOLING_CURVES)
def test_edot_matches_reference(curve):
    ref, mp = pair(curve)
    P, T = gas(1)
    rho = P[RO]
    out = mp.edot(torch.from_numpy(rho), torch.from_numpy(T))
    want = np.asarray(ref.edot(jnp.asarray(rho), jnp.asarray(T)))
    assert out.dtype == torch.float64 and out.shape == rho.shape
    close(out, want, rtol=RTOL, atol=1e-12 * np.abs(want).max())
    # the curve's sign where it is known: pure cooling curves never heat
    if curve in ("SD93_CIE",):
        assert float(out.max()) <= 0.0


@pytest.mark.parametrize("curve", ["SD93_CIE", "WSS09_CIE_LINE_HEAT_COOL",
                                   "KI02"])
def test_update_and_timescales_match_reference(curve):
    ref, mp = pair(curve)
    P, _ = gas(2)
    for dt in (1.0e9, 3.0e11):
        out = mp.update(torch.from_numpy(P), dt, None)
        want = np.asarray(ref.update(jnp.asarray(P), dt, None))
        close(out, want, rtol=RTOL, atol=1e-300)
        # only the pressure moves
        assert np.array_equal(out.numpy()[:PG], P[:PG])
        assert np.array_equal(out.numpy()[PG + 1:], P[PG + 1:])
    ts = mp.timescales(torch.from_numpy(P), None)
    assert ts.ndim == 0
    close(ts, ref.timescales(jnp.asarray(P), None), rtol=RTOL)
    # temperature and set_temp round trip
    Pt = torch.from_numpy(P)
    T = mp.temperature(Pt, None)
    close(T, np.asarray(ref.temperature(jnp.asarray(P), None)), rtol=RTOL)
    back = mp.set_temp(Pt, T, None)
    close(back, P, rtol=1e-13)


def test_tables_match_reference():
    """The host tables the module builds, each curve and the SD93 and KI02
    functions over and beyond their range."""
    ref, mp = pair("WSS09_CIE_LINE_HEAT_COOL", min_temperature=20.0,
                   max_temperature=1.0e8)
    np.testing.assert_allclose(mp.Tg, np.asarray(ref.Tg), rtol=0)
    for k, v in ref.tab.items():
        np.testing.assert_allclose(mp.tab[k], np.asarray(v), rtol=1e-14)
    T = np.logspace(0.5, 9.5, 200)
    np.testing.assert_allclose(cooling.cooling_rate_sd93_cie(T),
                               ref_cooling.cooling_rate_sd93_cie(T),
                               rtol=1e-14)
    np.testing.assert_allclose(cooling.cooling_rate_ki02(T),
                               ref_cooling.cooling_rate_ki02(T), rtol=1e-14)
    np.testing.assert_allclose(
        cooling.lambda_starbench(torch.from_numpy(T)).numpy(),
        np.asarray(ref_cooling.lambda_starbench(jnp.asarray(T))), rtol=1e-13)


def test_config_crosses_both_ways_and_bad_curve_raises():
    mpc = CoolingConfig(curve="KI02", min_temperature=50.0, mu=1.2)
    fields = convert.mp_config_to_reference(mpc)
    assert ref_cooling.CoolingConfig(**fields) == ref_cooling.CoolingConfig(
        curve="KI02", min_temperature=50.0, mu=1.2)
    assert convert.mp_config_from_reference("MPOnlyCooling", fields) == mpc
    with pytest.raises(ValueError, match="unknown CoolingConfig keys"):
        convert.mp_config_from_reference("MPOnlyCooling",
                                         dict(fields, tracer_slot=5))
    with pytest.raises(ValueError, match="cooling curve"):
        MPOnlyCooling(CoolingConfig(curve="nope"))
    phys = convert.physics_from_reference(fields, dt_limit=1)
    assert isinstance(phys.mp, MPOnlyCooling) and phys.mp.mpc == mpc


def test_float32_table_lookup_stays_float32():
    """A float32 state reads a float32 table, kept per dtype and device."""
    _, mp = pair("WSS09_CIE_LINE_HEAT_COOL")
    P, T = gas(3)
    rho32 = torch.from_numpy(P[RO].astype(np.float32))
    T32 = torch.from_numpy(T.astype(np.float32))
    out = mp.edot(rho32, T32)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert mp._table(T32) is mp._table(T32)
    want = mp.edot(torch.from_numpy(P[RO]), torch.from_numpy(T))
    scale = float(want.abs().max())
    assert float((out.double() - want).abs().max()) <= 1e-4 * scale
