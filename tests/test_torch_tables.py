"""pion_tpu_torch.microphysics.tables and the rate tables MPv3 builds from
them, against the JAX package's.  The port keeps its own numpy copy of the
rate libraries and rebuilds every table; nothing is shared by import."""
import dataclasses

import numpy as np
import pytest
import torch

from pion_tpu.constants import RSUN
from pion_tpu.microphysics import MPv3 as RefMPv3
from pion_tpu.microphysics import MPv3Config as RefMPv3Config
from pion_tpu.microphysics import tables as ref_tables

from pion_tpu_torch import convert
from pion_tpu_torch.microphysics import MPv3, tables

torch.set_num_threads(1)

# the same numpy formulas on the same inputs: the tables agree to the last
# bits (1e-13 leaves room for a libm that differs between two builds)
RTOL = 1.0e-13

T_GRID = np.logspace(1.0, 9.0, 97)


@pytest.mark.parametrize("name", [
    "hii_rad_recomb_rate", "hii_total_cooling", "hi_coll_ion_rates",
    "hi_coll_excitation_cooling_rate", "cooling_rate_wss09_metals"])
def test_rate_functions_match_reference(name):
    got = getattr(tables, name)(T_GRID)
    ref = getattr(ref_tables, name)(T_GRID)
    for g, r in zip(np.atleast_2d(np.asarray(got)),
                    np.atleast_2d(np.asarray(ref))):
        np.testing.assert_allclose(g, r, rtol=RTOL)


def test_cross_sections_and_photoion_tables_match_reference():
    E = np.logspace(np.log10(tables.E_THRESH), np.log10(tables.E_THRESH) + 2,
                    33)
    for name in ("hi_xsection_fractional", "hi_xsection"):
        np.testing.assert_allclose(getattr(tables, name)(E),
                                   getattr(ref_tables, name)(E), rtol=RTOL)
    assert tables.LOGTEN == ref_tables.LOGTEN
    got = tables.build_photoion_tables(3.75e4, 10 * RSUN)
    ref = ref_tables.build_photoion_tables(3.75e4, 10 * RSUN)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, err_msg=k)


def _ref_mp(ion):
    mf = ion == "mfion"
    return RefMPv3(RefMPv3Config(
        tracer_slot=5, ion_src=ion, n_idot=1e48, tstar=3.75e4 if mf else 0.0,
        rstar_cm=10 * RSUN if mf else 0.0, min_temperature=50.0))


@pytest.mark.parametrize("ion", [None, "mono", "mfion"])
def test_mpv3_tables_match_reference(ion):
    ref = _ref_mp(ion)
    mp = MPv3(convert.mp_config_from_reference(
        "MPv3", dataclasses.asdict(ref.mpc)))
    ref_tab = {k: np.asarray(v) for k, v in ref.tab.items()}
    n = convert.check_rate_tables(mp, ref_tab, rtol=RTOL)
    assert n == len(ref_tab) - len(convert.TPU_LAYOUT_TABLES) >= 16
    assert mp.rate_scale_log == ref.rate_scale_log
    assert mp.tau_bounds == ref.tau_bounds
    for attr in ("_lt0", "_inv_dlt") + (
            ("_ltau0", "_inv_dltau", "_n_tau") if ion == "mfion" else ()):
        assert getattr(mp, attr) == getattr(ref, attr)
    # the kernels' row-major layouts are the stacks transposed
    assert mp.tab["t1_rows"].shape == (11, mp.mpc.n_table)
    if ion == "mfion":
        assert mp.tab["tau_rows"].shape == (4, mp._n_tau)
        stack, ls = mp.set_multifreq_source_properties(3.0e4, 8 * RSUN)
        rstack, rls = ref.set_multifreq_source_properties(3.0e4, 8 * RSUN)
        assert ls == pytest.approx(rls, rel=RTOL)
        np.testing.assert_allclose(stack, rstack, rtol=RTOL, atol=1e-13)


def test_check_rate_tables_rejects_a_wrong_table():
    ref = _ref_mp("mfion")
    mp = MPv3(convert.mp_config_from_reference(
        "MPv3", dataclasses.asdict(ref.mpc)))
    ref_tab = {k: np.array(v) for k, v in ref.tab.items()}
    ref_tab["rrhp"] = ref_tab["rrhp"] * (1.0 + 1e-9)
    with pytest.raises(ValueError, match="rrhp"):
        convert.check_rate_tables(mp, ref_tab)
    with pytest.raises(ValueError, match="missing"):
        convert.check_rate_tables(mp, {"no_such_table": np.zeros(3)})
    with pytest.raises(ValueError, match="unknown MPv3Config keys"):
        convert.mp_config_from_reference("MPv3", {"tracer_slot": 5,
                                                  "bogus": 1})
