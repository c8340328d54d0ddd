"""Atomic rate data and lookup-table construction for the chemistry modules.

Numpy-only equivalent of the reference rate libraries
(reference: source/microphysics/hydrogen_mp.cpp (Voronov 1997 collisional
ionization, Aggarwal 1983 collisional excitation), hydrogen_recomb_Hummer94.cpp
(Hummer 1994 case-B recombination/cooling), cooling_SD93_cie.cpp (Wiersma et
al. 2009 metals-only CIE curve), hydrogen_photoion.cpp (multifrequency
blackbody photoionization integrals)).

The numeric tables below are published scientific data (Hummer 1994 MNRAS 268;
Aggarwal 1983; Wiersma, Schaye & Smith 2009 MNRAS 393).

Strategy matches the reference runtime exactly: the module builds dense
(200-point) linear-interpolation tables over log-spaced T (and n_e) once at
setup (reference: MPv3.cpp:1945-2105 gen_mpv3_lookup_tables), which the
vectorized ydot then indexes with an arithmetic bin index.  The dense
tables are themselves built from natural cubic splines of the source data,
mirroring the reference's interpolate.spline/splint.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

LOGTEN = np.log(10.0)


# ---------------------------------------------------------------------------
# Natural cubic spline (setup-time only, numpy)
# ---------------------------------------------------------------------------

class CubicSpline:
    """Natural cubic spline matching the reference's spline/splint
    (reference: source/tools/interpolate.cpp, Numerical-Recipes style)."""

    def __init__(self, x, y):
        x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        n = len(x)
        u = np.zeros(n)
        y2 = np.zeros(n)
        for i in range(1, n - 1):
            sig = (x[i] - x[i - 1]) / (x[i + 1] - x[i - 1])
            p = sig * y2[i - 1] + 2.0
            y2[i] = (sig - 1.0) / p
            u[i] = (
                (y[i + 1] - y[i]) / (x[i + 1] - x[i])
                - (y[i] - y[i - 1]) / (x[i] - x[i - 1])
            )
            u[i] = (6.0 * u[i] / (x[i + 1] - x[i - 1]) - sig * u[i - 1]) / p
        for k in range(n - 2, -1, -1):
            y2[k] = y2[k] * y2[k + 1] + u[k]
        self.x, self.y, self.y2 = x, y, y2

    def __call__(self, xq):
        xq = np.asarray(xq, dtype=float)
        i = np.clip(np.searchsorted(self.x, xq) - 1, 0, len(self.x) - 2)
        h = self.x[i + 1] - self.x[i]
        a = (self.x[i + 1] - xq) / h
        b = (xq - self.x[i]) / h
        return (
            a * self.y[i] + b * self.y[i + 1]
            + ((a**3 - a) * self.y2[i] + (b**3 - b) * self.y2[i + 1]) * h * h / 6.0
        )


# ---------------------------------------------------------------------------
# Hummer (1994) case-B H recombination + cooling (table 1)
# (reference: hydrogen_recomb_Hummer94.cpp:40-100; T_i = 10^(1+0.2i))
# ---------------------------------------------------------------------------

_HUM_T = 10.0 ** (1.0 + 0.2 * np.arange(31))
_HUM_CASEB = np.array([
    9.283e-11, 8.823e-11, 8.361e-11, 7.898e-11, 7.435e-11, 6.973e-11,
    6.512e-11, 6.054e-11, 5.599e-11, 5.147e-11, 4.700e-11, 4.258e-11,
    3.823e-11, 3.397e-11, 2.983e-11, 2.584e-11, 2.204e-11, 1.847e-11,
    1.520e-11, 1.226e-11, 9.696e-12, 7.514e-12, 5.710e-12, 4.257e-12,
    3.117e-12, 2.244e-12, 1.590e-12, 1.110e-12, 7.642e-13, 5.199e-13,
    3.498e-13,
])
_HUM_COOLTOT = np.array([
    9.348e-11, 8.889e-11, 8.432e-11, 7.977e-11, 7.525e-11, 7.077e-11,
    6.633e-11, 6.194e-11, 5.758e-11, 5.332e-11, 4.915e-11, 4.508e-11,
    4.112e-11, 3.733e-11, 3.373e-11, 3.039e-11, 2.737e-11, 2.472e-11,
    2.247e-11, 2.062e-11, 1.914e-11, 1.797e-11, 1.704e-11, 1.628e-11,
    1.563e-11, 1.505e-11, 1.451e-11, 1.402e-11, 1.358e-11, 1.318e-11,
    1.285e-11,
])
_hum_alpha = CubicSpline(_HUM_T, _HUM_CASEB / np.sqrt(_HUM_T))
_hum_btot = CubicSpline(_HUM_T, _HUM_COOLTOT / np.sqrt(_HUM_T))


def _extrap_pow(table_x, table_y, T, spline):
    """Evaluate spline with power-law extrapolation in log-log beyond the
    table ends (reference: Hii_rad_recomb_rate:165-205)."""
    T = np.asarray(T, dtype=float)
    lo, hi = table_x[0], table_x[-1]
    y_lo, y_hi = table_y[0], table_y[-1]
    slope_lo = (np.log10(table_y[1]) - np.log10(table_y[0])) / (
        np.log10(table_x[1]) - np.log10(table_x[0]))
    slope_hi = (np.log10(table_y[-1]) - np.log10(table_y[-2])) / (
        np.log10(table_x[-1]) - np.log10(table_x[-2]))
    mid = spline(np.clip(T, lo, hi))
    out = np.where(T < lo, y_lo * (T / lo) ** slope_lo, mid)
    out = np.where(T > hi, y_hi * (T / hi) ** slope_hi, out)
    return out


def hii_rad_recomb_rate(T):
    """alpha_B(T) [cm^3/s] (Hummer 1994 case B)."""
    return _extrap_pow(_HUM_T, _HUM_CASEB / np.sqrt(_HUM_T), T, _hum_alpha)


def hii_total_cooling(T):
    """Case-B recombination + free-free cooling coefficient
    beta^tot(T)*k_B*T [erg cm^3/s]: Hummer's table is beta/sqrt(T); the total
    cooling per (n_e n_H+) is beta*k_B*T (reference: Hii_total_cooling:247)."""
    beta = _extrap_pow(_HUM_T, _HUM_COOLTOT / np.sqrt(_HUM_T), T, _hum_btot)
    return beta * 1.380649e-16 * np.asarray(T, dtype=float)


# ---------------------------------------------------------------------------
# H collisional ionization (Voronov 1997 fit) + cooling
# (reference: hydrogen_mp.cpp:162-225)
# ---------------------------------------------------------------------------

def hi_coll_ion_rates(T):
    """Returns (rate [cm^3/s], cooling coefficient [erg cm^3/s])."""
    t = 1.578e5 / np.asarray(T, dtype=float)
    cir = 2.91e-8 * np.exp(0.39 * np.log(t) - t) / (0.232 + t)
    return cir, 2.18e-11 * cir


# ---------------------------------------------------------------------------
# H collisional excitation cooling (Aggarwal 1983 / Raga+ 1997)
# (reference: hydrogen_mp.cpp:78-160; log-log spline w/ linear extrapolation)
# ---------------------------------------------------------------------------

_CX_T = np.log10(np.array([
    3162.2776602, 3981.0717055, 5011.8723363, 6309.5734448, 7943.2823472,
    10000.0, 12589.2541179, 15848.9319246, 19952.6231497, 25118.8643151,
    31622.7766017, 39810.7170553, 50118.7233627, 63095.7344480,
    79432.8234724, 100000.0, 125892.5411794, 158489.3192461, 199526.2314969,
    251188.6431510, 316227.7660168, 398107.1705535, 501187.2336273,
    630957.3444802, 794328.2347243, 1000000.0,
]))
_CX_R = np.log10(np.array([
    1.150800e-34, 2.312065e-31, 9.571941e-29, 1.132400e-26, 4.954502e-25,
    9.794900e-24, 1.035142e-22, 6.652732e-22, 2.870781e-21, 9.036495e-21,
    2.218196e-20, 4.456562e-20, 7.655966e-20, 1.158777e-19, 1.588547e-19,
    2.013724e-19, 2.393316e-19, 2.710192e-19, 2.944422e-19, 3.104560e-19,
    3.191538e-19, 3.213661e-19, 3.191538e-19, 3.126079e-19, 3.033891e-19,
    2.917427e-19,
]))
_cx_spline = CubicSpline(_CX_T, _CX_R)


def hi_coll_excitation_cooling_rate(T):
    lT = np.log10(np.asarray(T, dtype=float))
    lo, hi = _CX_T[0], _CX_T[-1]
    slope_lo = (_CX_R[1] - _CX_R[0]) / (_CX_T[1] - _CX_T[0])
    slope_hi = (_CX_R[-1] - _CX_R[-2]) / (_CX_T[-1] - _CX_T[-2])
    mid = _cx_spline(np.clip(lT, lo, hi))
    out = np.where(lT < lo, _CX_R[0] + slope_lo * (lT - lo), mid)
    out = np.where(lT > hi, _CX_R[-1] + slope_hi * (lT - hi), out)
    return np.exp(LOGTEN * out)


# ---------------------------------------------------------------------------
# Wiersma, Schaye & Smith (2009) metals-only CIE cooling curve
# (reference: cooling_SD93_cie.cpp:443-553 setup_WSS09_CIE_OnlyMetals)
# ---------------------------------------------------------------------------

_WSS_LOGT = np.linspace(2.0, 8.98185031, 91)
_WSS_LOGL = np.array([
    -26.9042032, -26.8339466, -26.7628015, -26.6852365, -26.6026698,
    -26.5218150, -26.4469693, -26.3761355, -26.3097777, -26.2474256,
    -26.1886746, -26.1332877, -26.0808330, -26.0309113, -25.9830826,
    -25.9369007, -25.8919300, -25.8476214, -25.8031708, -25.7581287,
    -25.7139260, -25.6680924, -25.6216866, -25.5784123, -25.5358056,
    -25.4579940, -25.2789911, -24.2634880, -23.1979645, -22.7183209,
    -22.5726495, -22.4284223, -22.2590643, -22.0877851, -21.9241810,
    -21.7723986, -21.6330514, -21.5062964, -21.4071669, -21.3475926,
    -21.3492162, -21.3325337, -21.3034976, -21.2874309, -21.3074247,
    -21.4856951, -21.6658156, -21.7176117, -21.7351658, -21.7860161,
    -21.8142313, -21.8029824, -21.8098104, -21.8455343, -21.9092400,
    -22.0294769, -22.1901200, -22.3345038, -22.4678858, -22.5823022,
    -22.6539966, -22.6847250, -22.6876913, -22.6767177, -22.6732880,
    -22.6964528, -22.7613667, -22.8719040, -23.0037799, -23.1212437,
    -23.2122653, -23.2778695, -23.3214754, -23.3486237, -23.3630273,
    -23.3677304, -23.3656718, -23.3604758, -23.3515894, -23.3410786,
    -23.3304239, -23.3191682, -23.3067658, -23.2928461, -23.2761560,
    -23.2529092, -23.2280201, -23.2018214, -23.1746034, -23.1467139,
    -23.1183757,
])
_wss_spline = CubicSpline(_WSS_LOGT, _WSS_LOGL)


def cooling_rate_wss09_metals(T):
    """Lambda_metals(T) [erg cm^3 / s] for solar metallicity.
    MinSlope hardcoded to 8.0 like the reference (:530)."""
    lT = np.log10(np.asarray(T, dtype=float))
    lo, hi = _WSS_LOGT[0], _WSS_LOGT[-1]
    slope_hi = (_WSS_LOGL[-1] - _WSS_LOGL[-2]) / (_WSS_LOGT[-1] - _WSS_LOGT[-2])
    mid = _wss_spline(np.clip(lT, lo, hi))
    out = np.where(lT < lo, _WSS_LOGL[0] + 8.0 * (lT - lo), mid)
    out = np.where(lT > hi, _WSS_LOGL[-1] + slope_hi * (lT - hi), out)
    return np.exp(LOGTEN * out)


# ---------------------------------------------------------------------------
# Photoionization cross-section and multifrequency source tables
# (reference: hydrogen_photoion.cpp)
# ---------------------------------------------------------------------------

E_THRESH = 2.178720e-11  # 13.6 eV in erg (reference: :263)
SIGMA0_XS = 6.3042e-18   # sigma(13.6 eV) [cm^2]


def hi_xsection_fractional(E):
    """sigma(E)/sigma(13.6eV) ~ (E/E0)^-3.5 (reference: :263-295)."""
    E = np.asarray(E, dtype=float)
    return np.where(E < E_THRESH, 0.0, np.exp(-3.5 * np.log(E / 2.18e-11)))


def hi_xsection(E):
    return 6.3042e-18 * hi_xsection_fractional(E)


def _simpson_log(f, xmin, xmax, n):
    """Simpson integration in log-space, matching the reference's scheme
    (reference: photoion_rate_source_integral:536-570)."""
    h = (np.log(xmax) - np.log(xmin)) / n
    X = np.log(xmin) + h * np.arange(n + 1)
    E = np.exp(X)
    w = np.full(n + 1, 4.0)
    w[2::2] = 2.0
    w[0] = w[-1] = 1.0
    vals = np.array([E[i] * f(E[i]) for i in range(n + 1)])
    return max(np.sum(w * vals) * h / 3.0, 1.0e-200)


def build_photoion_tables(Tstar: float, Rstar_cm: float,
                          tau_min: float = 1.0e-3, tau_max: float = 1.0e6,
                          Emax: float = 54.41778 * 1.602e-12,
                          n_sub: int = 800, n_spl: int = 50) -> Dict:
    """Multifrequency blackbody photoionization/heating rate tables
    (reference: Setup_photoionisation_rate_table:372-440 and
    set_multifreq_source_properties:686-740).

    Returns log10-spaced tau grid and log10 rates; runtime lookups are
    linear in log-log (the reference uses cubic splines on the same 50-point
    grid; we resample to a 4x denser grid through the spline so linear
    interpolation agrees to < 1e-4).
    """

    lt = np.linspace(np.log10(tau_min), np.log10(tau_max), n_spl)
    taus = 10.0 ** lt
    emin = 13.6 * 1.602e-12

    # vectorized Simpson in log-E (same scheme as _simpson_log): one
    # (n_tau, n_E) integrand matrix instead of per-point Python calls —
    # the table is rebuilt at runtime for evolving sources when Teff/L
    # move >1% (reference: set_multifreq_source_properties, MPv3.cpp:686)
    h = (np.log(Emax) - np.log(emin)) / n_sub
    E = np.exp(np.log(emin) + h * np.arange(n_sub + 1))
    w = np.full(n_sub + 1, 4.0)
    w[2::2] = 2.0
    w[0] = w[-1] = 1.0
    sigf = hi_xsection_fractional(E)                    # (nE,)
    base = E * E / np.expm1(E / (1.38e-16 * Tstar)) \
        * 3.020e59 * Rstar_cm * Rstar_cm
    atten = np.exp(-taus[:, None] * sigf[None, :])      # (ntau, nE)
    mat = base[None, :] * atten * E[None, :]            # E factor: log-space

    def simp(extra):
        vals = (mat * extra[None, :] * w[None, :]).sum(axis=1) * h / 3.0
        return np.maximum(vals, 1.0e-200)

    pi_rate = simp(np.ones_like(E))
    pi_heat = simp(E - 2.18e-11)
    lt_rate = simp(SIGMA0_XS * sigf)
    lt_heat = simp(SIGMA0_XS * sigf * (E - 2.18e-11))
    # resample through cubic splines onto a denser grid for linear lookup;
    # enforce monotone non-increasing rates (the spline oscillates at the
    # exp-underflow cliff where the integral hits its 1e-200 floor, which
    # the reference tolerates because no photons survive there anyway)
    dense = np.linspace(lt[0], lt[-1], 4 * n_spl)
    out = {"log_tau": dense, "tau_min": tau_min, "tau_max": tau_max}
    for name, tab in (("pi_rate", pi_rate), ("pi_heat", pi_heat),
                      ("lt_pi_rate", lt_rate), ("lt_pi_heat", lt_heat)):
        out[name] = np.minimum.accumulate(CubicSpline(lt, np.log10(tab))(dense))
    return out
