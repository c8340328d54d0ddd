"""Shock-tube (Riemann problem) initial conditions, 1/2/3D.

The port's own copy of ``pion_tpu/ics/shocktube.py`` (numpy only; the same
arrays bit for bit).  Reference: source/ics/shock_tube.cpp — the predefined
test menu get_riemann_ics (shock_tube.cpp:462-860: Toro 1-5, Falle's BW/AW/FS/SS/
FR/SR/OFS, Ryu & Jones 1a-5b), the 1D two-cell interface smoothing
(shock_tube.cpp:327-336) and the 2D rotated-interface fill with state
rotation about z (shock_tube.cpp:338-365).  States are published test
data (Toro 1999 table 4.1; Ryu & Jones 1995 ApJ 442, 228), not code.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..config import SimConfig
from ..constants import BX, BY, BZ, PG, RO, VX, VY, VZ

_S4P = 1.0 / np.sqrt(4.0 * np.pi)

# number -> (left(ro,pg,vx,vy,vz,bx,by,bz), right(...), x0, gamma, tfinish,
#            needs_mhd); left/right in the reference's primitive order.
# (reference: shock_tube.cpp:462-860)
RIEMANN_TESTS = {
    # Toro (1999) tests 1-5
    1: ((1.0, 1.0, 0.75, 0, 0, 0, 0, 0),
        (0.125, 0.1, 0.0, 0, 0, 0, 0, 0), 0.3, 1.4, 0.2, False),
    2: ((1.0, 0.4, -2.0, 0, 0, 0, 0, 0),
        (1.0, 0.4, 2.0, 0, 0, 0, 0, 0), 0.5, 1.4, 0.15, False),
    3: ((1.0, 1000.0, 0.0, 0, 0, 0, 0, 0),
        (1.0, 0.01, 0.0, 0, 0, 0, 0, 0), 0.5, 1.4, 0.012, False),
    4: ((5.99924, 460.894, 19.5975, 0, 0, 0, 0, 0),
        (5.99242, 46.0950, -6.19633, 0, 0, 0, 0, 0), 0.4, 1.4, 0.035, False),
    5: ((1.0, 1000.0, -19.59745, 0, 0, 0, 0, 0),
        (1.0, 0.01, -19.59745, 0, 0, 0, 0, 0), 0.8, 1.4, 0.012, False),
    # near-stationary rarefaction
    6: ((0.604543, 1.69426, 1.876, 0.4, 0.4, 0, 0, 0),
        (1.0, 1.0, 2.0, 0.5, 0.5, 0, 0, 0), 0.3, 5.0 / 3.0, 0.15, False),
    # Falle suite
    7: ((1.0, 1.0, 0, 0, 0, 0.75, 1.0, 0),          # 'BW' Brio & Wu
        (0.125, 0.1, 0, 0, 0, 0.75, -1.0, 0), 0.5, 2.0, 0.12, True),
    8: ((1.0, 1.0, 0, 1.0, 1.0, 1.0, 1.0, 0),        # 'AW' Alfven wave
        (1.0, 1.0, 0, 1.0, 1.0, 1.0, 1.0, 0), 0.5, 5.0 / 3.0, 5.0, True),
    9: ((3.0, 16.33, -0.732, -1.333, 0, 3.0, 2.309, 0),   # 'FS'
        (1.0, 1.0, -4.196, 0, 0, 3.0, 0, 0), 0.3, 5.0 / 3.0, 0.4, True),
    10: ((1.368, 1.769, 0.269, 1.0, 0, 1.0, 0, 0),        # 'SS'
         (1.0, 1.0, 0, 0, 0, 1.0, 1.0, 0), 0.3, 5.0 / 3.0, 0.5, True),
    11: ((1.0, 2.0, 0, 0, 0, 1.0, 3.0, 0),                # 'FR'
         (0.2641, 0.2175, 3.6, -2.551, 0, 1.0, 0, 0), 0.5, 5.0 / 3.0, 0.1,
         True),
    12: ((1.0, 2.0, 0, 0, 0, 1.0, 0, 0),                  # 'SR'
         (0.2, 0.1368, 1.186, 2.967, 0, 1.0, 1.6405, 0), 0.5, 5.0 / 3.0, 0.3,
         True),
    13: ((1.0, 1.0, 6.505, 1.0, 0, 1.0, 1.0, 1.0),        # 'OFS'
         (3.0, 20.268, 2.169, 1.331, 0.331, 1.0, 3.153, 3.153), 0.5,
         5.0 / 3.0, 0.15, True),
    # trivial (noise carrier)
    14: ((1.0,) * 8, (1.0,) * 8, 0.5, None, None, False),
    # Ryu & Jones (1995) 1a-5b
    15: ((1.0, 20.0, 10.0, 0, 0, 5 * _S4P, 5 * _S4P, 0),
         (1.0, 1.0, -10.0, 0, 0, 5 * _S4P, 5 * _S4P, 0), 0.5, 5.0 / 3.0,
         None, True),
    16: ((1.0, 1.0, 0, 0, 0, 3 * _S4P, 5 * _S4P, 0),
         (0.1, 10.0, 0, 0, 0, 3 * _S4P, 2 * _S4P, 0), 0.5, 5.0 / 3.0,
         None, True),
    17: ((1.08, 0.95, 1.2, 0.01, 0.5, 2 * _S4P, 3.6 * _S4P, 2 * _S4P),
         (1.0, 1.0, 0, 0, 0, 2 * _S4P, 4 * _S4P, 2 * _S4P), 0.5, 5.0 / 3.0,
         None, True),
    18: ((1.0, 1.0, 0, 0, 0, 3 * _S4P, 6 * _S4P, 0),
         (0.1, 10.0, 0, 2.0, 1.0, 3 * _S4P, 1 * _S4P, 0), 0.5, 5.0 / 3.0,
         None, True),
    19: ((0.1, 0.4, 50.0, 0, 0, 0.0, -1 * _S4P, -2 * _S4P),
         (0.1, 0.2, 0, 0, 0, 0.0, 1 * _S4P, 2 * _S4P), 0.5, 5.0 / 3.0,
         None, True),
    20: ((1.0, 1.0, -1.0, 0, 0, 0.0, 1.0, 0),
         (1.0, 1.0, 1.0, 0, 0, 0.0, 1.0, 0), 0.5, 5.0 / 3.0, None, True),
    21: ((1.0, 1.0, 0, 0, 0, 1.0, 1.0, 0),
         (0.2, 0.1, 0, 0, 0, 1.0, 0.0, 0), 0.5, 5.0 / 3.0, None, True),
    22: ((0.4, 0.52467, -0.66991, 0.98263, 0, 1.3, 0.0025293, 0),
         (1.0, 1.0, 0, 0, 0, 1.3, 1.0, 0), 0.5, 5.0 / 3.0, None, True),
    23: ((0.65, 0.5, 0.667, -0.257, 0, 0.75, 0.55, 0),
         (1.0, 0.75, 0.4, -0.94, 0, 0.75, 0.0, 0), 0.5, 5.0 / 3.0, None,
         True),
    24: ((1.0, 1.0, 0, 0, 0, 0.7, 0.0, 0),
         (0.3, 0.2, 0, 0, 1.0, 0.7, 1.0, 0), 0.5, 5.0 / 3.0, None, True),
    25: ((1.0, 1.0, 0, 0, 0, 0.75, 1.0, 0),
         (0.125, 0.1, 0, 0, 0, 0.75, -1.0, 0), 0.5, 5.0 / 3.0, None, True),
    26: ((1.0, 1.0, 0, 0, 0, 1.3, 1.0, 0),
         (0.4, 0.4, 0, 0, 0, 1.3, -1.0, 0), 0.5, 5.0 / 3.0, None, True),
}

# back-compat alias: Toro table as (left(rho,v,p), right, x0)
TORO = {n: ((RIEMANN_TESTS[n][0][0], RIEMANN_TESTS[n][0][2],
             RIEMANN_TESTS[n][0][1]),
            (RIEMANN_TESTS[n][1][0], RIEMANN_TESTS[n][1][2],
             RIEMANN_TESTS[n][1][1]),
            RIEMANN_TESTS[n][2]) for n in range(1, 6)}


def _full_state(cfg: SimConfig, s8) -> np.ndarray:
    """Map the reference 8-slot (ro,pg,vx,vy,vz,bx,by,bz) onto cfg.nvar."""
    out = np.zeros(cfg.nvar)
    out[RO], out[PG] = s8[0], s8[1]
    out[VX : VX + 3] = s8[2:5]
    if cfg.eqn.is_mhd:
        out[BX : BX + 3] = s8[5:8]
    return out


def _rotate_xy(state: np.ndarray, theta: float, cfg: SimConfig) -> np.ndarray:
    """Rotate v and B about the z-axis (reference: eqns_base::rotateXY)."""
    out = state.copy()
    c, s = np.cos(theta), np.sin(theta)
    for k in [VX] + ([BX] if cfg.eqn.is_mhd else []):
        vx, vy = out[k], out[k + 1]
        out[k] = c * vx - s * vy
        out[k + 1] = s * vx + c * vy
    return out


def shocktube(cfg: SimConfig, left, right, x0: float,
              angle_xy: float = 0.0) -> np.ndarray:
    """Riemann-problem IC in cfg.ndim dimensions.

    1D: linear smoothing of the jump over |x-x0| < 2*dx (reference:
    shock_tube.cpp:327-336 with dx=2*DX).  2D/3D: sharp interface along
    the plane x = x0 + (0.5 - y) tan(angle_xy), with the left/right state
    vectors rotated by ``angle_xy`` about z (reference: :338-365; the
    reference refuses rotated 3D — here 3D extrudes the 2D layout).
    """
    left = np.asarray(left, dtype=float)[: cfg.nvar]
    right = np.asarray(right, dtype=float)[: cfg.nvar]
    x = cfg.cell_centers(cfg.ndim - 1)  # physical x = last array axis

    if cfg.ndim == 1:
        dxs = 2.0 * cfg.dx
        w = np.clip(0.5 + 0.5 * (x - x0) / dxs, 0.0, 1.0)
        w = np.where(x < x0 - dxs, 0.0, np.where(x > x0 + dxs, 1.0, w))
        return (left[:, None] * (1.0 - w)[None, :]
                + right[:, None] * w[None, :])

    theta = angle_xy
    if theta != 0.0:
        left = _rotate_xy(left, theta, cfg)
        right = _rotate_xy(right, theta, cfg)
    # physical y axis = array axis ndim-2
    yax = cfg.ndim - 2
    y = cfg.cell_centers(yax)
    tt = np.tan(theta)
    xs = x0 + (0.5 - cfg.xmin[yax]) * tt - (y - cfg.xmin[yax]) * tt
    # broadcast: mask over (y, x) then extrude along z if 3D
    mask2 = x[None, :] <= xs[:, None]
    if cfg.ndim == 3:
        mask2 = np.broadcast_to(mask2[None], cfg.shape)
    P = np.where(mask2[None], left.reshape((-1,) + (1,) * cfg.ndim),
                 right.reshape((-1,) + (1,) * cfg.ndim))
    return np.ascontiguousarray(P)


def predefined_test(cfg: SimConfig, number: int,
                    angle_xy: float = 0.0) -> np.ndarray:
    """One of the reference's predefined tests (get_riemann_ics menu)."""
    l8, r8, x0, gam, _tf, needs_mhd = RIEMANN_TESTS[number]
    if needs_mhd and not cfg.eqn.is_mhd:
        raise ValueError(f"shock-tube test {number} needs MHD equations "
                         "(reference: get_riemann_ics eqns check)")
    P = shocktube(cfg, _full_state(cfg, l8), _full_state(cfg, r8), x0,
                  angle_xy=angle_xy)
    if number == 8:  # Alfven-wave: rotation profile on [x0, x0+0.3)
        assert cfg.ndim == 1, "AW test is 1D (reference errors otherwise)"
        x = cfg.cell_centers(0)
        ln, amp = 0.3, 1.0
        ph = 2.0 * np.pi * (x - x0) / ln
        in_w = (x >= x0) & (x < x0 + ln)
        P[VY] = np.where(in_w, amp * np.cos(ph), P[VY])
        P[BY] = np.where(in_w, amp * np.cos(ph), P[BY])
        P[VZ] = np.where(in_w, amp * (1.0 + np.sin(ph)), P[VZ])
        P[BZ] = np.where(in_w, amp * np.sin(ph), P[BZ])
    return P


def test_meta(number: int) -> Tuple[Optional[float], Optional[float]]:
    """(gamma, finishtime) the reference forces for this test number
    (get_riemann_ics sets SimPM->gamma/finishtime)."""
    _l, _r, _x0, gam, tf, _m = RIEMANN_TESTS[number]
    return gam, tf


def toro_tests(cfg: SimConfig, n: int, angle_xy: float = 0.0) -> np.ndarray:
    return predefined_test(cfg, n, angle_xy=angle_xy)


def brio_wu(cfg: SimConfig, angle_xy: float = 0.0) -> np.ndarray:
    """Brio & Wu (1988): test 7 in the reference menu."""
    return predefined_test(cfg, 7, angle_xy=angle_xy)
