"""Saturated thermal conduction (Slavin & Cox 1992).

Counterpart of the reference's compile-flagged conduction module
(reference: source/spatial_solvers/solver_eqn_base.cpp:687-875
``set_thermal_conduction_Edot``; enabled by ``#define THERMAL_CONDUCTION``,
defines/functionality_flags.h:90; dt limit in
sim_control/calc_timestep.cpp:163-211 ``calc_conduction_dt_and_Edot``).

Per face between cells 1 and 2 along each axis:

  gradT      = (T2 - T1) / dx
  donor      = the upstream cell (2 if gradT > 0 else 1)
  ln(Lambda) = 29.7                          for T <= 4.2e5 K
             = 29.7 + ln(T / (1e6 sqrt(rho * 4.2735e23)))  otherwise
  Q_clas     = -1.84e-5 T^2.5 gradT / ln(Lambda)
  Q_sat      = -sign(gradT) 1.5 p^1.5 / sqrt(rho)     (phi_s = 0.3, S&C92)
  Q          = Q_sat (1 - exp(-Q_clas / Q_sat))

and Edot = -div(Q) with the coordinate-system face/volume factors
(the same div_cn/div_cp coefficients the flux divergence uses).  Each axis
is three dense slices of the padded state; plain PyTorch on any device.
"""
from __future__ import annotations

import torch

from ..config import SimConfig
from ..constants import PG, RO
from ..grid import Geometry


def conduction_Edot(Ppad, Tpad, cfg: SimConfig, geom: Geometry):
    """Energy-density rate dE/dt (erg/cm^3/s) on the interior cells.

    ``Ppad``: padded primitive state (nvar, *spatial+2ng);
    ``Tpad``: padded temperature (spatial+2ng).
    """
    nd = cfg.ndim
    ng = cfg.ng
    out = None
    for ax in range(nd):
        # window: one ghost layer along ax, interior on the other axes
        win = [slice(ng, -ng)] * nd
        win[ax] = slice(ng - 1, Tpad.shape[ax] - ng + 1)
        w = tuple(win)
        T = Tpad[w]
        rho = Ppad[(RO,) + w]
        pg = Ppad[(PG,) + w]

        def lo(A):
            return A.narrow(ax, 0, A.shape[ax] - 1)

        def hi(A):
            return A.narrow(ax, 1, A.shape[ax] - 1)

        gradT = (hi(T) - lo(T)) / geom.dx
        up = gradT > 0.0
        Td = torch.where(up, hi(T), lo(T))
        rd = torch.where(up, hi(rho), lo(rho))
        pd = torch.where(up, hi(pg), lo(pg))
        lnL = torch.where(
            Td <= 4.2e5, 29.7,
            29.7 + torch.log(torch.clamp(Td, min=4.2e5)
                             / (1.0e6 * torch.sqrt(rd * 4.2735e23))))
        q_clas = -1.84e-5 * Td ** 2.5 * gradT / lnL
        q_sat = -torch.sign(gradT) * 1.5 * pd * torch.sqrt(pd / rd)
        # Q = Qs (1 - exp(-Qc/Qs)): -> Qc when |Qc|<<|Qs|, -> Qs when >>.
        # Guard the 0/0 at gradT == 0 (both zero -> Q = 0).
        ratio = q_clas / torch.where(q_sat == 0.0, 1.0, q_sat)
        Q = torch.where(q_sat == 0.0, 0.0, q_sat * -torch.expm1(-ratio))

        # divergence with the per-axis face/volume coefficients
        g = geom.axis_tensors(ax, Q.dtype, Q.device)
        shape = [1] * nd
        shape[ax] = -1
        cn = g["div_cn"].reshape(shape)
        cp = g["div_cp"].reshape(shape)
        contrib = cn * lo(Q) - cp * hi(Q)
        out = contrib if out is None else out + contrib
    return out


def conduction_dt(P, Edot, cfg: SimConfig):
    """Conduction timestep limit: 0.1 min(E_int/|Edot|) over cells with
    pressure above floor (reference: calc_timestep.cpp:188-210; the
    reference uses gm1*|Edot| i.e. internal energy, and multiplies 0.1).
    A 0-d tensor, never read back.

    Where no cell passes the pressure test the limit is 1e200 in float64
    and ``inf`` in float32, as the JAX package computes it without x64
    (its literal leaves float32), so the dynamical dt stands; ``1e-100``
    is 0 in float32 for the same reason, and a cell with ``Edot == 0``
    gives ``inf``."""
    gm1 = cfg.gamma - 1.0
    ok = P[PG] > 1.0e-3 * cfg.p_ref
    tc = P[PG] / (gm1 * (torch.abs(Edot) + 1.0e-100))
    big = 1.0e200 if tc.dtype == torch.float64 else float("inf")
    return 0.1 * torch.min(torch.where(ok, tc, big))
