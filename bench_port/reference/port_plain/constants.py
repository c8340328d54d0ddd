"""Variable layout, enums and physical constants.

State-vector layout mirrors the reference code's primitive/conserved enums
(reference: source/constants.h:256-280) so that snapshots are directly
comparable, but here a field is a dense array of shape ``(nvar, *spatial)``
rather than a linked list of cells.

Primitive:  [rho, p_g, v_x, v_y, v_z, (B_x, B_y, B_z, (psi)), tracers...]
Conserved:  [rho, E,   m_x, m_y, m_z, (B_x, B_y, B_z, (psi)), tracers...]

Unlike the reference (which puts energy at index 1 in conserved and pressure
at index 1 in primitive), both vectors here use the SAME slot for the same
"kind" of quantity, so conversion is slot-local and layout questions never
leak outside :mod:`pion_tpu_torch.ops.eqns`.
"""
from __future__ import annotations

import enum

# ---------------------------------------------------------------------------
# Primitive-variable slots (same indices used for the conserved vector:
# RO<->RHO(mass), PG<->ERG(energy), VX..VZ<->MMX..MMZ, BX..BZ same, SI<->PSI).
# ---------------------------------------------------------------------------
RO = 0  # density                (conserved: mass density)
PG = 1  # gas pressure           (conserved: total energy density)
VX = 2  # velocity x             (conserved: momentum density x)
VY = 3
VZ = 4
BX = 5  # magnetic field x (MHD only)
BY = 6
BZ = 7
SI = 8  # GLM scalar psi (GLM-MHD only)

N_HYDRO = 5   # number of non-tracer variables for Euler equations
N_MHD = 8     # ... ideal MHD
N_GLM = 9     # ... GLM-MHD


class Eqn(str, enum.Enum):
    """Equation system (reference: source/sim_params.h eqntype)."""

    EULER = "euler"
    MHD = "mhd"        # ideal MHD with Powell 8-wave source terms
    GLM = "glm"        # GLM-MHD, Dedner mixed hyperbolic/parabolic cleaning

    @property
    def nbase(self) -> int:
        return {Eqn.EULER: N_HYDRO, Eqn.MHD: N_MHD, Eqn.GLM: N_GLM}[self]

    @property
    def is_mhd(self) -> bool:
        return self is not Eqn.EULER


class Coord(str, enum.Enum):
    """Coordinate system (reference: source/constants.h COORD_*)."""

    CARTESIAN = "cartesian"       # 1/2/3D slab symmetry
    CYLINDRICAL = "cylindrical"   # 2D axisymmetric (z, R); R is the LAST axis
    SPHERICAL = "spherical"       # 1D spherically symmetric (r)


class Solver(str, enum.Enum):
    """Flux solver menu (reference: source/constants.h:238-246 FLUX_*)."""

    LF = "lf"              # Lax-Friedrichs (FLUX_LF=0)
    LINEAR = "linear"      # linear Riemann solver in prim. vars (FLUX_RSlinear=1)
    EXACT = "exact"        # exact iterative Riemann solver (FLUX_RSexact=2)
    HYBRID = "hybrid"      # linear with exact fallback near shocks (FLUX_RShybrid=3)
    RCV = "roe"            # Roe solver, conserved vars (FLUX_RSroe=4)
    RPV = "roe_pv"         # Roe solver, primitive vars (FLUX_RSroe_pv=5)
    FVS = "fvs"            # van Leer flux vector splitting (FLUX_FVS=6)
    HLLD = "hlld"          # HLLD (MHD) (FLUX_RS_HLLD=7)
    HLL = "hll"            # HLL (FLUX_RS_HLL=8)


class AV(str, enum.Enum):
    """Artificial viscosity menu (reference: source/constants.h AV_*)."""

    NONE = "none"
    FALLE = "falle"              # FKJ98 viscous flux correction (AV_FKJ98_1D=1)
    HCORR = "hcorr"              # H-correction only (AV_HCORRECTION=3)
    HCORR_FALLE = "hcorr_falle"  # both (AV_HCORR_FKJ98=4)


class BC(str, enum.Enum):
    """External boundary-condition types (reference: source/boundaries/boundaries.h:31-76)."""

    PERIODIC = "periodic"
    OUTFLOW = "outflow"          # zero-gradient
    ONEWAY_OUT = "oneway_out"    # zero-gradient, inflow velocity clipped to 0
    INFLOW = "inflow"            # frozen-in-time edge value
    FIXED = "fixed"              # fixed to user-supplied state
    REFLECTING = "reflecting"    # mirror, normal velocity (and normal B) negated
    AXISYMMETRIC = "axisymmetric"  # R=0 axis: mirror with vR, BR negated
    JET = "jet"                  # reflecting wall with circular jet inflow region
    JETREFLECT = "jetreflect"    # reflecting, but B fully reversed (equatorial symm.)
    DMACH = "dmach"              # double-Mach-reflection time-dependent bc
    DMACH2 = "dmach2"            # DMR fixed post-shock state


# ---------------------------------------------------------------------------
# Physical constants, cgs (reference: source/constants.cpp).
# ---------------------------------------------------------------------------
K_B = 1.380649e-16        # Boltzmann constant [erg/K]
M_P = 1.67262192369e-24   # proton mass [g]
GAMMA_DEFAULT = 5.0 / 3.0
MSUN = 1.9891e33          # solar mass [g] (reference: constants.h:113)
RSUN = 6.96e10            # solar radius [cm]
LSUN = 3.839e33           # solar luminosity [erg/s]
PARSEC = 3.0856775807e18  # parsec [cm]
AU = 1.49597870700e13     # astronomical unit [cm]
YEAR = 3.1558150e7        # sidereal year [s] (reference: constants.h:107)
EV = 1.602176634e-12      # electron-volt [erg]
ETA_ION_EV = 13.59844     # H ionization potential [eV]

# Numerical guards
TINY = 1.0e-100
SMALL = 1.0e-50
