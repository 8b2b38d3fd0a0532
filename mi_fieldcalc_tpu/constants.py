"""Physical constants, thermodynamic tables, and ICAO standard atmosphere.

Re-design of the reference's ``miutil::constants``
(src/mi_fieldcalc/MetConstants.{h,cc}).  Scalar table walks become
vectorized selects so they run as elementwise vector code.

All constants carry the same float32 values as the reference
(MetConstants.h:39-53).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = [
    "r", "cp", "p0", "t0", "eps", "xlh", "rcp", "cplr", "exl", "p0inv",
    "kappa", "g", "ginv", "rhmin", "rhmax", "ft_per_m", "ms2knots",
    "knots2ms", "EWT", "N_EWT", "ewt_index", "ewt_defined", "ewt_value",
    "ewt_inverse", "P_LEVEL_TABLE", "F_LEVEL_TABLE", "F_LEVEL_TABLE_OLD",
    "icao_geo_altitude_from_pressure", "icao_pressure_from_geo_altitude",
    "fl_from_geo_altitude", "geo_altitude_from_fl",
    "pidcp_from_p", "pi_from_p", "clamp_rh",
]

# --- physical constants (MetConstants.h:39-53) -----------------------------
r = np.float32(287.0)
cp = np.float32(1004.0)
p0 = np.float32(1000.0)
t0 = np.float32(273.15)
eps = np.float32(0.622)
xlh = np.float32(2.501e6)
rcp = np.float32(r / cp)
cplr = np.float32(xlh / rcp)
exl = np.float32(eps * xlh)
p0inv = np.float32(1.0 / p0)
kappa = np.float32(r / cp)
g = np.float32(9.8)
ginv = np.float32(1.0 / g)
rhmin = np.float32(0.02)
rhmax = np.float32(1.00)
ft_per_m = 3.2808399  # feet per meter (double in the reference)
ms2knots = 3600.0 / 1852.0
knots2ms = 1.0 / ms2knots

# --- saturation vapor pressure table (MetConstants.h:56-59) -----------------
# e_w(T) for T = -100, -95, ..., +100 degC; 41 entries.
N_EWT = 41
EWT = np.array(
    [.000034, .000089, .000220, .000517, .001155, .002472, .005080, .01005,
     .01921, .03553, .06356, .1111, .1891, .3139, .5088, .8070, 1.2540,
     1.9118, 2.8627, 4.2148, 6.1078, 8.7192, 12.272, 17.044, 23.373, 31.671,
     42.430, 56.236, 73.777, 95.855, 123.40, 157.46, 199.26, 250.16, 311.69,
     385.56, 473.67, 578.09, 701.13, 845.28, 1013.25], dtype=np.float32)


def ewt_index(t_celsius):
    """Table coordinate for ``ewt_calculator`` (MetConstants.h:64-68).

    Returns ``(x, l)`` where ``x = (t+100)*0.2`` and ``l = int(x)`` with C
    truncation-toward-zero semantics (so ``t`` slightly below -100 degC still
    yields ``l == 0`` and extrapolates, exactly like the reference).
    """
    t = jnp.asarray(t_celsius, jnp.float32)
    x = (t + jnp.float32(100.0)) * jnp.float32(0.2)
    l = jnp.trunc(x).astype(jnp.int32)
    return x, l


def ewt_defined(l):
    """``ewt_calculator::defined`` (MetConstants.h:69)."""
    return (l >= 0) & (l < N_EWT - 1)


def _ewt_pair(ls):
    """``(ewt[ls], ewt[ls+1])`` for ``ls`` in [0, 39] — WITHOUT a gather.

    A dynamic gather from a 41-entry table does not fuse into the
    surrounding elementwise program everywhere, and a one-hot @ table
    contraction materializes a ``[..., 40]`` float32 intermediate (40x
    the field's own memory traffic).  Instead: an unrolled chain of 40
    compare+selects per output.  These are pure elementwise ops that XLA
    fuses into the surrounding program,
    so the lookup costs ~120 vector ops/point and ZERO extra HBM traffic.
    The selected entries are exact table values (bit-exact lookup).
    """
    e0 = jnp.full(ls.shape, EWT[0], jnp.float32)
    e1 = jnp.full(ls.shape, EWT[1], jnp.float32)
    for k in range(1, N_EWT - 1):
        m = ls >= k
        e0 = jnp.where(m, EWT[k], e0)
        e1 = jnp.where(m, EWT[k + 1], e1)
    return e0, e1


def ewt_value(x, l):
    """Linear interpolation ``ewt[l] + (ewt[l+1]-ewt[l])*(x-l)``
    (MetConstants.h:78).  ``l`` is clipped for safe evaluation at undefined
    points; callers must combine with :func:`ewt_defined`.
    """
    ls = jnp.clip(l, 0, N_EWT - 2)
    e0, e1 = _ewt_pair(ls)
    return e0 + (e1 - e0) * (x - ls.astype(jnp.float32))


def ewt_inverse(et, l):
    """Vectorized ``ewt_calculator::inverse`` (MetConstants.cc:37-45).

    The reference walks ``ll`` down from ``l`` while ``ewt[ll] > et`` (never
    up), clamped at 0.  Since the table is monotone this equals
    ``clip(searchsorted_right(EWT, et) - 1, 0, l)``; implemented as an
    unrolled comparison sum so it stays a pure VPU op sequence.
    """
    et = jnp.asarray(et, jnp.float32)
    # count of table entries <= et  (41 fused compares, no gather blowup);
    # inline numpy scalars so the constants fold at trace time
    cnt = jnp.zeros(et.shape, jnp.int32)
    for k in range(N_EWT):
        cnt = cnt + (et >= EWT[k]).astype(jnp.int32)
    ll = jnp.clip(cnt - 1, 0, jnp.clip(l, 0, N_EWT - 2))
    e0, e1 = _ewt_pair(ll)
    rr = (et - e0) / (e1 - e0)
    return jnp.float32(-100.0) + (ll.astype(jnp.float32) + rr) * jnp.float32(5.0)


# --- pressure <-> flight level tables (MetConstants.h:87-91) ----------------
P_LEVEL_TABLE = np.array(
    [1000, 925, 850, 800, 700, 500, 400, 300, 250, 200, 150, 100, 70, 50, 30, 10],
    dtype=np.float32)
F_LEVEL_TABLE = np.array(
    [5, 25, 50, 65, 100, 185, 235, 300, 340, 385, 445, 530, 605, 675, 780, 1020],
    dtype=np.float32)
F_LEVEL_TABLE_OLD = np.array(
    [0, 25, 50, 70, 100, 180, 240, 300, 340, 390, 450, 530, 600, 700, 800, 999],
    dtype=np.float32)

# --- ICAO standard atmosphere (MetConstants.cc:47-132) ----------------------
_ICAO_G = 9.80665
_ICAO_R = 287.05287
_ICAO_N = 8
_ICAO_LAMBDAS = np.array([-6.5, 0.0, 1.0, 2.8, 0.0, -2.8, -2.0])  # K/km
_ICAO_BASE_H = np.array([0.0, 11.0, 20.0, 32.0, 47.0, 51.0, 71.0, 84.852])  # km
_ICAO_BASE_T = np.array([288.15, 216.65, 216.65, 228.65, 270.65, 270.65,
                         214.65, 186.946])
_ICAO_BASE_P = np.array([
    1013.15, 226.29806486313493, 54.743370958898005, 8.679301101236328,
    1.1089482781849516, 0.6693192180209551, 0.0395600169484907,
    0.0037334345211142398])


def icao_geo_altitude_from_pressure(pressure):
    """Pressure (hPa) -> geopotential altitude (m), ICAO standard atmosphere
    (MetConstants.cc:84-100).  Vectorized over arrays; float64 math like the
    reference (runs host-side / NumPy — it is a table op, not a hot kernel).
    """
    p = np.asarray(pressure, dtype=np.float64)
    # layer index l = i-1 where i = first base with p >= base_p[i] (scan up)
    i = np.ones(p.shape, dtype=np.int64)
    for k in range(1, _ICAO_N):
        i = np.where((i == k) & (p < _ICAO_BASE_P[k]), k + 1, i)
    beyond = i >= _ICAO_N
    l = np.clip(i - 1, 0, _ICAO_N - 2)
    lam = _ICAO_LAMBDAS[l] / 1000.0
    h_l = _ICAO_BASE_H[l] * 1000.0
    t_l = _ICAO_BASE_T[l]
    p_l = _ICAO_BASE_P[l]
    rp = p / p_l
    with np.errstate(divide="ignore", invalid="ignore"):
        grad = (t_l / np.where(lam == 0, 1.0, lam)) * (
            np.power(rp, -(lam * _ICAO_R) / _ICAO_G) - 1.0) + h_l
        iso = h_l - np.log(rp) * (_ICAO_R * t_l) / _ICAO_G
    out = np.where(lam != 0, grad, iso)
    out = np.where(beyond, 1000.0 * (_ICAO_BASE_H[-1] + 1.0), out)
    return out if out.shape else float(out)


def icao_pressure_from_geo_altitude(altitude):
    """Geopotential altitude (m) -> pressure (hPa) (MetConstants.cc:102-122)."""
    a = np.asarray(altitude, dtype=np.float64)
    h = a / 1000.0
    i = np.ones(h.shape, dtype=np.int64)
    for k in range(1, _ICAO_N):
        i = np.where((i == k) & (h > _ICAO_BASE_H[k]), k + 1, i)
    beyond = i >= _ICAO_N
    l = np.clip(i - 1, 0, _ICAO_N - 2)
    lam = _ICAO_LAMBDAS[l] / 1000.0
    alt_l = _ICAO_BASE_H[l] * 1000.0
    t_l = _ICAO_BASE_T[l]
    p_l = _ICAO_BASE_P[l]
    da = a - alt_l
    with np.errstate(divide="ignore", invalid="ignore"):
        grad = np.power(1.0 + da * np.where(lam == 0, 1.0, lam) / t_l,
                        -_ICAO_G / (np.where(lam == 0, 1.0, lam) * _ICAO_R))
        iso = np.exp(-da * _ICAO_G / (_ICAO_R * t_l))
    pf = np.where(lam != 0, grad, iso)
    out = np.where(beyond, _ICAO_BASE_P[-1] - 1.0, p_l * pf)
    return out if out.shape else float(out)


def fl_from_geo_altitude(a):
    """Altitude (m) -> flight level rounded to 500 ft (MetConstants.cc:124-127)."""
    out = 5 * np.round(np.asarray(a, np.float64) * ft_per_m / 500.0).astype(np.int64)
    return out if out.shape else int(out)


def geo_altitude_from_fl(fl):
    """Flight level -> altitude (m), no rounding (MetConstants.cc:129-132)."""
    out = np.asarray(fl, np.float64) * 100.0 / ft_per_m
    return out if out.shape else float(out)


# --- Exner helpers (FieldCalculations.cc:308-316) ---------------------------

def pidcp_from_p(p):
    """``(p/p0)**kappa`` — Exner function / cp (FieldCalculations.cc:308-311).

    Deterministic pow: a backend's native power can be tens of ulps off
    host libm, which pushed the pow-heavy conversions out of the golden
    band on an earlier accelerator.  Round 5 switched the composition from
    ``exp_f32(kappa*log_f32(p))`` to the narrow-domain
    ``_libm.pow_posc_f32`` (<= ~1.2 ulp measured on the Exner domain vs
    ~4.4 for the exp∘log chain, tests/test_libm.py).

    Edge semantics: a DEFINED lane can still carry p <= 0 (e.g. a
    hybrid level with alevel = blevel = 0), where the reference's powf
    gives 0**kappa = +0 (theta -> inf) or NaN for negative p.  Because
    kappa is a fixed positive constant those edges are CONSTANTS, so
    the select needs no backend pow (a ``jnp.power`` fallback branch
    measurably perturbed XLA:CPU fusion of the shared pow chain at the
    last ulp on vector-remainder lanes, breaking a bitwise contract on
    ordinary lanes — round-5 regression).  NaN propagates through the
    same select (x > 0 and x == 0 both false)."""
    from ._libm import pow_posc_f32
    x = jnp.asarray(p, jnp.float32) * p0inv
    edge = jnp.where(x == 0, jnp.float32(0.0), jnp.float32(jnp.nan))
    return jnp.where(x > 0, pow_posc_f32(x, kappa), edge)


def pi_from_p(p):
    """``cp * (p/p0)**kappa`` (FieldCalculations.cc:313-316)."""
    return cp * pidcp_from_p(p)


def clamp_rh(rh):
    """Clamp relative humidity (fraction) to [0.02, 1.0]
    (FieldCalculations.cc:186-194)."""
    return jnp.clip(rh, rhmin, rhmax)
