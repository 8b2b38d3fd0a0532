"""Shared per-point thermodynamic kernels, vectorized.

Each function here mirrors one scalar kernel of the reference
(FieldCalculations.cc:186-322) but operates on whole arrays in float32 on
the VPU.  Kernels that can *introduce* undefined points (saturation table
out of range) return ``(value, ok)`` where ``ok`` is the per-point validity
mask; pure kernels return just the value array.

All formulas are recomputed from the reference's physics, not transcribed:
saturation vapor pressure uses the 41-entry table lookup + linear
interpolation exactly (bit-compatible gather path), dewpoint inversion uses
the monotone-table inverse.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..constants import (
    cp, eps, t0, xlh, cplr, exl,
    clamp_rh, ewt_defined, ewt_index, ewt_inverse, ewt_value,
)

__all__ = [
    "esat_table", "t_thesat", "th_thesat", "tk_q_rh", "tk_rh_q",
    "tk_q_td", "tk_rh_td", "tk_rh_the", "tk_q_duct", "tk_rh_duct",
]

_f32 = jnp.float32

def esat_table(tk):
    """Saturation vapor pressure e_w(T) from the table; T in Kelvin.

    Returns ``(et, ok, x, l)`` so dependent kernels can reuse the table
    coordinate for the dewpoint inverse.
    """
    x, l = ewt_index(jnp.asarray(tk, _f32) - t0)
    return ewt_value(x, l), ewt_defined(l), x, l


def t_thesat(tk, p, pi):
    """T(K) -> saturated equivalent potential temperature
    (FieldCalculations.cc:196-205)."""
    et, ok, _, _ = esat_table(tk)
    qsat = eps * et / p
    return (cp * tk + xlh * qsat) / pi, ok


def th_thesat(th, p, pi):
    """theta -> saturated equivalent potential temperature
    (FieldCalculations.cc:207-216)."""
    tk = th * pi / cp
    et, ok, _, _ = esat_table(tk)
    qsat = eps * et / p
    return th + xlh * qsat / pi, ok


def tk_q_rh(tk, q, p):
    """(T[K], q) -> RH% (FieldCalculations.cc:218-227)."""
    et, ok, _, _ = esat_table(tk)
    qsat = eps * et / p
    return _f32(100.0) * q / qsat, ok


def tk_rh_q(tk, rh, p):
    """(T[K], RH%) -> q (FieldCalculations.cc:229-238)."""
    et, ok, _, _ = esat_table(tk)
    qsat = eps * et / p
    return _f32(0.01) * rh * qsat, ok


def tk_q_td(tk, q, p, tdconv):
    """(T[K], q) -> dewpoint (degC, or K if tdconv == t0)
    (FieldCalculations.cc:240-253)."""
    et, ok, _, l = esat_table(tk)
    qsat = eps * et / p
    rh = clamp_rh(q / qsat)
    etd = rh * et
    return ewt_inverse(etd, l) + tdconv, ok


def tk_rh_td(tk, rh100, tdconv):
    """(T[K], RH%) -> dewpoint (FieldCalculations.cc:255-267)."""
    et, ok, _, l = esat_table(tk)
    rh = clamp_rh(_f32(0.01) * rh100)
    etd = rh * et
    return ewt_inverse(etd, l) + tdconv, ok


def tk_rh_the(tk, rh, thconv):
    """Equivalent potential temperature building block
    (FieldCalculations.cc:269-278): ``tk*thconv + e_w(tk)*rh`` where the
    caller pre-scales ``rh`` by ``0.01*(xlh/pi)*eps/p``."""
    et, ok, _, _ = esat_table(tk)
    return tk * thconv + et * rh, ok


def tk_q_duct(tk, q, p):
    """Ducting index from specific humidity (FieldCalculations.cc:280-283)."""
    return _f32(77.6) * (p / tk) + _f32(373000.0) * (q * p) / (eps * tk * tk)


def tk_rh_duct(tk, rh100, p):
    """Ducting index from RH% (FieldCalculations.cc:285-296)."""
    et, ok, _, _ = esat_table(tk)
    rh = clamp_rh(rh100 * _f32(0.01))
    return _f32(77.6) * (p / tk) + _f32(373000.0) * rh * et / (tk * tk), ok
