"""Stability / severe-weather indices on pressure levels.

Reference: FieldCalculations.cc — kIndex (745), ductingIndex (816),
showalterIndex (872), boydenIndex (973), sweatIndex (1016).

The showalter moist-adiabat adjustment is the reference's fixed 7-iteration
per-point loop (cc:948-960) with a data-dependent early break when the
lifted parcel leaves the saturation table; here that becomes 7 unrolled
masked iterations — identical results, no per-point control flow.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..constants import (
    cp, cplr, eps, exl, ms2knots, t0, xlh,
    clamp_rh, ewt_defined, ewt_index, ewt_inverse, ewt_value,
)
from ..field import Field
from ._harness import and_masks, out_field, require
from .levels import _scalar_pidcp

__all__ = ["k_index", "ducting_index", "showalter_index", "boyden_index",
           "sweat_index"]

_f32 = jnp.float32


def k_index(t500: Field, t700: Field, rh700: Field, t850: Field, rh850: Field,
            p500: float, p700: float, p850: float, compute: int) -> Field:
    """K-index: (T+Td)850 - (T-Td)700 - T500, in Celsius
    (FieldCalculations.cc:745-814).  compute: 1 inputs are T(K), 2 theta."""
    require(p500 > 0 and p500 < p700 < p850, "kIndex: bad pressures")
    require(compute in (1, 2), f"kIndex: bad compute {compute}")
    if compute == 1:
        cvt500 = cvt700 = cvt850 = np.float32(1)
    else:
        cvt500 = _scalar_pidcp(p500)
        cvt700 = _scalar_pidcp(p700)
        cvt850 = _scalar_pidcp(p850)

    mask = and_masks(t500, t700, rh700, t850, rh850)
    tc850 = cvt850 * t850.values - t0
    tc700 = cvt700 * t700.values - t0
    x850, l850 = ewt_index(tc850)
    x700, l700 = ewt_index(tc700)
    ok = ewt_defined(l850) & ewt_defined(l700)

    rh_850 = clamp_rh(_f32(0.01) * rh850.values)
    etd850 = ewt_value(x850, l850) * rh_850
    tdc850 = ewt_inverse(etd850, l850)

    rh_700 = clamp_rh(_f32(0.01) * rh700.values)
    etd700 = ewt_value(x700, l700) * rh_700
    tdc700 = ewt_inverse(etd700, l700)

    tc500 = cvt500 * t500.values - t0
    out = (tc850 + tdc850) - (tc700 - tdc700) - tc500
    return out_field(out, mask & ok)


def ducting_index(t850: Field, rh850: Field, p850: float, compute: int) -> Field:
    """Ducting index nw(T) - nw(Td) at one level
    (FieldCalculations.cc:816-870)."""
    require(p850 > 0, "ductingIndex: p <= 0")
    require(compute in (1, 2), f"ductingIndex: bad compute {compute}")
    bduct = _f32(3.8e5)
    tconvert = _scalar_pidcp(p850) if compute == 2 else np.float32(1)

    mask = and_masks(t850, rh850)
    rh = clamp_rh(_f32(0.01) * rh850.values)
    tk = t850.values * tconvert
    x, l = ewt_index(tk - t0)
    ok = ewt_defined(l)
    et = ewt_value(x, l)
    etd = et * rh
    tdk = ewt_inverse(etd, l) + t0
    out = bduct * (et / (tk * tk) - etd / (tdk * tdk))
    return out_field(out, mask & ok)


def showalter_index(t500: Field, t850: Field, rh850: Field,
                    p500: float, p850: float, compute: int) -> Field:
    """Showalter index: T500 minus the 850 hPa parcel lifted dry-adiabatically
    then moist-adjusted with 7 fixed iterations
    (FieldCalculations.cc:872-971).  compute: 1 T(K) inputs, 2 theta.

    Reference quirk (documented divergence): on undefined input the
    reference leaves the output *uninitialized* (cc:965-967); here it is a
    masked-out lane.
    """
    require(0 < p500 < p850, "showalterIndex: bad pressures")
    require(compute in (1, 2), f"showalterIndex: bad compute {compute}")
    pi500 = np.float32(_scalar_pidcp(p500) * np.float32(cp))
    pi850 = np.float32(_scalar_pidcp(p850) * np.float32(cp))
    if compute == 1:
        cvt500 = cvt850 = np.float32(1)
        dryadiabat = np.float32(np.float32(cp) * (np.float32(cp) / pi850)
                                * (pi500 / np.float32(cp)))
    else:
        cvt500 = np.float32(pi500 / np.float32(cp))
        cvt850 = np.float32(pi850 / np.float32(cp))
        dryadiabat = np.float32(np.float32(cp) * (pi500 / np.float32(cp)))

    mask = and_masks(t500, t850, rh850)
    tk500 = cvt500 * t500.values
    tk850 = cvt850 * t850.values
    rh = clamp_rh(_f32(0.01) * rh850.values)
    x, l = ewt_index(tk850 - t0)
    ok = ewt_defined(l)
    etd = ewt_value(x, l) * rh

    # lift along dry adiabat, then 7 masked moist-adjustment iterations
    tcl = dryadiabat * t850.values
    qcl = eps * etd / _f32(p850)
    active = jnp.ones(tcl.shape, bool)
    for _ in range(7):
        x2, l2 = ewt_index(tcl / cp - t0)
        step_ok = ewt_defined(l2)
        active = active & step_ok  # reference: break when table exits
        esat = ewt_value(x2, l2)
        qsat = eps * esat / _f32(p500)
        dq = qcl - qsat
        a1 = cplr * qcl / tcl
        a2 = exl / tcl
        dq = dq / (1 + a1 * a2)
        qcl = jnp.where(active, qcl - dq, qcl)
        tcl = jnp.where(active, tcl + dq * xlh, tcl)

    tx500 = tcl / cp
    return out_field(tk500 - tx500, mask & ok)


def boyden_index(t700: Field, z700: Field, z1000: Field,
                 p700: float, p1000: float, compute: int) -> Field:
    """Boyden index (Z700-Z1000)/10 - Tc700 - 200
    (FieldCalculations.cc:973-1014)."""
    require(compute in (1, 2), f"boydenIndex: bad compute {compute}")
    require(0 < p700 < p1000, "boydenIndex: bad pressures")
    tconv = _scalar_pidcp(p700) if compute == 2 else np.float32(1)
    tc700 = t700.values * tconv - t0
    out = (z700.values - z1000.values) / _f32(10) - tc700 - _f32(200)
    return out_field(out, and_masks(t700, z700, z1000))


def sweat_index(t850: Field, t500: Field, td850: Field, td500: Field,
                u850: Field, v850: Field, u500: Field, v500: Field) -> Field:
    """Severe Weather Threat index (FieldCalculations.cc:1016-1040)."""
    mask = and_masks(t850, t500, td850, td500, u850, v850, u500, v500)
    ff850 = jnp.sqrt(u850.values**2 + v850.values**2)
    ff500 = jnp.sqrt(u500.values**2 + v500.values**2)
    sind = (u500.values * v850.values - v500.values * u850.values) \
        / (ff850 * ff500)
    out = (_f32(32) * td850.values + _f32(20) * t850.values
           - _f32(40) * t500.values - _f32(20 * 49)
           + _f32(2) * (ff850 * _f32(ms2knots)) + ff500 * _f32(ms2knots)
           + _f32(125) * (sind + _f32(0.2)))
    return out_field(out, mask)
