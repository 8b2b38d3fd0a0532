"""Temperature / humidity / THE / ducting operators on pressure, hybrid,
generic-model, and ocean levels.

Reference: FieldCalculations.cc — pleveltemp (328), plevelthe (369),
plevelhum (400), pleveldz2tmean (466), plevelducting (597), hleveltemp
(1046), hlevelthe (1100), hlevelhum (1145), hlevelducting (1219),
hlevelpressure (1276), aleveltemp (1310), alevelthe (1355), alevelhum
(1394), alevelducting (1460), seaSoundSpeed (1555).

Design: the reference triplicates every operator across the
p/h/a level families, differing only in how per-point pressure is obtained
(scalar, ``alevel + blevel*ps``, or a field).  Here the hybrid and generic
model-level ("alevel") variants share one vectorized core taking a pressure
*array*; the pressure-level variant keeps its own scalar-precomputed path
because the reference folds ``(p/p0)^kappa`` into float32 scalars on the
host, and matching its rounding keeps the 719x929 bit-exactness canary
(FieldCalculationsTest.cc:145-170).

``compute`` mode integers and ``unit`` strings are static (trace-time)
parameters, exactly as in the reference where they select straight-line
code.  Invalid parameters raise :class:`ValueError` (reference: ``return
false``).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..constants import cp, eps, g, kappa, p0inv, t0, xlh, pidcp_from_p
from ..field import Field, UNDEF, full_undef
from . import thermo
from ._harness import and_masks, out_field, require

__all__ = [
    "pleveltemp", "plevelthe", "plevelhum", "pleveldz2tmean", "plevelducting",
    "hleveltemp", "hlevelthe", "hlevelhum", "hlevelducting", "hlevelpressure",
    "aleveltemp", "alevelthe", "alevelhum", "alevelducting",
    "sea_sound_speed",
]

_f32 = jnp.float32


# ---------------------------------------------------------------------------
# static-parameter helpers
# ---------------------------------------------------------------------------

def _scalar_pidcp(p: float) -> np.float32:
    """Host-side float32 ``(p/p0)^kappa`` matching the reference's ``powf``."""
    return np.float32(np.power(np.float32(p) * p0inv, kappa))


def _remap_temp_compute(compute: int, unit: str) -> int:
    """Unit-string override for the *temp ops (FieldCalculations.cc:340-345)."""
    if compute < 3:
        if unit == "celsius":
            return 1
        if unit == "kelvin":
            return 2
    return compute


def _remap_hum_compute(compute: int, unit: str) -> int:
    """Celsius/Kelvin dewpoint remap for the *hum ops
    (FieldCalculations.cc:422-425)."""
    if compute > 8 and unit == "celsius":
        return compute - 4
    if 4 < compute <= 8 and unit == "kelvin":
        return compute + 4
    return compute


def _bad_hlevel(alevel: float, blevel: float) -> bool:
    """Hybrid-coefficient validation (FieldCalculations.cc:298-301)."""
    return (alevel < 0.0) or (blevel < 0.0) or (alevel == 0.0 and blevel == 0.0) \
        or (blevel > 1.0)


# ---------------------------------------------------------------------------
# temperature conversions
# ---------------------------------------------------------------------------

def pleveltemp(t: Field, p: float, compute: int, unit: str = "") -> Field:
    """Pressure-level temperature conversions (FieldCalculations.cc:328-367).

    compute: 1 TH->T(C), 2 TH->T(K), 3 T(K)->TH, 4 T(K)->theta_e,sat,
    5 TH->theta_e,sat.  ``unit`` ("celsius"/"kelvin") overrides compute<3.
    """
    require(p > 0, "pleveltemp: p <= 0")
    compute = _remap_temp_compute(compute, unit)
    require(1 <= compute <= 5, f"pleveltemp: bad compute {compute}")
    pidcp = _scalar_pidcp(p)
    pi = np.float32(pidcp * np.float32(cp))
    v = t.values
    if compute == 1:
        return Field(v * pidcp - t0, t.mask)
    if compute == 2:
        return Field(v * pidcp, t.mask)
    if compute == 3:
        return Field(v / pidcp, t.mask)
    if compute == 4:
        out, ok = thermo.t_thesat(v, _f32(p), pi)
    else:  # 5
        out, ok = thermo.th_thesat(v, _f32(p), pi)
    return out_field(out, t.mask & ok)


def _leveltemp_core(t: Field, p_arr, mask, compute: int) -> Field:
    """hlevel/alevel temperature core (FieldCalculations.cc:1076-1095,
    1332-1350); ``p_arr`` is the per-point pressure array."""
    pidcp = pidcp_from_p(p_arr)
    v = t.values
    if compute == 1:
        return out_field(v * pidcp - t0, mask)
    if compute == 2:
        return out_field(v * pidcp, mask)
    if compute == 3:
        return out_field(v / pidcp, mask)
    pi = pidcp * cp
    if compute == 4:
        out, ok = thermo.t_thesat(v, p_arr, pi)
    else:  # 5
        out, ok = thermo.th_thesat(v, p_arr, pi)
    return out_field(out, mask & ok)


def hleveltemp(t: Field, ps: Field, alevel: float, blevel: float,
               compute: int, unit: str = "") -> Field:
    """Hybrid-level temperature conversions (FieldCalculations.cc:1046-1098);
    per-point ``p = alevel + blevel * ps``."""
    compute = _remap_temp_compute(compute, unit)
    require(not _bad_hlevel(alevel, blevel), "hleveltemp: bad alevel/blevel")
    require(1 <= compute <= 5, f"hleveltemp: bad compute {compute}")
    p_arr = _f32(alevel) + _f32(blevel) * ps.values
    return _leveltemp_core(t, p_arr, and_masks(t, ps), compute)


def aleveltemp(t: Field, p: Field, compute: int, unit: str = "") -> Field:
    """Model-level temperature conversions with a pressure field
    (FieldCalculations.cc:1310-1353)."""
    require(0 < compute < 6, f"aleveltemp: bad compute {compute}")
    compute = _remap_temp_compute(compute, unit)
    return _leveltemp_core(t, p.values, and_masks(t, p), compute)


# ---------------------------------------------------------------------------
# equivalent potential temperature (THE)
# ---------------------------------------------------------------------------

def plevelthe(t: Field, rh: Field, p: float, compute: int) -> Field:
    """Equivalent potential temperature from T/TH + RH% at a pressure level
    (FieldCalculations.cc:369-398).  compute: 1 T(K)+RH%, 2 TH+RH%."""
    require(compute in (1, 2), f"plevelthe: bad compute {compute}")
    require(p > 0, "plevelthe: p <= 0")
    pidcp = _scalar_pidcp(p)
    pi = np.float32(pidcp * np.float32(cp))
    cvrh = np.float32(np.float32(0.01) * (np.float32(xlh) / pi)
                      * np.float32(eps) / np.float32(p))
    tconv = pidcp if compute == 2 else np.float32(1)
    thconv = np.float32(1) / pidcp
    out, ok = thermo.tk_rh_the(t.values * tconv, rh.values * cvrh, thconv)
    return out_field(out, and_masks(t, rh) & ok)


def _levelthe_core(t: Field, q: Field, p_arr, mask, compute: int) -> Field:
    """hlevel/alevel THE core (FieldCalculations.cc:1128-1140, 1377-1389)."""
    pi = cp * pidcp_from_p(p_arr)
    if compute == 1:  # T(K), q -> THE
        out = (t.values * cp + q.values * xlh) / pi
    else:  # TH, q -> THE
        out = t.values + q.values * xlh / pi
    return out_field(out, mask)


def hlevelthe(t: Field, q: Field, ps: Field, alevel: float, blevel: float,
              compute: int) -> Field:
    """THE on hybrid levels (FieldCalculations.cc:1100-1143)."""
    require(not _bad_hlevel(alevel, blevel), "hlevelthe: bad alevel/blevel")
    require(compute in (1, 2), f"hlevelthe: bad compute {compute}")
    p_arr = _f32(alevel) + _f32(blevel) * ps.values
    return _levelthe_core(t, q, p_arr, and_masks(t, q, ps), compute)


def alevelthe(t: Field, q: Field, p: Field, compute: int) -> Field:
    """THE on generic model levels (FieldCalculations.cc:1355-1392)."""
    require(compute in (1, 2), f"alevelthe: bad compute {compute}")
    return _levelthe_core(t, q, p.values, and_masks(t, q, p), compute)


# ---------------------------------------------------------------------------
# humidity conversions (RH <-> q <-> Td), 12 modes per level family
# ---------------------------------------------------------------------------

def plevelhum(t: Field, hum: Field, p: float, compute: int, unit: str = "",
              undef: float = UNDEF) -> Field:
    """Pressure-level humidity conversions (FieldCalculations.cc:400-464).

    compute (after unit remap): 1/2 (T|TH, q)->RH%; 3/4 (T|TH, RH%)->q;
    5/6 (T|TH, RH%)->Td(C); 7/8 (T|TH, q)->Td(C); 9-12 like 5-8 in Kelvin.
    Odd computes take T(K), even take TH.  ``p == undef`` yields an
    all-undefined field unless the mode is pressure-independent (5/6/9/10).
    """
    require(p > 0 and 0 < compute < 13, "plevelhum: bad p or compute")
    compute = _remap_hum_compute(compute, unit)
    if p == undef and compute not in (5, 6, 9, 10):
        return full_undef(t.shape, t.dtype)

    pidcp = _scalar_pidcp(p)
    tconv = pidcp if compute % 2 == 0 else np.float32(1)
    tdconv = t0 if compute >= 9 else _f32(0)
    tk = t.values * tconv
    pa = _f32(p)
    if compute in (1, 2):
        out, ok = thermo.tk_q_rh(tk, hum.values, pa)
    elif compute in (3, 4):
        out, ok = thermo.tk_rh_q(tk, hum.values, pa)
    elif compute in (5, 6, 9, 10):
        out, ok = thermo.tk_rh_td(tk, hum.values, tdconv)
    else:  # 7, 8, 11, 12
        out, ok = thermo.tk_q_td(tk, hum.values, pa, tdconv)
    return out_field(out, and_masks(t, hum) & ok)


def _levelhum_core(t: Field, hum: Field, p_arr, p_mask, compute: int) -> Field:
    """hlevel/alevel humidity core (FieldCalculations.cc:1186-1214,
    1428-1454).  Mode numbering differs from plevelhum: 5/6/9/10 are q->Td
    and 7/8/11/12 are RH->Td, with 7/11 pressure-independent.

    ``p_mask`` is the *gate*: None means the pressure's definedness does
    not gate the output (the caller decides — h- and a-level gates differ,
    see hlevelhum/alevelhum)."""
    mask = and_masks(t, hum)
    if p_mask is not None:
        mask = mask & p_mask
    tdconv = t0 if compute >= 9 else _f32(0)
    tk = t.values if compute % 2 == 1 else t.values * pidcp_from_p(p_arr)
    if compute in (1, 2):
        out, ok = thermo.tk_q_rh(tk, hum.values, p_arr)
    elif compute in (3, 4):
        out, ok = thermo.tk_rh_q(tk, hum.values, p_arr)
    elif compute in (5, 6, 9, 10):
        out, ok = thermo.tk_q_td(tk, hum.values, p_arr, tdconv)
    else:  # 7, 8, 11, 12
        out, ok = thermo.tk_rh_td(tk, hum.values, tdconv)
    return out_field(out, mask & ok)


def hlevelhum(t: Field, hum: Field, ps: Field, alevel: float, blevel: float,
              compute: int, unit: str = "") -> Field:
    """Hybrid-level humidity conversions (FieldCalculations.cc:1145-1217)."""
    require(0 < compute < 13, f"hlevelhum: bad compute {compute}")
    require(not _bad_hlevel(alevel, blevel), "hlevelhum: bad alevel/blevel")
    compute = _remap_hum_compute(compute, unit)
    p_arr = _f32(alevel) + _f32(blevel) * ps.values
    # gate (cc:1187): ps must be defined except for the pressure-independent
    # modes 7/11
    p_mask = None if compute in (7, 11) else ps.mask
    return _levelhum_core(t, hum, p_arr, p_mask, compute)


def alevelhum(t: Field, hum: Field, p: Field, compute: int,
              unit: str = "") -> Field:
    """Model-level humidity conversions with a pressure field
    (FieldCalculations.cc:1394-1458).

    Reference quirk (cc:1438, inverted vs hlevelhum): the *pressure-
    independent* modes 7/11 demand a defined p, while every p-using mode
    lets an undefined p flow into the kernels — producing defined garbage
    (e.g. RH blows up, Td collapses to T via the RH clamp).  Reproduced
    exactly by materializing the sentinel into the computation.
    """
    require(0 < compute < 13, f"alevelhum: bad compute {compute}")
    compute = _remap_hum_compute(compute, unit)
    if compute in (7, 11):
        return _levelhum_core(t, hum, p.values, p.mask, compute)
    return _levelhum_core(t, hum, p.to_sentinel(), None, compute)


# ---------------------------------------------------------------------------
# ducting
# ---------------------------------------------------------------------------

def plevelducting(t: Field, h: Field, p: float, compute: int) -> Field:
    """Ducting index at a pressure level (FieldCalculations.cc:597-636).
    compute: 1 (T,q), 2 (TH,q), 3 (T,RH%), 4 (TH,RH%)."""
    require(p > 0, "plevelducting: p <= 0")
    require(compute in (1, 2, 3, 4), f"plevelducting: bad compute {compute}")
    tconv = _scalar_pidcp(p) if compute % 2 == 0 else np.float32(1)
    tk = t.values * tconv
    mask = and_masks(t, h)
    if compute in (1, 2):
        return out_field(thermo.tk_q_duct(tk, h.values, _f32(p)), mask)
    out, ok = thermo.tk_rh_duct(tk, h.values, _f32(p))
    return out_field(out, mask & ok)


def _levelducting_core(t: Field, h: Field, p_arr, mask, compute: int) -> Field:
    """hlevel/alevel ducting core (FieldCalculations.cc:1256-1271,
    1490-1502)."""
    tk = t.values
    if compute % 2 == 0:
        tk = tk * pidcp_from_p(p_arr)
    if compute in (1, 2):
        return out_field(thermo.tk_q_duct(tk, h.values, p_arr), mask)
    out, ok = thermo.tk_rh_duct(tk, h.values, p_arr)
    return out_field(out, mask & ok)


def hlevelducting(t: Field, h: Field, ps: Field, alevel: float, blevel: float,
                  compute: int) -> Field:
    """Ducting on hybrid levels (FieldCalculations.cc:1219-1274)."""
    require(not _bad_hlevel(alevel, blevel), "hlevelducting: bad alevel/blevel")
    require(compute in (1, 2, 3, 4), f"hlevelducting: bad compute {compute}")
    p_arr = _f32(alevel) + _f32(blevel) * ps.values
    return _levelducting_core(t, h, p_arr, and_masks(t, h, ps), compute)


def alevelducting(t: Field, h: Field, p: Field, compute: int) -> Field:
    """Ducting with a pressure field (FieldCalculations.cc:1460-1505).

    Note: the reference never updates ``fDefined`` here (cc:1500-1503 — a
    latent bug); this implementation propagates the mask correctly and the
    divergence is recorded in the conformance spec.
    """
    require(compute in (1, 2, 3, 4), f"alevelducting: bad compute {compute}")
    return _levelducting_core(t, h, p.values, and_masks(t, h, p), compute)


# ---------------------------------------------------------------------------
# misc level ops
# ---------------------------------------------------------------------------

def pleveldz2tmean(z1: Field, z2: Field, p1: float, p2: float,
                   compute: int) -> Field:
    """Mean temperature of a thickness layer (FieldCalculations.cc:466-503).
    compute: 1 mean T(C), 2 mean T(K), 3 mean theta."""
    require(p1 > 0 and p2 > 0 and p1 != p2, "pleveldz2tmean: bad p1/p2")
    require(compute in (1, 2, 3), f"pleveldz2tmean: bad compute {compute}")
    pi1 = np.float32(_scalar_pidcp(p1) * np.float32(cp))
    pi2 = np.float32(_scalar_pidcp(p2) * np.float32(cp))
    if compute in (1, 2):
        convert = np.float32(np.float32(g) * np.float32(0.5)
                             * (pi1 + pi2) / ((pi2 - pi1) * np.float32(cp)))
        tconvert = -t0 if compute == 1 else _f32(0)
    else:
        convert = np.float32(np.float32(g) / (pi2 - pi1))
        tconvert = _f32(0)
    out = (z1.values - z2.values) * convert + tconvert
    return out_field(out, and_masks(z1, z2))


def hlevelpressure(ps: Field, alevel: float, blevel: float) -> Field:
    """Per-point hybrid-level pressure ``p = alevel + blevel*ps``
    (FieldCalculations.cc:1276-1304)."""
    require(not _bad_hlevel(alevel, blevel), "hlevelpressure: bad alevel/blevel")
    return Field(_f32(alevel) + _f32(blevel) * ps.values, ps.mask)


def sea_sound_speed(t: Field, s: Field, z: float, compute: int) -> Field:
    """Sea-water sound speed, D. Ross SACLANTCEN SM-107 formula
    (FieldCalculations.cc:1555-1602).  compute: 1 T in Celsius, 2 in Kelvin.

    The reference evaluates intermediates in float64; this computes in
    float32 like the rest of the framework — conformance tolerance ~1e-3 m/s on a
    ~1450 m/s result (documented in the conformance spec).
    """
    require(compute in (1, 2), f"seaSoundSpeed: bad compute {compute}")
    tconv = _f32(0) if compute == 1 else t0
    Z = abs(float(z))
    Cz = np.float32(0.01635 * Z + 0.000000175 * Z * Z)
    T = t.values - tconv
    S = s.values
    Ct = _f32(4.565) * T - _f32(0.0517) * T * T + _f32(0.000221) * T * T * T
    Cs = (_f32(1.338) - _f32(0.013) * T + _f32(0.0001) * T * T) * (S - _f32(35.0))
    return out_field(_f32(1449.1) + Ct + Cs + Cz, and_masks(t, s))
