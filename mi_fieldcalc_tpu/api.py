"""Drop-in replacement for the reference's ``mi_fieldcalc`` python module.

The reference binds 15 functions via pybind11 (python/py_mi_fieldcalc.cc:
179-208) with numpy-in / numpy-out signatures, a trailing ``undef``
sentinel float, and ``None`` returned for invalid shapes or parameters
(py_mi_fieldcalc.cc:72-96).  This module reproduces that surface exactly —
``import mi_fieldcalc_tpu.api as fc`` is a drop-in for
``import mi_fieldcalc as fc`` — while running every calculation through
the mask-lane device programs.

Sentinel decode/encode happens only here, at the boundary, mirroring
``is_defined`` (FieldCalculations.h:42-45); inside, everything is Fields.
"""

from __future__ import annotations

import functools

import numpy as np

from .field import Field, UNDEF, ValuesDefined, from_sentinel  # noqa: F401
from .batch import (batch, clear_input_cache, cache_stats,  # noqa: F401
                    fetch, Deferred, BatchError)
from . import ops

__all__ = [
    # call-storm batching (batch.py): one device program per storm
    "batch", "clear_input_cache", "cache_stats", "fetch", "Deferred",
    "BatchError",
    # the 15 functions the reference's pybind11 module exposes
    "ValuesDefined", "kIndex", "ductingIndex", "showalterIndex",
    "boydenIndex", "sweatIndex", "seaSoundSpeed", "cvtemp", "cvhum",
    "abshum", "windCooling", "underCooledRain", "vesselIcingOverland",
    "vesselIcingMertins", "vesselIcingModStall", "vesselIcingMincog",
    # the rest of the C++ API (FieldCalculations.h:113-304), same
    # signature order minus (nx, ny, out, fDefined)
    "pleveltemp", "plevelthe", "plevelhum", "pleveldz2tmean",
    "plevelqvector", "plevelducting", "plevelgwind_xcomp",
    "plevelgwind_ycomp", "plevelgvort", "hleveltemp", "hlevelthe",
    "hlevelhum", "hlevelducting", "hlevelpressure", "aleveltemp",
    "alevelthe", "alevelhum", "alevelducting", "ilevelgwind", "vectorabs",
    "relvort", "absvort", "divergence", "advection", "gradient",
    "shapiro2_filter", "thermalFrontParameter", "pressure2FlightLevel",
    "momentumXcoordinate", "momentumYcoordinate", "jacobian",
    "values2classes", "minvalueFields", "minvalueFieldConst",
    "maxvalueFields", "maxvalueFieldConst", "absvalueField", "log10Field",
    "pow10Field", "logField", "expField", "powerField", "replaceUndefined",
    "replaceDefined", "fieldOPERfield", "fieldOPERconstant",
    "constantOPERfield", "sumFields", "meanValue", "stddevValue",
    "extremeValue", "probability", "neighbourProbFunctions",
    "neighbourFunctions", "snow_in_cm", "copy_field",
]


def _canon(x):
    """Hashable (jit-cache-key) form of a scalar parameter."""
    return tuple(x) if isinstance(x, (list, tuple)) else x


@functools.lru_cache(maxsize=1024)
def _compiled(op, undef, scalars, kwitems, lead_scalars=()):
    """One jitted program per (operator, scalar-parameter) combination
    covering the whole numpy boundary: sentinel decode -> operator ->
    sentinel encode.  Eagerly dispatching the decoded ops one by one costs
    100-2000 ms/call over this backend's relay; compiled calls are
    transfer-bound (~10 ms on the operational grid).

    Argument order: ``op(*lead_scalars, *fields, *scalars, **kwitems)``.
    """
    import jax

    kw = dict(kwitems)

    def run(*arrs):
        fields = tuple(from_sentinel(a, undef) for a in arrs)
        out = op(*lead_scalars, *fields, *scalars, **kw)
        if isinstance(out, Field):
            return out.to_sentinel(undef)
        return tuple(o.to_sentinel(undef) for o in out)

    return jax.jit(run)


def _wrap(op, undef, *arrays, scalars=(), kwscalars=None, lead_scalars=()):
    """The py_wrap_2d equivalent: validate 2-D equal shapes, decode
    sentinels, run the jit-compiled operator, re-encode.  Returns None on
    invalid input, like the reference binding.  ``lead_scalars`` go
    BEFORE the fields (the reference's ``(compute, ...)``-first
    signatures).

    Inside a :func:`batch` context the call is RECORDED instead of
    dispatched (one device program for the whole storm — batch.py)."""
    from .batch import active_batch
    b = active_batch()
    if b is not None:
        return b.record(op, float(undef), arrays,
                        tuple(_canon(s) for s in scalars),
                        tuple(sorted((kwscalars or {}).items())),
                        tuple(_canon(s) for s in lead_scalars))
    npa = [np.asarray(a, dtype=np.float32) for a in arrays]
    if npa[0].ndim != 2 or any(a.shape != npa[0].shape for a in npa[1:]):
        return None
    fn = _compiled(op, float(undef), tuple(_canon(s) for s in scalars),
                   tuple(sorted((kwscalars or {}).items())),
                   tuple(_canon(s) for s in lead_scalars))
    try:
        out = fn(*npa)
    except ValueError:
        return None  # reference operators signal bad parameters with false
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def kIndex(t500, t700, rh700, t850, rh850, p500: float, p700: float,
           p850: float, compute: int, undef: float = UNDEF):
    return _wrap(ops.k_index, undef, t500, t700, rh700, t850, rh850,
                 scalars=(p500, p700, p850, compute))


def ductingIndex(t850, rh850, p850: float, compute: int,
                 undef: float = UNDEF):
    return _wrap(ops.ducting_index, undef, t850, rh850,
                 scalars=(p850, compute))


def showalterIndex(t500, t850, rh850, p500: float, p850: float,
                   compute: int, undef: float = UNDEF):
    return _wrap(ops.showalter_index, undef, t500, t850, rh850,
                 scalars=(p500, p850, compute))


def boydenIndex(t700, z700, z1000, p700: float, p1000: float, compute: int,
                undef: float = UNDEF):
    return _wrap(ops.boyden_index, undef, t700, z700, z1000,
                 scalars=(p700, p1000, compute))


def sweatIndex(t850, t500, td850, td500, u850, v850, u500, v500,
               undef: float = UNDEF):
    return _wrap(ops.sweat_index, undef, t850, t500, td850, td500,
                 u850, v850, u500, v500)


def seaSoundSpeed(t, s, z: float, compute: int, undef: float = UNDEF):
    return _wrap(ops.sea_sound_speed, undef, t, s, scalars=(z, compute))


def cvtemp(tinp, compute: int, undef: float = UNDEF):
    return _wrap(ops.cvtemp, undef, tinp, scalars=(compute,))


def cvhum(t, huminp, unit: str, compute: int, undef: float = UNDEF):
    return _wrap(ops.cvhum, undef, t, huminp, scalars=(compute, unit))


def abshum(t, rhum, undef: float = UNDEF):
    return _wrap(ops.abshum, undef, t, rhum)


def windCooling(t, u, v, compute: int, undef: float = UNDEF):
    return _wrap(ops.wind_cooling, undef, t, u, v, scalars=(compute,))


def underCooledRain(precip, snow, tk, precipMin: float, snowRateMax: float,
                    tcMax: float, undef: float = UNDEF):
    return _wrap(ops.under_cooled_rain, undef, precip, snow, tk,
                 scalars=(precipMin, snowRateMax, tcMax))


def vesselIcingOverland(airtemp, seatemp, u, v, sal, aice,
                        undef: float = UNDEF):
    return _wrap(ops.vessel_icing_overland, undef, airtemp, seatemp, u, v,
                 sal, aice)


def vesselIcingMertins(airtemp, seatemp, u, v, sal, aice,
                       undef: float = UNDEF):
    return _wrap(ops.vessel_icing_mertins, undef, airtemp, seatemp, u, v,
                 sal, aice)


def vesselIcingModStall(sal, wave, x_wind, y_wind, airtemp, rh, sst, p, Pw,
                        aice, depth, vs: float, alpha: float, zmin: float,
                        zmax: float, undef: float = UNDEF):
    return _wrap(ops.vessel_icing_modstall, undef, sal, wave, x_wind,
                 y_wind, airtemp, rh, sst, p, Pw, aice, depth,
                 scalars=(vs, alpha, zmin, zmax))


def vesselIcingMincog(sal, wave, x_wind, y_wind, airtemp, rh, sst, p, Pw,
                      aice, depth, vs: float, alpha: float, zmin: float,
                      zmax: float, alt: int, undef: float = UNDEF):
    return _wrap(ops.vessel_icing_mincog, undef, sal, wave, x_wind, y_wind,
                 airtemp, rh, sst, p, Pw, aice, depth,
                 scalars=(vs, alpha, zmin, zmax, alt))


# ---------------------------------------------------------------------------
# Full C++ API surface (FieldCalculations.h:113-304) beyond the reference's
# python-bound subset: same argument order as the C++ declarations, minus
# (nx, ny) / output pointer / fDefined, with a trailing undef.
# ---------------------------------------------------------------------------

def pleveltemp(tinp, p: float, unit: str, compute: int,
               undef: float = UNDEF):
    return _wrap(ops.pleveltemp, undef, tinp, scalars=(p, compute, unit))


def plevelthe(t, rh, p: float, compute: int, undef: float = UNDEF):
    return _wrap(ops.plevelthe, undef, t, rh, scalars=(p, compute))


def plevelhum(t, huminp, p: float, unit: str, compute: int,
              undef: float = UNDEF):
    # undef threads through: p == undef fills the output undef for the
    # pressure-dependent modes (FieldCalculations.cc:437)
    return _wrap(ops.plevelhum, undef, t, huminp,
                 scalars=(p, compute, unit), kwscalars={"undef": undef})


def pleveldz2tmean(z1, z2, p1: float, p2: float, compute: int,
                   undef: float = UNDEF):
    return _wrap(ops.pleveldz2tmean, undef, z1, z2,
                 scalars=(p1, p2, compute))


def plevelqvector(z, t, xmapr, ymapr, fcoriolis, p: float, compute: int,
                  undef: float = UNDEF):
    return _wrap(ops.plevelqvector, undef, z, t, xmapr, ymapr, fcoriolis,
                 scalars=(p, compute))


def plevelducting(t, h, p: float, compute: int, undef: float = UNDEF):
    return _wrap(ops.plevelducting, undef, t, h, scalars=(p, compute))


def plevelgwind_xcomp(z, xmapr, ymapr, fcoriolis, undef: float = UNDEF):
    return _wrap(ops.plevelgwind_xcomp, undef, z, xmapr, ymapr, fcoriolis)


def plevelgwind_ycomp(z, xmapr, ymapr, fcoriolis, undef: float = UNDEF):
    return _wrap(ops.plevelgwind_ycomp, undef, z, xmapr, ymapr, fcoriolis)


def plevelgvort(z, xmapr, ymapr, fcoriolis, undef: float = UNDEF):
    return _wrap(ops.plevelgvort, undef, z, xmapr, ymapr, fcoriolis)


def hleveltemp(tinp, ps, alevel: float, blevel: float, unit: str,
               compute: int, undef: float = UNDEF):
    return _wrap(ops.hleveltemp, undef, tinp, ps,
                 scalars=(alevel, blevel, compute, unit))


def hlevelthe(t, q, ps, alevel: float, blevel: float, compute: int,
              undef: float = UNDEF):
    return _wrap(ops.hlevelthe, undef, t, q, ps,
                 scalars=(alevel, blevel, compute))


def hlevelhum(t, huminp, ps, alevel: float, blevel: float, unit: str,
              compute: int, undef: float = UNDEF):
    return _wrap(ops.hlevelhum, undef, t, huminp, ps,
                 scalars=(alevel, blevel, compute, unit))


def hlevelducting(t, h, ps, alevel: float, blevel: float, compute: int,
                  undef: float = UNDEF):
    return _wrap(ops.hlevelducting, undef, t, h, ps,
                 scalars=(alevel, blevel, compute))


def hlevelpressure(ps, alevel: float, blevel: float, undef: float = UNDEF):
    return _wrap(ops.hlevelpressure, undef, ps, scalars=(alevel, blevel))


def aleveltemp(tinp, p, unit: str, compute: int, undef: float = UNDEF):
    return _wrap(ops.aleveltemp, undef, tinp, p, scalars=(compute, unit))


def alevelthe(t, q, p, compute: int, undef: float = UNDEF):
    return _wrap(ops.alevelthe, undef, t, q, p, scalars=(compute,))


def alevelhum(t, huminp, p, unit: str, compute: int, undef: float = UNDEF):
    return _wrap(ops.alevelhum, undef, t, huminp, p,
                 scalars=(compute, unit))


def alevelducting(t, h, p, compute: int, undef: float = UNDEF):
    return _wrap(ops.alevelducting, undef, t, h, p, scalars=(compute,))


def ilevelgwind(mpot, xmapr, ymapr, fcoriolis, undef: float = UNDEF):
    """Returns (ug, vg) — the reference fills two output arrays."""
    return _wrap(ops.ilevelgwind, undef, mpot, xmapr, ymapr, fcoriolis)


def vectorabs(u, v, undef: float = UNDEF):
    return _wrap(ops.vectorabs, undef, u, v)


def relvort(u, v, xmapr, ymapr, undef: float = UNDEF):
    return _wrap(ops.relvort, undef, u, v, xmapr, ymapr)


def absvort(u, v, xmapr, ymapr, fcoriolis, undef: float = UNDEF):
    return _wrap(ops.absvort, undef, u, v, xmapr, ymapr, fcoriolis)


def divergence(u, v, xmapr, ymapr, undef: float = UNDEF):
    return _wrap(ops.divergence, undef, u, v, xmapr, ymapr)


def advection(f, u, v, xmapr, ymapr, hours: float, undef: float = UNDEF):
    return _wrap(ops.advection, undef, f, u, v, xmapr, ymapr,
                 scalars=(hours,))


def gradient(field, xmapr, ymapr, compute: int, undef: float = UNDEF):
    return _wrap(ops.gradient, undef, field, xmapr, ymapr,
                 scalars=(compute,))


def shapiro2_filter(field, undef: float = UNDEF):
    npa = np.asarray(field, np.float32)
    if npa.ndim != 2:
        return None
    # resolve the all-defined fast path host-side (a traced jnp.all would
    # fail under jit; the reference also branches once per call, cc:2101)
    all_defined = bool(not np.isnan(npa).any()
                       and not (npa == np.float32(undef)).any())
    return _wrap(ops.shapiro2_filter, undef, npa,
                 kwscalars={"undef": undef, "all_defined": all_defined})


def thermalFrontParameter(t, xmapr, ymapr, undef: float = UNDEF):
    return _wrap(ops.thermal_front_parameter, undef, t, xmapr, ymapr)


def pressure2FlightLevel(pressure, undef: float = UNDEF):
    return _wrap(ops.pressure2flightlevel, undef, pressure)


def momentumXcoordinate(v, xmapr, fcoriolis, fcoriolisMin: float,
                        undef: float = UNDEF):
    return _wrap(ops.momentum_x_coordinate, undef, v, xmapr, fcoriolis,
                 scalars=(fcoriolisMin,))


def momentumYcoordinate(u, ymapr, fcoriolis, fcoriolisMin: float,
                        undef: float = UNDEF):
    return _wrap(ops.momentum_y_coordinate, undef, u, ymapr, fcoriolis,
                 scalars=(fcoriolisMin,))


def jacobian(field1, field2, xmapr, ymapr, undef: float = UNDEF):
    return _wrap(ops.jacobian, undef, field1, field2, xmapr, ymapr)


def values2classes(fvalue, values, undef: float = UNDEF):
    return _wrap(ops.values2classes, undef, fvalue,
                 scalars=(list(values),))


def minvalueFields(field1, field2, undef: float = UNDEF):
    return _wrap(ops.minvalue_fields, undef, field1, field2)


def maxvalueFields(field1, field2, undef: float = UNDEF):
    return _wrap(ops.maxvalue_fields, undef, field1, field2)


def minvalueFieldConst(field1, value: float, undef: float = UNDEF):
    return _wrap(ops.minvalue_field_const, undef, field1,
                 scalars=(value,), kwscalars={"undef": undef})


def maxvalueFieldConst(field1, value: float, undef: float = UNDEF):
    return _wrap(ops.maxvalue_field_const, undef, field1,
                 scalars=(value,), kwscalars={"undef": undef})


def absvalueField(field, undef: float = UNDEF):
    return _wrap(ops.absvalue_field, undef, field)


def log10Field(field, undef: float = UNDEF):
    return _wrap(ops.log10_field, undef, field)


def pow10Field(field, undef: float = UNDEF):
    return _wrap(ops.pow10_field, undef, field)


def logField(field, undef: float = UNDEF):
    return _wrap(ops.log_field, undef, field)


def expField(field, undef: float = UNDEF):
    return _wrap(ops.exp_field, undef, field)


def powerField(field, value: float, undef: float = UNDEF):
    return _wrap(ops.power_field, undef, field, scalars=(value,),
                 kwscalars={"undef": undef})


def replaceUndefined(field, value: float, undef: float = UNDEF):
    return _wrap(ops.replace_undefined, undef, field, scalars=(value,),
                 kwscalars={"undef": undef})


def replaceDefined(field, value: float, undef: float = UNDEF):
    return _wrap(ops.replace_defined, undef, field, scalars=(value,),
                 kwscalars={"undef": undef})


def fieldOPERfield(compute: int, field1, field2, undef: float = UNDEF):
    return _wrap(ops.field_oper_field, undef, field1, field2,
                 lead_scalars=(compute,))


def fieldOPERconstant(compute: int, field, value: float,
                      undef: float = UNDEF):
    # undef threads through: value == undef yields an all-undef field
    # (FieldCalculations.cc:2631-2634)
    return _wrap(ops.field_oper_constant, undef, field,
                 lead_scalars=(compute,), scalars=(value,),
                 kwscalars={"undef": undef})


def constantOPERfield(compute: int, value: float, field,
                      undef: float = UNDEF):
    return _wrap(ops.constant_oper_field, undef, field,
                 lead_scalars=(compute, value),
                 kwscalars={"undef": undef})


@functools.lru_cache(maxsize=256)
def _member_stack_op(op, nlead, nfields):
    """Adapter giving a member reduction the regular per-field call
    convention: the members enter as ``nfields`` separate 2-D Fields
    and are stacked IN-PROGRAM.  Inside :func:`batch` this keeps each
    member an individual input — it dedups/caches like any other array
    and ships inside the shared same-shape transfer group instead of as
    a separate pre-stacked 3-D block."""
    def run(*args, **kw):
        import jax.numpy as jnp
        lead = args[:nlead]
        fs = args[nlead:nlead + nfields]
        scal = args[nlead + nfields:]
        stacked = Field(jnp.stack([f.values for f in fs]),
                        jnp.stack([f.mask for f in fs]))
        return op(*lead, stacked, *scal, **kw)
    return run


def _wrap_members(op, undef, fields, lead_scalars=(), scalars=()):
    """Ensemble wrapper: stack member fields on a leading axis and run the
    jitted reduction (``op(*lead_scalars, stack, *scalars)``).  Inside a
    :func:`batch` context each member records as its own 2-D input
    (stacked in-program by :func:`_member_stack_op`), so Deferred
    members chain on device and concrete members ride the input cache."""
    from .batch import active_batch
    b = active_batch()
    if b is not None:
        fields = list(fields)
        if not fields:
            return None
        return b.record(
            _member_stack_op(op, len(lead_scalars), len(fields)),
            float(undef), tuple(fields),
            tuple(_canon(s) for s in scalars), (),
            tuple(_canon(s) for s in lead_scalars))
    npa = [np.asarray(a, np.float32) for a in fields]
    if not npa or npa[0].ndim != 2 \
            or any(a.shape != npa[0].shape for a in npa[1:]):
        return None
    fn = _compiled(op, float(undef), tuple(_canon(s) for s in scalars), (),
                   tuple(_canon(s) for s in lead_scalars))
    try:
        return np.asarray(fn(np.stack(npa)))
    except ValueError:
        return None


def sumFields(fields, undef: float = UNDEF):
    return _wrap_members(ops.sum_fields, undef, fields)


def _member_flags(fDefinedIn):
    if fDefinedIn is None:
        return None
    return tuple(ValuesDefined(int(d)) for d in fDefinedIn)


def meanValue(fields, fDefinedIn=None, undef: float = UNDEF):
    # a member flagged ALL_DEFINED skips the per-point sentinel check
    # (reference cc:2710) — see ops.ensemble._apply_member_flags
    return _wrap_members(ops.mean_value, undef, fields,
                         scalars=(_member_flags(fDefinedIn),))


def stddevValue(fields, fDefinedIn=None, undef: float = UNDEF):
    return _wrap_members(ops.stddev_value, undef, fields,
                         scalars=(_member_flags(fDefinedIn),))


def extremeValue(compute: int, fields, undef: float = UNDEF):
    return _wrap_members(ops.extreme_value, undef, fields,
                         lead_scalars=(compute,))


def probability(compute: int, fields, fDefinedIn, limits,
                undef: float = UNDEF):
    return _wrap_members(
        ops.probability, undef, fields, lead_scalars=(compute,),
        scalars=(tuple(limits),
                 tuple(ValuesDefined(int(d)) for d in fDefinedIn)))


def _all_defined_2d(field, undef):
    """Host-side ALL_DEFINED precondition (the pattern shapiro2_filter
    uses): returns the validated array or None."""
    npa = np.asarray(field, np.float32)
    if npa.ndim != 2 or np.isnan(npa).any() \
            or (npa == np.float32(undef)).any():
        return None
    return npa


def neighbourProbFunctions(field, constants, compute: int,
                           undef: float = UNDEF):
    # reference cc:2869 returns false unless the input is ALL_DEFINED —
    # a sentinel flowing into the window sums would otherwise poison
    # whole windows while staying marked defined
    npa = _all_defined_2d(field, undef)
    if npa is None:
        return None
    return _wrap(ops.neighbour_prob_functions, undef, npa,
                 scalars=(list(constants), compute))


def neighbourFunctions(field, constants, compute: int,
                       undef: float = UNDEF):
    # ALL_DEFINED precondition, as above (reference cc:2965)
    npa = _all_defined_2d(field, undef)
    if npa is None:
        return None
    return _wrap(ops.neighbour_functions, undef, npa,
                 scalars=(list(constants), compute))


def snow_in_cm(snow_water, tk2m, td2m, undef: float = UNDEF):
    return _wrap(ops.snow_in_cm, undef, snow_water, tk2m, td2m)


def copy_field(finp, undef: float = UNDEF):
    """Verbatim copy (FieldCalculations.cc:318-322); numpy-in/numpy-out."""
    npa = np.asarray(finp, np.float32)
    if npa.ndim != 2:
        return None
    return npa.copy()
