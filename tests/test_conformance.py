"""Reference-conformance suite: every golden in tests/goldens/goldens.npz
(generated from the compiled reference library via tools/oracle/) is
replayed through this framework's ops and compared.

Comparison contract (SURVEY §7 hard part 1):
* values must agree (allclose at per-case tolerance; exact for pure
  arithmetic, loose only where the reference computes double-precision
  intermediates) at every point where BOTH sides are defined;
* the native mask must equal the reference's sentinel pattern exactly,
  except for ops on the documented-divergence list (``mask_exact=False``)
  where the reference's flag handling is buggy/inconsistent
  (e.g. showalterIndex leaves outputs uninitialized, cc:965-967).
"""

import os

import numpy as np
import pytest

from conformance_cases import CASES, UNDEF, case_inputs

from mi_fieldcalc_tpu import from_sentinel, ops

GOLDENS_PATH = os.path.join(os.path.dirname(__file__), "goldens",
                            "goldens.npz")
GOLDENS = np.load(GOLDENS_PATH) if os.path.exists(GOLDENS_PATH) else None


def _native(case, ins):
    """Dispatch a conformance case to the native operator suite."""
    F = [from_sentinel(a) for a in ins]
    s = case.scalars
    op = case.op
    if op == "pleveltemp":
        return ops.pleveltemp(F[0], s["p"], s["compute"], s["unit"])
    if op == "plevelthe":
        return ops.plevelthe(F[0], F[1], s["p"], s["compute"])
    if op == "plevelhum":
        return ops.plevelhum(F[0], F[1], s["p"], s["compute"], s["unit"])
    if op == "pleveldz2tmean":
        return ops.pleveldz2tmean(F[0], F[1], s["p1"], s["p2"], s["compute"])
    if op == "plevelducting":
        return ops.plevelducting(F[0], F[1], s["p"], s["compute"])
    if op == "hleveltemp":
        return ops.hleveltemp(F[0], F[1], s["alevel"], s["blevel"],
                              s["compute"], s["unit"])
    if op == "hlevelthe":
        return ops.hlevelthe(F[0], F[1], F[2], s["alevel"], s["blevel"],
                             s["compute"])
    if op == "hlevelhum":
        return ops.hlevelhum(F[0], F[1], F[2], s["alevel"], s["blevel"],
                             s["compute"], s["unit"])
    if op == "hlevelducting":
        return ops.hlevelducting(F[0], F[1], F[2], s["alevel"], s["blevel"],
                                 s["compute"])
    if op == "hlevelpressure":
        return ops.hlevelpressure(F[0], s["alevel"], s["blevel"])
    if op == "aleveltemp":
        return ops.aleveltemp(F[0], F[1], s["compute"], s["unit"])
    if op == "alevelthe":
        return ops.alevelthe(F[0], F[1], F[2], s["compute"])
    if op == "alevelhum":
        return ops.alevelhum(F[0], F[1], F[2], s["compute"], s["unit"])
    if op == "alevelducting":
        return ops.alevelducting(F[0], F[1], F[2], s["compute"])
    if op == "ilevelgwind":
        return ops.ilevelgwind(F[0], F[1], F[2], F[3])
    if op == "seaSoundSpeed":
        return ops.sea_sound_speed(F[0], F[1], s["z"], s["compute"])
    if op == "kIndex":
        return ops.k_index(F[0], F[1], F[2], F[3], F[4], s["p500"],
                           s["p700"], s["p850"], s["compute"])
    if op == "ductingIndex":
        return ops.ducting_index(F[0], F[1], s["p850"], s["compute"])
    if op == "showalterIndex":
        return ops.showalter_index(F[0], F[1], F[2], s["p500"], s["p850"],
                                   s["compute"])
    if op == "boydenIndex":
        return ops.boyden_index(F[0], F[1], F[2], s["p700"], s["p1000"],
                                s["compute"])
    if op == "sweatIndex":
        return ops.sweat_index(*F)
    if op == "cvtemp":
        return ops.cvtemp(F[0], s["compute"])
    if op == "cvhum":
        return ops.cvhum(F[0], F[1], s["compute"], s["unit"])
    if op == "abshum":
        return ops.abshum(F[0], F[1])
    if op == "vectorabs":
        return ops.vectorabs(F[0], F[1])
    if op == "windCooling":
        return ops.wind_cooling(F[0], F[1], F[2], s["compute"])
    if op == "underCooledRain":
        return ops.under_cooled_rain(F[0], F[1], F[2], s["precipMin"],
                                     s["snowRateMax"], s["tcMax"])
    if op == "pressure2FlightLevel":
        return ops.pressure2flightlevel(F[0])
    if op == "snow_in_cm":
        return ops.snow_in_cm(F[0], F[1], F[2])
    if op == "values2classes":
        return ops.values2classes(F[0], s["values"])
    if op == "fieldOPERfield":
        return ops.field_oper_field(s["compute"], F[0], F[1])
    if op == "fieldOPERconstant":
        return ops.field_oper_constant(s["compute"], F[0], s["value"])
    if op == "constantOPERfield":
        return ops.constant_oper_field(s["compute"], s["value"], F[0])
    if op == "minvalueFields":
        return ops.minvalue_fields(F[0], F[1])
    if op == "maxvalueFields":
        return ops.maxvalue_fields(F[0], F[1])
    if op == "minvalueFieldConst":
        return ops.minvalue_field_const(F[0], s["value"])
    if op == "maxvalueFieldConst":
        return ops.maxvalue_field_const(F[0], s["value"])
    if op == "absvalueField":
        return ops.absvalue_field(F[0])
    if op == "log10Field":
        return ops.log10_field(F[0])
    if op == "pow10Field":
        return ops.pow10_field(F[0])
    if op == "logField":
        return ops.log_field(F[0])
    if op == "expField":
        return ops.exp_field(F[0])
    if op == "powerField":
        return ops.power_field(F[0], s["value"])
    if op == "replaceUndefined":
        return ops.replace_undefined(F[0], s["value"])
    if op == "replaceDefined":
        return ops.replace_defined(F[0], s["value"])
    if op == "copy_field":
        return F[0]    # functional identity; reference memcpy (cc:318-322)
    if op == "plevelgwind_xcomp":
        return ops.plevelgwind_xcomp(F[0], F[1], F[2], F[3])
    if op == "plevelgwind_ycomp":
        return ops.plevelgwind_ycomp(F[0], F[1], F[2], F[3])
    if op == "plevelgvort":
        return ops.plevelgvort(F[0], F[1], F[2], F[3])
    if op == "plevelqvector":
        return ops.plevelqvector(F[0], F[1], F[2], F[3], F[4], s["p"],
                                 s["compute"])
    if op == "relvort":
        return ops.relvort(F[0], F[1], F[2], F[3])
    if op == "absvort":
        return ops.absvort(F[0], F[1], F[2], F[3], F[4])
    if op == "divergence":
        return ops.divergence(F[0], F[1], F[2], F[3])
    if op == "advection":
        return ops.advection(F[0], F[1], F[2], F[3], F[4], s["hours"])
    if op == "gradient":
        return ops.gradient(F[0], F[1], F[2], s["compute"])
    if op == "shapiro2_filter":
        return ops.shapiro2_filter(F[0])
    if op == "thermalFrontParameter":
        return ops.thermal_front_parameter(F[0], F[1], F[2])
    if op == "momentumXcoordinate":
        return ops.momentum_x_coordinate(F[0], F[1], F[2],
                                         s["fcoriolisMin"])
    if op == "momentumYcoordinate":
        return ops.momentum_y_coordinate(F[0], F[1], F[2],
                                         s["fcoriolisMin"])
    if op == "jacobian":
        return ops.jacobian(F[0], F[1], F[2], F[3])
    if op == "sumFields":
        return ops.sum_fields(F[0])
    if op == "meanValue":
        return ops.mean_value(F[0])
    if op == "stddevValue":
        return ops.stddev_value(F[0])
    if op == "extremeValue":
        return ops.extreme_value(s["compute"], F[0])
    if op == "probability":
        return ops.probability(s["compute"], F[0], s["limits"])
    if op == "neighbourProbFunctions":
        return ops.neighbour_prob_functions(F[0], s["constants"],
                                            s["compute"])
    if op == "neighbourFunctions":
        return ops.neighbour_functions(F[0], s["constants"], s["compute"])
    if op == "vesselIcingOverland":
        return ops.vessel_icing_overland(*F)
    if op == "vesselIcingMertins":
        return ops.vessel_icing_mertins(*F)
    if op == "vesselIcingModStall":
        return ops.vessel_icing_modstall(*F, s["vs"], s["alpha"], s["zmin"],
                                         s["zmax"])
    if op == "vesselIcingMincog":
        return ops.vessel_icing_mincog(*F, s["vs"], s["alpha"], s["zmin"],
                                       s["zmax"], s["alt"])
    raise KeyError(f"no native adapter for {op}")


def _check(case, field, ref):
    ref_mask = (ref != UNDEF) & ~np.isnan(ref)
    my_mask = np.asarray(field.mask)
    my_vals = np.asarray(field.values)
    if case.mask_exact:
        np.testing.assert_array_equal(
            my_mask, ref_mask,
            err_msg=f"{case.name}: mask != reference sentinel pattern")
    both = my_mask & ref_mask
    assert both.any() or not ref_mask.any(), \
        f"{case.name}: no commonly-defined points"
    np.testing.assert_allclose(
        my_vals[both], ref[both], rtol=case.rtol, atol=case.atol,
        err_msg=f"{case.name}: values diverge from reference")


@pytest.mark.skipif(GOLDENS is None, reason="goldens.npz not generated")
@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_conformance(case):
    ins = case_inputs(case)
    out = _native(case, ins)
    if case.op == "ilevelgwind":
        _check(case, out[0], GOLDENS[case.name + "__out"])
        _check(case, out[1], GOLDENS[case.name + "__out2"])
    else:
        _check(case, out, GOLDENS[case.name + "__out"])
