"""Drop-in compatibility tests for mi_fieldcalc_tpu.api.

Mirrors the reference's python unittest (python/test_mi_fieldcalc.py:36-41)
and the binding's None-return conventions (py_mi_fieldcalc.cc:72-96).
"""

import numpy as np

import mi_fieldcalc_tpu.api as fc


def test_abshum_reference_value():
    # python/test_mi_fieldcalc.py:36-41: abshum(293.16K, 0.8) ~= 13.83
    tk = np.array([[293.16]])
    rh = np.array([[0.8]])
    ah = fc.abshum(tk, rh, -1)
    assert ah is not None
    assert abs(ah[0, 0] - 13.83) < 0.02


def test_shape_mismatch_returns_none():
    a = np.zeros((2, 2), np.float32)
    b = np.zeros((2, 3), np.float32)
    assert fc.abshum(a, b) is None


def test_non_2d_returns_none():
    a = np.zeros((4,), np.float32)
    assert fc.cvtemp(a, 1) is None


def test_bad_parameter_returns_none():
    a = np.zeros((2, 2), np.float32)
    assert fc.cvtemp(a, 99) is None
    assert fc.seaSoundSpeed(a, a, 10.0, 3) is None


def test_undef_sentinel_roundtrip():
    undef = 1.0e35
    t = np.full((3, 3), 280.0, np.float32)
    t[1, 1] = undef
    u = np.full((3, 3), 5.0, np.float32)
    v = np.full((3, 3), 5.0, np.float32)
    out = fc.windCooling(t, u, v, 1, undef)
    assert out is not None
    assert out[1, 1] == undef
    assert out[0, 0] != undef


def test_cvhum_dewpoint():
    # cvhum compute=1: T(K), RH(%) -> Td(K); Td <= T, sane range
    t = np.full((2, 2), 290.0, np.float32)
    rh = np.full((2, 2), 50.0, np.float32)
    td = fc.cvhum(t, rh, "", 1)
    assert td is not None
    assert np.all(td < 290.0) and np.all(td > 250.0)


def test_vessel_icing_runs():
    shp = (4, 4)
    airtemp = np.full(shp, -10.0, np.float32)
    seatemp = np.full(shp, 2.0, np.float32)
    u = np.full(shp, 15.0, np.float32)
    v = np.full(shp, 5.0, np.float32)
    sal = np.full(shp, 35.0, np.float32)
    aice = np.zeros(shp, np.float32)
    over = fc.vesselIcingOverland(airtemp, seatemp, u, v, sal, aice)
    mert = fc.vesselIcingMertins(airtemp, seatemp, u, v, sal, aice)
    assert over is not None and np.all(over > 0)
    assert mert is not None and np.all(mert >= 0)


def test_full_surface_smoke():
    """Every reference C++ function has an api wrapper that runs."""
    rng = np.random.default_rng(3)
    g = lambda lo, hi: rng.uniform(lo, hi, (6, 6)).astype(np.float32)  # noqa: E731
    tk, th, rh, q = g(240, 300), g(260, 330), g(5, 95), g(1e-4, 1e-2)
    z, zl, ps, p = g(4900, 5800), g(-50, 250), g(950, 1040), g(200, 1000)
    xm, ym, fcor, w = g(8e-6, 1.3e-5), g(8e-6, 1.3e-5), g(1e-4, 1.4e-4), g(-20, 20)
    calls = [
        lambda: fc.pleveltemp(tk, 500.0, "", 3),
        lambda: fc.plevelthe(tk, rh, 700.0, 1),
        lambda: fc.plevelhum(tk, q, 850.0, "", 1),
        lambda: fc.pleveldz2tmean(z, zl, 500.0, 1000.0, 2),
        lambda: fc.plevelqvector(z, tk, xm, ym, fcor, 500.0, 1),
        lambda: fc.plevelducting(tk, q, 850.0, 1),
        lambda: fc.plevelgwind_xcomp(z, xm, ym, fcor),
        lambda: fc.plevelgwind_ycomp(z, xm, ym, fcor),
        lambda: fc.plevelgvort(z, xm, ym, fcor),
        lambda: fc.hleveltemp(tk, ps, 50.0, 0.9, "", 3),
        lambda: fc.hlevelthe(tk, q, ps, 50.0, 0.9, 1),
        lambda: fc.hlevelhum(tk, q, ps, 50.0, 0.9, "", 1),
        lambda: fc.hlevelducting(tk, q, ps, 50.0, 0.9, 1),
        lambda: fc.hlevelpressure(ps, 50.0, 0.9),
        lambda: fc.aleveltemp(tk, p, "", 3),
        lambda: fc.alevelthe(tk, q, p, 1),
        lambda: fc.alevelhum(tk, q, p, "", 1),
        lambda: fc.alevelducting(tk, q, p, 1),
        lambda: fc.vectorabs(w, w),
        lambda: fc.relvort(w, w, xm, ym),
        lambda: fc.absvort(w, w, xm, ym, fcor),
        lambda: fc.divergence(w, w, xm, ym),
        lambda: fc.advection(tk, w, w, xm, ym, 3.0),
        lambda: fc.gradient(tk, xm, ym, 3),
        lambda: fc.shapiro2_filter(tk),
        lambda: fc.thermalFrontParameter(tk, xm, ym),
        lambda: fc.pressure2FlightLevel(p),
        lambda: fc.momentumXcoordinate(w, xm, fcor, 1e-5),
        lambda: fc.momentumYcoordinate(w, ym, fcor, 1e-5),
        lambda: fc.jacobian(z, tk, xm, ym),
        lambda: fc.values2classes(p, [0.0, 300.0, 600.0, 1000.0]),
        lambda: fc.minvalueFields(tk, th),
        lambda: fc.maxvalueFields(tk, th),
        lambda: fc.minvalueFieldConst(tk, 270.0),
        lambda: fc.maxvalueFieldConst(tk, 270.0),
        lambda: fc.absvalueField(w),
        lambda: fc.log10Field(p),
        lambda: fc.pow10Field(np.log10(p)),
        lambda: fc.logField(p),
        lambda: fc.expField(np.log(p)),
        lambda: fc.powerField(p, 0.5),
        lambda: fc.replaceUndefined(tk, 0.0),
        lambda: fc.replaceDefined(tk, 1.0),
        lambda: fc.fieldOPERfield(1, tk, th),
        lambda: fc.fieldOPERconstant(2, tk, 1.5),
        lambda: fc.constantOPERfield(3, 1.5, tk),
        lambda: fc.sumFields([tk, th]),
        lambda: fc.meanValue([tk, th]),
        lambda: fc.stddevValue([tk, th]),
        lambda: fc.extremeValue(1, [tk, th]),
        lambda: fc.probability(1, [q, q], [2, 2], [5e-3]),
        lambda: fc.neighbourProbFunctions(p, [500.0, 2.0], 5),
        lambda: fc.neighbourFunctions(p, [2.0], 1),
        lambda: fc.snow_in_cm(q * 100, tk, tk),
    ]
    for i, call in enumerate(calls):
        out = call()
        assert out is not None, f"call #{i} returned None"
        arr = out[0] if isinstance(out, tuple) else out
        assert arr.shape == (6, 6), f"call #{i} shape {arr.shape}"
    ug_vg = fc.ilevelgwind(g(2.9e5, 3.1e5), xm, ym, fcor)
    assert ug_vg is not None and len(ug_vg) == 2


def test_undef_threading_value_equals_undef():
    """fieldOPERconstant / constantOPERfield / plevelhum must see the
    caller's undef: value == undef yields an all-undef field
    (cc:2631-2634), and p == undef fills plevelhum's output undef
    (cc:437) — previously the op-side undef stayed at 1e35."""
    import numpy as np
    import mi_fieldcalc_tpu.api as fc

    U = -999.0
    f = np.full((2, 3), 5.0, np.float32)
    out = fc.fieldOPERconstant(1, f, value=U, undef=U)
    assert (out == np.float32(U)).all()
    out = fc.constantOPERfield(1, U, f, undef=U)
    assert (out == np.float32(U)).all()
    t = np.full((2, 3), 288.0, np.float32)
    q = np.full((2, 3), 5e-3, np.float32)
    # p == undef must be a POSITIVE value to pass the reference's p <= 0
    # validation (cc:419 precedes the undef check)
    U2 = 9999.0
    out = fc.plevelhum(t, q, p=U2, unit="x", compute=1, undef=U2)
    assert (out == np.float32(U2)).all()
    # and a real p still computes
    out = fc.plevelhum(t, q, p=850.0, unit="x", compute=1, undef=U2)
    assert (out != np.float32(U2)).all()


def test_neighbour_requires_all_defined():
    """Reference cc:2869/2965: neighbour ops return false unless the
    input is ALL_DEFINED -> drop-in surface returns None."""
    import numpy as np
    import mi_fieldcalc_tpu.api as fc

    v = np.ones((10, 10), np.float32)
    assert fc.neighbourFunctions(v, [2.0], compute=1) is not None
    v[3, 3] = 1e35
    assert fc.neighbourFunctions(v, [2.0], compute=1) is None
    assert fc.neighbourProbFunctions(v, [5.0, 2.0], compute=5) is None


def test_mean_value_all_defined_flag_trusts_member():
    """A member flagged ALL_DEFINED skips the per-point sentinel check
    (cc:2710): its sentinel values count as real data."""
    import numpy as np
    import mi_fieldcalc_tpu.api as fc
    from mi_fieldcalc_tpu.field import ValuesDefined as VD

    a = np.full((2, 2), 2.0, np.float32)
    b = np.full((2, 2), 4.0, np.float32)
    b[0, 0] = 1e35
    # flags honest: the sentinel point is excluded -> mean 2.0 there
    out = fc.meanValue([a, b], fDefinedIn=[VD.ALL_DEFINED, VD.SOME_DEFINED])
    assert out[0, 0] == np.float32(2.0) and out[1, 1] == np.float32(3.0)
    # member b falsely flagged ALL_DEFINED: the 1e35 is summed as data
    out = fc.meanValue([a, b], fDefinedIn=[VD.ALL_DEFINED, VD.ALL_DEFINED])
    assert out[0, 0] == np.float32((2.0 + 1e35) / 2)
    # no flags: sentinel-derived masks (previous behavior)
    out = fc.meanValue([a, b])
    assert out[0, 0] == np.float32(2.0)


def test_drop_in_module_shim():
    """`import mi_fieldcalc` (the reference's pybind11 module name)
    resolves to this build with the bound surface intact."""
    import mi_fieldcalc as mf

    assert hasattr(mf, "ValuesDefined")
    for name in ("kIndex", "ductingIndex", "showalterIndex", "boydenIndex",
                 "sweatIndex", "seaSoundSpeed", "cvtemp", "cvhum", "abshum",
                 "windCooling", "underCooledRain", "vesselIcingOverland",
                 "vesselIcingMertins", "vesselIcingModStall",
                 "vesselIcingMincog"):
        assert callable(getattr(mf, name)), name
    out = mf.abshum(np.array([[293.16]], np.float32),
                    np.array([[0.8]], np.float32), -1.0)
    assert abs(float(out[0, 0]) - 13.84) < 0.01
