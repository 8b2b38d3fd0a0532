"""Declarative case list for reference-conformance goldens.

Each case names an operator, the *kinds* of its input fields (value ranges
that make the formula's domain valid), scalar parameters, and an undef
pattern.  ``tools/oracle/gen_goldens.py`` replays these through the
compiled reference library (the oracle) and stores outputs in
``tests/goldens/goldens.npz``; ``tests/test_conformance.py`` replays them
through this framework's ops and compares.

Input generation is deterministic: ``case_inputs(case)`` seeds a
PCG64 stream with the case name so generator and test agree bit-for-bit.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

UNDEF = 1.0e35
NY, NX = 12, 10  # small grid; (ny, nx) C-order == reference x-fastest
#: production-size grid (the reference's own perf canary: the MET Norway
#: operational AROME grid, test/FieldCalculationsTest.cc:145-170)
LARGE_NY, LARGE_NX = 719, 929

# value ranges per field kind (chosen inside each formula's valid domain)
KIND_RANGES = {
    "tk": (235.0, 305.0),        # air temperature, Kelvin
    "tc": (-35.0, 25.0),         # air temperature, Celsius
    "th": (260.0, 330.0),        # potential temperature, K
    "rh%": (3.0, 99.0),          # relative humidity, percent
    "rhfrac": (0.03, 0.99),      # relative humidity, fraction
    "q": (1e-4, 1.5e-2),         # specific humidity kg/kg
    "z": (4800.0, 5900.0),       # geopotential height m (mid-troposphere)
    "z_low": (-80.0, 250.0),     # near-surface geopotential m
    "wind": (-30.0, 30.0),       # wind component m/s
    "ps": (950.0, 1045.0),       # surface pressure hPa
    "pfield": (150.0, 1000.0),   # pressure field hPa
    "mapr": (8e-6, 1.3e-5),      # map ratio / (2 grid distance)
    "fcor": (9e-5, 1.45e-4),     # coriolis parameter
    "sal": (30.0, 36.0),         # salinity PSU
    "aice": (0.0, 0.35),         # ice concentration
    "sst_c": (-1.2, 9.0),        # sea-surface temperature Celsius
    "atemp_c": (-25.0, -3.0),    # air temperature Celsius (icing regime)
    "wave": (0.6, 6.0),          # significant wave height m
    "depth": (25.0, 350.0),      # water depth m
    "precip": (0.0, 5.0),        # precipitation mm
    "snow": (0.0, 2.0),          # snowfall mm
    "mslp": (990.0, 1035.0),     # sea-level pressure hPa
    "unit": (0.0, 1.0),          # uniform [0, 1)
    "pw_s": (2.0, 25.0),         # wave period s (physical; the mslp-range
                                 # periods of the small icing cases would
                                 # drive ~1.3% of a production grid into
                                 # the 10k-iteration knife-edge band)
    "sw": (0.0, 10.0),           # snow water mm
    "montg": (2.8e5, 3.1e5),     # montgomery potential
    "small": (0.1, 9.9),         # generic small positive
    "signed": (-5.0, 5.0),       # generic signed (for OPER ops; zeros added)
}

# undef sentinel plant locations per pattern slot are built inside
# case_inputs (the corner spot depends on the case's shape); slot k
# applies to input field k (cycled) so combined-mask paths are exercised


class Case:
    def __init__(self, name: str, op: str, kinds: List[str],
                 scalars: Optional[Dict] = None, undef: bool = True,
                 fdef_in: int = 2, rtol: float = 2e-5, atol: float = 1e-5,
                 n_members: int = 0, mask_exact: bool = True,
                 shape: Optional[Tuple[int, int]] = None):
        self.name = name          # unique golden key
        self.op = op              # operator name (oracle + native adapters)
        self.kinds = kinds        # input field kinds, in operator order
        self.scalars = scalars or {}
        self.undef = undef        # plant undef sentinels?
        self.fdef_in = fdef_in    # input ValuesDefined passed to the oracle
        self.rtol = rtol
        self.atol = atol
        self.n_members = n_members  # >0: kinds[0] replicated as members
        self.mask_exact = mask_exact  # require my-mask == (ref != undef)
        self.shape = tuple(shape) if shape else (NY, NX)


def case_inputs(case: Case) -> List[np.ndarray]:
    """Deterministic inputs for a case (same in generator and test)."""
    seed = zlib.crc32(case.name.encode())
    rng = np.random.default_rng(seed)
    arrays = []
    n_fields = len(case.kinds)
    ny, nx = case.shape
    spots = [[(1, 2), (5, 0), (ny - 1, nx - 1)],
             [(3, 7), (0, 0)],
             [(8, 4)]]
    for k, kind in enumerate(case.kinds):
        lo, hi = KIND_RANGES[kind]
        if case.n_members and k == 0:
            shape = (case.n_members, ny, nx)
        else:
            shape = (ny, nx)
        a = rng.uniform(lo, hi, shape).astype(np.float32)
        if kind == "signed":
            a.flat[::17] = 0.0  # exercise divide-by-zero -> undef
        # map factors / coriolis are never undef in practice, and the
        # reference reads them without defined-checks (sentinel values
        # alias into outputs, e.g. absvort's +fcoriolis absorbs to 1e35)
        if case.undef and kind not in ("mapr", "fcor"):
            for (y, x) in spots[k % len(spots)]:
                a[..., y, x] = UNDEF
            if (ny, nx) != (NY, NX):
                # production-size grids: additionally scatter ~0.1%
                # random undefs so combined-mask paths are exercised at
                # scale (same rng stream -> generator/test agree)
                yy = rng.integers(0, ny, 600)
                xx = rng.integers(0, nx, 600)
                a[..., yy, xx] = UNDEF
        arrays.append(a)
    return arrays


def _hum_kinds(compute: int) -> List[str]:
    """plevel/hlevel/alevel humidity input kinds by compute mode
    (FieldCalculations.cc:403-415): odd modes take T(K), even take TH;
    modes 1,2,5,6,9,10 take q, modes 3,4,7,8,11,12 take RH."""
    t = "tk" if compute % 2 == 1 else "th"
    hum = "q" if compute in (1, 2, 5, 6, 9, 10) else "rh%"
    return [t, hum]


def build_cases() -> List[Case]:
    cases: List[Case] = []
    add = cases.append

    # ---- pressure-level ---------------------------------------------------
    for c in range(1, 6):
        tkind = "th" if c in (1, 2, 5) else "tk"
        add(Case(f"pleveltemp_c{c}", "pleveltemp", [tkind],
                 {"p": 500.0, "unit": "", "compute": c}))
    add(Case("pleveltemp_alldef", "pleveltemp", ["tk"],
             {"p": 850.0, "unit": "", "compute": 3}, undef=False, fdef_in=0))
    for c in (1, 2):
        add(Case(f"plevelthe_c{c}", "plevelthe",
                 ["tk" if c == 1 else "th", "rh%"],
                 {"p": 700.0, "compute": c}))
    # Td-in-Celsius modes (5-8) subtract t0 from an ~273 K float32 dewpoint:
    # the cancellation amplifies last-ulp rounding to ~1e-4 absolute
    td_c_atol = {c: 5e-4 for c in (5, 6, 7, 8)}
    for c in range(1, 13):
        add(Case(f"plevelhum_c{c}", "plevelhum", _hum_kinds(c),
                 {"p": 850.0, "unit": "", "compute": c},
                 atol=td_c_atol.get(c, 1e-5)))
    add(Case("plevelhum_unit_celsius", "plevelhum", _hum_kinds(9),
             {"p": 850.0, "unit": "celsius", "compute": 9}))
    for c in (1, 2, 3):
        add(Case(f"pleveldz2tmean_c{c}", "pleveldz2tmean", ["z", "z_low"],
                 {"p1": 500.0, "p2": 1000.0, "compute": c}))
    for c in range(1, 5):
        add(Case(f"plevelducting_c{c}", "plevelducting", _hum_kinds(c),
                 {"p": 850.0, "compute": c}))

    # ---- hybrid-level -----------------------------------------------------
    for c in range(1, 6):
        tkind = "th" if c in (1, 2, 5) else "tk"
        add(Case(f"hleveltemp_c{c}", "hleveltemp", [tkind, "ps"],
                 {"alevel": 50.0, "blevel": 0.9, "unit": "", "compute": c}))
    for c in (1, 2):
        add(Case(f"hlevelthe_c{c}", "hlevelthe",
                 ["tk" if c == 1 else "th", "q", "ps"],
                 {"alevel": 50.0, "blevel": 0.9, "compute": c}))
    for c in range(1, 13):
        add(Case(f"hlevelhum_c{c}", "hlevelhum", _hum_kinds(c) + ["ps"],
                 {"alevel": 50.0, "blevel": 0.9, "unit": "", "compute": c},
                 atol=td_c_atol.get(c, 1e-5)))
    for c in range(1, 5):
        add(Case(f"hlevelducting_c{c}", "hlevelducting",
                 _hum_kinds(c) + ["ps"],
                 {"alevel": 50.0, "blevel": 0.9, "compute": c}))
    add(Case("hlevelpressure", "hlevelpressure", ["ps"],
             {"alevel": 50.0, "blevel": 0.9}))

    # ---- model-level (pressure field) ------------------------------------
    for c in range(1, 6):
        tkind = "th" if c in (1, 2, 5) else "tk"
        add(Case(f"aleveltemp_c{c}", "aleveltemp", [tkind, "pfield"],
                 {"unit": "", "compute": c}))
    for c in (1, 2):
        add(Case(f"alevelthe_c{c}", "alevelthe",
                 ["tk" if c == 1 else "th", "q", "pfield"], {"compute": c}))
    for c in range(1, 13):
        add(Case(f"alevelhum_c{c}", "alevelhum", _hum_kinds(c) + ["pfield"],
                 {"unit": "", "compute": c}, atol=td_c_atol.get(c, 1e-5)))
    for c in range(1, 5):
        # reference never updates the flag on its undef branch (cc:1500-1504)
        add(Case(f"alevelducting_c{c}", "alevelducting",
                 _hum_kinds(c) + ["pfield"], {"compute": c},
                 mask_exact=False))

    # ---- isentropic / ocean ----------------------------------------------
    add(Case("ilevelgwind", "ilevelgwind", ["montg", "mapr", "mapr", "fcor"],
             mask_exact=False))
    for c in (1, 2):
        add(Case(f"seaSoundSpeed_c{c}", "seaSoundSpeed",
                 ["sst_c" if c == 1 else "tk", "sal"],
                 {"z": 50.0, "compute": c}, rtol=5e-5, atol=5e-3))

    # ---- stability indices ------------------------------------------------
    for c in (1, 2):
        k = "tk" if c == 1 else "th"
        add(Case(f"kIndex_c{c}", "kIndex", [k, k, "rh%", k, "rh%"],
                 {"p500": 500.0, "p700": 700.0, "p850": 850.0, "compute": c}))
        add(Case(f"ductingIndex_c{c}", "ductingIndex", [k, "rh%"],
                 {"p850": 850.0, "compute": c}))
        # showalter: moist-adjustment iterations amplify rounding; outputs
        # at undef inputs are uninitialized in the reference (cc:965-967)
        add(Case(f"showalterIndex_c{c}", "showalterIndex", [k, k, "rh%"],
                 {"p500": 500.0, "p850": 850.0, "compute": c},
                 mask_exact=False, rtol=2e-4, atol=5e-3))
        add(Case(f"boydenIndex_c{c}", "boydenIndex", [k, "z", "z_low"],
                 {"p700": 700.0, "p1000": 1000.0, "compute": c}))
    add(Case("sweatIndex", "sweatIndex",
             ["tc", "tc", "tc", "tc", "wind", "wind", "wind", "wind"]))

    # ---- elementwise ------------------------------------------------------
    add(Case("cvtemp_c1", "cvtemp", ["tk"], {"compute": 1}))
    add(Case("cvtemp_c2", "cvtemp", ["tc"], {"compute": 2}))
    add(Case("cvtemp_c3_kelvin", "cvtemp", ["tk"], {"compute": 3}))
    add(Case("cvtemp_c3_celsius", "cvtemp", ["tc"], {"compute": 3}))
    add(Case("cvtemp_c4_kelvin", "cvtemp", ["tk"], {"compute": 4}))
    add(Case("cvtemp_c4_celsius", "cvtemp", ["tc"], {"compute": 4}))
    for c in (1, 2, 3, 4):
        t = "tk" if c in (1, 3) else "tc"
        add(Case(f"cvhum_c{c}", "cvhum", [t, "rh%"],
                 {"unit": "", "compute": c}))
    add(Case("cvhum_c1_frac", "cvhum", ["tk", "rhfrac"],
             {"unit": "1", "compute": 1}))
    add(Case("abshum", "abshum", ["tk", "rhfrac"]))
    add(Case("vectorabs", "vectorabs", ["wind", "wind"]))
    for c in (1, 2):
        add(Case(f"windCooling_c{c}", "windCooling",
                 ["tk" if c == 1 else "tc", "wind", "wind"],
                 {"compute": c}, mask_exact=False))
    add(Case("underCooledRain", "underCooledRain", ["precip", "snow", "tk"],
             {"precipMin": 0.1, "snowRateMax": 0.5, "tcMax": 0.5}))
    add(Case("pressure2FlightLevel", "pressure2FlightLevel", ["pfield"]))
    add(Case("snow_in_cm", "snow_in_cm", ["sw", "tk", "tk"]))
    add(Case("values2classes", "values2classes", ["small"],
             {"values": [0.0, 2.5, 5.0, 7.5, 10.0]}))
    for c in (1, 2, 3, 4):
        add(Case(f"fieldOPERfield_c{c}", "fieldOPERfield",
                 ["signed", "signed"], {"compute": c}))
        add(Case(f"fieldOPERconstant_c{c}", "fieldOPERconstant", ["signed"],
                 {"value": 2.5, "compute": c}))
        add(Case(f"constantOPERfield_c{c}", "constantOPERfield", ["signed"],
                 {"value": 2.5, "compute": c}))
    add(Case("minvalueFields", "minvalueFields", ["signed", "signed"]))
    add(Case("maxvalueFields", "maxvalueFields", ["signed", "signed"]))
    add(Case("minvalueFieldConst", "minvalueFieldConst", ["signed"],
             {"value": 0.5}))
    add(Case("maxvalueFieldConst", "maxvalueFieldConst", ["signed"],
             {"value": -0.5}))
    add(Case("minvalueFieldConst_undef", "minvalueFieldConst", ["signed"],
             {"value": UNDEF}))
    add(Case("absvalueField", "absvalueField", ["signed"]))
    add(Case("log10Field", "log10Field", ["small"]))
    add(Case("pow10Field", "pow10Field", ["signed"]))
    add(Case("logField", "logField", ["small"]))
    add(Case("expField", "expField", ["signed"]))
    add(Case("powerField", "powerField", ["small"], {"value": 1.7}))
    add(Case("replaceUndefined", "replaceUndefined", ["signed"],
             {"value": -7.0}))
    add(Case("replaceDefined", "replaceDefined", ["signed"],
             {"value": 3.25}))
    add(Case("copy_field", "copy_field", ["signed"]))

    # ---- stencils ---------------------------------------------------------
    add(Case("plevelgwind_xcomp", "plevelgwind_xcomp",
             ["z", "mapr", "mapr", "fcor"], mask_exact=False))
    add(Case("plevelgwind_ycomp", "plevelgwind_ycomp",
             ["z", "mapr", "mapr", "fcor"], mask_exact=False))
    add(Case("plevelgvort", "plevelgvort", ["z", "mapr", "mapr", "fcor"]))
    for c in range(1, 5):
        add(Case(f"plevelqvector_c{c}", "plevelqvector",
                 ["z", "tk", "mapr", "mapr", "fcor"],
                 {"p": 500.0, "compute": c}, mask_exact=False))
    add(Case("relvort", "relvort", ["wind", "wind", "mapr", "mapr"]))
    add(Case("absvort", "absvort", ["wind", "wind", "mapr", "mapr", "fcor"]))
    add(Case("divergence", "divergence", ["wind", "wind", "mapr", "mapr"]))
    add(Case("advection", "advection",
             ["tk", "wind", "wind", "mapr", "mapr"], {"hours": 3.0}))
    for c in range(1, 5):
        add(Case(f"gradient_c{c}", "gradient", ["tk", "mapr", "mapr"],
                 {"compute": c}))
    add(Case("shapiro2_alldef", "shapiro2_filter", ["tk"], undef=False,
             fdef_in=0))
    add(Case("shapiro2_undef", "shapiro2_filter", ["tk"], mask_exact=False))
    add(Case("thermalFrontParameter", "thermalFrontParameter",
             ["tk", "mapr", "mapr"], mask_exact=False))
    add(Case("momentumXcoordinate", "momentumXcoordinate",
             ["wind", "mapr", "fcor"], {"fcoriolisMin": 1e-5}))
    add(Case("momentumYcoordinate", "momentumYcoordinate",
             ["wind", "mapr", "fcor"], {"fcoriolisMin": 1e-5}))
    add(Case("jacobian", "jacobian", ["z", "tk", "mapr", "mapr"]))

    # ---- ensemble (member stack in kinds[0]) ------------------------------
    add(Case("sumFields", "sumFields", ["unit"], n_members=5))
    add(Case("meanValue", "meanValue", ["unit"], n_members=5))
    add(Case("stddevValue", "stddevValue", ["unit"], n_members=5))
    for c in (1, 2, 3, 4):
        add(Case(f"extremeValue_c{c}", "extremeValue", ["unit"],
                 {"compute": c}, n_members=5, mask_exact=False))
    for c in range(1, 7):
        limits = [0.25, 0.75] if c in (3, 6) else [0.5]
        add(Case(f"probability_c{c}", "probability", ["unit"],
                 {"compute": c, "limits": limits}, n_members=8))

    # ---- window (require ALL_DEFINED inputs) ------------------------------
    for c in (5, 6):
        add(Case(f"neighbourProb_c{c}", "neighbourProbFunctions", ["small"],
                 {"constants": [5.0, 2.0], "compute": c}, undef=False,
                 fdef_in=0))
    for c in range(1, 7):
        constants = [2.0] if c < 4 else [5.0, 2.0]
        add(Case(f"neighbour_c{c}", "neighbourFunctions", ["small"],
                 {"constants": constants, "compute": c}, undef=False,
                 fdef_in=0))
    add(Case("neighbour_c1_step", "neighbourFunctions", ["small"],
             {"constants": [2.0, 3.0], "compute": 1}, undef=False, fdef_in=0))

    # ---- vessel icing (double intermediates in reference: loose rtol) ----
    icing6 = ["atemp_c", "sst_c", "wind", "wind", "sal", "aice"]
    add(Case("vesselIcingOverland", "vesselIcingOverland", icing6,
             rtol=1e-4, atol=1e-4, mask_exact=False))
    add(Case("vesselIcingMertins", "vesselIcingMertins", icing6,
             rtol=1e-4, atol=1e-4, mask_exact=False))
    icing11 = ["sal", "wave", "wind", "wind", "atemp_c", "rh%", "sst_c",
               "mslp", "mslp", "aice", "depth"]
    add(Case("vesselIcingModStall", "vesselIcingModStall", icing11,
             {"vs": 5.0, "alpha": 90.0, "zmin": 2.0, "zmax": 4.0},
             rtol=2e-3, atol=2e-3, mask_exact=False))
    for alt in (1, 2):
        add(Case(f"vesselIcingMincog_alt{alt}", "vesselIcingMincog", icing11,
                 {"vs": 5.0, "alpha": 90.0, "zmin": 2.0, "zmax": 4.0,
                  "alt": alt},
                 rtol=2e-3, atol=2e-3, mask_exact=False))
    return cases


def build_large_cases() -> List[Case]:
    """Production-size (719x929) goldens for 5 representative ops — one
    stencil with fillEdges, one 12-mode-family humidity, one per-point
    Exner pow conversion, one ensemble, one icing solver (VERDICT r4 item 5; the reference's own canary grid,
    test/FieldCalculationsTest.cc:145-170).  Kept out of the main CASES
    list: they live in goldens_large.npz (~11 MB) and run via
    tests/test_conformance_large.py (chip_smoke.py replays them on the
    GPU)."""
    L = (LARGE_NY, LARGE_NX)
    cases: List[Case] = []
    add = cases.append
    add(Case("large_plevelgvort", "plevelgvort",
             ["z", "mapr", "mapr", "fcor"], shape=L))
    add(Case("large_plevelhum_c9", "plevelhum", _hum_kinds(9),
             {"p": 850.0, "unit": "", "compute": 9}, shape=L))
    add(Case("large_probability_c3", "probability", ["unit"],
             {"compute": 3, "limits": [0.25, 0.75]}, n_members=8,
             shape=L))
    # per-point Exner pow at production scale: compute=3 (T -> theta)
    # divides by pidcp_from_p(pfield) lane-by-lane — validates the
    # round-5 deterministic pow + constant-edge select against the
    # compiled reference powf on the full 719x929 grid
    add(Case("large_aleveltemp_c3", "aleveltemp", ["tk", "pfield"],
             {"unit": "", "compute": 3}, shape=L))
    icing11_phys = ["sal", "wave", "wind", "wind", "atemp_c", "rh%",
                    "sst_c", "mslp", "pw_s", "aice", "depth"]
    add(Case("large_vesselIcingModStall", "vesselIcingModStall",
             icing11_phys,
             {"vs": 5.0, "alpha": 90.0, "zmin": 2.0, "zmax": 4.0},
             rtol=2e-3, atol=2e-3, mask_exact=False, shape=L))
    return cases


CASES = build_cases()
CASE_BY_NAME = {c.name: c for c in CASES}
LARGE_CASES = build_large_cases()
