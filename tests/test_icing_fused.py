"""The vessel-icing solvers through the entry points users call.

``staging.run_vessel_icing_np`` (one decode of the 11 shared inputs,
one jitted program per product) and the drop-in ``api`` must agree with
the jnp solvers of ops/icing.py: masks bit-for-bit, values to the
solver tolerance (rtol 2e-4, atol 1e-5: a jitted program and an eager
call fuse the solver's iterations differently).  The solvers' own
agreement with the oracle is pinned by tests/test_conformance*.py and
tests/test_icing_solver.py.
"""

import numpy as np
import pytest

from mi_fieldcalc_tpu.field import UNDEF, from_sentinel
from mi_fieldcalc_tpu.ops import icing
from mi_fieldcalc_tpu.staging import run_vessel_icing_np

NAMES = ("sal", "wave", "x_wind", "y_wind", "airtemp", "rh", "sst", "p",
         "pw", "aice", "depth")


def _inputs(ny, nx, seed=0, undefs=True, adversarial=False):
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        x = rng.uniform(lo, hi, (ny, nx)).astype(np.float32)
        if undefs:
            idx = rng.integers(0, x.size, max(1, x.size // 23))
            x.reshape(-1)[idx] = UNDEF
        return from_sentinel(x)

    sal = f(0.0, 35.0)
    wave = f(0.0 if adversarial else 0.1, 8.0)   # includes skip lanes
    xw = f(-25.0, 25.0)
    yw = f(-25.0, 25.0)
    at = f(-25.0, 2.0)
    rh = f(0.3, 1.0)
    sst = f(-1.0, 8.0)
    p = f(960.0, 1040.0)
    # adversarial: long periods + shallow depths drive the wave fixed
    # point near |slope|=1 (cap/projection paths)
    pw = f(6.0, 14.0) if adversarial else f(2.0, 12.0)
    aice = f(0.0, 0.5)                           # includes gated lanes
    depth = f(2.0, 40.0) if adversarial else f(5.0, 500.0)
    return (sal, wave, xw, yw, at, rh, sst, p, pw, aice, depth)


def _np(fields):
    return [np.asarray(f.to_sentinel(UNDEF)) for f in fields]


def _staged(fields):
    """The Fields staging builds from the sentinel arrays (the codec
    fills undefined points with 0, as the solvers see them there)."""
    from mi_fieldcalc_tpu import native
    from mi_fieldcalc_tpu.field import Field
    out = []
    for a in _np(fields):
        v, m, _ = native.decode_pad(a, *a.shape, UNDEF)
        out.append(Field(v, m))
    return out


def _check(got, ref, rtol=2e-4, atol=1e-5):
    mr = np.asarray(ref.mask)
    gm = got != np.float32(UNDEF)
    np.testing.assert_array_equal(mr, gm)
    np.testing.assert_allclose(got[mr], np.asarray(ref.values)[mr],
                               rtol=rtol, atol=atol, equal_nan=True)


@pytest.mark.parametrize("ny,nx", [
    (37, 61),     # ragged
    (9, 131),     # few rows
    (64, 256),    # tile-aligned
])
@pytest.mark.parametrize("alt", [1, 2])
def test_icing_np_mincog_matches_op(ny, nx, alt):
    args = _inputs(ny, nx, seed=ny + nx + alt)
    scal = (5.0, 0.52, 2.0, 11.0, alt)
    ref = icing.vessel_icing_mincog(*args, *scal)
    got = run_vessel_icing_np(*_np(args), *scal[:4], alt=alt,
                              products=("mincog",))
    _check(got["mincog"], ref)


def test_icing_np_adversarial_wave_lanes():
    args = _inputs(48, 160, seed=7, adversarial=True)
    scal = (0.0, 0.0, 1.0, 4.0, 2)   # vs=0: vr=c, exercises tper/skip
    # undefined wave lanes take the skip branch on their fill value, so
    # the reference sees the staged values
    args_s = _staged(args)
    ref = icing.vessel_icing_mincog(*args_s, *scal)
    got = run_vessel_icing_np(*_np(args), *scal[:4], alt=2,
                              products=("mincog", "modstall"))
    _check(got["mincog"], ref)
    _check(got["modstall"], icing.vessel_icing_modstall(*args_s, *scal[:4]))


@pytest.mark.parametrize("ny,nx", [(37, 61), (64, 256)])
@pytest.mark.parametrize("adversarial", [False, True])
def test_icing_np_modstall_matches_op(ny, nx, adversarial):
    """The ModStall product through staging holds the jnp solver's
    values (the documented 2e-3 icing tolerance needs no knobs)."""
    args = _inputs(ny, nx, seed=3 * ny + nx, adversarial=adversarial)
    scal = (5.0, 0.52, 2.0, 11.0)
    ref = icing.vessel_icing_modstall(*args, *scal)
    got = run_vessel_icing_np(*_np(args), *scal, products=("modstall",))
    _check(got["modstall"], ref)


def test_api_modstall_matches_op():
    """The drop-in ``vesselIcingModStall`` runs the jnp solver."""
    import mi_fieldcalc_tpu.api as fc

    args = _inputs(40, 140, seed=21)
    scal = (5.0, 0.52, 2.0, 11.0)
    ref = icing.vessel_icing_modstall(*args, *scal)
    _check(np.asarray(fc.vesselIcingModStall(*_np(args), *scal)), ref)


def test_icing_sharded_matches_unsharded():
    """Icing ops are pointwise (radius 0): run_sharded on the CPU mesh
    must reproduce the unsharded result bit-for-bit."""
    from mi_fieldcalc_tpu.parallel import grid_mesh, run_sharded

    args = _inputs(48, 256, seed=11)
    scal = (5.0, 0.52, 2.0, 11.0, 2)
    mesh = grid_mesh((1, 4, 2))
    ref = icing.vessel_icing_mincog(*args, *scal)

    got = run_sharded(lambda *f: icing.vessel_icing_mincog(*f, *scal),
                      mesh, 0, *args)
    np.testing.assert_array_equal(np.asarray(ref.mask),
                                  np.asarray(got.mask))
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(np.asarray(ref.values)[m],
                                  np.asarray(got.values)[m])


def test_icing_np_products_and_validation():
    """Overland/Mertins come from the same single decode; an unknown
    product raises."""
    args = _inputs(32, 140, seed=3)
    sent = _np(args)
    got = run_vessel_icing_np(*sent, 5.0, 0.52, 2.0, 11.0,
                              products=("overland", "mertins"))
    sal, _, xw, yw, at, _, sst, _, _, aice, _ = args
    _check(got["overland"],
           icing.vessel_icing_overland(at, sst, xw, yw, sal, aice))
    _check(got["mertins"],
           icing.vessel_icing_mertins(at, sst, xw, yw, sal, aice))
    with pytest.raises(ValueError):
        run_vessel_icing_np(*sent, 5.0, 0.52, 2.0, 11.0,
                            products=("nope",))
