"""The pipelines as XLA compiles them for the card (``gpu`` marker).

These run only where JAX's default device is a GPU — chip_smoke.py runs
them there in its own process; elsewhere the ``gpu`` fixture skips them.
The same comparisons run on the CPU in tests/test_pipeline_stacked.py
and tests/test_fused_suite.py.
"""

import jax
import numpy as np
import pytest

from mi_fieldcalc_tpu.models import derived_fields, derived_fields_stacked

from test_pipeline_stacked import _assert_matches, _inputs, _with_gates

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("nlev,ny,nx", [(3, 37, 61), (2, 130, 257),
                                        (1, 3, 3)])
@pytest.mark.parametrize("undefs", [True, False])
def test_stacked_layout_on_card(gpu, nlev, ny, nx, undefs):
    """The served layout (9 or 2 mask planes) against the per-field
    program, both compiled for the card."""
    args = jax.device_put(_inputs(nlev, ny, nx, seed=ny + nx,
                                  undefs=undefs), gpu)
    if not undefs:
        args = _with_gates(args) if ny > 10 else args
    ref = jax.jit(derived_fields)(*args)
    got = jax.jit(derived_fields_stacked, static_argnames="all_defined")(
        *args, all_defined=not undefs)
    _assert_matches(got.as_fields(), ref)


@pytest.mark.parametrize("temps,hq,hr", [
    ((3, 4), (1, 5, 9), (3, 7, 11)),
    ((1, 2, 5), (), ()),
])
def test_suite_on_card(gpu, temps, hq, hr):
    """The jitted level-conversion suite against per-op programs on the
    card, to CONFORMANCE.md's one-program contract."""
    from mi_fieldcalc_tpu.ops import alevelhum, aleveltemp
    from mi_fieldcalc_tpu.ops.fused_suite import alevel_suite_fused
    from test_fused_suite import CELSIUS, _assert_contract
    from test_fused_suite import _inputs as suite_inputs

    tk, q, rh, p = jax.device_put(suite_inputs(seed=len(temps)), gpu)
    got = alevel_suite_fused(tk, q, rh, p, temps=temps, hums_q=hq,
                             hums_rh=hr)
    modes = [("temp", c) for c in temps] + [("hum", c) for c in hq + hr]
    for k, (fam, c) in enumerate(modes):
        if fam == "temp":
            r = jax.jit(lambda t, p, c=c: aleveltemp(t, p, compute=c))(tk, p)
        else:
            h = q if k < len(temps) + len(hq) else rh
            r = jax.jit(lambda t, h, p, c=c: alevelhum(
                t, h, p, compute=c))(tk, h, p)
        rm = np.asarray(r.mask)
        assert np.array_equal(rm, np.asarray(got[k].mask)), (fam, c)
        _assert_contract(np.asarray(got[k].values)[rm],
                         np.asarray(r.values)[rm], (fam, c),
                         celsius=(fam, c) in CELSIUS)
