"""Platform-deterministic transcendentals (mi_fieldcalc_tpu/_libm.py).

These back every conversion core and the icing solver stages; the
conformance story (the oracle goldens on every backend, replayed on the
GPU by chip_smoke.py) rests on their accuracy staying libm-class.  Bounds are
asserted against float64 references on dense random sweeps, and the
libm edges (log of 0/negative/inf, pow's non-positive bases, tanh
saturation) are pinned.
"""

import numpy as np
import jax.numpy as jnp

from mi_fieldcalc_tpu._libm import (exp_f32, log_f32, log10_f32, pow_f32,
                                    pow10_f32, tanh_f32)


def _ulp(ours, true64):
    ours64 = np.asarray(ours).astype(np.float64)
    spacing = np.spacing(np.abs(true64).astype(np.float32)).astype(
        np.float64)
    return np.abs(ours64 - true64) / np.maximum(spacing, 1e-45)


def test_exp_accuracy():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-80, 80, 100000),
                        rng.uniform(-1, 1, 100000)]).astype(np.float32)
    u = _ulp(exp_f32(x), np.exp(x.astype(np.float64)))
    assert u.max() < 1.5, u.max()


def test_log_accuracy_and_edges():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(1e-30, 1e30, 100000),
                        rng.uniform(0.3, 3.0, 100000)]).astype(np.float32)
    u = _ulp(log_f32(x), np.log(x.astype(np.float64)))
    assert u.max() < 1.5, u.max()
    edges = np.asarray(log_f32(jnp.asarray(
        [0.0, -1.0, np.inf, np.nan], jnp.float32)))
    assert edges[0] == -np.inf and np.isnan(edges[1])
    assert edges[2] == np.inf and np.isnan(edges[3])


def test_log10_accuracy():
    rng = np.random.default_rng(2)
    x = rng.uniform(1e-20, 1e20, 100000).astype(np.float32)
    u = _ulp(log10_f32(x), np.log10(x.astype(np.float64)))
    assert u.max() < 2.5, u.max()


def test_pow_accuracy_and_edges():
    rng = np.random.default_rng(3)
    # the production exponents: kappa (pidcp), 0.16 (windCooling),
    # and a generic powerField value.  The composition's envelope is
    # ~0.15 ulp per unit of |c*ln x| (_libm.pow_f32 docstring): bound
    # each sweep accordingly.
    for c, hi, bound in ((0.2857142857142857, 1e4, 8.0),
                         (0.16, 1e4, 8.0),
                         (2.5, 1e4, 40.0)):
        x = rng.uniform(1e-4, hi, 100000).astype(np.float32)
        u = _ulp(pow_f32(x, c), np.power(x.astype(np.float64), c))
        assert u.max() < bound, (c, u.max())
    # non-positive bases keep jnp.power's semantics
    got = np.asarray(pow_f32(jnp.asarray([0.0, -2.0], jnp.float32), 2.0))
    want = np.asarray(jnp.power(jnp.asarray([0.0, -2.0], jnp.float32),
                                jnp.float32(2.0)))
    np.testing.assert_array_equal(got, want)


def test_pow10_accuracy():
    rng = np.random.default_rng(4)
    x = rng.uniform(-36, 36, 100000).astype(np.float32)
    u = _ulp(pow10_f32(x), np.power(10.0, x.astype(np.float64)))
    assert u.max() < 3.0, u.max()


def test_tanh_accuracy_and_saturation():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-12, 12, 100000),
                        rng.uniform(-0.8, 0.8, 100000)]).astype(np.float32)
    u = _ulp(tanh_f32(x), np.tanh(x.astype(np.float64)))
    assert u.max() < 2.0, u.max()
    sat = np.asarray(tanh_f32(jnp.asarray([20.0, -20.0], jnp.float32)))
    np.testing.assert_array_equal(sat, [1.0, -1.0])


def test_exp_pow10_extreme_domains_match_backend():
    """Overflow saturates to inf and deep underflow to 0 exactly where
    the backend's own exp/pow do (XLA flushes subnormals, so the
    two-factor 2^k scaling must track that, not host libm's gradual
    underflow) — round-4 review fix: the single-clipped-exponent
    version returned 2^14-scale garbage in the (-103, -87) band."""
    xs = jnp.asarray([-1e30, -200.0, -103.0, -95.0, -88.0, -87.0,
                      87.0, 88.0, 89.0, 200.0, 1e30], jnp.float32)
    np.testing.assert_allclose(np.asarray(exp_f32(xs)),
                               np.asarray(jnp.exp(xs)), rtol=2e-5)
    xp = jnp.asarray([-1e30, -60.0, -44.0, -40.0, 38.0, 39.0, 50.0,
                      1e30], jnp.float32)
    np.testing.assert_allclose(
        np.asarray(pow10_f32(xp)),
        np.asarray(jnp.power(jnp.float32(10.0), xp)), rtol=1e-4)
    # log: subnormal positives fall back to the backend log
    sub = jnp.asarray([1e-39, 1e-44], jnp.float32)
    np.testing.assert_allclose(np.asarray(log_f32(sub)),
                               np.asarray(jnp.log(sub)), rtol=1e-6)


def test_pow_posc_accuracy_exner_domain():
    """Narrow-domain pow (the flagship kernel + pidcp_from_p tier):
    <= 3 ulp on the Exner pressure-ratio domain (spec: VERDICT r4 item
    4; measured ~1.2), <= 3 ulp on a wide positive sweep including the
    sentinel, and the positive-domain clamp contract for bad bases."""
    from mi_fieldcalc_tpu._libm import pow_posc_f32
    from mi_fieldcalc_tpu.constants import kappa

    rng = np.random.default_rng(7)
    for lo, hi in ((1e-5, 1.2), (1e-30, 1e35)):
        x = np.exp(rng.uniform(np.log(lo), np.log(hi), 200_000)
                   ).astype(np.float32)
        got = np.asarray(pow_posc_f32(x, float(kappa)))
        true = np.power(x.astype(np.float64), float(kappa))
        assert _ulp(got, true).max() <= 3.0
    # a second static exponent (the wind-speed 0.16-style family)
    x = np.exp(rng.uniform(np.log(0.05), np.log(90.0), 50_000)
               ).astype(np.float32)
    got = np.asarray(pow_posc_f32(x, 0.8))
    assert _ulp(got, np.power(x.astype(np.float64), 0.8)).max() <= 3.0
    # positive-domain contract: non-positive/NaN bases give FINITE
    # garbage (callers mask-gate), never inf/nan that could poison lanes
    bad = np.asarray(pow_posc_f32(
        np.array([0.0, -5.0, np.nan], np.float32), float(kappa)))
    assert np.isfinite(bad).all()


def test_pidcp_kernel_matches_surface_bitwise():
    """The fused kernel's Exner factor and the op surface's
    pidcp_from_p are the same arithmetic — bitwise, on this backend."""
    from mi_fieldcalc_tpu import constants as C
    from mi_fieldcalc_tpu._libm import pow_posc_f32

    rng = np.random.default_rng(8)
    p = rng.uniform(0.05, 1100.0, 20_000).astype(np.float32)
    surface = np.asarray(C.pidcp_from_p(p))
    kernel_expr = np.asarray(pow_posc_f32(p * C.p0inv, C.kappa))
    np.testing.assert_array_equal(surface, kernel_expr)


def test_pidcp_surface_keeps_libm_edges():
    """pidcp_from_p: DEFINED lanes with p <= 0 keep the reference powf
    edge values (0**kappa = 0 -> theta inf; negative -> NaN) via the
    backend-pow fallback select — only the positive domain runs
    pow_posc_f32 (review r5)."""
    from mi_fieldcalc_tpu import constants as C

    out = np.asarray(C.pidcp_from_p(
        np.array([0.0, -5.0, 850.0, 1e-3], np.float32)))
    assert out[0] == 0.0
    assert np.isnan(out[1])
    assert out[2] > 0 and out[3] > 0
