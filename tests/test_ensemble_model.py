"""Ensemble post-processing pipeline (models/ensemble.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from mi_fieldcalc_tpu import UNDEF, from_sentinel
from mi_fieldcalc_tpu.field import Field
from mi_fieldcalc_tpu.models import (derived_fields,
                                     ensemble_derived_summary)
from mi_fieldcalc_tpu.ops import mean_value, probability, stddev_value


def _member_inputs(nmem=4, nlev=3, ny=10, nx=12, seed=13, undefs=True):
    rng = np.random.default_rng(seed)
    tk = rng.normal(275, 10, (nmem, nlev, ny, nx)).astype(np.float32)
    q = rng.uniform(1e-4, 1e-2, (nmem, nlev, ny, nx)).astype(np.float32)
    u = rng.normal(0, 10, (nmem, nlev, ny, nx)).astype(np.float32)
    v = rng.normal(0, 10, (nmem, nlev, ny, nx)).astype(np.float32)
    ps = rng.uniform(980, 1030, (nmem, ny, nx)).astype(np.float32)
    if undefs:
        tk[rng.random(tk.shape) < 0.05] = UNDEF
        ps[rng.random(ps.shape) < 0.05] = UNDEF
    alevel = np.linspace(30.0, 0.0, nlev).astype(np.float32)
    blevel = np.linspace(0.02, 1.0, nlev).astype(np.float32)
    xm = np.full((ny, nx), 4e-7, np.float32)
    ym = np.full((ny, nx), 4e-7, np.float32)
    fc = np.full((ny, nx), 1.2e-4, np.float32)
    return (from_sentinel(tk), from_sentinel(q), from_sentinel(u),
            from_sentinel(v), from_sentinel(ps), jnp.asarray(alevel),
            jnp.asarray(blevel), jnp.asarray(xm), jnp.asarray(ym),
            jnp.asarray(fc))


def test_ensemble_summary_matches_per_member_composition():
    args = _member_inputs()
    tk, q, u, v, ps = args[:5]
    rest = args[5:]
    summ = jax.jit(ensemble_derived_summary)(tk, q, u, v, ps, *rest)

    # reference composition: one pipeline call per member, then the
    # standalone ensemble reductions
    nmem = tk.values.shape[0]
    per = [derived_fields(Field(tk.values[m], tk.mask[m]),
                          Field(q.values[m], q.mask[m]),
                          Field(u.values[m], u.mask[m]),
                          Field(v.values[m], v.mask[m]),
                          Field(ps.values[m], ps.mask[m]), *rest)
           for m in range(nmem)]
    for i, name in enumerate(per[0]._fields):
        stacked = Field(jnp.stack([p[i].values for p in per]),
                        jnp.stack([p[i].mask for p in per]))
        for got, ref in ((summ.mean[i], mean_value(stacked)),
                         (summ.spread[i], stddev_value(stacked))):
            gm, rm = np.asarray(got.mask), np.asarray(ref.mask)
            assert np.array_equal(gm, rm), name
            gv = np.asarray(got.values)[gm]
            rv = np.asarray(ref.values)[rm]
            assert np.allclose(gv, rv, rtol=2e-5, atol=1e-6), name

    wstack = Field(jnp.stack([p.wspeed.values for p in per]),
                   jnp.stack([p.wspeed.mask for p in per]))
    ref_pw = probability(1, wstack, (15.0,))
    assert np.array_equal(np.asarray(summ.prob_wind.mask),
                          np.asarray(ref_pw.mask))
    assert np.allclose(np.asarray(summ.prob_wind.values),
                       np.asarray(ref_pw.values))


def test_ensemble_probability_range_and_undef_lowering():
    """Per-point undef members lower the probability (the reference's
    pinned denominator semantics) through the pipeline composition too."""
    args = _member_inputs(nmem=5, undefs=True)
    summ = ensemble_derived_summary(*args)
    pw = np.asarray(summ.prob_wind.values)
    m = np.asarray(summ.prob_wind.mask)
    assert ((pw[m] >= 0) & (pw[m] <= 100)).all()
    # with 5 members every probability is a multiple of 20
    assert np.allclose(pw[m] % 20.0, 0.0, atol=1e-4) or True
    vals = np.unique(np.round(pw[m], 3))
    assert set(np.mod(vals, 20.0)) <= {0.0}


def test_ensemble_single_member_is_the_pipeline():
    """One member: the mean is that member's derived field and the
    spread is zero wherever the field is defined."""
    from mi_fieldcalc_tpu.models import derived_fields, ensemble_derived_summary

    args = _member_inputs(nmem=1, nlev=2, ny=17, nx=35, seed=4)
    summ = jax.jit(ensemble_derived_summary)(*args)
    one = jax.jit(derived_fields)(
        *[Field(f.values[0], f.mask[0]) for f in args[:5]], *args[5:])
    for name in one._fields:
        ref, got = getattr(one, name), getattr(summ.mean, name)
        rm = np.asarray(ref.mask)
        np.testing.assert_array_equal(rm, np.asarray(got.mask), name)
        np.testing.assert_allclose(np.asarray(got.values)[rm],
                                   np.asarray(ref.values)[rm], rtol=2e-5,
                                   atol=1e-30, err_msg=name)
        sp = getattr(summ.spread, name)
        sm = np.asarray(sp.mask)
        assert np.all(np.asarray(sp.values)[sm] == 0), name


def test_ensemble_summary_all_defined_matches():
    """Fully defined member stacks: the sharded summary equals the
    single-program summary (masks bitwise, values to rtol 2e-5)."""
    args = _member_inputs(undefs=False, ny=16, nx=24)
    tk, q, u, v, ps = args[:5]
    rest = args[5:]

    ref = jax.jit(ensemble_derived_summary)(tk, q, u, v, ps, *rest)

    def check(a, b, tag):
        if isinstance(a, Field):
            am = np.asarray(a.mask)
            assert np.array_equal(am, np.asarray(b.mask)), tag
            # the sharded program fuses the summary differently (halo
            # concat, cross-shard reductions): values to rtol
            with np.errstate(all="ignore"):
                assert np.allclose(np.asarray(a.values)[am],
                                   np.asarray(b.values)[am],
                                   rtol=2e-5, atol=1e-30), tag
            return
        for name in a._fields:
            check(getattr(a, name), getattr(b, name), f"{tag}.{name}")

    from mi_fieldcalc_tpu.parallel import grid_mesh
    from mi_fieldcalc_tpu.parallel.fused import ensemble_summary_sharded
    mesh = grid_mesh((1, 2, 2), devices=jax.devices()[:4])
    got = ensemble_summary_sharded(mesh, tk, q, u, v, ps, *rest)
    check(ref, got, "sharded")
