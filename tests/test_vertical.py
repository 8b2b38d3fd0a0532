"""Vertical interpolation (ops/vertical.py) and the isobaric pipeline."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mi_fieldcalc_tpu.field import UNDEF, Field, from_sentinel, from_values
from mi_fieldcalc_tpu.models.pipeline import derived_fields_isobaric
from mi_fieldcalc_tpu.ops import hlevel_to_plevel, plevel_interp


def _column(nlev=10, ny=4, nx=5):
    """Monotone pressure columns 100..1000 hPa, field linear in ln(p)."""
    p1d = np.linspace(100.0, 1000.0, nlev).astype(np.float32)
    p = np.broadcast_to(p1d[:, None, None], (nlev, ny, nx)).copy()
    f = (3.0 * np.log(p) + 7.0).astype(np.float32)
    return from_values(f), from_values(p)


def test_logp_linear_exact():
    f, p = _column()
    targets = [150.0, 312.5, 999.0]
    out = plevel_interp(f, p, targets, log_p=True)
    expect = 3.0 * np.log(np.asarray(targets, np.float32)) + 7.0
    got = np.asarray(out.values)
    assert np.asarray(out.mask).all()
    for i, e in enumerate(expect):
        assert np.allclose(got[i], e, rtol=2e-6), (i, got[i, 0, 0], e)


def test_linear_p_exact():
    f, p = _column()
    fv = (0.5 * np.asarray(p.values) - 20.0).astype(np.float32)
    out = plevel_interp(from_values(fv), p, [450.0], log_p=False)
    assert np.allclose(np.asarray(out.values), 0.5 * 450.0 - 20.0, rtol=1e-6)


def test_out_of_range_masked():
    f, p = _column()
    out = plevel_interp(f, p, [50.0, 500.0, 1500.0])
    m = np.asarray(out.mask)
    assert not m[0].any()      # above model top
    assert m[1].all()
    assert not m[2].any()      # below lowest level


def test_undef_bracketing_level_masks_out():
    f, p = _column()
    fv = np.asarray(f.values).copy()
    fv[4, 1, 1] = UNDEF        # level 4 undefined at one point
    fof = from_sentinel(fv)
    p1d = np.asarray(p.values)[:, 0, 0]
    # a target bracketed by levels 4 and 5 is undef exactly there
    tgt = float(0.5 * (p1d[4] + p1d[5]))
    out = plevel_interp(fof, p, [tgt])
    m = np.asarray(out.mask)[0]
    assert not m[1, 1]
    assert m.sum() == m.size - 1
    # a target away from level 4 is unaffected
    out2 = plevel_interp(fof, p, [float(0.5 * (p1d[7] + p1d[8]))])
    assert np.asarray(out2.mask).all()


def test_hlevel_to_plevel_matches_manual():
    nlev, ny, nx = 8, 6, 7
    rng = np.random.default_rng(3)
    alevel = np.linspace(50.0, 0.0, nlev).astype(np.float32)
    blevel = np.linspace(0.05, 1.0, nlev).astype(np.float32)
    ps = from_values(rng.uniform(950, 1030, (ny, nx)).astype(np.float32))
    f = from_values(rng.normal(0, 1, (nlev, ny, nx)).astype(np.float32))
    out = hlevel_to_plevel(f, ps, alevel, blevel, [850.0])
    # manual per-point log-p interpolation
    pv = alevel[:, None, None] + blevel[:, None, None] * np.asarray(ps.values)
    got = np.asarray(out.values)[0]
    fv = np.asarray(f.values)
    for y in range(ny):
        for x in range(nx):
            col = pv[:, y, x]
            k = np.searchsorted(col, 850.0) - 1
            w = (np.log(np.float32(850.0)) - np.log(col[k])) / (
                np.log(col[k + 1]) - np.log(col[k]))
            e = fv[k, y, x] + (fv[k + 1, y, x] - fv[k, y, x]) * w
            assert abs(got[y, x] - e) < 5e-5, (y, x, got[y, x], e)


def _interp_reference(fv, fm, ps, pm, alevel, blevel, targets, log_p):
    """float64 numpy statement of hlevel_to_plevel's semantics: bracket
    by the count of levels at or below the target (on the op's float32
    pressures), defined where the target lies inside the column and both
    bracketing levels and the surface pressure are defined."""
    nlev = fv.shape[0]
    p32 = (alevel[:, None, None] + blevel[:, None, None] * ps[None]
           ).astype(np.float32)
    x = np.log(np.where(p32 > 0, p32, 1).astype(np.float64)) if log_p \
        else p32.astype(np.float64)
    outs, masks = [], []
    for t in targets:
        cnt = (p32 <= np.float32(t)).sum(axis=0)
        k = np.clip(cnt - 1, 0, nlev - 2)[None]
        x0 = np.take_along_axis(x, k, 0)[0]
        x1 = np.take_along_axis(x, k + 1, 0)[0]
        f0 = np.take_along_axis(fv.astype(np.float64), k, 0)[0]
        f1 = np.take_along_axis(fv.astype(np.float64), k + 1, 0)[0]
        xt = np.log(t) if log_p else t
        w = (xt - x0) / np.where(x1 != x0, x1 - x0, 1)
        outs.append(f0 + (f1 - f0) * w)
        masks.append((cnt >= 1) & (cnt <= nlev - 1)
                     & np.take_along_axis(fm, k, 0)[0]
                     & np.take_along_axis(fm, k + 1, 0)[0] & pm
                     & (x1 != x0))
    return np.stack(outs), np.stack(masks)


@pytest.mark.parametrize("undef_frac", [0.0, 0.15, 0.5])
@pytest.mark.parametrize("log_p", [True, False])
def test_interp_matches_numpy_reference(log_p, undef_frac):
    """hlevel_to_plevel against a float64 numpy statement of the same
    semantics, with undefs in the fields and in ps (masks bitwise,
    values to f32 round-off)."""
    nlev, ny, nx = 13, 21, 37
    rng = np.random.default_rng(5)
    alevel = np.sort(rng.uniform(0, 300, nlev)).astype(np.float32)
    blevel = np.sort(rng.uniform(0, 1, nlev)).astype(np.float32)
    psv = rng.uniform(900, 1050, (ny, nx)).astype(np.float32)
    psv[2, 3] = UNDEF
    ps = from_sentinel(psv)
    targets = (1000.0, 925.0, 850.0, 500.0, 100.0, 50.0)
    for s in range(2):
        fv = rng.normal(280, 10, (nlev, ny, nx)).astype(np.float32)
        fv[rng.random((nlev, ny, nx)) < undef_frac] = UNDEF
        f = from_sentinel(fv)
        got = hlevel_to_plevel(f, ps, alevel, blevel, targets, log_p=log_p)
        rv, rm = _interp_reference(
            np.asarray(f.values), np.asarray(f.mask),
            np.asarray(ps.values), np.asarray(ps.mask), alevel, blevel,
            targets, log_p)
        gm = np.asarray(got.mask)
        assert np.array_equal(rm, gm), f"var {s}: mask mismatch"
        assert rm.any()
        assert np.allclose(np.asarray(got.values)[rm], rv[rm], rtol=2e-5,
                           atol=1e-4), f"var {s}: values"


def test_fused_interp_single_var_tall_stack():
    """A 137-level column stack (the global model's depth) against the
    float64 ground truth."""
    nlev, ny, nx = 137, 9, 150
    rng = np.random.default_rng(9)
    alevel = np.linspace(50.0, 0.0, nlev).astype(np.float32)
    blevel = np.linspace(0.05, 1.0, nlev).astype(np.float32)
    ps = from_values(rng.uniform(950, 1030, (ny, nx)).astype(np.float32))
    f = from_values(rng.normal(0, 1, (nlev, ny, nx)).astype(np.float32))
    targets = (850.0, 500.0, 70.0)
    ref = hlevel_to_plevel(f, ps, alevel, blevel, targets)
    rm = np.asarray(ref.mask)
    # At 137 levels the ln(p) brackets are ~0.008 wide, so one ulp of the
    # f32 log (~4.8e-7 at ln 850) moves the interpolation weight by ~1e-4;
    # both paths carry that error vs float64 truth, in different
    # directions.  Assert each against the float64 ground truth.
    pv64 = (alevel.astype(np.float64)[:, None, None]
            + blevel.astype(np.float64)[:, None, None]
            * np.asarray(ps.values, np.float64))
    fv64 = np.asarray(f.values, np.float64)
    for t, tgt in enumerate(targets):
        cnt = (pv64 <= tgt).sum(axis=0)
        k = np.clip(cnt - 1, 0, nlev - 2)
        p0 = np.take_along_axis(pv64, k[None], 0)[0]
        p1 = np.take_along_axis(pv64, k[None] + 1, 0)[0]
        w = (np.log(tgt) - np.log(p0)) / (np.log(p1) - np.log(p0))
        f0 = np.take_along_axis(fv64, k[None], 0)[0]
        f1 = np.take_along_axis(fv64, k[None] + 1, 0)[0]
        truth = f0 + (f1 - f0) * w
        if not rm[t].any():     # 70 hPa sits above the model top
            continue
        err = np.abs(np.asarray(ref.values)[t] - truth)[rm[t]]
        assert err.max() < 1e-3, (t, err.max())


def test_isobaric_pipeline_runs_and_masks():
    nlev, ny, nx = 12, 16, 20
    rng = np.random.default_rng(7)
    tk = rng.normal(275, 10, (nlev, ny, nx)).astype(np.float32)
    q = rng.uniform(1e-4, 1e-2, (nlev, ny, nx)).astype(np.float32)
    u = rng.normal(0, 10, (nlev, ny, nx)).astype(np.float32)
    v = rng.normal(0, 10, (nlev, ny, nx)).astype(np.float32)
    ps = rng.uniform(980, 1030, (ny, nx)).astype(np.float32)
    alevel = np.linspace(30.0, 0.0, nlev).astype(np.float32)
    blevel = np.linspace(0.02, 1.0, nlev).astype(np.float32)
    xm = np.full((ny, nx), 4e-7, np.float32)
    ym = np.full((ny, nx), 4e-7, np.float32)
    fc = np.full((ny, nx), 1.2e-4, np.float32)
    args = (from_sentinel(tk), from_sentinel(q), from_sentinel(u),
            from_sentinel(v), from_sentinel(ps), jnp.asarray(alevel),
            jnp.asarray(blevel), jnp.asarray(xm), jnp.asarray(ym),
            jnp.asarray(fc))
    plevels = (850.0, 700.0, 500.0)
    out = jax.jit(lambda *a: derived_fields_isobaric(*a, plevels=plevels))(
        *args)
    assert out.th.values.shape == (3, ny, nx)
    # 850/700/500 hPa are inside every column (ps >= 980, top ~ 30-50 hPa)
    assert np.asarray(out.th.mask).all()
    assert np.isfinite(np.asarray(out.th.values)).all()
    # interpolated theta at 500 hPa should exceed theta at 850 (stable atm
    # not guaranteed with random T, so just check ranges are sane)
    assert np.asarray(out.rh.values)[np.asarray(out.rh.mask)].max() < 1e4


def _isobaric_args(nlev=6, ny=24, nx=40, seed=11):
    rng = np.random.default_rng(seed)
    tk = rng.normal(275, 10, (nlev, ny, nx)).astype(np.float32)
    q = rng.uniform(1e-4, 1e-2, (nlev, ny, nx)).astype(np.float32)
    u = rng.normal(0, 10, (nlev, ny, nx)).astype(np.float32)
    v = rng.normal(0, 10, (nlev, ny, nx)).astype(np.float32)
    ps = rng.uniform(980, 1030, (ny, nx)).astype(np.float32)
    tk[2, 5, 5] = UNDEF
    ps[3, 3] = UNDEF
    return (from_sentinel(tk), from_sentinel(q), from_sentinel(u),
            from_sentinel(v), from_sentinel(ps),
            jnp.linspace(30.0, 0.0, nlev).astype(jnp.float32),
            jnp.linspace(0.02, 1.0, nlev).astype(jnp.float32),
            jnp.full((ny, nx), 4e-7, jnp.float32),
            jnp.full((ny, nx), 4e-7, jnp.float32),
            jnp.full((ny, nx), 1.2e-4, jnp.float32))


def test_isobaric_fused_matches_jnp():
    """The isobaric tail is the hybrid pipeline on constant-pressure
    surfaces: ``alevel = plevels, blevel = 0`` with a defined ps gives
    the same 12 fields (the form the pipeline kernel accepts)."""
    from mi_fieldcalc_tpu.models import derived_fields

    args = _isobaric_args()
    plv = (850.0, 700.0)
    ref = jax.jit(lambda *a: derived_fields_isobaric(*a, plevels=plv))(*args)
    tki, qi, ui, vi = (hlevel_to_plevel(f, args[4], args[5], args[6], plv)
                       for f in args[:4])
    ny, nx = args[0].values.shape[-2:]
    ps0 = Field(jnp.zeros((ny, nx), jnp.float32), jnp.ones((ny, nx), bool))
    got = jax.jit(derived_fields)(tki, qi, ui, vi, ps0,
                                  jnp.asarray(plv, jnp.float32),
                                  jnp.zeros(2, jnp.float32), *args[7:])
    for name in ref._fields:
        rm = np.asarray(getattr(ref, name).mask)
        gm = np.asarray(getattr(got, name).mask)
        rv = np.asarray(getattr(ref, name).values)
        gv = np.asarray(getattr(got, name).values)
        assert np.array_equal(rm, gm), f"{name}: mask mismatch"
        with np.errstate(all="ignore"):
            # atol floor: cancellation in the advection sum leaves ~1e-7
            # absolute noise on near-zero results under reassociation
            assert np.allclose(rv[rm], gv[rm], rtol=2e-5, atol=5e-6), \
                f"{name}: values"


def test_isobaric_fused_stacked_matches():
    """Targets may come in any order: permuting ``plevels`` permutes the
    output levels and nothing else."""
    args = _isobaric_args(seed=13)
    plv = (850.0, 500.0, 700.0)
    ref = jax.jit(lambda *a: derived_fields_isobaric(*a, plevels=plv))(*args)
    perm = (2, 0, 1)
    got = jax.jit(lambda *a: derived_fields_isobaric(
        *a, plevels=tuple(plv[i] for i in perm)))(*args)
    for name in ref._fields:
        ra, ga = getattr(ref, name), getattr(got, name)
        rm = np.asarray(ra.mask)[list(perm)]
        assert np.array_equal(rm, np.asarray(ga.mask)), name
        with np.errstate(all="ignore"):
            assert np.allclose(np.asarray(ra.values)[list(perm)][rm],
                               np.asarray(ga.values)[rm], rtol=2e-5,
                               atol=5e-6), name


def test_interp_above_top_gate():
    """Fully defined inputs: a target above the model top is undefined
    everywhere, targets inside every column are defined everywhere."""
    rng = np.random.default_rng(17)
    nlev, ny, nx = 9, 16, 140
    f = from_values(rng.normal(270, 20, (nlev, ny, nx)).astype(np.float32))
    ps = from_values(rng.uniform(960, 1030, (ny, nx)).astype(np.float32))
    al = jnp.asarray(np.linspace(50, 300, nlev), jnp.float32)
    bl = jnp.asarray(np.linspace(0.0, 0.7, nlev) ** 1.5, jnp.float32)
    tg = (850.0, 700.0, 500.0, 10.0)   # 10 hPa is above the top
    got = hlevel_to_plevel(f, ps, al, bl, tg)
    m = np.asarray(got.mask)
    assert m[:3].all() and not m[3].any()
