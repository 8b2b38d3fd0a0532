"""Host staging pipeline (mi_fieldcalc_tpu/staging.py).

End-to-end: numpy sentinel stacks -> native batch codec -> device Fields
-> pipeline -> sentinel numpy, compared against the plain Field-API
path.  chip_smoke.py runs the same comparisons on the card at the
operational size.
"""

import numpy as np
import jax
import pytest
import jax.numpy as jnp

from mi_fieldcalc_tpu import from_sentinel
from mi_fieldcalc_tpu.field import UNDEF
from mi_fieldcalc_tpu.models import derived_fields
from mi_fieldcalc_tpu.staging import HostStager, run_derived_fields_np


def _inputs(nlev=3, ny=24, nx=40, seed=0):
    rng = np.random.default_rng(seed)
    tk = rng.normal(275.0, 15.0, (nlev, ny, nx)).astype(np.float32)
    q = rng.uniform(1e-4, 1e-2, (nlev, ny, nx)).astype(np.float32)
    u = rng.normal(0.0, 12.0, (nlev, ny, nx)).astype(np.float32)
    v = rng.normal(0.0, 12.0, (nlev, ny, nx)).astype(np.float32)
    ps = rng.normal(1000.0, 15.0, (ny, nx)).astype(np.float32)
    tk[:, ny // 3, nx // 3] = UNDEF
    q[1, 2, 3] = np.nan
    alevel = np.linspace(0.0, 50.0, nlev).astype(np.float32)
    blevel = np.linspace(1.0, 0.5, nlev).astype(np.float32)
    xmapr = np.full((ny, nx), 4.0e-7, np.float32)
    ymapr = np.full((ny, nx), 3.6e-7, np.float32)
    fcor = np.full((ny, nx), 1.2e-4, np.float32)
    return tk, q, u, v, ps, alevel, blevel, xmapr, ymapr, fcor


def test_host_stager_matches_from_sentinel():
    tk, q, u, v, *_ = _inputs()
    stager = HostStager(k=4, pad=False)
    fields = stager.stage(tk, q, u, v)
    for arr, f in zip((tk, q, u, v), fields):
        ref = from_sentinel(arr)
        np.testing.assert_array_equal(np.asarray(f.mask),
                                      np.asarray(ref.mask))
        m = np.asarray(ref.mask)
        np.testing.assert_array_equal(np.asarray(f.values)[m],
                                      np.asarray(ref.values)[m])
    assert stager.counts[0] == int(np.asarray(fields[0].mask).sum())


def test_host_stager_padded_layout():
    tk, q, u, v, *_ = _inputs(ny=21, nx=70)
    stager = HostStager(k=4)
    fields = stager.stage(tk, q, u, v)
    assert fields[0].values.shape == (3, 24, 128)
    m = np.asarray(fields[0].mask)
    assert not m[..., 21:, :].any() and not m[..., :, 70:].any()
    np.testing.assert_array_equal(
        m[..., :21, :70], np.asarray(from_sentinel(tk).mask))


def test_run_derived_fields_np_matches_field_api():
    args = _inputs(seed=3)
    got = run_derived_fields_np(*args)

    fa = [from_sentinel(a) for a in args[:5]]
    rest = [jnp.asarray(a) for a in args[5:]]
    ref = jax.jit(derived_fields)(*fa, *rest)
    assert set(got) == set(ref._fields)
    for name in ref._fields:
        rf = getattr(ref, name)
        rm = np.asarray(rf.mask)
        g = got[name]
        assert g.shape == rm.shape
        np.testing.assert_array_equal(g == np.float32(UNDEF), ~rm)
        np.testing.assert_allclose(g[rm], np.asarray(rf.values)[rm],
                                   rtol=2e-5, atol=1e-6)


def test_stream_matches_single_steps():
    """The streaming executor yields, in order, exactly what
    run_derived_fields_np produces per step."""
    from mi_fieldcalc_tpu.staging import stream_derived_fields_np

    steps = [_inputs(seed=s) for s in (1, 2, 3)]
    got = list(stream_derived_fields_np(iter(steps)))
    assert len(got) == 3
    for args, out in zip(steps, got):
        ref = run_derived_fields_np(*args)
        assert set(out) == set(ref)
        for name in ref:
            np.testing.assert_array_equal(out[name], ref[name])


def test_stream_empty_and_single():
    from mi_fieldcalc_tpu.staging import stream_derived_fields_np

    assert list(stream_derived_fields_np(iter(()))) == []
    one = list(stream_derived_fields_np(iter([_inputs(seed=9)])))
    assert len(one) == 1 and "tfp" in one[0]


def test_stage_step_all_defined_gate():
    """The decode counts route fully defined steps to the 2-plane mask
    layout (and only those)."""
    from mi_fieldcalc_tpu.staging import HostStager, _stage_step

    args = list(_inputs())          # has undefs in tk and q
    stager = HostStager(k=4, pad=False)
    _, _, all_defined = _stage_step(tuple(args), stager, UNDEF)
    assert not all_defined

    clean = list(_inputs(seed=9))
    clean[0] = np.abs(clean[0])     # fresh arrays, no sentinels planted
    for a in clean[:5]:
        a[np.isnan(a)] = 1.0
        a[a == np.float32(UNDEF)] = 1.0
    _, _, all_defined = _stage_step(tuple(clean), stager, UNDEF)
    assert all_defined

    dirty_ps = [a.copy() if isinstance(a, np.ndarray) else a
                for a in clean]
    dirty_ps[4][0, 0] = UNDEF       # a single undef in ps flips the gate
    _, _, all_defined = _stage_step(tuple(dirty_ps), stager, UNDEF)
    assert not all_defined


@pytest.mark.parametrize("tag", ["9", "2"])
def test_encode_step_mask_map_layouts(tag):
    """_encode_step consumes every stacked mask layout (12 planes from
    the per-field pipeline, the 9 deduplicated planes and the 2-plane
    all_defined gates) and produces identical sentinel output dicts."""
    from mi_fieldcalc_tpu.models import derived_fields_stacked
    from mi_fieldcalc_tpu.staging import _encode_step

    nlev, ny, nx = 2, 21, 140
    clean = list(_inputs(nlev, ny, nx, seed=4))
    for a in clean[:5]:
        a[np.isnan(a)] = 1.0
        a[a == np.float32(UNDEF)] = 1.0
    args = ([from_sentinel(a) for a in clean[:5]]
            + [jnp.asarray(a) for a in clean[5:]])

    ref = jax.jit(derived_fields)(*args)
    outs = {"12": _encode_step(
        np.stack([np.asarray(f.values) for f in ref]),
        np.stack([np.asarray(f.mask) for f in ref]), ny, nx, UNDEF)}
    o = jax.jit(derived_fields_stacked, static_argnames="all_defined")(
        *args, all_defined=tag == "2")
    assert o.masks.shape[0] == int(tag)
    outs[tag] = _encode_step(np.asarray(o.values), np.asarray(o.masks),
                             ny, nx, UNDEF)
    assert outs[tag].keys() == outs["12"].keys()
    for name in outs["12"]:
        r, g = outs["12"][name], outs[tag][name]
        rm = r != np.float32(UNDEF)
        np.testing.assert_array_equal(rm, g != np.float32(UNDEF),
                                      err_msg=f"{tag}/{name}")
        np.testing.assert_allclose(g[rm], r[rm], rtol=2e-5,
                                   err_msg=f"{tag}/{name}")


def test_run_hlevel_suite_np():
    """Sentinel-numpy suite runner: per-level hlevel* agreement,
    sentinel propagation, and unused-input pruning (q/rh may be None)."""
    from mi_fieldcalc_tpu.ops import hlevelhum, hleveltemp
    from mi_fieldcalc_tpu.staging import run_hlevel_suite_np

    rng = np.random.default_rng(0)
    nlev, ny, nx = 2, 12, 20
    tk = rng.uniform(250, 300, (nlev, ny, nx)).astype(np.float32)
    q = rng.uniform(1e-4, 1e-2, (nlev, ny, nx)).astype(np.float32)
    tk[0, 3, 3] = UNDEF
    ps = rng.uniform(950, 1030, (ny, nx)).astype(np.float32)
    al = np.linspace(30.0, 0.0, nlev).astype(np.float32)
    bl = np.linspace(0.02, 1.0, nlev).astype(np.float32)

    out = run_hlevel_suite_np(tk, q, None, ps, al, bl,
                              temps=(3,), hums_q=(1, 9))
    assert sorted(out) == ["hum_q1", "hum_q9", "temp3"]
    assert out["temp3"].shape == (nlev, ny, nx)
    assert out["temp3"][0, 3, 3] == np.float32(UNDEF)

    for name, fn, c, h in (("temp3", hleveltemp, 3, None),
                           ("hum_q1", hlevelhum, 1, q)):
        for k in range(nlev):
            args = [from_sentinel(tk[k])]
            if h is not None:
                args.append(from_sentinel(h[k]))
            ref = fn(*args, from_sentinel(ps), float(al[k]),
                     float(bl[k]), compute=c)
            m = np.asarray(ref.mask)
            got = out[name][k]
            assert np.array_equal(got == np.float32(UNDEF), ~m)
            with np.errstate(all="ignore"):
                assert np.allclose(np.asarray(ref.values)[m], got[m],
                                   rtol=3e-6)


def test_run_vessel_icing_np():
    """Batch icing boundary: one decode of the 11 shared inputs, all
    requested products, sentinel propagation, product validation."""
    import pytest
    from mi_fieldcalc_tpu.ops import (vessel_icing_mertins,
                                      vessel_icing_overland)
    from mi_fieldcalc_tpu.staging import run_vessel_icing_np

    rng = np.random.default_rng(2)
    ny, nx = 16, 24
    f = lambda lo, hi: rng.uniform(lo, hi, (ny, nx)).astype(np.float32)
    sal, wave = f(30, 36), f(0.5, 6)
    xw, yw = f(-25, 25), f(-25, 25)
    at, rh = f(-25, -3), f(40, 95)
    sst, p = f(-1, 8), f(960, 1040)
    pw, aice, depth = f(6, 14), f(0, 0.3), f(25, 350)
    at[2, 2] = UNDEF
    scal = (5.0, 0.52, 2.0, 5.0)

    out = run_vessel_icing_np(sal, wave, xw, yw, at, rh, sst, p, pw,
                              aice, depth, *scal, alt=1)
    assert sorted(out) == ["mertins", "mincog", "modstall", "overland"]
    for prod, arr in out.items():
        assert arr.shape == (ny, nx)
        assert arr[2, 2] == np.float32(UNDEF), prod

    for prod, op in (("overland", vessel_icing_overland),
                     ("mertins", vessel_icing_mertins)):
        ref = op(*[from_sentinel(a)
                   for a in (at, sst, xw, yw, sal, aice)])
        m = np.asarray(ref.mask)
        assert np.array_equal(out[prod] == np.float32(UNDEF), ~m), prod
        with np.errstate(all="ignore"):
            assert np.allclose(np.asarray(ref.values)[m],
                               out[prod][m], rtol=1e-6), prod

    sub = run_vessel_icing_np(sal, wave, xw, yw, at, rh, sst, p, pw,
                              aice, depth, *scal,
                              products=("overland",))
    assert sorted(sub) == ["overland"]
    np.testing.assert_array_equal(sub["overland"], out["overland"])

    with pytest.raises(ValueError):
        run_vessel_icing_np(sal, wave, xw, yw, at, rh, sst, p, pw,
                            aice, depth, *scal, products=("nope",))


@pytest.mark.parametrize("undefs", [True, False])
def test_staging_layouts_match_per_field_pipeline(undefs):
    """run_derived_fields_np (9 mask planes with undefs, 2 when the
    decode counts prove every input defined) gives the sentinel outputs
    of the per-field pipeline on the same staged arrays: the stacked
    layouts, the all_defined gate and the codec's mask maps compose end
    to end."""
    from mi_fieldcalc_tpu.staging import _encode_step, _stage_step

    args = list(_inputs(2, 21, 70, seed=6))
    if not undefs:
        for a in args[:5]:
            a[~np.isfinite(a) | (a == np.float32(UNDEF))] = 1.0
    staged, (ny, nx), all_defined = _stage_step(
        tuple(args), HostStager(k=4, pad=False), UNDEF)
    assert all_defined == (not undefs)
    out = jax.jit(derived_fields)(*staged)
    ref = _encode_step(np.stack([np.asarray(f.values) for f in out]),
                       np.stack([np.asarray(f.mask) for f in out]),
                       ny, nx, UNDEF)
    got = run_derived_fields_np(*args)
    assert got.keys() == ref.keys()
    for name in ref:
        rm = ref[name] != np.float32(UNDEF)
        np.testing.assert_array_equal(rm, got[name] != np.float32(UNDEF),
                                      err_msg=name)
        np.testing.assert_allclose(got[name][rm], ref[name][rm], rtol=2e-5,
                                   err_msg=name)


def test_run_derived_fields_np_levpack_param():
    """The LEV-bit-packed staging option is gone with the mask ABI it
    fed: passing it raises instead of being ignored."""
    args = _inputs(seed=8)
    with pytest.raises(TypeError):
        run_derived_fields_np(*args, levpack=True)


def test_run_hlevel_suite_np_align():
    """align=True: the suite runs on the tile-aligned logical grid
    re-gridded at ingest — equals manually pre-resampling every input
    (the suite is pointwise: no map rescale involved)."""
    from mi_fieldcalc_tpu.ingest import aligned_target, resample_align
    from mi_fieldcalc_tpu.staging import run_hlevel_suite_np

    rng = np.random.default_rng(4)
    nlev, ny, nx = 2, 13, 21
    tk = rng.uniform(250, 300, (nlev, ny, nx)).astype(np.float32)
    q = rng.uniform(1e-4, 1e-2, (nlev, ny, nx)).astype(np.float32)
    tk[0, 3:6, 3:6] = UNDEF
    ps = rng.uniform(950, 1030, (ny, nx)).astype(np.float32)
    al = np.linspace(30.0, 0.0, nlev).astype(np.float32)
    bl = np.linspace(0.02, 1.0, nlev).astype(np.float32)
    tgt = aligned_target(ny, nx)

    got = run_hlevel_suite_np(tk, q, None, ps, al, bl,
                              temps=(3,), hums_q=(1,), align=True)
    for arr in got.values():
        assert arr.shape == (nlev,) + tgt

    # manual pre-resample through the SAME implementation the staging
    # path uses (native fused pass when available) -> bitwise equality
    # holds on any toolchain; native-vs-numpy tolerance lives in
    # tests/test_native.py
    from mi_fieldcalc_tpu import native

    def nat_sent(a):
        v_, m_, _ = native.decode_resample_batch(
            [np.ascontiguousarray(a, np.float32)], *tgt, UNDEF)
        return np.where(m_[0], v_[0], np.float32(UNDEF))

    man = run_hlevel_suite_np(nat_sent(tk), nat_sent(q),
                              None, nat_sent(ps), al, bl,
                              temps=(3,), hums_q=(1,), align=False)
    assert sorted(got) == sorted(man)
    for name in got:
        np.testing.assert_array_equal(got[name], man[name])


def test_run_vessel_icing_np_align():
    """align=True: the icing products run on the tile-aligned logical
    grid re-gridded at ingest — equals manually pre-resampling every
    input (pointwise suite, no map rescale), same contract as the
    hlevel align test above."""
    from mi_fieldcalc_tpu import native
    from mi_fieldcalc_tpu.ingest import aligned_target
    from mi_fieldcalc_tpu.staging import run_vessel_icing_np

    rng = np.random.default_rng(7)
    ny, nx = 13, 21
    f = lambda lo, hi: rng.uniform(lo, hi, (ny, nx)).astype(np.float32)
    sal, wave = f(30, 36), f(0.5, 6)
    xw, yw = f(-25, 25), f(-25, 25)
    at, rh = f(-25, -3), f(40, 95)
    sst, p = f(-1, 8), f(960, 1040)
    pw, aice, depth = f(6, 14), f(0, 0.3), f(25, 350)
    at[2, 2] = UNDEF
    scal = (5.0, 0.52, 2.0, 5.0)
    tgt = aligned_target(ny, nx)
    ins = (sal, wave, xw, yw, at, rh, sst, p, pw, aice, depth)

    got = run_vessel_icing_np(*ins, *scal, alt=1,
                              products=("overland", "modstall"),
                              align=True)
    for arr in got.values():
        assert arr.shape == tgt

    def nat_sent(a):
        v_, m_, _ = native.decode_resample_batch(
            [np.ascontiguousarray(a, np.float32)], *tgt, UNDEF)
        return np.where(m_[0], v_[0], np.float32(UNDEF))

    man = run_vessel_icing_np(*[nat_sent(a) for a in ins], *scal,
                              alt=1, products=("overland", "modstall"),
                              align=False)
    assert sorted(got) == sorted(man)
    for name in got:
        np.testing.assert_array_equal(got[name], man[name])
