"""Sharded-vs-unsharded equivalence of the derived-field pipelines.

Runs the jnp pipelines per shard through ``run_sharded`` on the
8-device CPU mesh and compares against the single-device programs:
masks bit-for-bit, values to f32 round-off.  This validates the halo
exchange, the physical-edge fills (none at shard seams), the crop of
the halo ring, and the stacked output layouts the staging layer serves.
"""

import functools

import jax
import numpy as np
import pytest

from mi_fieldcalc_tpu.models.pipeline import (RADIUS, derived_fields,
                                              derived_fields_stacked)
from mi_fieldcalc_tpu.parallel import grid_mesh, run_sharded

from test_pipeline_stacked import _inputs, _with_gates


def _sharded(mesh, op=derived_fields, **kw):
    return jax.jit(lambda *a: run_sharded(op, mesh, RADIUS, *a, **kw))


def _pad_defined(args, ny_p, nx_p):
    """Pad grids to ``(ny_p, nx_p)`` with defined edge copies (so a fully
    defined input stays fully defined)."""
    from mi_fieldcalc_tpu.field import Field

    def pad(a):
        w = [(0, 0)] * (a.ndim - 2) + [(0, ny_p - a.shape[-2]),
                                       (0, nx_p - a.shape[-1])]
        return jax.numpy.pad(a, w, mode="edge")
    return tuple(Field(pad(a.values), pad(a.mask)) if hasattr(a, "mask")
                 else (pad(a) if a.ndim >= 2 else a) for a in args)


@pytest.mark.parametrize("undefs", [True, False])
@pytest.mark.parametrize("mesh_shape,nlev,ny,nx", [
    ((1, 2, 2), 2, 48, 64),
    ((2, 2, 1), 4, 40, 137),    # lev-sharded + y-split, ragged nx
    ((1, 4, 1), 2, 64, 96),     # deep y-split
    ((1, 1, 4), 2, 32, 128),    # x-split only
])
def test_sharded_fused_matches_unsharded(mesh_shape, nlev, ny, nx, undefs):
    ndev = int(np.prod(mesh_shape))
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    mesh = grid_mesh(mesh_shape, devices=jax.devices()[:ndev])
    args = _inputs(nlev, ny, nx, seed=ny + nx, undefs=undefs)

    ref = jax.jit(derived_fields)(*args)
    got = _sharded(mesh)(*args)

    for name in ref._fields:
        rv = np.asarray(getattr(ref, name).values)
        rm = np.asarray(getattr(ref, name).mask)
        gv = np.asarray(getattr(got, name).values)
        gm = np.asarray(getattr(got, name).mask)
        assert np.array_equal(rm, gm), f"{name}: mask mismatch"
        w = rm
        with np.errstate(all="ignore"):
            assert np.allclose(rv[w], gv[w], rtol=2e-5, atol=1e-30), \
                f"{name}: value mismatch"


@pytest.mark.parametrize("mesh_shape,nlev,ny,nx", [
    ((1, 2, 2), 10, 48, 64),
    ((1, 4, 1), 8, 64, 96),
    ((1, 1, 4), 8, 32, 128),
])
@pytest.mark.parametrize("plv", [(925.0, 850.0, 700.0, 500.0, 300.0),
                                 (1000.0, 600.0, 50.0)])
def test_sharded_isobaric_matches_unsharded(mesh_shape, nlev, ny, nx, plv):
    """Per-shard column interpolation + the derived fields with halo
    exchange (run_sharded) equal the unsharded isobaric pipeline (masks
    bit-for-bit), for targets inside and outside the columns."""
    import numpy as _np

    from mi_fieldcalc_tpu.models.pipeline import derived_fields_isobaric
    from mi_fieldcalc_tpu.parallel.fused import (
        derived_fields_isobaric_sharded)

    ndev = int(np.prod(mesh_shape))
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    mesh = grid_mesh(mesh_shape, devices=jax.devices()[:ndev])
    args = list(_inputs(nlev, ny, nx, seed=7 * ny + nx, undefs=True))
    # monotone-increasing hybrid columns (model top first, surface last)
    import jax.numpy as jnp
    args[5] = jnp.asarray(_np.linspace(50, 300, nlev), jnp.float32)
    args[6] = jnp.asarray(_np.linspace(0.0, 0.7, nlev) ** 1.5, jnp.float32)

    ref = jax.jit(functools.partial(derived_fields_isobaric,
                                    plevels=plv))(*args)
    got = derived_fields_isobaric_sharded(mesh, *args, plevels=plv)
    for name in ref._fields:
        rv = np.asarray(getattr(ref, name).values)
        rm = np.asarray(getattr(ref, name).mask)
        gv = np.asarray(getattr(got, name).values)
        gm = np.asarray(getattr(got, name).mask)
        assert np.array_equal(rm, gm), f"{name}: mask mismatch"
        with np.errstate(all="ignore"):
            assert np.allclose(rv[rm], gv[rm], rtol=2e-5, atol=1e-30), \
                f"{name}: value mismatch"


def test_sharded_isobaric_rejects_lev_mesh():
    from mi_fieldcalc_tpu.parallel.fused import (
        derived_fields_isobaric_sharded)

    if len(jax.devices()) < 2:
        pytest.skip("not enough devices")
    mesh = grid_mesh((2, 1, 1), devices=jax.devices()[:2])
    args = _inputs(4, 16, 32)
    with pytest.raises(ValueError, match="lev == 1"):
        derived_fields_isobaric_sharded(mesh, *args, plevels=(900.0,))


@pytest.mark.parametrize("undefs", [True, False])
@pytest.mark.parametrize("mesh_shape,nlev,ny,nx", [
    ((1, 2, 1), 2, 45, 130),    # pads to (48, 256): dead rows + lanes
    ((2, 2, 1), 2, 41, 96),     # lev-sharded, pads to (48, 128)
    ((1, 2, 2), 2, 45, 140),
])
def test_sharded_padded_layout_matches(mesh_shape, nlev, ny, nx, undefs):
    """Shard-aligned padded layout (layout.padded_shape_sharded): the
    sharded pipeline on the padded grid equals the one-device pipeline
    on the same padded grid, dead rows and lanes included."""
    from mi_fieldcalc_tpu.layout import (pad_array, pad_field,
                                         padded_shape_sharded)

    ndev = int(np.prod(mesh_shape))
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    mesh = grid_mesh(mesh_shape, devices=jax.devices()[:ndev])
    args = _inputs(nlev, ny, nx, seed=5 * ny + nx, undefs=undefs)
    ny_p, nx_p = padded_shape_sharded(ny, nx, mesh_shape[1], mesh_shape[2])
    assert (ny_p, nx_p) != (ny, nx)
    pargs = tuple(
        pad_field(a, ny_p, nx_p) if hasattr(a, "mask") else
        (pad_array(a, ny_p, nx_p) if a.ndim == 2 else a)
        for a in args)
    ref = jax.jit(derived_fields)(*pargs)
    got = _sharded(mesh)(*pargs)
    for name in ref._fields:
        ra, ga = getattr(ref, name), getattr(got, name)
        rm = np.asarray(ra.mask)
        assert not rm[..., ny + 1:, :].any(), name   # dead rows stay dead
        assert np.array_equal(rm, np.asarray(ga.mask)), name
        rv, gv = np.asarray(ra.values), np.asarray(ga.values)
        with np.errstate(all="ignore"):
            assert np.allclose(rv[rm], gv[rm], rtol=2e-5, atol=1e-30), name


def test_sharded_isobaric_padded_layout_matches():
    """Undefined surface-pressure points and undefined model levels near
    shard seams: the sharded isobaric pipeline masks them exactly as the
    unsharded one."""
    from mi_fieldcalc_tpu.field import Field
    from mi_fieldcalc_tpu.models.pipeline import derived_fields_isobaric
    from mi_fieldcalc_tpu.parallel.fused import (
        derived_fields_isobaric_sharded)
    import jax.numpy as jnp

    mesh_shape, nlev, ny, nx = (1, 4, 1), 8, 64, 96
    ndev = int(np.prod(mesh_shape))
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    mesh = grid_mesh(mesh_shape, devices=jax.devices()[:ndev])
    args = list(_inputs(nlev, ny, nx, seed=13, undefs=True))
    args[5] = jnp.asarray(np.linspace(50, 300, nlev), jnp.float32)
    args[6] = jnp.asarray(np.linspace(0.0, 0.7, nlev) ** 1.5, jnp.float32)
    psm = np.asarray(args[4].mask).copy()
    psm[15:18, 40:44] = False               # straddles the first seam
    args[4] = Field(args[4].values, jnp.asarray(psm))
    plv = (925.0, 850.0, 700.0, 500.0)
    ref = jax.jit(functools.partial(derived_fields_isobaric,
                                    plevels=plv))(*args)
    got = derived_fields_isobaric_sharded(mesh, *args, plevels=plv)
    for name in ref._fields:
        ra, ga = getattr(ref, name), getattr(got, name)
        rm = np.asarray(ra.mask)
        assert np.array_equal(rm, np.asarray(ga.mask)), name
        rv, gv = np.asarray(ra.values), np.asarray(ga.values)
        with np.errstate(all="ignore"):
            assert np.allclose(rv[rm], gv[rm], rtol=2e-5, atol=5e-6), name


@pytest.mark.parametrize("mesh_shape", [(1, 2, 2), (1, 4, 1)])
def test_sharded_ensemble_matches_unsharded(mesh_shape):
    """Sharded ensemble pipeline (member pipelines per shard + summary):
    mean/spread/probabilities equal the unsharded jnp path, including
    the probability denominator's whole-field member flags — member 2
    below is defined ONLY inside shard (0, 0)'s subdomain, so a
    per-shard `any` would give other shards a different denominator."""
    import jax.numpy as jnp
    from mi_fieldcalc_tpu.field import Field
    from mi_fieldcalc_tpu.models.ensemble import ensemble_derived_summary
    from mi_fieldcalc_tpu.parallel.fused import ensemble_summary_sharded

    ndev = int(np.prod(mesh_shape))
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    mesh = grid_mesh(mesh_shape, devices=jax.devices()[:ndev])
    nmem, nlev, ny, nx = 3, 2, 32, 64

    members = [_inputs(nlev, ny, nx, seed=100 + m, undefs=True)
               for m in range(nmem)]

    def stack(i):
        vals = jnp.stack([np.asarray(mm[i].values) for mm in members])
        msks = jnp.stack([np.asarray(mm[i].mask) for mm in members])
        if i == 0:   # tk: member 2 defined only in the top-left corner
            m2 = np.zeros((nlev, ny, nx), bool)
            m2[:, :4, :4] = np.asarray(members[2][0].mask)[:, :4, :4]
            msks = msks.at[2].set(jnp.asarray(m2))
        return Field(vals, msks)

    tk, q, u, v, ps = (stack(i) for i in range(5))
    al, bl, xm, ym, fc = members[0][5:]
    xm2 = jnp.broadcast_to(xm, (ny, nx))
    ym2 = jnp.broadcast_to(ym, (ny, nx))
    fc2 = jnp.broadcast_to(fc, (ny, nx))

    # SHARDING correctness: reference is the same program on a 1-device
    # mesh — spread is a cancellation-amplifying statistic, so it is
    # compared program-to-program
    mesh1 = grid_mesh((1, 1, 1), devices=jax.devices()[:1])
    ref = ensemble_summary_sharded(mesh1, tk, q, u, v, ps, al, bl,
                                   xm2, ym2, fc2)
    got = ensemble_summary_sharded(mesh, tk, q, u, v, ps, al, bl,
                                   xm2, ym2, fc2)
    # and a SYSTEMATIC-error cross-check against the jnp path: tight on
    # means/probabilities, amplification-aware on spread
    jref = jax.jit(lambda *a: ensemble_derived_summary(*a))(
        tk, q, u, v, ps, al, bl, xm2, ym2, fc2)

    def cmp(r, g, name, rtol=2e-5, atol=1e-5):
        rm, gm = np.asarray(r.mask), np.asarray(g.mask)
        assert np.array_equal(rm, gm), f"{name}: mask"
        rv, gv = np.asarray(r.values), np.asarray(g.values)
        with np.errstate(all="ignore"):
            assert np.allclose(rv[rm], gv[rm], rtol=rtol, atol=atol), \
                f"{name}: values"

    for fam in ("mean", "spread"):
        for fname in ref.mean._fields:
            cmp(getattr(getattr(ref, fam), fname),
                getattr(getattr(got, fam), fname), f"{fam}.{fname}")
    cmp(ref.prob_wind, got.prob_wind, "prob_wind")
    cmp(ref.prob_t_freeze, got.prob_t_freeze, "prob_t_freeze")
    for fname in jref.mean._fields:
        cmp(getattr(jref.mean, fname), getattr(got.mean, fname),
            f"jnp-x-check mean.{fname}")
        cmp(getattr(jref.spread, fname), getattr(got.spread, fname),
            f"jnp-x-check spread.{fname}", rtol=1e-2, atol=0.3)
    cmp(jref.prob_wind, got.prob_wind, "jnp-x-check prob_wind")
    cmp(jref.prob_t_freeze, got.prob_t_freeze, "jnp-x-check prob_tf")


@pytest.mark.parametrize("undefs", [True, False])
def test_sharded_stacked_matches_per_field(undefs):
    """The stacked layout sharded (9 mask planes, or 2 on fully defined
    inputs) carries the same values and masks as the per-field result;
    the accessors recover each Field bitwise."""
    mesh_shape, nlev, ny, nx = (1, 2, 2), 2, 32, 64
    ndev = int(np.prod(mesh_shape))
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    mesh = grid_mesh(mesh_shape, devices=jax.devices()[:ndev])
    args = _inputs(nlev, ny, nx, seed=17, undefs=undefs)

    ref = _sharded(mesh)(*args)
    got = _sharded(mesh, derived_fields_stacked,
                   all_defined=not undefs)(*args)
    assert got.values.shape == (12, nlev, ny, nx)
    assert got.masks.shape[0] == (9 if undefs else 2)
    for i, name in enumerate(ref._fields):
        ra, ga = getattr(ref, name), got.field(i)
        rm = np.asarray(ra.mask)
        assert np.array_equal(rm, np.asarray(ga.mask)), name
        assert np.array_equal(np.asarray(ra.values)[rm],
                              np.asarray(ga.values)[rm]), name


@pytest.mark.parametrize("gates", [True, False])
@pytest.mark.parametrize("mesh_shape,nlev,ny,nx", [
    ((1, 2, 2), 2, 48, 64),
    ((1, 4, 1), 2, 64, 96),
    ((1, 1, 4), 2, 32, 128),
])
def test_sharded_all_defined_matches(mesh_shape, nlev, ny, nx, gates):
    """The sharded 2-plane layout on fully defined inputs equals the
    one-device pipeline, with the data-dependent gates firing near the
    shard seams or not at all."""
    ndev = int(np.prod(mesh_shape))
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    mesh = grid_mesh(mesh_shape, devices=jax.devices()[:ndev])
    args = _inputs(nlev, ny, nx, seed=5 * ny + nx, undefs=False)
    if gates:
        args = _with_gates(args)

    ref = jax.jit(derived_fields)(*args)
    st = _sharded(mesh, derived_fields_stacked, all_defined=True)(*args)
    assert st.masks.shape[0] == 2
    for i, name in enumerate(ref._fields):
        ra, ga = getattr(ref, name), st.field(i)
        rm = np.asarray(ra.mask)
        assert np.array_equal(rm, np.asarray(ga.mask)), name
        with np.errstate(all="ignore"):
            assert np.allclose(np.asarray(ra.values)[rm],
                               np.asarray(ga.values)[rm], rtol=2e-5,
                               atol=1e-30), name
    assert np.asarray(ref.rh.mask).all() != gates


@pytest.mark.parametrize("plv", [(925.0, 850.0, 500.0), (1000.0, 50.0)])
def test_sharded_isobaric_defined_inputs_matches(plv):
    """Fully defined inputs: the interpolated masks still gate targets
    below the surface or above the model top, identically on every
    shard and on one device."""
    import jax.numpy as jnp
    import numpy as _np
    from mi_fieldcalc_tpu.models.pipeline import derived_fields_isobaric
    from mi_fieldcalc_tpu.parallel.fused import (
        derived_fields_isobaric_sharded)

    mesh_shape, nlev, ny, nx = (1, 2, 2), 8, 48, 64
    ndev = int(np.prod(mesh_shape))
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    mesh = grid_mesh(mesh_shape, devices=jax.devices()[:ndev])
    args = list(_inputs(nlev, ny, nx, seed=13, undefs=False))
    args[5] = jnp.asarray(_np.linspace(50, 300, nlev), jnp.float32)
    args[6] = jnp.asarray(_np.linspace(0.0, 0.7, nlev) ** 1.5, jnp.float32)

    ref = jax.jit(functools.partial(derived_fields_isobaric,
                                    plevels=plv))(*args)
    got = derived_fields_isobaric_sharded(mesh, *args, plevels=plv)
    for name in ref._fields:
        ra, ga = getattr(ref, name), getattr(got, name)
        rm = np.asarray(ra.mask)
        assert np.array_equal(rm, np.asarray(ga.mask)), name
        with np.errstate(all="ignore"):
            assert np.allclose(np.asarray(ra.values)[rm],
                               np.asarray(ga.values)[rm], rtol=2e-5,
                               atol=5e-6), name


@pytest.mark.parametrize("mesh_shape", [(1, 2, 2), (1, 4, 1)])
def test_sharded_padded_all_defined_matches(mesh_shape):
    """Sharded + padded + 2-plane layout, together: grids padded with
    defined edge copies stay fully defined, and the sharded result
    equals the one-device one on the whole padded grid."""
    from mi_fieldcalc_tpu.layout import padded_shape_sharded

    nlev, ny, nx = 2, 43, 117
    ndev = int(np.prod(mesh_shape))
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    mesh = grid_mesh(mesh_shape, devices=jax.devices()[:ndev])
    args = _inputs(nlev, ny, nx, seed=11 * ny, undefs=False)
    ny_p, nx_p = padded_shape_sharded(ny, nx, mesh_shape[1], mesh_shape[2])
    assert (ny_p, nx_p) != (ny, nx)
    pargs = _pad_defined(args, ny_p, nx_p)
    ref = jax.jit(derived_fields)(*pargs)
    got = _sharded(mesh, derived_fields_stacked, all_defined=True)(*pargs)
    for i, name in enumerate(ref._fields):
        ra, ga = getattr(ref, name), got.field(i)
        rm = np.asarray(ra.mask)
        assert np.array_equal(rm, np.asarray(ga.mask)), name
        with np.errstate(all="ignore"):
            assert np.allclose(np.asarray(ra.values)[rm],
                               np.asarray(ga.values)[rm], rtol=2e-5,
                               atol=1e-30), name
