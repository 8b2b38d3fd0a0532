"""The pipeline's stacked output layout (models.derived_fields_stacked).

The staging layer serves :func:`derived_fields_stacked`: 12 value planes
and either the 9 deduplicated mask planes or, when every input is
defined, the 2 data-dependent gate planes.  Each layout must give back
exactly the 12 Fields of :func:`derived_fields`, and the identities the
layouts rely on (duplicate masks, masks that are constant once every
input is defined) must hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mi_fieldcalc_tpu.field import UNDEF, Field, from_sentinel
from mi_fieldcalc_tpu.models.pipeline import (DerivedFieldsStacked,
                                              derived_fields,
                                              derived_fields_stacked)


def _inputs(nlev, ny, nx, seed=0, undefs=True):
    rng = np.random.default_rng(seed)
    tk = rng.normal(275, 15, (nlev, ny, nx)).astype(np.float32)
    q = rng.uniform(1e-4, 1e-2, (nlev, ny, nx)).astype(np.float32)
    u = rng.normal(0, 12, (nlev, ny, nx)).astype(np.float32)
    v = rng.normal(0, 12, (nlev, ny, nx)).astype(np.float32)
    ps = rng.normal(1000, 15, (ny, nx)).astype(np.float32)
    if undefs:
        # scattered undefs incl. corners, edges, and extreme temps
        for arr in (tk, q, u, v):
            idx = rng.integers(0, arr.size, arr.size // 37)
            arr.reshape(-1)[idx] = UNDEF
        tk[0, 0, 0] = UNDEF
        tk[-1, -1, -1] = UNDEF
        tk[0, 1, 1] = 500.0        # beyond the e_sat table -> undef RH/Td
        ps[ny // 2, nx // 2] = UNDEF
    alevel = np.linspace(0, 50, nlev).astype(np.float32)
    blevel = np.linspace(1, 0.5, nlev).astype(np.float32)
    xm = rng.uniform(3e-7, 5e-7, (ny, nx)).astype(np.float32)
    ym = rng.uniform(3e-7, 5e-7, (ny, nx)).astype(np.float32)
    fc = np.full((ny, nx), 1.2e-4, np.float32)
    return (from_sentinel(tk), from_sentinel(q), from_sentinel(u),
            from_sentinel(v), from_sentinel(ps), jnp.asarray(alevel),
            jnp.asarray(blevel), jnp.asarray(xm), jnp.asarray(ym),
            jnp.asarray(fc))


def _assert_matches(got, ref, rtol=2e-5):
    """Masks bit for bit; values to ``rtol`` on defined points."""
    for name in ref._fields:
        rv = np.asarray(getattr(ref, name).values)
        rm = np.asarray(getattr(ref, name).mask)
        gv = np.asarray(getattr(got, name).values)
        gm = np.asarray(getattr(got, name).mask)
        assert np.array_equal(rm, gm), f"{name}: mask mismatch"
        with np.errstate(all="ignore"):
            assert np.allclose(rv[rm], gv[rm], rtol=rtol, atol=1e-30,
                               equal_nan=True), f"{name}: value mismatch"


def _with_gates(args):
    """Fully defined inputs where both data-dependent gates still fire:
    an out-of-table temperature (rh/td) and a |grad T| == 0 plateau
    (tfp)."""
    tk = args[0]
    v = np.asarray(tk.values).copy()
    v[0, 2, 2] = 500.0
    v[-1, 5:10, 5:10] = 300.0
    return (Field(jnp.asarray(v), tk.mask),) + tuple(args[1:])


_stacked = jax.jit(derived_fields_stacked, static_argnames="all_defined")


@pytest.mark.parametrize("nlev,ny,nx", [
    (3, 37, 61),     # ragged everything
    (2, 33, 135),
    (1, 9, 9),       # small grid
    (1, 17, 140),
    (2, 64, 256),
])
@pytest.mark.parametrize("undefs", [True, False])
def test_stacked_matches_per_field(nlev, ny, nx, undefs):
    """Both layouts recover the 12 Fields: 9 planes with undefs, 2 gate
    planes on fully defined inputs."""
    args = _inputs(nlev, ny, nx, seed=ny + nx, undefs=undefs)
    ref = jax.jit(derived_fields)(*args)
    got = _stacked(*args, all_defined=not undefs)
    assert got.values.shape == (12, nlev, ny, nx)
    assert got.masks.shape == (9 if undefs else 2, nlev, ny, nx)
    assert got.field(0).mask.dtype == np.bool_
    _assert_matches(got.as_fields(), ref)
    for i, name in enumerate(ref._fields):
        assert np.array_equal(np.asarray(getattr(got, name).mask),
                              np.asarray(got.field(i).mask)), name


@pytest.mark.parametrize("nlev,ny,nx", [(3, 37, 61), (2, 33, 135)])
def test_stacked_all_defined_gates(nlev, ny, nx):
    """The 2-plane layout keeps the gates that stay data-dependent with
    every input defined, and they fire."""
    args = _with_gates(_inputs(nlev, ny, nx, seed=7 * ny + nx,
                               undefs=False))
    ref = jax.jit(derived_fields)(*args)
    got = _stacked(*args, all_defined=True)
    _assert_matches(got.as_fields(), ref)
    assert not np.asarray(ref.rh.mask)[0, 2, 2]
    assert not np.asarray(ref.tfp.mask)[-1, 7, 7]
    assert np.array_equal(np.asarray(got.masks[0]),
                          np.asarray(ref.rh.mask))
    assert np.array_equal(np.asarray(got.masks[1]),
                          np.asarray(ref.tfp.mask))


@pytest.mark.parametrize("nlev,ny,nx", [(2, 21, 45), (1, 9, 9),
                                        (3, 40, 137)])
def test_all_defined_masks_constant(nlev, ny, nx):
    """The identity the 2-plane layout rests on: with every input
    defined, every output outside ``MASK2``'s planes is defined
    everywhere (fillEdges defines the edges)."""
    args = _with_gates(_inputs(nlev, ny, nx, seed=nx, undefs=False))
    out = jax.jit(derived_fields)(*args)
    for i, name in enumerate(out._fields):
        if DerivedFieldsStacked.MASK2[i] < 0:
            assert np.asarray(out[i].mask).all(), name


@pytest.mark.parametrize("nlev,ny,nx,seed", [(2, 21, 45, 1),
                                             (3, 37, 61, 2),
                                             (1, 9, 9, 3)])
def test_mask9_duplicates_hold(nlev, ny, nx, seed):
    """The identity the 9-plane layout rests on: the fields sharing a
    plane in ``MASK9`` have identical masks for any undef pattern."""
    out = jax.jit(derived_fields)(*_inputs(nlev, ny, nx, seed=seed))
    planes = {}
    for i, name in enumerate(out._fields):
        j = DerivedFieldsStacked.MASK9[i]
        m = np.asarray(out[i].mask)
        if j in planes:
            assert np.array_equal(planes[j], m), name
        planes[j] = m
    assert len(planes) == 9


@pytest.mark.parametrize("maps", ["scalar", "per_level"])
def test_stacked_map_factor_forms(maps):
    """Map factors as scalars or per-level stacks, as the pipeline
    accepts them."""
    nlev, ny, nx = 2, 15, 22
    args = list(_inputs(nlev, ny, nx, seed=31, undefs=True))
    if maps == "scalar":
        args[7], args[8] = jnp.float32(4e-7), jnp.float32(3e-7)
    else:
        args[7] = jnp.stack([args[7], 1.5 * args[7]])
        args[8] = jnp.stack([args[8], 0.5 * args[8]])
    ref = jax.jit(derived_fields)(*args)
    got = _stacked(*args)
    _assert_matches(got.as_fields(), ref)


@pytest.mark.parametrize("nplanes", [12, 9, 2])
def test_mask_plane_member_axis(nplanes):
    """``mask_plane`` reads every layout along the plane axis, also from
    member-batched ``[nmem, planes, ...]`` stacks (axis=1)."""
    rng = np.random.default_rng(nplanes)
    nmem, nlev, ny, nx = 3, 2, 5, 7
    masks = rng.random((nmem, nplanes, nlev, ny, nx)) < 0.5
    values = np.zeros((nlev, ny, nx), np.float32)
    for i in range(12):
        got = DerivedFieldsStacked.mask_plane(jnp.asarray(masks), i, values,
                                              axis=1)
        j = {12: i, 9: DerivedFieldsStacked.MASK9[i],
             2: DerivedFieldsStacked.MASK2[i]}[nplanes]
        want = (np.ones((nlev, ny, nx), bool) if j < 0
                else masks[:, j])
        assert np.array_equal(np.broadcast_to(np.asarray(got), want.shape),
                              want), i
        one = DerivedFieldsStacked.mask_plane(jnp.asarray(masks[0]), i,
                                              values)
        assert np.array_equal(np.asarray(one),
                              want if j < 0 else masks[0, j]), i
