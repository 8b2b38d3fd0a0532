"""Horizontal centered-difference stencil operators.

Reference: FieldCalculations.cc — fillEdges (59), plevelqvector (505),
plevelgwind_xcomp (638), plevelgwind_ycomp (674), plevelgvort (708),
ilevelgwind (1511), relvort (1843), absvort (1875), divergence (1910),
advection (1942), gradient (1985), shapiro2_filter (2076),
thermalFrontParameter (2266), momentumXcoordinate / momentumYcoordinate
(2351-2422), jacobian (2424).

Grid layout: arrays are ``[..., ny, nx]`` (y-major), matching the
reference's x-fastest flat layout where ``i-1/i+1`` are x-neighbours and
``i-nx/i+nx`` are y-neighbours.  Neighbour access uses circular shifts;
the wrapped lanes land exactly on the rows/columns that ``fillEdges``
(cc:59-74) overwrites, so values match the reference bit-for-bit on the
interior and by construction on the edges.

On a multi-device mesh these same kernels run per-shard with halo rings
exchanged between devices (see :mod:`mi_fieldcalc_tpu.parallel.halo`);
``fill_edges`` is then applied only at *physical* domain boundaries.
"""

from __future__ import annotations

from typing import Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import cp, g, kappa, p0
from ..field import UNDEF, Field
from ._harness import and_masks, out_field, require

__all__ = [
    "fill_edges", "gradient", "relvort", "absvort", "divergence",
    "advection", "jacobian", "plevelgwind_xcomp", "plevelgwind_ycomp",
    "plevelgvort", "ilevelgwind", "plevelqvector", "thermal_front_parameter",
    "momentum_x_coordinate", "momentum_y_coordinate", "shapiro2_filter",
]

_f32 = jnp.float32
ArrayLike = Union[jax.Array, Field]


def _vals(x: ArrayLike):
    return x.values if isinstance(x, Field) else jnp.asarray(x, _f32)


# -- neighbour shifts --------------------------------------------------------

def _xm(a):  # value at (y, x-1)  == flat i-1
    return jnp.roll(a, 1, axis=-1)


def _xp(a):  # value at (y, x+1)  == flat i+1
    return jnp.roll(a, -1, axis=-1)


def _ym(a):  # value at (y-1, x)  == flat i-nx
    return jnp.roll(a, 1, axis=-2)


def _yp(a):  # value at (y+1, x)  == flat i+nx
    return jnp.roll(a, -1, axis=-2)


def fill_edges(a):
    """Copy the first interior row/column outward (FieldCalculations.cc:59-74).

    Column 0 <- column 1, column nx-1 <- column nx-2 (for interior rows),
    then row 0 <- row 1 and row ny-1 <- row ny-2 (including the already
    fixed corners).  Works on value and mask arrays alike.
    """
    a = jnp.concatenate([a[..., :, 1:2], a[..., :, 1:-1], a[..., :, -2:-1]],
                        axis=-1)
    a = jnp.concatenate([a[..., 1:2, :], a[..., 1:-1, :], a[..., -2:-1, :]],
                        axis=-2)
    return a


# Sharded-execution hook: mi_fieldcalc_tpu.parallel.halo installs a masked
# fill here while tracing an op inside shard_map, so that fillEdges applies
# only at physical domain edges, never at shard seams.  A ContextVar, not
# a module global: run_sharded traces can run on worker threads (the
# staging executors) and a global swap could leak one trace's
# axis_index-closing fill into another thread's unrelated op.
import contextvars as _contextvars
from typing import NamedTuple as _NamedTuple

_EDGE_FILL = _contextvars.ContextVar("mf_edge_fill", default=None)


class ShardCtx(_NamedTuple):
    """Shard-global geometry for ops whose semantics reference GLOBAL
    grid coordinates (installed by ``parallel.halo.run_sharded``):
    ``(row0, col0)`` is the traced global coordinate of the local
    block's element (0, 0) (negative at halo rows), ``(nyg, nxg)`` the
    static logical global extents, and ``mesh_axes`` the spatial mesh
    axis names for global reductions.  The momentum-coordinate ops add
    the offsets to their iotas; shapiro freezes boundary rows/columns at
    physical coordinates and makes its all-defined branch a global
    decision."""
    row0: object
    col0: object
    nyg: int
    nxg: int
    mesh_axes: tuple


_SHARD_CTX = _contextvars.ContextVar("mf_shard_ctx", default=None)


def _finish(values, mask) -> Field:
    """fill_edges on both values and mask, returning a Field."""
    fe = _EDGE_FILL.get() or fill_edges
    return Field(fe(values), fe(mask))


def _check_min_size(f: Field, name: str) -> None:
    ny, nx = f.shape[-2], f.shape[-1]
    require(nx >= 3 and ny >= 3, f"{name}: grid must be at least 3x3")


# -- basic derivative operators ----------------------------------------------

def gradient(f: Field, xmapr: ArrayLike, ymapr: ArrayLike, compute: int) -> Field:
    """Centered-difference gradients (FieldCalculations.cc:1985-2074).

    compute: 1 df/dx, 2 df/dy, 3 |grad f|, 4 laplacian (map factors applied
    approximately, as in the reference).  ``xmapr = xm/(2*hx)``,
    ``ymapr = ym/(2*hy)``.
    """
    require(compute in (1, 2, 3, 4), f"gradient: bad compute {compute}")
    _check_min_size(f, "gradient")
    xm, ym = _vals(xmapr), _vals(ymapr)
    v, m = f.values, f.mask
    if compute == 1:
        out = _f32(0.5) * xm * (_xp(v) - _xm(v))
        mask = _xm(m) & _xp(m)
    elif compute == 2:
        out = _f32(0.5) * ym * (_yp(v) - _ym(v))
        mask = _ym(m) & _yp(m)
    elif compute == 3:
        dfdx = _f32(0.5) * xm * (_xp(v) - _xm(v))
        dfdy = _f32(0.5) * ym * (_yp(v) - _ym(v))
        out = jnp.sqrt(dfdx * dfdx + dfdy * dfdy)
        mask = _xm(m) & _xp(m) & _ym(m) & _yp(m)
    else:  # 4: laplacian
        d2fdx = _xm(v) - _f32(2) * v + _xp(v)
        d2fdy = _ym(v) - _f32(2) * v + _yp(v)
        out = _f32(4.0) * (_f32(0.25) * xm * xm * d2fdx
                           + _f32(0.25) * ym * ym * d2fdy)
        mask = _xm(m) & _xp(m) & m & _ym(m) & _yp(m)
    return _finish(out, mask)


def relvort(u: Field, v: Field, xmapr: ArrayLike, ymapr: ArrayLike) -> Field:
    """Relative vorticity dv/dx - du/dy (FieldCalculations.cc:1843-1873)."""
    _check_min_size(u, "relvort")
    xm, ym = _vals(xmapr), _vals(ymapr)
    out = _f32(0.5) * xm * (_xp(v.values) - _xm(v.values)) \
        - _f32(0.5) * ym * (_yp(u.values) - _ym(u.values))
    mask = _xm(v.mask) & _xp(v.mask) & _ym(u.mask) & _yp(u.mask)
    return _finish(out, mask)


def absvort(u: Field, v: Field, xmapr: ArrayLike, ymapr: ArrayLike,
            fcoriolis: ArrayLike) -> Field:
    """Absolute vorticity (FieldCalculations.cc:1875-1908)."""
    _check_min_size(u, "absvort")
    xm, ym, fc = _vals(xmapr), _vals(ymapr), _vals(fcoriolis)
    out = _f32(0.5) * xm * (_xp(v.values) - _xm(v.values)) \
        - _f32(0.5) * ym * (_yp(u.values) - _ym(u.values)) + fc
    mask = _xm(v.mask) & _xp(v.mask) & _ym(u.mask) & _yp(u.mask)
    return _finish(out, mask)


def divergence(u: Field, v: Field, xmapr: ArrayLike, ymapr: ArrayLike) -> Field:
    """Horizontal divergence du/dx + dv/dy (FieldCalculations.cc:1910-1940).

    Note: the reference's defined-check reads v[i+-1], u[i+-nx] (cc:1927) —
    i.e. the *vorticity* stencil's inputs — while computing from u[i+-1],
    v[i+-nx]; reproduced as-is for parity.
    """
    _check_min_size(u, "divergence")
    xm, ym = _vals(xmapr), _vals(ymapr)
    out = _f32(0.5) * xm * (_xp(u.values) - _xm(u.values)) \
        + _f32(0.5) * ym * (_yp(v.values) - _ym(v.values))
    mask = _xm(v.mask) & _xp(v.mask) & _ym(u.mask) & _yp(u.mask)
    return _finish(out, mask)


def advection(f: Field, u: Field, v: Field, xmapr: ArrayLike,
              ymapr: ArrayLike, hours: float) -> Field:
    """Scalar advection -(u df/dx + v df/dy) * 3600*hours
    (FieldCalculations.cc:1942-1983)."""
    _check_min_size(f, "advection")
    xm, ym = _vals(xmapr), _vals(ymapr)
    scale = _f32(-3600.0 * hours)
    fv = f.values
    out = (u.values * _f32(0.5) * xm * (_xp(fv) - _xm(fv))
           + v.values * _f32(0.5) * ym * (_yp(fv) - _ym(fv))) * scale
    mask = u.mask & v.mask & _xm(f.mask) & _xp(f.mask) & _ym(f.mask) & _yp(f.mask)
    return _finish(out, mask)


def jacobian(f1: Field, f2: Field, xmapr: ArrayLike, ymapr: ArrayLike) -> Field:
    """Jacobian df1/dx*df2/dy - df1/dy*df2/dx (FieldCalculations.cc:2424-2460)."""
    _check_min_size(f1, "jacobian")
    xm, ym = _vals(xmapr), _vals(ymapr)
    a, b = f1.values, f2.values
    df1dx = _f32(0.5) * xm * (_xp(a) - _xm(a))
    df1dy = _f32(0.5) * ym * (_yp(a) - _ym(a))
    df2dx = _f32(0.5) * xm * (_xp(b) - _xm(b))
    df2dy = _f32(0.5) * ym * (_yp(b) - _ym(b))
    mask = (_xm(f1.mask) & _xp(f1.mask) & _ym(f1.mask) & _yp(f1.mask)
            & _xm(f2.mask) & _xp(f2.mask) & _ym(f2.mask) & _yp(f2.mask))
    return _finish(df1dx * df2dy - df1dy * df2dx, mask)


# -- geostrophic wind / vorticity ---------------------------------------------

def plevelgwind_xcomp(z: Field, xmapr: ArrayLike, ymapr: ArrayLike,
                      fcoriolis: ArrayLike) -> Field:
    """ug = -(g/f) dz/dy (FieldCalculations.cc:638-672).

    Reference quirk: its ``n_undefined`` is incremented unconditionally
    (cc:664), making the output flag SOME/NONE even when all values are
    fine; the mask here reflects the actual values (recorded divergence).
    """
    _check_min_size(z, "plevelgwind_xcomp")
    ym, fc = _vals(ymapr), _vals(fcoriolis)
    out = _f32(-0.5) * ym * (_yp(z.values) - _ym(z.values)) * g / fc
    m = z.mask
    mask = _ym(m) & _xm(m) & _xp(m) & _yp(m)
    return _finish(out, mask)


def plevelgwind_ycomp(z: Field, xmapr: ArrayLike, ymapr: ArrayLike,
                      fcoriolis: ArrayLike) -> Field:
    """vg = +(g/f) dz/dx (FieldCalculations.cc:674-706)."""
    _check_min_size(z, "plevelgwind_ycomp")
    xm, fc = _vals(xmapr), _vals(fcoriolis)
    out = _f32(0.5) * xm * (_xp(z.values) - _xm(z.values)) * g / fc
    m = z.mask
    mask = _ym(m) & _xm(m) & _xp(m) & _yp(m)
    return _finish(out, mask)


def plevelgvort(z: Field, xmapr: ArrayLike, ymapr: ArrayLike,
                fcoriolis: ArrayLike) -> Field:
    """Geostrophic vorticity (g/f) * laplacian(z)
    (FieldCalculations.cc:708-743)."""
    _check_min_size(z, "plevelgvort")
    xm, ym, fc = _vals(xmapr), _vals(ymapr), _vals(fcoriolis)
    v = z.values
    out = (_f32(0.25) * xm * xm * (_xm(v) - _f32(2) * v + _xp(v))
           + _f32(0.25) * ym * ym * (_ym(v) - _f32(2) * v + _yp(v))) \
        * _f32(4.0) * g / fc
    m = z.mask
    mask = _ym(m) & _xm(m) & m & _xp(m) & _yp(m)
    return _finish(out, mask)


def ilevelgwind(mpot: Field, xmapr: ArrayLike, ymapr: ArrayLike,
                fcoriolis: ArrayLike) -> Tuple[Field, Field]:
    """Geostrophic wind from the Montgomery potential on an isentropic level
    (FieldCalculations.cc:1511-1549); returns (ug, vg)."""
    _check_min_size(mpot, "ilevelgwind")
    xm, ym, fc = _vals(xmapr), _vals(ymapr), _vals(fcoriolis)
    v = mpot.values
    ug = _f32(-0.5) * ym * (_yp(v) - _ym(v)) / fc
    vg = _f32(0.5) * xm * (_xp(v) - _xm(v)) / fc
    m = mpot.mask
    mask = _ym(m) & _xm(m) & _xp(m) & _yp(m)
    return _finish(ug, mask), _finish(vg, mask)


def plevelqvector(z: Field, t: Field, xmapr: ArrayLike, ymapr: ArrayLike,
                  fcoriolis: ArrayLike, p: float, compute: int) -> Field:
    """Q-vector components in a pressure level
    (FieldCalculations.cc:505-595).

    compute: 1/2 x-component (T / theta input), 3/4 y-component.  Composes
    the geostrophic-wind stencil with a second radius-1 stencil — the
    composed halo radius is 2 (relevant for sharded runs).
    """
    require(p > 0, "plevelqvector: p <= 0")
    require(compute in (1, 2, 3, 4), f"plevelqvector: bad compute {compute}")
    _check_min_size(z, "plevelqvector")
    if compute in (2, 4):
        # NOT levels._scalar_pidcp: the reference's qvector computes
        # ``pi = cp * powf(p / p0, r/cp); tscale = pi / cp`` inline
        # (cc:538-539) — a DIVISION by p0 and a cp round-trip, whereas
        # pidcp_from_p multiplies by p0inv (cc:308-310).  Same math,
        # different last-ulp rounding; mirror the reference's form.
        pi = np.float32(np.float32(cp)
                        * np.power(np.float32(p) / p0, kappa))
        tscale = np.float32(pi / np.float32(cp))
    else:
        tscale = np.float32(1.0)

    ug = plevelgwind_xcomp(z, xmapr, ymapr, fcoriolis)
    vg = plevelgwind_ycomp(z, xmapr, ymapr, fcoriolis)

    xm, ym = _vals(xmapr), _vals(ymapr)
    c = _f32(-287.0 / (float(p) * 100.0))
    uv, vv, tv = ug.values, vg.values, t.values
    dtdx = _f32(0.5) * xm * tscale * (_xp(tv) - _xm(tv))
    dtdy = _f32(0.5) * ym * tscale * (_yp(tv) - _ym(tv))
    if compute < 3:
        dugdx = _f32(0.5) * xm * (_xp(uv) - _xm(uv))
        dvgdx = _f32(0.5) * xm * (_xp(vv) - _xm(vv))
        out = c * (dugdx * dtdx + dvgdx * dtdy)
    else:
        dugdy = _f32(0.5) * ym * (_yp(uv) - _ym(uv))
        dvgdy = _f32(0.5) * ym * (_yp(vv) - _ym(vv))
        out = c * (dugdy * dtdx + dvgdy * dtdy)

    def ring(m):
        return _ym(m) & _xm(m) & _xp(m) & _yp(m)

    mask = ring(ug.mask) & ring(vg.mask) & ring(t.mask)
    return _finish(out, mask)


def thermal_front_parameter(t: Field, xmapr: ArrayLike,
                            ymapr: ArrayLike) -> Field:
    """TFP = -grad|grad T| . grad T / |grad T|
    (FieldCalculations.cc:2266-2309).  Composed radius-2 stencil through the
    intermediate |grad T| field."""
    _check_min_size(t, "thermalFrontParameter")
    xm, ym = _vals(xmapr), _vals(ymapr)
    absdelt = gradient(t, xmapr, ymapr, 3)
    a, tv = absdelt.values, t.values
    dadx = _f32(0.5) * xm * (_xp(a) - _xm(a))
    dady = _f32(0.5) * ym * (_yp(a) - _ym(a))
    nonzero = a != 0
    ainv = 1 / jnp.where(nonzero, a, _f32(1))
    dtdxa = _f32(0.5) * xm * (_xp(tv) - _xm(tv)) * ainv
    dtdya = _f32(0.5) * ym * (_yp(tv) - _ym(tv)) * ainv
    out = -(dadx * dtdxa + dady * dtdya)
    mask = (_ym(t.mask) & _xm(t.mask) & _xp(t.mask) & _yp(t.mask)
            & _ym(absdelt.mask) & _xm(absdelt.mask) & absdelt.mask
            & _xp(absdelt.mask) & _yp(absdelt.mask) & nonzero)
    return _finish(out, mask)


# -- momentum coordinates ------------------------------------------------------

def _clamped_coriolis(fc, fcoriolis_min: float):
    fcormin = _f32(abs(fcoriolis_min))
    pos = (fc >= 0) & (fc < fcormin)
    neg = (fc <= 0) & (fc > -fcormin)
    return jnp.where(pos, fcormin, jnp.where(neg, -fcormin, fc))


def momentum_x_coordinate(v: Field, xmapr: ArrayLike, fcoriolis: ArrayLike,
                          fcoriolis_min: float) -> Field:
    """m(x,y) = x + v*xmapr/fc, coriolis clamped away from zero
    (FieldCalculations.cc:2351-2386).  The x coordinate is the grid index."""
    _check_min_size(v, "momentumXcoordinate")
    xm = _vals(xmapr)
    fc = _clamped_coriolis(_vals(fcoriolis), fcoriolis_min)
    xcoord = jax.lax.broadcasted_iota(_f32, v.shape, len(v.shape) - 1)
    ctx = _SHARD_CTX.get()
    if ctx is not None:     # global grid index, not the shard-local one
        xcoord = xcoord + jnp.asarray(ctx.col0, _f32)
    return Field(xcoord + v.values * xm / fc, v.mask)


def momentum_y_coordinate(u: Field, ymapr: ArrayLike, fcoriolis: ArrayLike,
                          fcoriolis_min: float) -> Field:
    """n(x,y) = y - u*ymapr/fc (FieldCalculations.cc:2388-2422)."""
    _check_min_size(u, "momentumYcoordinate")
    ym = _vals(ymapr)
    fc = _clamped_coriolis(_vals(fcoriolis), fcoriolis_min)
    ycoord = jax.lax.broadcasted_iota(_f32, u.shape, len(u.shape) - 2)
    ctx = _SHARD_CTX.get()
    if ctx is not None:
        ycoord = ycoord + jnp.asarray(ctx.row0, _f32)
    return Field(ycoord - u.values * ym / fc, u.mask)


# -- Shapiro filter ------------------------------------------------------------

def _shapiro_edge_keep(prev, new, axis_from_end: int, ctx):
    """Boundary copy of one shapiro pass (cc:2117-2120): keep ``prev``
    at the boundary rows/columns.  Unsharded: the array edges.  Sharded
    (``ctx``): only PHYSICAL global edges — seam rows get the smoothed
    value (their halo neighbours are real data), and the pass never
    smooths a physical boundary against a zero halo lane."""
    if ctx is None:
        if axis_from_end == 1:
            return jnp.concatenate(
                [prev[..., :, :1], new[..., :, 1:-1], prev[..., :, -1:]],
                axis=-1)
        return jnp.concatenate(
            [prev[..., :1, :], new[..., 1:-1, :], prev[..., -1:, :]],
            axis=-2)
    axis = new.ndim - axis_from_end
    off = ctx.col0 if axis_from_end == 1 else ctx.row0
    ng = ctx.nxg if axis_from_end == 1 else ctx.nyg
    c = jax.lax.broadcasted_iota(jnp.int32, new.shape, axis) + off
    return jnp.where((c == 0) | (c == ng - 1), prev, new)


def _shapiro_x_pass(f1, s, ctx=None):
    f2 = f1 + s * (_xm(f1) + _xp(f1) - 2 * f1)
    return _shapiro_edge_keep(f1, f2, 1, ctx)


def _shapiro_y_pass(f2, s, ctx=None):
    f1 = f2 + s * (_ym(f2) + _yp(f2) - 2 * f2)
    return _shapiro_edge_keep(f2, f1, 2, ctx)


def shapiro2_filter(f: Field, all_defined=None,
                    undef: float = UNDEF) -> Field:
    """2nd-order Shapiro smoother (FieldCalculations.cc:2076-2179).

    All-defined path: two rounds of separable x-then-y passes with
    s = +0.25 then s = -0.25.  Undef-aware path: per-point coefficient
    fields frozen from the *initial* mask; note the reference never flips
    the sign for the second round in this path (cc:2141-2168, the ``s``
    reassignment does not reach the pre-computed ``s1``/``s2`` arrays) —
    reproduced as-is.  The output is force-marked all-defined (cc:2176),
    so undefined inputs propagate as sentinel *values*.

    ``all_defined`` selects the path statically (True/False); if None the
    choice is a traced ``lax.cond`` on the mask, so the op stays jittable
    and fuses into pipelines with no host sync.
    """
    ny, nx = f.shape[-2], f.shape[-1]
    require(nx >= 3 and ny >= 3, "shapiro2_filter: grid must be at least 3x3")
    ctx = _SHARD_CTX.get()

    if all_defined is None:
        if ctx is not None:
            # evaluate over the LOGICAL region only — the padded block's
            # physical-edge halo slots are ppermute zeros (mask False)
            # and would force the undef branch on fully-defined data —
            # then combine across shards: the reference decides once per
            # GLOBAL field (cc:2101), and a per-shard decision would
            # pick different smoothing paths across seams
            r = jax.lax.broadcasted_iota(jnp.int32, f.shape, f.mask.ndim - 2)
            c = jax.lax.broadcasted_iota(jnp.int32, f.shape, f.mask.ndim - 1)
            inside = ((r + ctx.row0 >= 0) & (r + ctx.row0 < ctx.nyg)
                      & (c + ctx.col0 >= 0) & (c + ctx.col0 < ctx.nxg))
            alldef = jnp.all(f.mask | ~inside)
            if ctx.mesh_axes:
                alldef = jax.lax.pmin(alldef.astype(jnp.int32),
                                      ctx.mesh_axes) > 0
        else:
            alldef = jnp.all(f.mask)
        return jax.lax.cond(alldef, lambda ff: _shapiro_all(ff, ctx),
                            lambda ff: _shapiro_undef(ff, undef, ctx), f)
    if all_defined:
        return _shapiro_all(f, ctx)
    return _shapiro_undef(f, undef, ctx)


def _shapiro_all(f: Field, ctx=None) -> Field:
    f1 = f.values
    for s in (_f32(0.25), _f32(-0.25)):
        f2 = _shapiro_x_pass(f1, s, ctx)
        f1 = _shapiro_y_pass(f2, s, ctx)
    return Field(f1, jnp.ones(f.shape, bool))


def _shapiro_undef(f: Field, undef: float, ctx=None) -> Field:
    # undef-aware path: arithmetic runs on sentinel-materialized values
    f1 = f.to_sentinel(undef)
    m = f.mask
    s1 = jnp.where(_xm(m) & m & _xp(m), _f32(0.25), _f32(0))
    s2 = jnp.where(_ym(m) & m & _yp(m), _f32(0.25), _f32(0))
    # the x-edge / y-edge coefficient rows are never used (boundaries copied)
    for _ in range(2):
        f2 = f1 + s1 * (_xm(f1) + _xp(f1) - 2 * f1)
        f2 = _shapiro_edge_keep(f1, f2, 1, ctx)
        f1n = f2 + s2 * (_ym(f2) + _yp(f2) - 2 * f2)
        f1 = _shapiro_edge_keep(f2, f1n, 2, ctx)
    return Field(f1, jnp.ones(f.shape, bool))
