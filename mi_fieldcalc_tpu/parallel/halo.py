"""Halo exchange + sharded execution of stencil operators.

The reference's stencils read a fixed radius-R neighbourhood in a flat
x-fastest array (e.g. FieldCalculations.cc:1862, 2016) and patch physical
boundaries with ``fillEdges`` (cc:59-74).  On a 2-D device mesh the same
operators run per-shard on blocks padded with a radius-R halo ring fetched
from mesh neighbours (``lax.ppermute`` inside ``shard_map``),
while ``fillEdges`` must apply only at *physical* domain edges.

Mechanics:

* :func:`halo_exchange` pads a local block ``[..., ny_loc, nx_loc]`` to
  ``[..., ny_loc+2R, nx_loc+2R]``; halo slots at physical edges receive
  zeros (``ppermute`` semantics) and are handled by the edge-fill below.
* :class:`EdgeContext` — installed while tracing the wrapped operator; the
  stencil module's ``_finish`` consults it so every ``fillEdges`` call
  (including those inside composed ops like ``plevelqvector``,
  FieldCalculations.cc:505-595, which fills after each internal stage)
  becomes a *masked* fill: at a shard on the physical boundary the
  outermost ``R+1`` rows/columns are overwritten with the first interior
  row/column — exactly reproducing the global ``fillEdges`` on the rows
  that survive the final crop — and shard-seam rows are left untouched.
* :func:`run_sharded` wires it together: shard inputs, exchange halos,
  trace the op under the context, crop R from each side.

Composed stencils work because the halo width is the *composed* radius:
stage k's output is valid on the padded block shrunk by the sum of stage
radii so far, and the masked fill re-establishes boundary rows between
stages just like the global algorithm does.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
try:
    from jax import shard_map  # jax >= 0.8
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..field import Field
from ..ops import stencil as _stencil_mod
from .mesh import partition_spec

__all__ = ["halo_exchange", "packed_strip_exchange", "packed_sendrecv",
           "packed_exchange_rows", "packed_exchange_cols", "run_sharded",
           "EdgeContext"]


def _exchange_1d(a, h: int, axis: int, name: str, size: int):
    """Pad ``a`` with an ``h``-wide halo along ``axis`` from mesh
    neighbours on mesh axis ``name`` (``size`` devices).  Physical-edge
    halo slots become zeros."""
    dim = a.shape[axis]
    if size == 1:
        pad = [(0, 0)] * a.ndim
        pad[axis] = (h, h)
        return jnp.pad(a, pad)
    # bool collectives ride as int8: ppermute support for i1 operands
    # varies by backend, and masks are the halo payload here too
    if a.dtype == jnp.bool_:
        return _exchange_1d(a.astype(jnp.int8), h, axis, name,
                            size).astype(jnp.bool_)
    lo_strip = lax.slice_in_dim(a, 0, h, axis=axis)          # my first h rows
    hi_strip = lax.slice_in_dim(a, dim - h, dim, axis=axis)  # my last h rows
    fwd = [(i, i + 1) for i in range(size - 1)]  # i's hi -> (i+1)'s lo halo
    bwd = [(i + 1, i) for i in range(size - 1)]  # i's lo -> (i-1)'s hi halo
    halo_lo = lax.ppermute(hi_strip, name, fwd)
    halo_hi = lax.ppermute(lo_strip, name, bwd)
    return jnp.concatenate([halo_lo, a, halo_hi], axis=axis)


def _pack_strips(strips):
    """Stack halo strips of one dtype into a single 2-D buffer: each
    strip keeps its own trailing dim (``nx`` for row strips, ``h`` for
    lane strips — uniform within one exchange) and flattens the rest."""
    last = strips[0].shape[-1]
    return jnp.concatenate([s.reshape(-1, last) for s in strips], axis=0)


def _unpack_strips(buf, arrays, h: int, axis: int):
    """Inverse of :func:`_pack_strips`: split ``buf`` back into per-array
    halo strips shaped like ``arrays[i]`` with dim ``axis`` replaced by
    ``h``."""
    out, r = [], 0
    for a in arrays:
        shape = list(a.shape)
        shape[axis] = h
        shape = tuple(shape)
        n = 1
        for d in shape[:-1]:
            n *= d
        out.append(lax.slice_in_dim(buf, r, r + n, axis=0).reshape(shape))
        r += n
    return out


def packed_strip_exchange(arrays: Sequence, h: int, name: str, size: int,
                          axis: int = -2):
    """Fetch the ``h``-wide halos of MANY arrays along trailing ``axis``
    (``-2``: row/y halos, ``-1``: lane/x halos) with one ``ppermute``
    per (direction, dtype class) instead of one per array.

    A multi-field pipeline step otherwise issues 2 x n_arrays small
    collectives, each paying launch latency.  Packing the strips into a
    single f32 buffer (+ one int8 buffer for bool masks) per direction
    turns that into 4 larger messages whose latency amortises.

    Returns ``(tops, bots)``: per-array strips arriving from the mesh
    neighbour before / after on ``name`` (zeros at physical edges),
    dtypes restored.
    """
    cast = [a.astype(jnp.int8) if a.dtype == jnp.bool_ else a
            for a in arrays]
    groups = {}                       # dtype -> list of array indices
    for i, a in enumerate(cast):
        groups.setdefault(a.dtype, []).append(i)

    fwd = [(i, i + 1) for i in range(size - 1)]
    bwd = [(i + 1, i) for i in range(size - 1)]
    tops = [None] * len(arrays)
    bots = [None] * len(arrays)
    for idxs in groups.values():
        arrs = [cast[i] for i in idxs]
        ax = lambda a: a.ndim + axis
        lo = _pack_strips([lax.slice_in_dim(a, 0, h, axis=ax(a))
                           for a in arrs])
        hi = _pack_strips([lax.slice_in_dim(a, a.shape[axis] - h,
                                            a.shape[axis], axis=ax(a))
                           for a in arrs])
        top = lax.ppermute(hi, name, fwd)   # preceding neighbour's last strip
        bot = lax.ppermute(lo, name, bwd)   # following neighbour's first strip
        for i, t, b in zip(idxs, _unpack_strips(top, arrs, h, axis),
                           _unpack_strips(bot, arrs, h, axis)):
            if arrays[i].dtype == jnp.bool_:
                t, b = t != 0, b != 0
            tops[i], bots[i] = t, b
    return tops, bots


def packed_sendrecv(lo_strips: Sequence, hi_strips: Sequence, name: str,
                    size: int):
    """ppermute PRE-SLICED strips with packed collectives: ``lo_strips[i]``
    goes to the preceding neighbour on mesh axis ``name``, ``hi_strips[i]``
    to the following.  Returns ``(from_prev, from_next)`` per array —
    the preceding neighbour's ``hi_strip`` and the following neighbour's
    ``lo_strip`` (zeros at physical edges), dtypes restored.

    Unlike :func:`packed_strip_exchange` (which slices the edge strips of
    whole arrays itself), this takes the strips ready-made — needed when
    the payload is not a plain edge slice, e.g. y-extended corner
    columns.  Strips must be
    shard-uniform (every shard sends the same shapes) and share one
    trailing dim within each dtype class — the packer flattens to
    ``(-1, last)`` and a mismatched trailing dim would silently
    desynchronise every later unpack offset, so it is asserted.  One
    collective per (direction, dtype class), bools ride as int8.
    """
    cast = lambda a: a.astype(jnp.int8) if a.dtype == jnp.bool_ else a
    lo = [cast(a) for a in lo_strips]
    hi = [cast(a) for a in hi_strips]
    groups = {}
    for i, a in enumerate(lo):
        groups.setdefault(a.dtype, []).append(i)
    for idxs in groups.values():
        lasts = {lo[i].shape[-1] for i in idxs} | \
                {hi[i].shape[-1] for i in idxs}
        if len(lasts) != 1:
            raise ValueError("packed_sendrecv: strips in one dtype group "
                             f"must share a trailing dim, got {lasts}")

    fwd = [(i, i + 1) for i in range(size - 1)]
    bwd = [(i + 1, i) for i in range(size - 1)]
    from_prev = [None] * len(lo)
    from_next = [None] * len(lo)
    def unpack(buf, shapes):
        out, r = [], 0
        for shape in shapes:
            n = 1
            for d in shape[:-1]:
                n *= d
            out.append(lax.slice_in_dim(buf, r, r + n, axis=0)
                       .reshape(shape))
            r += n
        return out

    for idxs in groups.values():
        prev = lax.ppermute(_pack_strips([hi[i] for i in idxs]), name, fwd)
        nxt = lax.ppermute(_pack_strips([lo[i] for i in idxs]), name, bwd)
        for i, p, n in zip(idxs,
                           unpack(prev, [hi[i].shape for i in idxs]),
                           unpack(nxt, [lo[i].shape for i in idxs])):
            if lo_strips[i].dtype == jnp.bool_:
                p, n = p != 0, n != 0
            from_prev[i], from_next[i] = p, n
    return from_prev, from_next


def packed_exchange_rows(arrays: Sequence, h: int, mesh: Mesh):
    """y-axis :func:`halo_exchange` over many arrays with packed
    collectives (see :func:`packed_strip_exchange`).  Returns each array
    padded with ``h`` rows per side; zeros at physical edges."""
    size = mesh.shape["gy"] if "gy" in mesh.axis_names else 1
    if size == 1:
        pad = lambda a: jnp.pad(a, [(0, 0)] * (a.ndim - 2)
                                + [(h, h), (0, 0)])
        return [pad(a) for a in arrays]
    tops, bots = packed_strip_exchange(arrays, h, "gy", size)
    ax = lambda a: a.ndim - 2
    return [jnp.concatenate([t, a, b], axis=ax(a))
            for a, t, b in zip(arrays, tops, bots)]


def packed_exchange_cols(arrays: Sequence, h: int, mesh: Mesh):
    """x-axis halo exchange over many arrays with packed collectives
    (:func:`packed_strip_exchange` on the lane axis).  Returns each
    array padded with ``h`` lanes per side; zeros at physical edges.

    The per-array alternative costs 2 x n_arrays tiny ``(.., ny, 2)``
    ppermutes on a (gy, gx) mesh, each paying full launch latency for a
    few-KB payload.  Packed, the whole x-leg is 4 messages, matching the
    y-leg."""
    size = mesh.shape["gx"] if "gx" in mesh.axis_names else 1
    if size == 1:
        pad = lambda a: jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(h, h)])
        return [pad(a) for a in arrays]
    lefts, rights = packed_strip_exchange(arrays, h, "gx", size, axis=-1)
    ax = lambda a: a.ndim - 1
    return [jnp.concatenate([l, a, r], axis=ax(a))
            for a, l, r in zip(arrays, lefts, rights)]


def halo_exchange(a, radius: int, mesh: Mesh):
    """Pad the trailing (ny, nx) axes of ``a`` with a radius-R halo ring
    from (gy, gx) mesh neighbours.  Must be called inside ``shard_map``."""
    names = mesh.axis_names
    if "gy" in names:
        a = _exchange_1d(a, radius, a.ndim - 2, "gy",
                         mesh.shape["gy"])
    else:
        a = jnp.pad(a, [(0, 0)] * (a.ndim - 2) + [(radius, radius), (0, 0)])
    if "gx" in names:
        a = _exchange_1d(a, radius, a.ndim - 1, "gx",
                         mesh.shape["gx"])
    else:
        a = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(radius, radius)])
    return a


class EdgeContext:
    """Physical-edge information for one sharded trace.

    ``fill(a)`` is the sharded replacement for the global ``fillEdges``
    (FieldCalculations.cc:59-74): on a padded block with halo width H, a
    shard at the physical top overwrites rows [0..H] with row H+1 (the
    global copy "row 0 <- row 1" plus the discarded halo rows), etc.
    Column fill first, then row fill, matching the reference's order.
    """

    def __init__(self, halo: int, mesh: Mesh):
        self.halo = halo
        names = mesh.axis_names
        if "gy" in names:
            iy = lax.axis_index("gy")
            self.is_top = iy == 0
            self.is_bottom = iy == mesh.shape["gy"] - 1
        else:
            self.is_top = self.is_bottom = jnp.bool_(True)
        if "gx" in names:
            ix = lax.axis_index("gx")
            self.is_left = ix == 0
            self.is_right = ix == mesh.shape["gx"] - 1
        else:
            self.is_left = self.is_right = jnp.bool_(True)

    def _fill_axis(self, a, axis: int, is_lo, is_hi):
        h = self.halo
        dim = a.shape[axis]
        idx = lax.broadcasted_iota(jnp.int32, a.shape, axis)
        lo_src = lax.slice_in_dim(a, h + 1, h + 2, axis=axis)
        hi_src = lax.slice_in_dim(a, dim - h - 2, dim - h - 1, axis=axis)
        a = jnp.where((idx <= h) & is_lo, lo_src, a)
        a = jnp.where((idx >= dim - 1 - h) & is_hi, hi_src, a)
        return a

    def fill(self, a):
        a = self._fill_axis(a, a.ndim - 1, self.is_left, self.is_right)
        a = self._fill_axis(a, a.ndim - 2, self.is_top, self.is_bottom)
        return a


def _crop(a, r: int):
    if r == 0:          # a[..., 0:-0, 0:-0] would be EMPTY, not identity
        return a
    return a[..., r:-r, r:-r]


def run_sharded(op, mesh: Mesh, radius: int, *args, **kwargs):
    """Run stencil operator ``op`` with (gy, gx) domain decomposition.

    ``args`` may be Fields, arrays (``[..., ny, nx]``, sharded on the
    trailing axes per :func:`mesh.partition_spec`) or Python scalars
    (closed over statically).  ``radius`` is the op's *composed* stencil
    radius (1 for simple derivatives, 2 for plevelqvector /
    thermal_front_parameter).  ``kwargs`` are static.

    Returns the same pytree-of-Fields the unsharded op returns, with
    global values identical to the unsharded run (sharded-vs-unsharded
    equivalence is tested in tests/test_parallel.py).
    """
    dyn_leaves, treedef = jax.tree_util.tree_flatten(args)
    dyn_leaves = tuple(jnp.asarray(leaf) for leaf in dyn_leaves)
    in_specs = tuple(partition_spec(leaf.ndim, mesh) for leaf in dyn_leaves)

    out_shape = jax.eval_shape(lambda leaves: op(
        *jax.tree_util.tree_unflatten(treedef, leaves), **kwargs), dyn_leaves)
    out_specs = jax.tree_util.tree_map(
        lambda s: partition_spec(len(s.shape), mesh), out_shape)

    def body(leaves):
        # grids get a halo ring; 0/1-D coefficient vectors pass through;
        # pointwise ops (radius 0, e.g. the icing solvers) skip the
        # exchange entirely
        padded = [halo_exchange(leaf, radius, mesh)
                  if leaf.ndim >= 2 and radius > 0 else leaf
                  for leaf in leaves]
        ctx = EdgeContext(radius, mesh)
        # shard-global geometry for ops that reference global grid
        # coordinates (momentum m/n, shapiro's physical-edge copies and
        # global all-defined decision) — ShardCtx in ops.stencil
        names = mesh.axis_names
        grid = next(leaf for leaf in leaves if leaf.ndim >= 2)
        ny_loc, nx_loc = grid.shape[-2:]
        gy = mesh.shape["gy"] if "gy" in names else 1
        gx = mesh.shape["gx"] if "gx" in names else 1
        iy = lax.axis_index("gy") if "gy" in names else 0
        ix = lax.axis_index("gx") if "gx" in names else 0
        sctx = _stencil_mod.ShardCtx(
            row0=iy * ny_loc - radius, col0=ix * nx_loc - radius,
            nyg=ny_loc * gy, nxg=nx_loc * gx,
            mesh_axes=tuple(n for n in ("gy", "gx") if n in names))
        token = _stencil_mod._EDGE_FILL.set(ctx.fill)
        token2 = _stencil_mod._SHARD_CTX.set(sctx)
        try:
            out = op(*jax.tree_util.tree_unflatten(treedef, padded), **kwargs)
        finally:
            _stencil_mod._EDGE_FILL.reset(token)
            _stencil_mod._SHARD_CTX.reset(token2)
        return jax.tree_util.tree_map(lambda a: _crop(a, radius), out)

    fn = shard_map(body, mesh=mesh, in_specs=(in_specs,),
                   out_specs=out_specs, check_vma=False)
    return fn(dyn_leaves)
