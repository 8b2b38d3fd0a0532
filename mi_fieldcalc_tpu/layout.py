"""Canonical tile-aligned device layout for gridded fields.

A *padded layout*: grids padded once (rows to a multiple of 8, columns
to a multiple of 128), carried padded through whole pipelines, and
trimmed back to the logical extent when results leave the device.  The
staging layer does not need it (XLA handles ragged grids); it remains
for callers that pad grids to split them
evenly over a device mesh (:func:`padded_shape_sharded`) and for the
tile-aligned ingest grid (ingest.py).  Padding rules:

* ``Field`` values pad with zeros and masks pad with ``False`` — dead
  points are simply undefined points, so every mask-respecting operator
  is automatically correct on padded grids.
* Reductions respect masks, so dead lanes never contaminate counts or
  means.

The reference has no analog: its flat C arrays have no tiling
(FieldCalculations.h:102-107 just takes ``nx*ny`` floats).
"""

from __future__ import annotations

import jax.numpy as jnp

from .field import Field

__all__ = ["ROW_TILE", "LANE_TILE", "padded_shape", "padded_shape_sharded",
           "pad_field", "pad_array", "trim_field", "trim_array"]

#: row / column multiples of the padded layout.
ROW_TILE = 8
LANE_TILE = 128


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def padded_shape(ny: int, nx: int) -> tuple[int, int]:
    """The canonical padded extent of a logical ``(ny, nx)`` grid."""
    return _up(ny, ROW_TILE), _up(nx, LANE_TILE)


def pad_array(a, ny_p: int | None = None, nx_p: int | None = None,
              fill=0):
    """Pad the trailing two dims of ``a`` to ``(ny_p, nx_p)`` (defaults:
    the canonical padded shape) with ``fill``."""
    ny, nx = a.shape[-2:]
    dny, dnx = padded_shape(ny, nx)
    ny_p = dny if ny_p is None else ny_p
    nx_p = dnx if nx_p is None else nx_p
    if (ny_p, nx_p) == (ny, nx):
        return a
    widths = [(0, 0)] * (a.ndim - 2) + [(0, ny_p - ny), (0, nx_p - nx)]
    return jnp.pad(a, widths, constant_values=fill)


def pad_field(f: Field, ny_p: int | None = None,
              nx_p: int | None = None) -> Field:
    """Pad a Field to the canonical layout: values 0, mask ``False``."""
    return Field(pad_array(f.values, ny_p, nx_p),
                 pad_array(f.mask, ny_p, nx_p))


def padded_shape_sharded(ny: int, nx: int, gy: int = 1,
                         gx: int = 1) -> tuple[int, int]:
    """Global padded extent for a ``(gy, gx)``-decomposed grid such that
    every shard's *local* block is tile-aligned: ``ny_p/gy % 8 == 0`` and
    ``nx_p/gx % 128 == 0``."""
    return (_up(-(-ny // gy), ROW_TILE) * gy,
            _up(-(-nx // gx), LANE_TILE) * gx)


def trim_array(a, ny: int, nx: int):
    """Slice the trailing two dims back to the logical ``(ny, nx)``."""
    if a.shape[-2:] == (ny, nx):
        return a
    return a[..., :ny, :nx]


def trim_field(f: Field, ny: int, nx: int) -> Field:
    return Field(trim_array(f.values, ny, nx), trim_array(f.mask, ny, nx))
