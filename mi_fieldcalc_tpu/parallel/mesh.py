"""Device-mesh construction for grid domain decomposition.

Axis convention:

* ``"lev"`` — batch parallelism over leading dims (vertical level,
  ensemble member, time step).  Embarrassingly parallel; no communication.
* ``"gy"`` / ``"gx"`` — spatial decomposition of the trailing ``(ny, nx)``
  grid axes.  Stencil operators need halo exchange along these
  (:mod:`mi_fieldcalc_tpu.parallel.halo`).

The mesh is built in plain device order: the GPUs of a host are joined
all to all (NVLink), so every card reaches every other at the same rate
and the layout follows the decomposition alone.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec

__all__ = ["grid_mesh", "partition_spec", "factor_devices",
           "factor_devices_for_grid"]

AXES = ("lev", "gy", "gx")


def factor_devices(n: int) -> Tuple[int, int, int]:
    """Factor ``n`` devices into a (lev, gy, gx) mesh shape: all devices on
    a square-ish (gy, gx) spatial grid (minimises halo surface per shard)."""
    gy = int(np.sqrt(n))
    while n % gy:
        gy -= 1
    return (1, gy, n // gy)


def factor_devices_for_grid(ny: int, nx: int, n: int) -> Tuple[int, int, int]:
    """Factor ``n`` devices into the (1, gy, gx) spatial mesh that wastes
    the least device memory/bandwidth on a logical ``(ny, nx)`` grid under
    the canonical padded layout.

    Every shard's local block is padded to (8-row, 128-lane) tiles
    (layout.padded_shape_sharded), so deep 1-D decompositions go
    progressively dead: at 128 chips on the 0.25-degree grid gy=128 pads
    721 -> 1024 rows (live fraction 0.66) while (gy, gx) = (32, 4) stays
    at 0.88 and streams 25% fewer bytes per chip (PERF.md "2-D (gy, gx)
    decomposition").  This picks the divisor pair minimising padded
    points among the pairs the fused sharded pipeline can actually run
    (fused._require_local_rows needs >= 8 CARRIED rows per gy shard:
    with unpadded carriage — only possible when ``ny % gy == 0`` —
    that means ``ny // gy >= 8``; padded carriage always satisfies it
    because local blocks round up to 8-row tiles); pairs violating that
    are considered only when no divisor pair satisfies it (the jnp
    ``run_sharded`` path has no such constraint).  Ties break toward
    fewer gx shards (x-halos are 2 lanes of every row and lanes are the
    scarce axis; y-halos ride 8-row tiles)."""
    from ..layout import padded_shape_sharded

    candidates = []
    for gx in range(1, n + 1):
        if n % gx:
            continue
        gy = n // gx
        if gy > ny or gx > nx:
            continue
        ny_p, nx_p = padded_shape_sharded(ny, nx, gy, gx)
        fused_ok = gy == 1 or ny % gy != 0 or ny // gy >= 8
        candidates.append(((not fused_ok, ny_p * nx_p, gx), (1, gy, gx)))
    if not candidates:
        raise ValueError(f"cannot decompose {ny}x{nx} over {n} devices")
    return min(candidates)[1]


def grid_mesh(mesh_shape: Optional[Sequence[int]] = None,
              devices=None,
              axis_names: Sequence[str] = AXES,
              grid_shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """Create a device mesh for grid decomposition.

    ``mesh_shape`` defaults to putting all devices on a square-ish
    (gy, gx) spatial grid with lev=1; pass the logical ``grid_shape``
    ``(ny, nx)`` instead to pick the (gy, gx) split that minimises the
    canonical padded footprint (:func:`factor_devices_for_grid` — at
    64+ chips on the global 0.25-degree grid this streams 25% fewer
    bytes per chip than either 1-D or square-ish splits, PERF.md).
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if mesh_shape is None:
        if grid_shape is not None:
            mesh_shape = factor_devices_for_grid(*grid_shape, n)
        else:
            mesh_shape = factor_devices(n)
    elif grid_shape is not None:
        raise ValueError("pass mesh_shape or grid_shape, not both")
    mesh_shape = tuple(mesh_shape)
    if int(np.prod(mesh_shape)) != n:
        raise ValueError(f"mesh shape {mesh_shape} != {n} devices")
    names = tuple(axis_names)
    if len(mesh_shape) < len(names):
        # shorter shapes drop axes from the FRONT of ("lev","gy","gx"):
        # a 2-element shape is the intuitive (gy, gx) SPATIAL mesh, a
        # 1-element shape a gy row split — truncating from the front
        # would silently read (2, 4) as lev=2 batch + gy=4 and leave nx
        # undecomposed with half the machine doing duplicate work
        names = names[len(names) - len(mesh_shape):]
    # plain device order: the cards of a host are joined all to all, so
    # the mesh follows the decomposition alone
    dev_array = np.asarray(devices).reshape(mesh_shape)
    return Mesh(dev_array, names)


def partition_spec(ndim: int, mesh: Mesh) -> PartitionSpec:
    """PartitionSpec for framework arrays on ``mesh``.

    ``[..., ny, nx]`` grids map trailing axes to (gy, gx) and the leading
    axis (if 3-D+) to ``lev``; 1-D arrays are per-level coefficient vectors
    (hybrid alevel/blevel) and shard over ``lev`` so they stay aligned with
    a lev-sharded grid's leading axis; scalars replicate.
    """
    names = mesh.axis_names
    gy = "gy" if "gy" in names else None
    gx = "gx" if "gx" in names else None
    lev = "lev" if "lev" in names else None
    if ndim == 0:
        return PartitionSpec()
    if ndim == 1:
        return PartitionSpec(lev)
    spec = [None] * ndim
    spec[-2] = gy
    spec[-1] = gx
    if ndim > 2:
        spec[0] = lev
    return PartitionSpec(*spec)
