"""Multi-chip scaling: device meshes, domain decomposition, halo exchange.

The reference library's only parallelism is OpenMP threads over per-point
loops (openmp_tools.h:42-45); it has no distributed backend at all
(SURVEY §2.7).  Here the equivalent is spatial domain decomposition
of the ``(ny, nx)`` grid over a 2-D device mesh, with radius-R halo rings
exchanged via ``jax.lax.ppermute`` inside ``shard_map``, and the
reference's ``fillEdges`` boundary treatment applied only at *physical*
domain edges — never at shard seams.
"""

from .mesh import (grid_mesh, partition_spec,  # noqa: F401
                   factor_devices_for_grid)
from .halo import halo_exchange, run_sharded  # noqa: F401
from . import distributed  # noqa: F401
