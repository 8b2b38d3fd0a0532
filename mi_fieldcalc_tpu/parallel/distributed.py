"""Multi-host runtime: initialization and mesh construction across hosts.

The reference is a single-process library (OpenMP threads only — SURVEY
§2.7); here a run can span processes with the JAX distributed runtime:
every process runs the same program, ``jax.distributed.initialize``
wires them into one global device set, and the ``(lev, gy, gx)`` mesh
from :func:`..parallel.mesh.grid_mesh` then covers every device — the
halo ``ppermute`` rings and definedness reductions are laid out by XLA
with no further code changes.

Typical multi-process entry::

    from mi_fieldcalc_tpu.parallel import distributed, grid_mesh
    distributed.initialize("host0:1234", num_processes=2, process_id=i)
    mesh = grid_mesh(grid_shape=(ny, nx))  # all devices
    out = run_sharded(derived_fields, mesh, RADIUS, *fields)

Per-host I/O: each host feeds only its local shard via
``jax.make_array_from_process_local_data`` (helpers below), so a global
0.25-degree x 137-level grid never has to fit in one host's memory.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["initialize", "is_initialized", "local_shard_array"]

_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the multi-process JAX runtime; a no-op for one process.

    With no arguments nothing is joined (single-process use).  A cluster
    is described explicitly: ``coordinator_address`` (``host:port`` of
    process 0), ``num_processes`` and this ``process_id`` are passed to
    ``jax.distributed.initialize``, and a failure there is raised.
    """
    global _initialized
    if _initialized:
        return
    if (coordinator_address is not None or num_processes is not None
            or process_id is not None):
        import jax
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    _initialized = True


def is_initialized() -> bool:
    return _initialized


def local_shard_array(global_shape: Sequence[int], local_data: np.ndarray,
                      mesh, pspec=None):
    """Assemble a global sharded array from this host's local block.

    ``local_data`` must be exactly this process's shard(s) of the global
    array under ``pspec`` (default: the framework layout from
    :func:`..parallel.mesh.partition_spec`).  Wraps
    ``jax.make_array_from_process_local_data``.
    """
    import jax
    from .mesh import partition_spec

    if pspec is None:
        pspec = partition_spec(len(global_shape), mesh)
    sharding = jax.sharding.NamedSharding(mesh, pspec)
    return jax.make_array_from_process_local_data(
        sharding, np.asarray(local_data), tuple(global_shape))
