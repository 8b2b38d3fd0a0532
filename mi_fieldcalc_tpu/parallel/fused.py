"""Sharded execution of the isobaric and ensemble pipelines.

Both run their jnp form per shard through
:func:`..parallel.halo.run_sharded` (radius-2 halo rings; XLA hands the
``ppermute`` collectives to NCCL), as the hybrid-level pipeline does
(``run_sharded(derived_fields, mesh, RADIUS, ...)``).  Columns and the
member axis stay local, so both need ``lev == 1``.  Equivalence with the
unsharded paths is tested on a virtual CPU mesh in
tests/test_parallel_fused.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..field import Field

__all__ = ["derived_fields_isobaric_sharded", "ensemble_summary_sharded"]

#: Composed stencil radius of the pipeline (TFP through |grad T|).
RADIUS = 2


def _spatial(mesh: Mesh):
    names = mesh.axis_names
    return (mesh.shape["gy"] if "gy" in names else 1,
            mesh.shape["gx"] if "gx" in names else 1)


def _require_local_rows(mesh: Mesh, ny: int, nx: int):
    """Each shard must hold at least the halo radius plus one row and
    column of its own."""
    gy, gx = _spatial(mesh)
    if ny // gy <= RADIUS or nx // gx <= RADIUS:
        raise ValueError(
            f"sharded pipeline needs more than {RADIUS} local rows and "
            f"columns per shard: ({ny}, {nx}) over (gy={gy}, gx={gx})")


def _maps(a, ny, nx):
    return jnp.broadcast_to(jnp.asarray(a, jnp.float32), (ny, nx))


def derived_fields_isobaric_sharded(mesh: Mesh, tk: Field, q: Field,
                                    u: Field, v: Field, ps: Field,
                                    alevel, blevel, xmapr, ymapr, fcoriolis,
                                    plevels):
    """Sharded 3-D isobaric pipeline: hybrid -> pressure-level
    interpolation followed by the 12 derived fields, domain-decomposed
    over ``mesh`` with :func:`..parallel.halo.run_sharded`.  Columns
    never cross the (gy, gx) decomposition;
    level parallelism does not apply (columns span all levels), so the
    mesh must have ``lev == 1``.

    Arguments as :func:`..models.pipeline.derived_fields_isobaric`.
    Returns a sharded :class:`DerivedFields` on the ``plevels`` stack.
    """
    if dict(mesh.shape).get("lev", 1) != 1:
        raise ValueError("isobaric sharding needs lev == 1 (columns span "
                         "all model levels)")
    ny, nx = tk.values.shape[-2:]
    _require_local_rows(mesh, ny, nx)
    return _isobaric_sharded_fn(mesh, tuple(float(t) for t in plevels))(
        tk, q, u, v, ps, alevel, blevel, _maps(xmapr, ny, nx),
        _maps(ymapr, ny, nx), _maps(fcoriolis, ny, nx))


@functools.lru_cache(maxsize=64)
def _isobaric_sharded_fn(mesh: Mesh, plevels):
    from ..models.pipeline import derived_fields_isobaric
    from .halo import run_sharded
    op = functools.partial(derived_fields_isobaric, plevels=plevels)
    return jax.jit(lambda *a: run_sharded(op, mesh, RADIUS, *a))


def ensemble_summary_sharded(mesh: Mesh, tk: Field, q: Field, u: Field,
                             v: Field, ps: Field, alevel, blevel,
                             xmapr, ymapr, fcoriolis,
                             wind_limit: float = 15.0):
    """Sharded ensemble pipeline: per-member derived fields + ensemble
    summary, spatially decomposed over ``mesh``.

    Inputs as :func:`..models.ensemble.ensemble_derived_summary`
    (``[nmem, nlev, ny, nx]`` member stacks, ``[nmem, ny, nx]`` surface
    pressure).  The member pipelines run per shard through
    :func:`..parallel.halo.run_sharded`; the summary reduces the sharded
    member stacks in the same jitted program, so XLA reduces the
    probability denominators' whole-field member flags across shards —
    the reference's flag is a whole-field decision
    (FieldCalculations.cc:2840-2847), and a per-shard ``any`` would
    diverge between shards whose subdomain sees no defined point of a
    member.  The mesh must have ``lev == 1`` (the member axis stays
    local).
    """
    if dict(mesh.shape).get("lev", 1) != 1:
        raise ValueError("ensemble sharding needs lev == 1 (the member "
                         "axis stays local; spatial axes shard)")
    ny, nx = tk.values.shape[-2:]
    _require_local_rows(mesh, ny, nx)
    return _ensemble_sharded_fn(mesh, float(wind_limit))(
        tk, q, u, v, ps, jnp.asarray(alevel, jnp.float32),
        jnp.asarray(blevel, jnp.float32), _maps(xmapr, ny, nx),
        _maps(ymapr, ny, nx), _maps(fcoriolis, ny, nx))


@functools.lru_cache(maxsize=64)
def _ensemble_sharded_fn(mesh: Mesh, wind_limit: float):
    from ..models.ensemble import summarize
    from ..models.pipeline import derived_fields
    from .halo import run_sharded

    def members(tk, q, u, v, ps, al, bl, xm, ym, fc):
        return jax.vmap(lambda *f: derived_fields(*f, al, bl, xm, ym, fc))(
            tk, q, u, v, ps)

    def step(*args):
        return summarize(run_sharded(members, mesh, RADIUS, *args),
                         wind_limit)

    return jax.jit(step)
