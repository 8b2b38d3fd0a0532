"""Core Field type: mask-based missing-value semantics.

The reference library (mi-fieldcalc) threads a missing-value sentinel
(``undef``, default 1e35 — src/mi_fieldcalc/FieldDefined.cc:34) plus a
tri-state ``ValuesDefined`` flag (FieldDefined.h:41) through every operator,
and re-checks every point with ``is_defined`` predicates
(FieldCalculations.h:42-98).

On an accelerator, branches per point are poison; the idiomatic design is an explicit
boolean mask carried next to the values ("mask lanes, not branches").  A
:class:`Field` is a pytree of

* ``values`` — ``float32[..., ny, nx]`` (leading dims batch over level /
  ensemble / time); the value at masked-out points is *unspecified*,
* ``mask``   — ``bool[..., ny, nx]``; ``True`` where the point is defined.

The sentinel representation only exists at the boundary:
:func:`from_sentinel` / :meth:`Field.to_sentinel` convert, mirroring the
reference predicate ``is_defined(v, undef) = !isnan(v) && v != undef``
(FieldCalculations.h:42-45).

The tri-state flag maps to :func:`defined_state` (a reduction over the
mask, equivalent to ``checkDefined`` FieldDefined.cc:41-70) and
:func:`combine_defined` (FieldDefined.cc:72-83).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "UNDEF",
    "ValuesDefined",
    "Field",
    "from_sentinel",
    "from_values",
    "full_undef",
    "defined_state",
    "defined_counts",
    "combine_defined",
]

#: Default missing-value sentinel, identical to ``miutil::UNDEF``
#: (FieldDefined.cc:34).
UNDEF: float = 1.0e35


class ValuesDefined(enum.IntEnum):
    """Tri-state definedness summary (FieldDefined.h:41)."""

    ALL_DEFINED = 0
    NONE_DEFINED = 1
    SOME_DEFINED = 2


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Field:
    """A gridded value array plus its definedness mask.

    ``values`` and ``mask`` always have identical shape.  The trailing two
    axes are the horizontal grid ``(ny, nx)`` — note this is C-order
    ``[y, x]``, matching the reference's x-fastest flat layout
    (``i = x + y*nx``).
    """

    values: jax.Array
    mask: jax.Array

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        return (self.values, self.mask), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        values, mask = children
        return cls(values, mask)

    # -- convenience -------------------------------------------------------
    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype

    def to_sentinel(self, undef: float = UNDEF) -> jax.Array:
        """Materialize the sentinel representation (boundary codec)."""
        return jnp.where(self.mask, self.values, jnp.asarray(undef, self.values.dtype))

    def sanitized(self, fill: Union[float, jax.Array] = 0.0) -> jax.Array:
        """Values with masked-out points replaced by a numerically safe fill.

        Use before transcendental kernels so garbage at undefined points
        cannot produce inf/nan that slows down or poisons vector lanes.
        """
        return jnp.where(self.mask, self.values, jnp.asarray(fill, self.values.dtype))

    def defined_state(self) -> ValuesDefined:
        """Tri-state summary; forces a host sync (use sparingly)."""
        return defined_state(self.mask)

    def to_numpy(self, undef: float = UNDEF) -> np.ndarray:
        return np.asarray(self.to_sentinel(undef))


def from_sentinel(values, undef: float = UNDEF, dtype=jnp.float32) -> Field:
    """Decode a sentinel-encoded array into a :class:`Field`.

    Mirrors ``fieldcalc::is_defined`` (FieldCalculations.h:42-45):
    a point is defined iff it is not NaN and not equal to ``undef``.
    """
    v = jnp.asarray(values, dtype)
    mask = jnp.logical_not(jnp.isnan(v)) & (v != jnp.asarray(undef, dtype))
    return Field(v, mask)


def from_values(values, mask=None, dtype=jnp.float32) -> Field:
    """Wrap an all-defined (or explicitly masked) array as a Field."""
    v = jnp.asarray(values, dtype)
    if mask is None:
        mask = jnp.ones(v.shape, dtype=bool)
    else:
        mask = jnp.broadcast_to(jnp.asarray(mask, bool), v.shape)
    return Field(v, mask)


def full_undef(shape, dtype=jnp.float32) -> Field:
    """An all-undefined field (``fillUndef``, FieldCalculations.cc:76-82)."""
    return Field(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype=bool))


def defined_counts(mask):
    """Jit-safe definedness summary: ``(n_defined, n_total)`` as scalars.

    The traced counterpart of :func:`defined_state` (``checkDefined``,
    FieldDefined.cc:41-70) for use *inside* pipelines: compare
    ``n_defined`` against 0 / ``n_total`` with lane selects instead of
    host branches (see ``cvtemp``'s auto-detect for the pattern).  Under
    ``shard_map`` the sum is per-shard; combine across a mesh axis with
    ``jax.lax.psum(n_def, axis_name)`` — the multi-chip equivalent of the
    reference's serial ``n_undefined`` reduction.
    """
    m = jnp.asarray(mask)
    return jnp.sum(m, dtype=jnp.int32), jnp.int32(np.prod(m.shape or (1,)))


def defined_state(mask) -> ValuesDefined:
    """``checkDefined`` (FieldDefined.cc:41-70) over a mask array.

    Host-synchronizing; intended for API-boundary use and tests, not for
    inside jitted pipelines (use :func:`defined_counts` there).
    """
    n_def = int(jnp.sum(mask))
    n = int(np.prod(np.asarray(mask.shape))) if mask.shape else 1
    if n_def == n:
        return ValuesDefined.ALL_DEFINED
    if n_def == 0:
        return ValuesDefined.NONE_DEFINED
    return ValuesDefined.SOME_DEFINED


def combine_defined(a: ValuesDefined, b: ValuesDefined) -> ValuesDefined:
    """``combineDefined`` (FieldDefined.cc:72-83)."""
    if a == ValuesDefined.ALL_DEFINED:
        return b
    if a == ValuesDefined.NONE_DEFINED:
        return ValuesDefined.NONE_DEFINED
    # SOME_DEFINED
    return b if b != ValuesDefined.ALL_DEFINED else ValuesDefined.SOME_DEFINED
