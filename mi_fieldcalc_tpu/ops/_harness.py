"""Small helpers shared by all operator modules.

The reference library signals invalid *parameters* by returning ``false``
from every operator (e.g. FieldCalculations.cc:419, 477).  Parameters are
static Python values here, so the equivalent is a trace-time
:class:`ValueError` raised by :func:`require`; the drop-in compat layer
(:mod:`mi_fieldcalc_tpu.api`) converts that back into the reference's
``None`` / ``False`` convention.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..field import Field

__all__ = ["require", "and_masks", "out_field"]


def require(cond: bool, message: str) -> None:
    """Trace-time parameter validation (reference: ``return false``)."""
    if not cond:
        raise ValueError(message)


def and_masks(*fields_or_masks):
    """Combined definedness of several inputs (the ``is_defined(a, b, ...)``
    predicates, FieldCalculations.h:42-98) as one fused AND."""
    m = None
    for f in fields_or_masks:
        fm = f.mask if isinstance(f, Field) else f
        m = fm if m is None else (m & fm)
    return m


def out_field(values, mask) -> Field:
    """Build an output Field, broadcasting the mask to the value shape."""
    values = jnp.asarray(values)
    mask = jnp.broadcast_to(jnp.asarray(mask, bool), values.shape)
    return Field(values, mask)
