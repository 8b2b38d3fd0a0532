"""Ensemble-member reductions.

Reference: FieldCalculations.cc — sumFields (2671), meanValue (2696),
stddevValue (2726), extremeValue (2759), probability (2807).

Members are stacked on a leading axis (``member`` first), so every
reduction is a masked reduce along axis 0 — the vectorized form of the
reference's per-point member loops.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from ..field import Field, ValuesDefined
from ._harness import out_field, require

__all__ = ["sum_fields", "mean_value", "stddev_value", "extreme_value",
           "probability"]

_f32 = jnp.float32


def _stack(members: Sequence[Field]) -> Field:
    if isinstance(members, Field):
        return members
    return Field(jnp.stack([m.values for m in members]),
                 jnp.stack([m.mask for m in members]))


def _apply_member_flags(s: Field, member_defined) -> Field:
    """Reference fast-path semantics for per-member ``fDefinedIn`` flags:
    a member flagged ALL_DEFINED skips the per-point ``is_defined`` check
    entirely (``is_defined(fDefinedIn[j] == ALL_DEFINED, v, undef)``,
    e.g. FieldCalculations.cc:2710) — its sentinel values, if the flag
    lies, are treated as real data.  Flags are trace-time static."""
    if member_defined is None:
        return s
    import numpy as _np
    flags = _np.asarray([int(d) == int(ValuesDefined.ALL_DEFINED)
                         for d in member_defined], bool)
    flags = flags.reshape((-1,) + (1,) * (s.mask.ndim - 1))
    return Field(s.values, s.mask | jnp.asarray(flags))


def sum_fields(members) -> Field:
    """Pointwise sum over members; undefined wherever any member is
    (FieldCalculations.cc:2671-2694)."""
    s = _stack(members)
    vals = jnp.sum(jnp.where(s.mask, s.values, _f32(0)), axis=0)
    mask = jnp.all(s.mask, axis=0)
    return Field(vals, mask)


def mean_value(members, member_defined=None) -> Field:
    """Pointwise mean over *defined* members; denominator is the per-point
    defined count (FieldCalculations.cc:2696-2724).  ``member_defined``:
    optional per-member tri-state flags (:func:`_apply_member_flags`)."""
    s = _apply_member_flags(_stack(members), member_defined)
    n = jnp.sum(s.mask, axis=0)
    total = jnp.sum(jnp.where(s.mask, s.values, _f32(0)), axis=0)
    some = n > 0
    out = total / jnp.where(some, n, 1).astype(_f32)
    return out_field(out, some)


def stddev_value(members, member_defined=None) -> Field:
    """Pointwise population standard deviation over defined members
    (FieldCalculations.cc:2726-2757).  The reference uses a per-point
    Welford recurrence; this uses the numerically equivalent two-pass
    masked form (float ordering differs at the ulp level).
    ``member_defined``: optional per-member tri-state flags
    (:func:`_apply_member_flags`)."""
    s = _apply_member_flags(_stack(members), member_defined)
    n = jnp.sum(s.mask, axis=0)
    some = n > 0
    nf = jnp.where(some, n, 1).astype(_f32)
    mean = jnp.sum(jnp.where(s.mask, s.values, _f32(0)), axis=0) / nf
    d = s.values - mean[None]
    m2 = jnp.sum(jnp.where(s.mask, d * d, _f32(0)), axis=0)
    return out_field(jnp.sqrt(m2 / nf), some)


def extreme_value(compute: int, members) -> Field:
    """Max/min value or arg-index over members
    (FieldCalculations.cc:2759-2805).  compute: 1 max value, 2 min value,
    3 max index, 4 min index.

    Reproduces the reference's sequential tracking semantics exactly,
    including the quirk that in index mode (3/4) an all-undefined point
    yields index ``n_members - 1`` *marked defined* (the sentinel-compare
    tracking at cc:2789-2801 never flags it undefined).
    """
    require(compute in (1, 2, 3, 4), f"extremeValue: bad compute {compute}")
    s = _stack(members)
    n_members = s.values.shape[0]
    require(n_members > 0, "extremeValue: no fields")
    want_max = compute in (1, 3)

    shape = s.values.shape[1:]

    def body(j, state):
        cur, cur_def, idx = state
        vj = s.values[j]
        mj = s.mask[j]
        better = (vj > cur) if want_max else (vj < cur)
        take = (~cur_def) | (mj & better)
        return (jnp.where(take, vj, cur),
                jnp.where(take, mj, cur_def),
                jnp.where(take, j.astype(_f32), idx))

    # fori_loop, not an unrolled Python loop: real ensembles run 15-51
    # members and unrolled graphs compile catastrophically slowly on the
    # remote compiler (CLAUDE.md loop rule)
    cur, cur_def, idx = jax.lax.fori_loop(
        0, n_members, body,
        (jnp.zeros(shape, _f32), jnp.zeros(shape, bool),
         jnp.zeros(shape, _f32)))

    if compute in (1, 2):
        return Field(cur, cur_def)
    # index mode: always defined (reference quirk, see docstring)
    return Field(idx, jnp.ones(shape, bool))


def probability(compute: int, members, limits: Sequence[float],
                member_defined: Optional[Sequence[ValuesDefined]] = None,
                member_defined_mask=None) -> Field:
    """Ensemble probability / count of values above/below/between limits
    (FieldCalculations.cc:2807-2860).

    compute: 1 above %, 2 below %, 3 between %, 4/5/6 same as counts.

    Reference semantics pinned by FieldCalculationsTest.cc:225-305: the
    denominator counts members whose *whole-field* flag is not
    NONE_DEFINED, even if the member's value at this point is undefined —
    per-point undefs lower the probability instead of shrinking the
    denominator.  ``member_defined`` supplies those flags as static
    Python values; ``member_defined_mask`` supplies them as a TRACED
    ``[nmem]`` bool array instead — the whole-field flag is a *global*
    decision, so spatially sharded callers must reduce it across shards
    (``lax.pmax`` over the mesh axes; parallel/fused.py
    ensemble_summary_sharded) rather than let the default per-shard
    ``any`` diverge between shards.  If both are omitted the flags are
    derived from each member's mask (``any`` reduction over this
    call's view of the field).
    """
    s = _stack(members)
    n_members = s.values.shape[0]
    lsize = len(limits)
    check_between = lsize >= 2 and compute in (3, 6)
    check_above = lsize >= 1 and (compute in (1, 4) or check_between)
    check_below = lsize >= 1 and (compute in (2, 5) or check_between)
    require(check_above or check_below,
            "probability: bad compute/limits combination")
    value_above = _f32(limits[0])
    value_below = _f32(limits[1]) if check_between else _f32(limits[0])

    passes = s.mask
    if check_above:
        passes = passes & (s.values > value_above)
    if check_below:
        passes = passes & (s.values < value_below)

    require(member_defined is None or member_defined_mask is None,
            "probability: pass member_defined or member_defined_mask, "
            "not both")
    if member_defined is not None:
        counted = [int(d) != int(ValuesDefined.NONE_DEFINED)
                   for d in member_defined]
        nfields_defined = jnp.asarray(sum(counted), jnp.int32)
        member_sel = jnp.asarray(counted, bool)
        passes = passes & member_sel.reshape((-1,) + (1,) * (s.values.ndim - 1))
    elif member_defined_mask is not None:
        member_sel = jnp.asarray(member_defined_mask).astype(bool)
        require(member_sel.ndim == 1,
                "probability: member_defined_mask must be a [nmem] vector")
        nfields_defined = jnp.sum(member_sel).astype(jnp.int32)
        passes = passes & member_sel.reshape((-1,) + (1,) * (s.values.ndim - 1))
    else:
        axes = tuple(range(1, s.mask.ndim))
        member_any = jnp.any(s.mask, axis=axes)
        from .stencil import _SHARD_CTX
        ctx = _SHARD_CTX.get()
        if ctx is not None and ctx.mesh_axes:
            # the whole-field flag is a GLOBAL decision — reduce across
            # spatial shards or the denominators diverge per shard
            member_any = jax.lax.pmax(member_any.astype(jnp.int32),
                                      ctx.mesh_axes) != 0
        nfields_defined = jnp.sum(member_any).astype(jnp.int32)
        passes = passes & member_any.reshape((-1,) + (1,) * (s.values.ndim - 1))

    count = jnp.sum(passes, axis=0).astype(_f32)
    some = nfields_defined > 0
    if compute < 4:
        # count / (n/100) evaluated as count*100/n: exact in f32 for small
        # counts, matching the reference's double-precision division
        out = count * _f32(100.0) \
            / jnp.where(some, nfields_defined, 1).astype(_f32)
    else:
        out = count
    return out_field(out, jnp.broadcast_to(some, count.shape))
