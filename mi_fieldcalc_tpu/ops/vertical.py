"""Vertical interpolation: hybrid/model levels -> pressure or height levels.

The reference library has no vertical interpolation (its operators act on
one level at a time; callers interpolate elsewhere).  The framework's
flagship workload (BASELINE.json config 4: "hybrid/pressure level
interpolation + derived fields over a 137-level column stack") needs it
as a first-class, mask-aware batched op, so it is built here as
vectorized array code:

* the per-column bracket search over a monotone pressure profile is a
  fused compare-count along the (small) level axis — no gathers, no
  data-dependent control flow; XLA keeps it one elementwise loop,
* level selection is a one-hot masked reduction along the level axis
  (exact: one term contributes per lane),
* interpolation is linear in ln(p) (the meteorological standard for
  temperature/geopotential) or linear in p, chosen at trace time,
* undef semantics: a target level is defined where both bracketing model
  levels are defined and the target pressure is inside the column's
  range; everything else is masked out (no extrapolation — matching the
  conservative behavior of operational post-processing).

Shapes: field ``[nlev, ny, nx]`` (+ leading batch dims are not supported
here — vmap over them), pressure ``[nlev, ny, nx]`` monotone increasing
along axis 0 (model top first, surface last — the hybrid-coefficient
convention of ``hlevelpressure``), targets ``[ntarget]`` static.
"""

from __future__ import annotations

from typing import Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..field import Field
from ._harness import require

__all__ = ["plevel_interp", "hlevel_to_plevel"]

_f32 = jnp.float32


def _interp_one(fv, fm, pv, pm, lnp, pt, log_p):
    """Interpolate one target pressure ``pt`` (traced scalar) from columns.

    ``fv/fm``: [nlev, ny, nx] values/mask(int32); ``pv``: pressures;
    ``lnp``: precomputed ln(pv).  Returns (out, mask_bool) of [ny, nx].
    Vmapped over a target vector by :func:`plevel_interp` — one compact
    batched program instead of ``ntargets`` unrolled reductions.
    """
    nlev = fv.shape[0]
    ptf = jnp.asarray(pt, _f32)
    # bracket index k = (#levels with p <= pt) - 1, clipped to a valid
    # interior bracket; separately track in-range-ness
    below = (pv <= ptf).astype(jnp.int32)
    cnt = jnp.sum(below, axis=0)
    k = jnp.clip(cnt - 1, 0, nlev - 2)
    in_range = (cnt >= 1) & (cnt <= nlev - 1)

    # one-hot select of the bracketing levels (k and k+1)
    lev = jax.lax.broadcasted_iota(jnp.int32, fv.shape, 0)
    sel0 = (lev == k[None]).astype(_f32)
    sel1 = (lev == (k + 1)[None]).astype(_f32)

    def pick(arr, sel):
        return jnp.sum(arr * sel, axis=0)

    f0, f1 = pick(fv, sel0), pick(fv, sel1)
    m0 = jnp.sum(fm * sel0.astype(jnp.int32), axis=0)
    m1 = jnp.sum(fm * sel1.astype(jnp.int32), axis=0)
    pm0 = jnp.sum(pm * sel0.astype(jnp.int32), axis=0)
    pm1 = jnp.sum(pm * sel1.astype(jnp.int32), axis=0)
    if log_p:
        x0, x1, xt = pick(lnp, sel0), pick(lnp, sel1), jnp.log(ptf)
    else:
        x0, x1, xt = pick(pv, sel0), pick(pv, sel1), ptf
    denom = x1 - x0
    w = (xt - x0) / jnp.where(denom != 0, denom, _f32(1))
    out = f0 + (f1 - f0) * w
    mask = in_range & (m0 != 0) & (m1 != 0) & (pm0 != 0) & (pm1 != 0) \
        & (denom != 0)
    return out, mask


def plevel_interp(f: Field, p: Field, targets: Sequence[float],
                  log_p: bool = True) -> Field:
    """Interpolate ``f`` from model levels to constant-pressure surfaces.

    Args:
      f: ``[nlev, ny, nx]`` Field on model levels.
      p: per-point pressure Field, monotone increasing along axis 0.
      targets: static target pressures (hPa), any order.
      log_p: interpolate linearly in ln(p) (default) or in p.

    Returns a ``[len(targets), ny, nx]`` Field; out-of-column targets and
    points with undefined bracketing levels are masked out.
    """
    require(f.values.ndim == 3, "plevel_interp: field must be [nlev, ny, nx]")
    require(f.values.shape == p.values.shape,
            "plevel_interp: field/pressure shape mismatch")
    require(len(targets) >= 1, "plevel_interp: no targets")
    fv = f.values
    fm = f.mask.astype(jnp.int32)
    pv = p.values
    pmask = p.mask.astype(jnp.int32)
    # ln(p) guarded against non-positive garbage at masked points
    lnp = jnp.log(jnp.where(pv > 0, pv, _f32(1.0)))

    tgt = jnp.asarray([float(t) for t in targets], _f32)
    # vmap over targets: batched level reductions (chip_smoke.py prints
    # the compile time at operational shapes)
    out, mask = jax.vmap(
        lambda pt: _interp_one(fv, fm, pv, pmask, lnp, pt, log_p))(tgt)
    return Field(out, mask)


def hlevel_to_plevel(f: Field, ps: Field, alevel, blevel,
                     targets: Sequence[float], log_p: bool = True) -> Field:
    """Hybrid-level field -> pressure levels: builds the per-point hybrid
    pressure ``p = alevel + blevel * ps`` (hlevelpressure,
    FieldCalculations.cc:1276-1304) and interpolates to ``targets``."""
    nlev = f.values.shape[0]
    a = jnp.asarray(alevel, _f32).reshape(nlev, 1, 1)
    b = jnp.asarray(blevel, _f32).reshape(nlev, 1, 1)
    pv = a + b * ps.values[None]
    pm = jnp.broadcast_to(ps.mask[None], f.values.shape)
    return plevel_interp(f, Field(pv, pm), targets, log_p=log_p)
