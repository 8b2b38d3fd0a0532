"""Ensemble post-processing pipeline.

The reference exposes per-point ensemble reductions (meanValue,
stddevValue, probability — FieldCalculations.cc:2696-2860) that callers
chain per member and per level on the CPU.  Here it is one
jitted program over a ``[nmem, nlev, ny, nx]`` member stack:

* the full derived-field pipeline runs per member via ``vmap`` (one
  compiled body, batched — not nmem program dispatches),
* the ensemble summary (mean, spread, exceedance probabilities) reduces
  along the member axis with the reference's semantics: mean/stddev
  denominators count *defined members per point*
  (FieldCalculations.cc:2706-2719), probability denominators count
  members whose whole-field flag is defined (cc:2840-2847),
* everything fuses: member fields never round-trip HBM between the
  pipeline and the reductions.

Sharding: :func:`..parallel.fused.ensemble_summary_sharded` —
spatial (gy, gx) decomposition with the member axis local; the
probability denominators' whole-field member flags are reduced across
shards, so every shard sees the reference's global decision.
"""

from __future__ import annotations

from typing import NamedTuple

import jax

from ..field import Field
from ..ops import mean_value, stddev_value, probability
from .pipeline import DerivedFields, derived_fields

__all__ = ["EnsembleSummary", "ensemble_derived_summary", "summarize"]


class EnsembleSummary(NamedTuple):
    """Per-quantity ensemble statistics (Fields of ``[nlev, ny, nx]``)."""
    mean: DerivedFields       # ensemble mean of each derived field
    spread: DerivedFields     # ensemble (population) standard deviation
    prob_wind: Field          # P(wind speed > wind_limit) in %
    prob_t_freeze: Field      # P(temperature advection cools below 0) in %


def ensemble_derived_summary(tk: Field, q: Field, u: Field, v: Field,
                             ps: Field, alevel: jax.Array,
                             blevel: jax.Array, xmapr: jax.Array,
                             ymapr: jax.Array, fcoriolis: jax.Array,
                             wind_limit: float = 15.0) -> EnsembleSummary:
    """Derived fields per member + ensemble statistics, one program.

    Args:
      tk, q, u, v: ``[nmem, nlev, ny, nx]`` member-stacked Fields.
      ps: ``[nmem, ny, nx]`` member-stacked surface pressure.
      alevel..fcoriolis: as :func:`..models.derived_fields` (shared by
        all members).
      wind_limit: exceedance threshold (m/s) for the wind probability.

    Returns an :class:`EnsembleSummary`; the mean/spread cover all 12
    derived fields, probabilities are computed for wind speed and for
    1-hour temperature advection below 0 (cooling).
    """
    per_member = jax.vmap(
        lambda tkm, qm, um, vm, psm: derived_fields(
            tkm, qm, um, vm, psm, alevel, blevel, xmapr, ymapr,
            fcoriolis))
    return summarize(per_member(tk, q, u, v, ps), float(wind_limit))


def summarize(out: DerivedFields, wind_limit: float) -> EnsembleSummary:
    """The ensemble statistics of member-stacked derived fields (Fields
    of ``[nmem, nlev, ny, nx]``)."""
    mean = DerivedFields(*[mean_value(f) for f in out])
    spread = DerivedFields(*[stddev_value(f) for f in out])
    prob_wind = probability(1, out.wspeed, (wind_limit,))
    prob_t_freeze = probability(2, out.tadv, (0.0,))
    return EnsembleSummary(mean=mean, spread=spread, prob_wind=prob_wind,
                           prob_t_freeze=prob_t_freeze)
