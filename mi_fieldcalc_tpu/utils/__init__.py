"""Observability utilities: profiling traces and HBM-roofline accounting.

The reference library has no tracing/profiling subsystem at all (SURVEY
§5) — its only perf affordance is a 719x929 bit-exactness canary.  This
framework adds ``jax.profiler`` trace capture, a per-op memory-roofline
model to judge "are we at speed-of-light", and the persistent compile
cache location (:mod:`.compile_cache`).
"""

from .profiling import trace, Roofline, roofline_for_op, device_hbm_gbps  # noqa: F401
