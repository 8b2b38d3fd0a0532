"""The level-conversion suites as one jitted program.

BASELINE config 2 — the humidity/temperature conversion suite on a level
stack — composes many independent pointwise operators over the same
inputs.  :func:`alevel_suite_fused` computes any requested set of the
a-level family (``aleveltemp`` / ``alevelhum`` / ``alevelthe`` /
``alevelducting`` modes) in one jitted program, so XLA fuses the sibling
outputs and shares the saturation-table math between them.
:func:`hlevel_suite_fused` is the hybrid-level form: surface pressure and
per-level coefficients, with the 3-D pressure built inside the program.

The formulas are the ``levels.*`` implementations themselves, so the
suite agrees with per-op calls (tests/test_fused_suite.py, with undefs
and out-of-table temperatures).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..field import Field
from ._harness import and_masks, require
from .levels import (_bad_hlevel, _levelducting_core, _levelhum_core,
                     _levelthe_core, _leveltemp_core, alevelducting,
                     alevelhum, alevelthe, aleveltemp)

__all__ = ["alevel_suite_fused", "hlevel_suite_fused"]

#: valid compute modes per request family.  The humidity split encodes
#: WHICH input each mode consumes (levels.py _levelhum_core: 1/2, 5/6,
#: 9/10 take q; 3/4, 7/8, 11/12 take RH — a/h-level numbering, which
#: differs from plevelhum), so a q-mode in ``hums_rh`` is rejected
#: instead of silently clamping garbage.
_VALID = {"temp": frozenset(range(1, 6)),
          "hum_q": frozenset({1, 2, 5, 6, 9, 10}),
          "hum_rh": frozenset({3, 4, 7, 8, 11, 12}),
          "the": frozenset({1, 2}),
          "duct_q": frozenset({1, 2}),
          "duct_rh": frozenset({3, 4})}


def _build_reqs(name, temps, hums_q, hums_rh, thes, ducts_q, ducts_rh):
    """Validated ``(family, compute)`` request tuple, in argument order."""
    groups = (("temp", temps), ("hum_q", hums_q), ("hum_rh", hums_rh),
              ("the", thes), ("duct_q", ducts_q), ("duct_rh", ducts_rh))
    reqs = []
    for fam, cs in groups:
        for c in cs:
            c = int(c)
            require(c in _VALID[fam],
                    f"{name}: bad {fam} compute {c} "
                    f"(valid: {sorted(_VALID[fam])})")
            reqs.append((fam, c))
    require(len(reqs) >= 1, f"{name}: no conversions requested")
    return tuple(reqs)


def _consumes(reqs):
    """(need_q, need_rh): which optional inputs the request set reads —
    the single source of truth for input pruning (the suites and the
    staging runner both derive from this)."""
    return (any(f in ("hum_q", "the", "duct_q") for f, _ in reqs),
            any(f in ("hum_rh", "duct_rh") for f, _ in reqs))


def _defined(f: Field, all_defined: bool) -> Field:
    """``all_defined``: the caller asserts every point is defined, so the
    mask is never read and XLA folds the ANDs away."""
    if f is None or not all_defined:
        return f
    return Field(f.values, jnp.ones(f.values.shape, bool))


_KW = ("temps", "hums_q", "hums_rh", "thes", "ducts_q", "ducts_rh",
       "all_defined")


@functools.partial(jax.jit, static_argnames=_KW)
def alevel_suite_fused(t: Field, q: Field, rh: Field, p: Field,
                       temps=(), hums_q=(), hums_rh=(),
                       thes=(), ducts_q=(), ducts_rh=(),
                       all_defined: bool = False):
    """All requested a-level conversions in one program.

    Args:
      t: ``[nlev, ny, nx]`` temperature Field (Kelvin for odd computes,
        theta for even — exactly :func:`..ops.levels.aleveltemp` /
        :func:`..ops.levels.alevelhum` semantics per mode).
      q, rh: specific humidity / RH% Fields (an input whose request
        tuples are all empty is never read, so any placeholder works).
      p: pressure Field (hPa).
      temps: tuple of ``aleveltemp`` computes (1-5).
      hums_q: tuple of ``alevelhum`` computes taking ``q`` (1/2, 5/6,
        9/10 — a/h-level numbering; a RH-taking mode here raises).
      hums_rh: tuple of ``alevelhum`` computes taking ``rh`` (3/4, 7/8,
        11/12).
      thes: tuple of ``alevelthe`` computes (1/2; both take ``q``).
      ducts_q / ducts_rh: ``alevelducting`` computes taking ``q``
        (1/2) / ``rh`` (3/4).
      all_defined: the caller asserts every input point is defined; the
        input masks are not read and only the data-dependent gates (the
        saturation table's range) remain in the output masks.

    Returns the outputs as a list of Fields, in
    ``temps + hums_q + hums_rh + thes + ducts_q + ducts_rh`` request
    order.  The suite is pointwise, so it shards with no halo exchange:
    ``run_sharded(op, mesh, 0, ...)``.
    """
    reqs = _build_reqs("alevel_suite_fused", temps, hums_q, hums_rh,
                       thes, ducts_q, ducts_rh)
    need_q, need_rh = _consumes(reqs)
    t, p = _defined(t, all_defined), _defined(p, all_defined)
    q = _defined(q, all_defined) if need_q else None
    rh = _defined(rh, all_defined) if need_rh else None
    for f in (q, rh, p):
        require(f is None or f.values.shape == t.values.shape,
                "alevel_suite_fused: field shape mismatch")
    outs = []
    for fam, c in reqs:
        if fam == "temp":
            outs.append(aleveltemp(t, p, compute=c))
        elif fam == "hum_q":
            outs.append(alevelhum(t, q, p, compute=c))
        elif fam == "hum_rh":
            outs.append(alevelhum(t, rh, p, compute=c))
        elif fam == "the":
            outs.append(alevelthe(t, q, p, compute=c))
        elif fam == "duct_q":
            outs.append(alevelducting(t, q, p, compute=c))
        else:  # "duct_rh"
            outs.append(alevelducting(t, rh, p, compute=c))
    return outs


def hlevel_suite_fused(t: Field, q: Field, rh: Field, ps: Field,
                       alevel, blevel,
                       temps=(), hums_q=(), hums_rh=(),
                       thes=(), ducts_q=(), ducts_rh=(),
                       all_defined: bool = False):
    """The hybrid-level conversion suite in one program: surface pressure
    and per-level hybrid coefficients instead of a 3-D pressure field
    (``p = alevel[k] + blevel[k] * ps`` is formed inside the program).

    Semantics are hleveltemp / hlevelhum / hlevelthe / hlevelducting per
    mode — including hlevelhum's ps-definedness gate (defined ps required
    except for the pressure-independent modes 7/11,
    FieldCalculations.cc:1187), which is INVERTED vs alevelhum's.

    Args as :func:`alevel_suite_fused` except ``ps`` is the ``(ny, nx)``
    surface-pressure Field and ``alevel``/``blevel`` are length-``nlev``
    coefficient arrays.  They are DATA (one compiled program serves every
    coefficient set of the same nlev); the per-level ``bad_hlevel``
    validation runs when they are concrete and is skipped for traced
    values (e.g. inside ``run_sharded`` / an outer jit).
    """
    if not isinstance(alevel, jax.core.Tracer) \
            and not isinstance(blevel, jax.core.Tracer):
        for a, b in zip(np.asarray(alevel), np.asarray(blevel)):
            require(not _bad_hlevel(float(a), float(b)),
                    "hlevel_suite_fused: bad a/b level")
    return _hlevel_suite(t, q, rh, ps, jnp.asarray(alevel, jnp.float32),
                         jnp.asarray(blevel, jnp.float32),
                         temps=tuple(int(c) for c in temps),
                         hums_q=tuple(int(c) for c in hums_q),
                         hums_rh=tuple(int(c) for c in hums_rh),
                         thes=tuple(int(c) for c in thes),
                         ducts_q=tuple(int(c) for c in ducts_q),
                         ducts_rh=tuple(int(c) for c in ducts_rh),
                         all_defined=all_defined)


@functools.partial(jax.jit, static_argnames=_KW)
def _hlevel_suite(t, q, rh, ps, alevel, blevel, temps, hums_q, hums_rh,
                  thes, ducts_q, ducts_rh, all_defined=False):
    reqs = _build_reqs("hlevel_suite_fused", temps, hums_q, hums_rh,
                       thes, ducts_q, ducts_rh)
    need_q, need_rh = _consumes(reqs)
    nlev, ny, nx = t.values.shape
    require(alevel.shape == (nlev,) and blevel.shape == (nlev,),
            "hlevel_suite_fused: alevel/blevel must have nlev entries")
    require(ps.values.shape == (ny, nx),
            "hlevel_suite_fused: ps must be (ny, nx)")
    t, ps = _defined(t, all_defined), _defined(ps, all_defined)
    q = _defined(q, all_defined) if need_q else None
    rh = _defined(rh, all_defined) if need_rh else None
    for f in (q, rh):
        require(f is None or f.values.shape == (nlev, ny, nx),
                "hlevel_suite_fused: field shape mismatch")
    p_arr = alevel[:, None, None] + blevel[:, None, None] * ps.values
    psm = ps.mask
    outs = []
    for fam, c in reqs:
        if fam == "temp":
            outs.append(_leveltemp_core(t, p_arr, and_masks(t) & psm, c))
        elif fam in ("hum_q", "hum_rh"):
            h = q if fam == "hum_q" else rh
            # hlevel gate (cc:1187): ps defined except modes 7/11
            p_mask = None if c in (7, 11) else psm
            outs.append(_levelhum_core(t, h, p_arr, p_mask, c))
        elif fam == "the":
            outs.append(_levelthe_core(t, q, p_arr,
                                       and_masks(t, q) & psm, c))
        else:  # duct_q / duct_rh
            h = q if fam == "duct_q" else rh
            outs.append(_levelducting_core(t, h, p_arr,
                                           and_masks(t, h) & psm, c))
    return outs
