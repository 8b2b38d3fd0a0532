"""The flagship derived-field pipeline.

One fused, jittable program mapping prognostic model output — temperature,
specific humidity, wind, surface pressure on hybrid model levels — to the
full set of diagnostic fields a forecaster's workstation requests, i.e. the
composition the reference computes one C++ call at a time:

* per-point hybrid-level pressure      (hlevelpressure,  cc:1276-1304)
* potential temperature                (aleveltemp 3,     cc:1310-1353)
* relative humidity                    (alevelhum 1,      cc:1394-1458)
* dewpoint (K)                         (alevelhum 9,      cc:1394-1458)
* equivalent potential temperature     (alevelthe 1,      cc:1355-1392)
* ducting index                        (alevelducting 1,  cc:1460-1505)
* wind speed                           (vectorabs,        cc:1819-1841)
* relative vorticity                   (relvort,          cc:1843-1873)
* divergence                           (divergence,       cc:1910-1940)
* temperature advection (1 h)          (advection,        cc:1942-1983)
* |grad T|                             (gradient 3,       cc:1985-2074)
* thermal front parameter              (cc:2266-2309)

All operators are batched over the leading level axis; the stencil ops
read radius-1 neighbourhoods (TFP composes to radius 2), so the pipeline's
composed halo radius for sharded execution is ``RADIUS = 2``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import jax
import jax.numpy as jnp

from ..field import Field
from ..ops import (
    aleveltemp, alevelhum, alevelthe, alevelducting, vectorabs, relvort,
    divergence, advection, gradient, thermal_front_parameter, plevelhum,
    pleveltemp,
)

__all__ = ["DerivedFields", "DerivedFieldsStacked", "derived_fields",
           "derived_fields_stacked", "derived_fields_plevel",
           "derived_fields_isobaric", "STANDARD_PLEVELS", "RADIUS"]

#: Composed stencil radius of the pipeline (TFP = gradient ∘ gradient).
RADIUS = 2


class DerivedFields(NamedTuple):
    """Pipeline output bundle (all Fields, same shape as the inputs)."""
    p: Field          # pressure (hPa)
    th: Field         # potential temperature (K)
    rh: Field         # relative humidity (%)
    td: Field         # dewpoint (K)
    thetae: Field     # equivalent potential temperature (K)
    ducting: Field    # ducting index
    wspeed: Field     # wind speed (m/s)
    vort: Field       # relative vorticity (1/s)
    div: Field        # divergence (1/s)
    tadv: Field       # 1-hour temperature advection (K)
    gradt: Field      # |grad T| (K/m)
    tfp: Field        # thermal front parameter


class DerivedFieldsStacked(NamedTuple):
    """Structure-of-arrays pipeline output: all 12 value planes in ONE
    ``(12, nlev, ny, nx)`` float32 array plus one mask array, in
    :class:`DerivedFields` field order.

    This is the output layout of :func:`derived_fields_stacked` and of
    the staging layer: two buffers instead of 24, and downstream
    consumers (file writers, ensemble reducers) usually want the planes
    contiguous.  ``masks`` is an int8 (or bool) plane stack in one of
    three layouts:
    the 9 DEDUPLICATED planes (td/duc/dv are identical to rh/the/vo by
    construction), indexed through :data:`MASK9`; the 2 data-dependent
    gate planes of the ``all_defined`` path, indexed through
    :data:`MASK2`; or the plain 12-plane stack.  Named accessors slice
    lazily — outside ``jit`` each access is one device-side op."""
    values: jax.Array
    masks: jax.Array

    #: field index -> plane index in the deduplicated 9-plane mask stack
    #: (DerivedFields order: p th rh td the duc ws vo dv ad gt tf)
    MASK9 = (0, 1, 2, 2, 3, 3, 4, 5, 5, 6, 7, 8)

    #: field index -> plane index in the all_defined 2-plane mask stack
    #: (plane 0 = humidity table gate for rh/td, plane 1 = TFP's
    #: |grad T| != 0 gate; -1 = constant True)
    MASK2 = (-1, -1, 0, 0, -1, -1, -1, -1, -1, -1, -1, 1)

    @classmethod
    def mask_plane(cls, masks, i: int, values_i, axis: int = 0):
        """Field ``i``'s bool mask from any stacked-mask layout.
        ``axis`` is the plane axis (1 for member-batched
        ``[nmem, planes, ...]`` stacks); ``values_i`` supplies the shape
        for the constant-True masks of the 2-plane layout."""
        nplanes = masks.shape[axis]
        if nplanes == 2:
            j = cls.MASK2[i]
            if j < 0:
                return jnp.ones(values_i.shape, bool)
        else:
            j = cls.MASK9[i] if nplanes == 9 else i
        m = jnp.take(masks, j, axis=axis) if axis else masks[j]
        return m if m.dtype == jnp.bool_ else m != 0

    def field(self, i: int) -> Field:
        return Field(self.values[i],
                     self.mask_plane(self.masks, i, self.values[i]))

    def as_fields(self) -> "DerivedFields":
        return DerivedFields(*[self.field(i) for i in range(12)])

    def __getattr__(self, name):
        if name in DerivedFields._fields:
            return self.field(DerivedFields._fields.index(name))
        raise AttributeError(name)


def derived_fields(tk: Field, q: Field, u: Field, v: Field, ps: Field,
                   alevel: jax.Array, blevel: jax.Array,
                   xmapr: jax.Array, ymapr: jax.Array,
                   fcoriolis: jax.Array) -> DerivedFields:
    """Full derived-field pipeline on hybrid model levels.

    Args:
      tk, q, u, v: ``[nlev, ny, nx]`` Fields (temperature K, specific
        humidity kg/kg, wind m/s).
      ps: ``[ny, nx]`` surface-pressure Field (hPa).
      alevel, blevel: ``[nlev]`` hybrid coefficients.
      xmapr, ymapr, fcoriolis: ``[ny, nx]`` map-factor / coriolis arrays
        (or ``[nlev, ny, nx]``; broadcast over levels otherwise).
    """
    nlev = tk.values.shape[0]
    a = jnp.asarray(alevel, jnp.float32).reshape(nlev, 1, 1)
    b = jnp.asarray(blevel, jnp.float32).reshape(nlev, 1, 1)
    p = Field(a + b * ps.values[None],
              jnp.broadcast_to(ps.mask[None], tk.values.shape))

    def bcast(arr):
        arr = jnp.asarray(arr, jnp.float32)
        return jnp.broadcast_to(arr, tk.values.shape) if arr.ndim == 2 else arr

    xm, ym, fc = bcast(xmapr), bcast(ymapr), bcast(fcoriolis)

    th = aleveltemp(tk, p, compute=3)
    rh = alevelhum(tk, q, p, compute=1)
    td = alevelhum(tk, q, p, compute=9)
    thetae = alevelthe(tk, q, p, compute=1)
    ducting = alevelducting(tk, q, p, compute=1)
    wspeed = vectorabs(u, v)
    vort = relvort(u, v, xm, ym)
    div = divergence(u, v, xm, ym)
    tadv = advection(tk, u, v, xm, ym, hours=1.0)
    gradt = gradient(tk, xm, ym, compute=3)
    tfp = thermal_front_parameter(tk, xm, ym)

    return DerivedFields(p=p, th=th, rh=rh, td=td, thetae=thetae,
                         ducting=ducting, wspeed=wspeed, vort=vort, div=div,
                         tadv=tadv, gradt=gradt, tfp=tfp)


def derived_fields_stacked(*args, all_defined: bool = False
                           ) -> DerivedFieldsStacked:
    """:func:`derived_fields` in the :class:`DerivedFieldsStacked`
    layout: the 12 value planes and the 9 deduplicated mask planes
    (``MASK9``), or with ``all_defined=True`` only the 2 data-dependent
    gate planes (``MASK2``).  ``all_defined=True`` asserts every input
    point is defined (the reference's ``inAllDefined`` shortcut,
    FieldCalculations.cc:100); the other 10 outputs are then defined
    everywhere, so fewer mask bytes reach the host."""
    out = derived_fields(*args)
    layout = (DerivedFieldsStacked.MASK2 if all_defined
              else DerivedFieldsStacked.MASK9)
    first = [layout.index(k) for k in range(max(layout) + 1)]
    return DerivedFieldsStacked(
        values=jnp.stack([f.values for f in out]),
        masks=jnp.stack([out[i].mask for i in first]))


#: Standard isobaric surfaces for the 3-D vertical pipeline (hPa).
STANDARD_PLEVELS = (1000.0, 925.0, 850.0, 700.0, 500.0, 400.0, 300.0,
                    250.0, 200.0, 150.0, 100.0)


def derived_fields_isobaric(tk: Field, q: Field, u: Field, v: Field,
                            ps: Field, alevel: jax.Array, blevel: jax.Array,
                            xmapr: jax.Array, ymapr: jax.Array,
                            fcoriolis: jax.Array,
                            plevels=STANDARD_PLEVELS) -> DerivedFields:
    """The 3-D vertical pipeline (BASELINE.json config 4): interpolate the
    prognostic fields from hybrid model levels to standard isobaric
    surfaces (log-p linear, mask-aware — ops/vertical.py), then run the
    full derived-field suite on the interpolated stack.  One jittable
    program; the interpolation's level reductions fuse with the
    elementwise suite under XLA."""
    from ..ops import hlevel_to_plevel

    plevels = tuple(float(t) for t in plevels)
    tki, qi, ui, vi = (hlevel_to_plevel(f, ps, alevel, blevel, plevels)
                       for f in (tk, q, u, v))
    np_ = len(plevels)
    # constant-pressure "field" per target level; defined everywhere
    pvals = jnp.asarray(plevels, jnp.float32).reshape(np_, 1, 1)
    p = Field(jnp.broadcast_to(pvals, tki.values.shape),
              jnp.ones(tki.values.shape, bool))

    def bcast(arr):
        arr = jnp.asarray(arr, jnp.float32)
        return jnp.broadcast_to(arr, tki.values.shape) if arr.ndim == 2 else arr

    xm, ym = bcast(xmapr), bcast(ymapr)

    th = aleveltemp(tki, p, compute=3)
    rh = alevelhum(tki, qi, p, compute=1)
    td = alevelhum(tki, qi, p, compute=9)
    thetae = alevelthe(tki, qi, p, compute=1)
    ducting = alevelducting(tki, qi, p, compute=1)
    wspeed = vectorabs(ui, vi)
    vort = relvort(ui, vi, xm, ym)
    div = divergence(ui, vi, xm, ym)
    tadv = advection(tki, ui, vi, xm, ym, hours=1.0)
    gradt = gradient(tki, xm, ym, compute=3)
    tfp = thermal_front_parameter(tki, xm, ym)
    return DerivedFields(p=p, th=th, rh=rh, td=td, thetae=thetae,
                         ducting=ducting, wspeed=wspeed, vort=vort, div=div,
                         tadv=tadv, gradt=gradt, tfp=tfp)


def derived_fields_plevel(tk: Field, rh: Field, u: Field, v: Field,
                          p: float, xmapr: jax.Array, ymapr: jax.Array,
                          fcoriolis: jax.Array) -> Dict[str, Field]:
    """Pressure-level variant (BASELINE.json config 1): potential
    temperature + dewpoint + kinematics on one constant-pressure surface."""
    th = pleveltemp(tk, p, compute=3)
    td = plevelhum(tk, rh, p, compute=11)   # T(K), RH -> Td(K)
    wspeed = vectorabs(u, v)
    vort = relvort(u, v, xmapr, ymapr)
    div = divergence(u, v, xmapr, ymapr)
    gradt = gradient(tk, xmapr, ymapr, compute=3)
    return {"th": th, "td": td, "wspeed": wspeed, "vort": vort,
            "div": div, "gradt": gradt}
