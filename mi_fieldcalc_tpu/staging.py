"""Host staging pipeline: numpy sentinel grids -> device Fields and
back, through the native batch codec.

This is the production serving boundary.  The reference's callers hand
flat sentinel-encoded ``float*`` grids to each operator
(FieldCalculations.h:102-107); here the same numpy arrays are staged
once per step for the whole pipeline:

* decode of ALL input stacks in ONE native parallel pass
  (``native.decode_pad_batch`` — one thread-team dispatch instead of one
  per field, buffers reused across steps),
* one ``jax.device_put`` of the contiguous staging block,
* the jnp pipeline under ``jit`` on the device, returning one stacked
  value block and one mask block (2 gate planes instead of 9 when the
  decode counts prove every input defined),
* one fetch of each + ``native.encode_trim_batch`` back to 12 sentinel
  arrays.

Without the native library the codec falls back to numpy.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import native, ops
from .field import UNDEF, Field
from .layout import padded_shape
from .models.pipeline import derived_fields_stacked

__all__ = ["HostStager", "run_derived_fields_np",
           "stream_derived_fields_np", "run_hlevel_suite_np",
           "run_vessel_icing_np"]

#: the pipeline program of the serving path (one executable per shape
#: and mask layout)
_derived_fields_stacked = jax.jit(derived_fields_stacked,
                                  static_argnames="all_defined")


class HostStager:
    """Reusable staging buffers for K same-shape sentinel inputs.

    Owns one contiguous ``[K, ..., ny_p, nx_p]`` (values, mask) host
    block sized at first use and reused for every subsequent step with
    the same shape — the allocation/page-faulting cost of ~100 MB/step
    staging buffers is paid once.

    >>> stager = HostStager(k=4)
    >>> fields = stager.stage(tk, q, u, v)   # list of padded device Fields
    """

    def __init__(self, k: int, undef: float = UNDEF, fill: float = 0.0,
                 pad: bool = True):
        self.k = int(k)
        self.undef = float(undef)
        self.fill = float(fill)
        self.pad = bool(pad)
        self._values: Optional[np.ndarray] = None
        self._mask: Optional[np.ndarray] = None
        self._shape = None
        self.counts: List[int] = []

    def stage(self, *arrays, device=None) -> List[Field]:
        """Decode+pad the K sentinel arrays and put them on device as
        one block; returns K padded Fields (views into the block)."""

        if len(arrays) != self.k:
            raise ValueError(f"HostStager(k={self.k}) got {len(arrays)}")
        a0 = np.asarray(arrays[0])
        ny, nx = a0.shape[-2:]
        ny_p, nx_p = padded_shape(ny, nx) if self.pad else (ny, nx)
        oshape = (self.k,) + a0.shape[:-2] + (ny_p, nx_p)
        if self._shape != oshape:
            self._values = np.empty(oshape, np.float32)
            self._mask = np.empty(oshape, np.uint8)
            self._shape = oshape
        vals, mask, self.counts = native.decode_pad_batch(
            arrays, ny_p, nx_p, self.undef, self.fill,
            out=self._values, mask=self._mask)
        dv = jax.device_put(vals, device)
        dm = jax.device_put(mask, device)
        return [Field(dv[i], dm[i]) for i in range(self.k)]

    def stage_resample(self, *arrays, shape_to, device=None):
        """Aligned ingest: decode + mask-aware bilinear re-grid of the
        K sentinel arrays onto ``shape_to`` in ONE native pass
        (native.decode_resample_batch; numpy fallback), device_put as
        one block.  Returns K Fields on the aligned logical grid."""

        if len(arrays) != self.k:
            raise ValueError(f"HostStager(k={self.k}) got {len(arrays)}")
        a0 = np.asarray(arrays[0])
        ny_t, nx_t = shape_to
        oshape = (self.k,) + a0.shape[:-2] + (ny_t, nx_t)
        if self._shape != oshape:
            self._values = np.empty(oshape, np.float32)
            self._mask = np.empty(oshape, np.uint8)
            self._shape = oshape
        vals, mask, self.counts = native.decode_resample_batch(
            arrays, ny_t, nx_t, self.undef, self.fill,
            out=self._values, mask=self._mask)
        dv = jax.device_put(vals, device)
        dm = jax.device_put(mask, device)
        return [Field(dv[i], dm[i]) for i in range(self.k)]


def _stage_step(args, stager: HostStager, undef: float,
                align: bool = False):
    """Decode one step's inputs onto the device (host-thread-safe:
    everything here is numpy + the native codec + async device_put).
    ``align=True`` re-grids ragged inputs onto the tile-aligned logical
    grid at ingest (ingest.py) — the product grid changes; map ratios
    are rescaled for the new spacing so physical gradients match."""
    tk, q, u, v, ps, alevel, blevel, xmapr, ymapr, fcoriolis = args
    tk = np.ascontiguousarray(tk, np.float32)
    nlev, ny, nx = tk.shape
    tgt = (ny, nx)
    if align:
        from .ingest import aligned_target, resample_align, resample_maps
        tgt = aligned_target(ny, nx)
        if tgt != (ny, nx):
            xmapr, ymapr = resample_maps(xmapr, ymapr, ny, nx, tgt)
            fcoriolis = resample_align(np.asarray(fcoriolis, np.float32),
                                       mask_aware=False)

    if tgt != (ny, nx):
        # fused native decode+re-grid straight into the staging block
        tkf, qf, uf, vf = stager.stage_resample(tk, q, u, v,
                                                shape_to=tgt)
        psp, psm, pc = native.decode_resample_batch(
            [np.asarray(ps, np.float32)], *tgt, undef)
        psp, psm, ps_ndef = psp[0], psm[0], pc[0]
        ny, nx = tgt
    else:
        tkf, qf, uf, vf = stager.stage(tk, q, u, v)
        psp, psm, ps_ndef = native.decode_pad(np.asarray(ps, np.float32),
                                              ny, nx, undef)
    psf = Field(jnp.asarray(psp), jnp.asarray(psm))
    # the decode counts prove (or disprove) full definedness — the gate
    # for the 2-plane mask layout (the reference's inAllDefined shortcut,
    # FieldCalculations.cc:100)
    all_defined = (ps_ndef == ny * nx
                   and all(c == nlev * ny * nx for c in stager.counts))

    def dev(a):
        return jnp.asarray(np.asarray(a, np.float32))

    return ((tkf, qf, uf, vf, psf, dev(alevel), dev(blevel), dev(xmapr),
             dev(ymapr), dev(fcoriolis)), (ny, nx), all_defined)


def _compute_fetch(staged, all_defined: bool = False):
    """Dispatch the pipeline and fetch (values, masks) numpy stacks in
    a :class:`DerivedFieldsStacked` mask layout."""
    out = _derived_fields_stacked(*staged, all_defined=all_defined)
    return np.asarray(out.values), np.asarray(out.masks)


def _encode_step(values, masks, ny, nx, undef) -> Dict[str, np.ndarray]:
    from .models.pipeline import DerivedFields, DerivedFieldsStacked

    mask_map = {12: None, 9: DerivedFieldsStacked.MASK9,
                2: DerivedFieldsStacked.MASK2}[masks.shape[0]]
    planes = native.encode_trim_batch(values, masks, ny, nx, undef,
                                      mask_map=mask_map)
    return dict(zip(DerivedFields._fields, planes))


def _align_default(align):
    if align is None:
        import os
        align = os.environ.get("MF_STAGING_ALIGN", "0") != "0"
    return align


def run_derived_fields_np(tk, q, u, v, ps, alevel, blevel, xmapr, ymapr,
                          fcoriolis, undef: float = UNDEF,
                          align: Optional[bool] = None,
                          ) -> Dict[str, np.ndarray]:
    """The 12-output derived-field pipeline, numpy sentinel boundary to
    numpy sentinel boundary.

    Inputs mirror :func:`mi_fieldcalc_tpu.models.derived_fields`
    (reference semantics per operator; see models/pipeline.py) but as
    sentinel-encoded numpy arrays; returns ``{name: [nlev, ny, nx]}``
    sentinel arrays for the 12 :class:`DerivedFields` outputs.  Steps
    whose decode counts prove every input defined fetch 2 mask planes
    instead of 9 (``derived_fields_stacked(all_defined=True)``).

    ``align`` (opt-in; default the ``MF_STAGING_ALIGN`` env var, unset
    = off): re-grid ragged inputs onto the tile-aligned logical grid at
    ingest (mask-aware bilinear over the same physical extent, map ratios
    rescaled — see ingest.py).  The returned product grids are then the
    aligned shape (e.g. 719x929 -> 720x1024).
    """
    stager = _stager_cache(k=4, undef=undef)
    staged, (ny, nx), all_defined = _stage_step(
        (tk, q, u, v, ps, alevel, blevel, xmapr, ymapr, fcoriolis),
        stager, undef, align=_align_default(align))
    values, masks = _compute_fetch(staged, all_defined)
    return _encode_step(values, masks, ny, nx, undef)


def stream_derived_fields_np(steps, undef: float = UNDEF,
                             align: Optional[bool] = None):
    """Streaming executor: drive the pipeline over an iterable of input
    tuples (the 10 arguments of :func:`run_derived_fields_np`), yielding
    one output dict per step in order.

    Three-stage software pipeline on two worker threads: while the
    device computes step ``i``, one thread decodes+stages step ``i+1``
    (double-buffered :class:`HostStager` pair, so a buffer is never
    rewritten until the transfer that reads it has long completed) and
    another re-encodes step ``i-1``'s outputs to sentinel numpy.  The
    host codec is the serial part of serving-style use, so overlapping
    it with device time is the throughput lever on hosts with a discrete
    accelerator.  On the CPU backend XLA:CPU compute contends for the
    codec threads' cores.

    ``align`` as in :func:`run_derived_fields_np`.
    """
    import concurrent.futures as cf

    align = _align_default(align)
    stagers = (HostStager(4, undef, pad=False),
               HostStager(4, undef, pad=False))
    it = iter(steps)
    try:
        first = next(it)
    except StopIteration:
        return
    with cf.ThreadPoolExecutor(1) as ex_in, \
            cf.ThreadPoolExecutor(1) as ex_out:
        fut_stage = ex_in.submit(_stage_step, first, stagers[0], undef,
                                 align)
        prev_encode = None
        i = 0
        while fut_stage is not None:
            staged, (ny, nx), all_defined = fut_stage.result()
            nxt = next(it, None)
            fut_stage = None if nxt is None else ex_in.submit(
                _stage_step, nxt, stagers[(i + 1) % 2], undef, align)
            values, masks = _compute_fetch(staged, all_defined)
            if prev_encode is not None:
                yield prev_encode.result()
            prev_encode = ex_out.submit(_encode_step, values, masks,
                                        ny, nx, undef)
            i += 1
        yield prev_encode.result()


#: thread-local stager cache: the staging buffers are mutable per-step
#: state, so two threads calling run_derived_fields_np concurrently
#: must not share one block (thread B's decode would overwrite thread
#: A's inputs mid-flight) — each thread amortizes its own buffers.
_TLS = threading.local()


def _stager_cache(k: int, undef: float) -> HostStager:
    cache = getattr(_TLS, "stagers", None)
    if cache is None:
        cache = _TLS.stagers = {}
    key = (k, undef)
    if key not in cache:
        cache[key] = HostStager(k, undef, pad=False)
    return cache[key]


def run_hlevel_suite_np(tk, q, rh, ps, alevel, blevel,
                        temps=(), hums_q=(), hums_rh=(),
                        thes=(), ducts_q=(), ducts_rh=(),
                        undef: float = UNDEF,
                        align: Optional[bool] = None,
                        ) -> Dict[str, np.ndarray]:
    """The hybrid-level conversion suite, sentinel numpy to sentinel
    numpy — the drop-in replacement for looping one ``fc.hlevel*`` call
    per product.

    Inputs: ``[nlev, ny, nx]`` sentinel stacks (``q``/``rh`` may be
    ``None`` when no requested mode consumes them), ``(ny, nx)``
    surface pressure, per-level coefficients; request tuples as
    :func:`..ops.fused_suite.hlevel_suite_fused`.  The whole suite runs
    as ONE jitted program over the level stacks, with the decode counts
    routing fully defined steps to its ``all_defined`` form.  Returns
    ``{"temp3": ..., "hum_q1": ..., ...}`` keyed by family + compute, in
    request order.

    ``align`` (default the ``MF_STAGING_ALIGN`` env var): re-grid
    ragged inputs onto the tile-aligned logical grid at ingest, as in
    :func:`run_derived_fields_np` — the suite is pointwise, so only
    the product-grid change applies (no map-ratio rescale needed).
    """
    from .ops.fused_suite import _build_reqs, _consumes, hlevel_suite_fused

    tk = np.ascontiguousarray(tk, np.float32)
    nlev, ny, nx = tk.shape
    if _align_default(align):
        from .ingest import aligned_target
        ny, nx = aligned_target(ny, nx)
    decode = (native.decode_resample_batch if (ny, nx) != tk.shape[1:]
              else native.decode_pad_batch)

    reqs = _build_reqs("run_hlevel_suite_np", temps, hums_q, hums_rh,
                       thes, ducts_q, ducts_rh)
    need_q, need_rh = _consumes(reqs)
    if need_q and q is None:
        raise ValueError("run_hlevel_suite_np: a requested mode "
                         "consumes q but q is None")
    if need_rh and rh is None:
        raise ValueError("run_hlevel_suite_np: a requested mode "
                         "consumes rh but rh is None")

    # ONE native pass over every needed 3-D stack; ps separately
    stacks = [tk] + ([np.ascontiguousarray(q, np.float32)] if need_q
                     else []) \
        + ([np.ascontiguousarray(rh, np.float32)] if need_rh else [])
    v3, m3, c3 = decode(stacks, ny, nx, undef)
    fields = iter([Field(jnp.asarray(v3[i]), jnp.asarray(m3[i]))
                   for i in range(len(stacks))])
    tkf = next(fields)
    qf = next(fields) if need_q else None
    rhf = next(fields) if need_rh else None
    vp, mp, cp_ = decode([np.ascontiguousarray(ps, np.float32)], ny, nx,
                         undef)
    psf = Field(jnp.asarray(vp[0]), jnp.asarray(mp[0]))
    all_defined = (cp_[0] == ny * nx
                   and all(c == nlev * ny * nx for c in c3))

    outs = hlevel_suite_fused(
        tkf, qf, rhf, psf, np.asarray(alevel, np.float32),
        np.asarray(blevel, np.float32), temps=tuple(temps),
        hums_q=tuple(hums_q), hums_rh=tuple(hums_rh), thes=tuple(thes),
        ducts_q=tuple(ducts_q), ducts_rh=tuple(ducts_rh),
        all_defined=all_defined)
    return {f"{fam}{c}": native.encode_trim(np.asarray(f.values),
                                            np.asarray(f.mask), ny, nx,
                                            undef)
            for (fam, c), f in zip(reqs, outs)}


def run_vessel_icing_np(sal, wave, x_wind, y_wind, airtemp, rh, sst, p,
                        pw, aice, depth,
                        vs: float, alpha: float, zmin: float, zmax: float,
                        alt: int = 1,
                        products=("overland", "mertins", "modstall",
                                  "mincog"),
                        undef: float = UNDEF,
                        align: Optional[bool] = None,
                        ) -> Dict[str, np.ndarray]:
    """All requested vessel-icing products from ONE decode of the shared
    inputs — the production form of the reference's per-product
    `vesselIcing*` calls (each re-reading the same 11 sentinel grids).

    Inputs: ``(ny, nx)`` sentinel arrays (the ModStall/MINCOG set;
    Overland/Mertins use the ``airtemp/sst/x_wind/y_wind/sal/aice``
    subset); scalars as :func:`..api.vesselIcingMincog`.  Returns
    ``{product: sentinel array}``.

    ``align`` (default the ``MF_STAGING_ALIGN`` env var): re-grid the
    ragged inputs onto the tile-aligned logical grid at ingest
    (:mod:`..ingest`) — the icing products are pointwise, so only the
    product-grid change applies; outputs are then the aligned shape.
    """
    known = ("overland", "mertins", "modstall", "mincog")
    for prod in products:
        if prod not in known:
            raise ValueError(f"run_vessel_icing_np: unknown product "
                             f"{prod!r} (known: {known})")

    align = _align_default(align)

    # one decode pass for all 11 shared inputs
    arrays = [np.ascontiguousarray(a, np.float32) for a in
              (sal, wave, x_wind, y_wind, airtemp, rh, sst, p, pw,
               aice, depth)]
    tgt = arrays[0].shape[-2:]
    if align:
        from .ingest import aligned_target
        tgt = aligned_target(*tgt)
    stager = _stager_cache(k=11, undef=undef)
    if tuple(tgt) != arrays[0].shape[-2:]:
        # ONE fused native decode+re-grid pass over all 11 inputs, one
        # device_put of the block
        fields = stager.stage_resample(*arrays, shape_to=tgt)
    else:
        fields = stager.stage(*arrays)
    (salf, wavef, xwf, ywf, atf, rhf, sstf, pf, pwf, aicef,
     depthf) = fields

    shared = (salf, wavef, xwf, ywf, atf, rhf, sstf, pf, pwf, aicef,
              depthf)
    result = {}
    for prod in products:
        if prod in ("overland", "mertins"):
            f = _icing_jit(prod)(atf, sstf, xwf, ywf, salf, aicef)
        elif prod == "modstall":
            f = _icing_jit(prod)(*shared, float(vs), float(alpha),
                                 float(zmin), float(zmax))
        else:
            f = _icing_jit(prod)(*shared, float(vs), float(alpha),
                                 float(zmin), float(zmax), int(alt))
        result[prod] = native.encode(np.asarray(f.values),
                                     np.asarray(f.mask), undef)
    return result


@functools.lru_cache(maxsize=None)
def _icing_jit(product: str):
    """One jitted program per icing product (scalars static)."""
    fn = {"overland": ops.vessel_icing_overland,
          "mertins": ops.vessel_icing_mertins,
          "modstall": ops.vessel_icing_modstall,
          "mincog": ops.vessel_icing_mincog}[product]
    static = {"modstall": (11, 12, 13, 14),
              "mincog": (11, 12, 13, 14, 15)}.get(product, ())
    return jax.jit(fn, static_argnums=static)
