"""Aligned ingest: re-grid producer sentinel grids onto the canonical
tile-aligned layout so the *logical* grid equals the wire grid.

Why this exists: a consumer that wants a tile-aligned product grid
(rows a multiple of 8, columns a multiple of 128) for a ragged
production grid like the MET Norway operational 719x929 (the
reference's own perf canary, test/FieldCalculationsTest.cc:145-170) can
re-grid ONCE at ingest onto such a grid over the same physical domain;
every downstream plane, stencil and pipeline step then runs on the
aligned grid.  Whether that pays on the GPU is not measured.

This is an opt-in PRODUCT decision, not a transparent optimization: the
output grid changes (719x929 -> 720x1024 over the same extent).  The
reference has no analog — its flat C arrays are untiled — so there is
no conformance contract to preserve; semantics are defined here:

* **mask-aware bilinear**: each target point takes the bilinear-weighted
  mean of its (up to) 4 source corners, weights zeroed on undefined
  corners and renormalized.  A target point is undefined iff the total
  defined weight is ~0 (all contributing corners undefined), so undef
  regions map onto the new grid without inventing data and without
  growing by more than the 1-cell interpolation support.
* bilinear is EXACT on per-axis linear fields, so smooth met fields
  re-grid with second-order error and constants re-grid bitwise-exactly
  where defined.
* map-ratio fields (``xmapr = xm/(2*hx)``, ops/stencil.py:126-135)
  embed the grid spacing; over a fixed physical extent the spacing
  scales by (n-1)/(n_new-1) per axis, so :func:`resample_maps` scales
  the resampled ratios by (n_new-1)/(n-1) — physical gradients are then
  identical on either grid (tests/test_ingest.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .field import UNDEF
from .layout import padded_shape

__all__ = ["resample_align", "resample_maps", "aligned_target"]

#: below this total defined bilinear weight a target point is undefined
#: (also guards the renormalization divide)
_WEIGHT_EPS = np.float32(1e-6)


def aligned_target(ny: int, nx: int) -> Tuple[int, int]:
    """The canonical tile-aligned logical shape ingest re-grids to."""
    return padded_shape(ny, nx)


def _axis_coords(n_src: int, n_dst: int):
    """Source-index sample positions for n_dst points spanning the same
    physical extent as n_src points (endpoints map to endpoints)."""
    if n_src == 1:
        return (np.zeros(n_dst, np.int64), np.zeros(n_dst, np.int64),
                np.zeros(n_dst, np.float32))
    pos = np.linspace(0.0, n_src - 1.0, n_dst)
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, n_src - 2)
    w = (pos - i0).astype(np.float32)
    return i0, i0 + 1, w


def _resample_separable(a, y0, y1, wy, x0, x1, wx) -> np.ndarray:
    """Plain bilinear as two 1-D passes (x then y).  Algebraically equal
    to the 4-corner form — (1-wy)(1-wx)c00 + ... factors exactly — so on
    fully-defined planes it matches the mask-aware path to FP rounding
    (~1 ulp) while doing ~an order of magnitude less work: two 2-point
    gathers and no per-corner mask temps."""
    one = np.float32(1.0)
    # np.take is ~3.6x a fancy lane gather here; y gathers move whole
    # contiguous rows and are cheap either way.  Both return fresh
    # buffers, safe to update in place.
    ax = np.take(a, x0, axis=-1)
    ax *= (one - wx)
    ax += np.take(a, x1, axis=-1) * wx
    wyc = wy[:, None]
    out = ax[..., y0, :]
    out *= (one - wyc)
    out += ax[..., y1, :] * wyc
    return out if out.dtype == np.float32 else out.astype(np.float32)


def resample_align(a, undef: float = UNDEF,
                   shape_to: Optional[Tuple[int, int]] = None,
                   mask_aware: bool = True) -> np.ndarray:
    """Re-grid sentinel array(s) ``[..., ny, nx]`` onto the tile-aligned
    grid over the same physical extent (host-side, numpy in/out).

    ``shape_to`` defaults to :func:`aligned_target`; if it equals the
    source shape the input is returned as-is (already aligned).
    ``mask_aware=False`` runs plain bilinear (for fields known fully
    defined, e.g. map factors); with it True (default), undefined
    corners (NaN or == ``undef``) get zero weight and the result is
    renormalized, going undefined only where every contributing corner
    is undefined.
    """
    a = np.asarray(a, np.float32)
    ny, nx = a.shape[-2:]
    ny_t, nx_t = shape_to if shape_to is not None else aligned_target(ny, nx)
    if (ny_t, nx_t) == (ny, nx):
        return a
    y0, y1, wy = _axis_coords(ny, ny_t)
    x0, x1, wx = _axis_coords(nx, nx_t)
    if not mask_aware:
        return _resample_separable(a, y0, y1, wy, x0, x1, wx)
    undef32 = np.float32(undef)
    # The renormalized 4-corner form factors separably: with d the 0/1
    # defined weight, num = sum_i w_i d_i c_i = sep(d*c) and
    # den = sum_i w_i d_i = sep(d) (the bilinear weight w_i = wy_i*wx_i
    # is itself a product per axis).  So mask-aware resample is two
    # separable passes + an elementwise renormalize — same algebra as
    # the corner gather (FP order differs ~1 ulp), measured ~2x on
    # undef-bearing stacks and ~15x on fully-defined ones (PERF.md
    # "Aligned ingest").  Fully-defined input needs only one pass
    # (den == 1 exactly: the per-axis weights sum to 1).
    src_def = ~np.isnan(a) & (a != undef32)
    if src_def.all():
        return _resample_separable(a, y0, y1, wy, x0, x1, wx)
    az = np.where(src_def, a, np.float32(0.0))
    num = _resample_separable(az, y0, y1, wy, x0, x1, wx)
    den = _resample_separable(src_def.astype(np.float32),
                              y0, y1, wy, x0, x1, wx)
    defined = den > _WEIGHT_EPS
    return np.where(defined, num / np.where(defined, den, np.float32(1.0)),
                    undef32).astype(np.float32)


def resample_maps(xmapr, ymapr, ny: int, nx: int,
                  shape_to: Optional[Tuple[int, int]] = None):
    """Re-grid the map-ratio pair onto the aligned grid AND rescale for
    the new spacing: over a fixed extent, ``hx_new = hx*(nx-1)/(nx_t-1)``
    and ``xmapr`` carries ``1/(2*hx)``, so the resampled ratios scale by
    ``(n_t-1)/(n-1)`` per axis.  Returns ``(xmapr_t, ymapr_t)``."""
    ny_t, nx_t = shape_to if shape_to is not None else aligned_target(ny, nx)
    xm = resample_align(xmapr, shape_to=(ny_t, nx_t), mask_aware=False)
    ym = resample_align(ymapr, shape_to=(ny_t, nx_t), mask_aware=False)
    if nx_t != nx and nx > 1:
        xm = xm * np.float32((nx_t - 1) / (nx - 1))
    if ny_t != ny and ny > 1:
        ym = ym * np.float32((ny_t - 1) / (ny - 1))
    return xm.astype(np.float32), ym.astype(np.float32)
