"""ctypes bindings for the native host boundary codec.

The compute path of this framework is JAX on the accelerator; what remains
host-side work is the numpy *boundary* — turning sentinel-encoded grids
(``miutil::UNDEF = 1e35``, reference FieldDefined.cc:34) into
``(values, mask)`` pairs before ``device_put``, re-encoding device results,
and answering ``checkDefined``-style tri-state queries
(FieldDefined.cc:41-70) without an accelerator round trip.  Those scans are
memory-bound; ``native/fieldcodec.cc`` does each in one fused multithreaded
pass (size-adaptive threads mirroring openmp_tools.cc:38-69) where numpy
needs 3-4 full passes.

Every entry point falls back to a numpy implementation when the shared
library is absent (it is built on demand with ``native/build.sh``; the
wrapper also attempts one quiet build on first use if ``g++`` exists).

Functions take/return numpy arrays; nothing here touches JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

from .field import UNDEF, ValuesDefined

__all__ = [
    "available",
    "decode",
    "decode_pad",
    "decode_pad_batch",
    "decode_pad_levpack_batch",
    "decode_resample_batch",
    "encode",
    "encode_trim",
    "encode_trim_batch",
    "count_defined",
    "defined_state_host",
]

_ABI = 6

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SO = os.path.join(_REPO, "native", "build", "libmifieldcalc_host.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    script = os.path.join(_REPO, "native", "build.sh")
    if not os.path.exists(script):
        return False
    try:
        subprocess.run(["sh", script], capture_output=True,
                       timeout=120, check=True)
        return True
    except Exception:
        return False


def _bind(lib: ctypes.CDLL) -> Optional[ctypes.CDLL]:
    i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    u8p, f32 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_float
    lib.mf_decode.restype = i64
    lib.mf_decode.argtypes = [f32p, i64, f32, f32, f32p, u8p]
    lib.mf_encode.restype = None
    lib.mf_encode.argtypes = [f32p, u8p, i64, f32, f32p]
    lib.mf_count_defined.restype = i64
    lib.mf_count_defined.argtypes = [f32p, i64, f32]
    lib.mf_count_mask.restype = i64
    lib.mf_count_mask.argtypes = [u8p, i64]
    lib.mf_decode_pad.restype = i64
    lib.mf_decode_pad.argtypes = [f32p, i64, i64, i64, i64, i64, f32, f32,
                                  f32p, u8p]
    lib.mf_encode_trim.restype = None
    lib.mf_encode_trim.argtypes = [f32p, u8p, i64, i64, i64, i64, i64, f32,
                                   f32p]
    f32pp = ctypes.POINTER(f32p)
    i64p = ctypes.POINTER(i64)
    lib.mf_decode_pad_batch.restype = None
    lib.mf_decode_pad_batch.argtypes = [f32pp, i64, i64, i64, i64, i64,
                                        i64, f32, f32, f32p, u8p, i64p]
    lib.mf_encode_trim_batch.restype = None
    lib.mf_encode_trim_batch.argtypes = [f32p, u8p, i64, i64, i64, i64,
                                         i64, i64, f32, f32pp]
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.mf_encode_trim_batch_map.restype = None
    lib.mf_encode_trim_batch_map.argtypes = [f32p, u8p, i64p, i64, i64,
                                             i64, i64, i64, i64, f32, f32pp]
    lib.mf_decode_resample_batch.restype = None
    lib.mf_decode_resample_batch.argtypes = [
        f32pp, i64, i64, i64, i64, i64, i64,
        i64p, i64p, f32p, i64p, i64p, f32p,
        f32, f32, f32p, u8p, i64p]
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.mf_decode_pad_levpack_batch.restype = None
    lib.mf_decode_pad_levpack_batch.argtypes = [
        f32pp, i64, i64, i64, i64, i64, i64, f32, f32, f32p, u32p, i64p]
    lib.mf_encode_trim_batch_levpack.restype = None
    lib.mf_encode_trim_batch_levpack.argtypes = [
        f32p, u32p, i64p, i64, i64, i64, i64, i64, i64, f32, f32pp]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO):
        _build()
    if not os.path.exists(_SO):
        return None
    try:
        lib = ctypes.CDLL(_SO)
        if lib.mf_native_abi_version() != _ABI:
            # stale build from an older source revision: rebuild once
            del lib
            if not _build():
                return None
            lib = ctypes.CDLL(_SO)
            if lib.mf_native_abi_version() != _ABI:
                return None
        _lib = _bind(lib)
    except (OSError, AttributeError):
        return None
    return _lib


def available() -> bool:
    """Whether the compiled codec is loadable (builds it if needed)."""
    return _load() is not None


def _f32c(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def decode(values, undef: float = UNDEF, fill: float = 0.0,
           ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Sentinel array -> ``(sanitized values, bool mask, n_defined)``.

    One fused pass over the array: the point predicate is ``is_defined``
    (FieldCalculations.h:42-45), undefined points are replaced by ``fill``
    (numerically safe for downstream transcendentals), and the defined
    count for the tri-state summary comes for free.
    """
    v = _f32c(values)
    lib = _load()
    if lib is None:
        mask = ~np.isnan(v) & (v != np.float32(undef))
        out = np.where(mask, v, np.float32(fill))
        return out, mask, int(mask.sum())
    out = np.empty_like(v)
    mask = np.empty(v.shape, dtype=np.uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n_def = lib.mf_decode(v.ctypes.data_as(f32p), v.size,
                          ctypes.c_float(undef), ctypes.c_float(fill),
                          out.ctypes.data_as(f32p), mask.ctypes.data_as(u8p))
    return out, mask.view(np.bool_), int(n_def)


def decode_pad(values, ny_p: Optional[int] = None,
               nx_p: Optional[int] = None, undef: float = UNDEF,
               fill: float = 0.0) -> Tuple[np.ndarray, np.ndarray, int]:
    """Sentinel array ``[..., ny, nx]`` -> tile-aligned padded
    ``(values, mask, n_defined)`` in ONE host pass.

    The production device layout keeps grids padded to (8, 128) tiles
    (layout.padded_shape; ragged trailing dims pay ~2x in Pallas DMA), so
    the host boundary decodes straight into that layout: logical points
    are sanitized exactly like :func:`decode`, dead rows/lanes get
    ``fill`` with mask ``False``, and the defined count covers logical
    points only.  The result is ready for ``jax.device_put`` with no
    intermediate numpy pad pass.
    """
    from .layout import padded_shape
    v = _f32c(values)
    ny, nx = v.shape[-2:]
    if ny_p is None or nx_p is None:
        d_ny, d_nx = padded_shape(ny, nx)
        ny_p = d_ny if ny_p is None else ny_p
        nx_p = d_nx if nx_p is None else nx_p
    if ny_p < ny or nx_p < nx:
        raise ValueError(f"padded shape ({ny_p}, {nx_p}) smaller than "
                         f"logical ({ny}, {nx})")
    lead = int(np.prod(v.shape[:-2], dtype=np.int64)) if v.ndim > 2 else 1
    oshape = v.shape[:-2] + (ny_p, nx_p)
    lib = _load()
    if lib is None:
        mask = ~np.isnan(v) & (v != np.float32(undef))
        out = np.where(mask, v, np.float32(fill))
        n_def = int(mask.sum())
        pad = [(0, 0)] * (v.ndim - 2) + [(0, ny_p - ny), (0, nx_p - nx)]
        return (np.pad(out, pad, constant_values=np.float32(fill)),
                np.pad(mask, pad), n_def)
    out = np.empty(oshape, np.float32)
    mask = np.empty(oshape, np.uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n_def = lib.mf_decode_pad(v.ctypes.data_as(f32p), lead, ny, nx,
                              ny_p, nx_p, ctypes.c_float(undef),
                              ctypes.c_float(fill),
                              out.ctypes.data_as(f32p),
                              mask.ctypes.data_as(u8p))
    return out, mask.view(np.bool_), int(n_def)


def decode_pad_batch(arrays, ny_p: Optional[int] = None,
                     nx_p: Optional[int] = None, undef: float = UNDEF,
                     fill: float = 0.0,
                     out: Optional[np.ndarray] = None,
                     mask: Optional[np.ndarray] = None,
                     ) -> Tuple[np.ndarray, np.ndarray, list]:
    """Stage K same-shape sentinel arrays ``[..., ny, nx]`` into ONE
    contiguous tile-aligned ``[K, ..., ny_p, nx_p]`` (values, mask)
    block in a single parallel pass — the host side of a production
    pipeline step (e.g. the 4 input stacks of the derived-field
    pipeline), one thread-team dispatch instead of K.

    ``out``/``mask`` accept preallocated buffers of the right shape
    (a :class:`HostStager` reuses them across steps); returns
    ``(values, mask, per-field defined counts)``.
    """
    from .layout import padded_shape
    vs = [_f32c(a) for a in arrays]
    shape = vs[0].shape
    for a in vs:
        if a.shape != shape:
            raise ValueError("decode_pad_batch: arrays must share a shape")
    ny, nx = shape[-2:]
    if ny_p is None or nx_p is None:
        d_ny, d_nx = padded_shape(ny, nx)
        ny_p = d_ny if ny_p is None else ny_p
        nx_p = d_nx if nx_p is None else nx_p
    if ny_p < ny or nx_p < nx:
        raise ValueError(f"padded shape ({ny_p}, {nx_p}) smaller than "
                         f"logical ({ny}, {nx})")
    k = len(vs)
    lead = int(np.prod(shape[:-2], dtype=np.int64)) if len(shape) > 2 else 1
    oshape = (k,) + shape[:-2] + (ny_p, nx_p)
    # validate / allocate the buffers BEFORE the library check so the
    # write-into-buffer contract (and its ValueErrors) is identical
    # with and without the native library
    if out is None:
        out = np.empty(oshape, np.float32)
    if mask is None:
        mask = np.empty(oshape, np.uint8)
    if out.shape != oshape or out.dtype != np.float32:
        raise ValueError("decode_pad_batch: bad `out` buffer")
    if mask.shape != oshape or mask.dtype not in (np.uint8, np.bool_):
        raise ValueError("decode_pad_batch: bad `mask` buffer")
    lib = _load()
    if lib is None:
        counts = []
        for i, a in enumerate(vs):
            o, m, n = decode_pad(a, ny_p, nx_p, undef, fill)
            out[i] = o
            mask[i] = m
            counts.append(n)
        return out, mask.view(np.bool_), counts
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    srcs = (f32p * k)(*[a.ctypes.data_as(f32p) for a in vs])
    counts = (ctypes.c_int64 * k)()
    lib.mf_decode_pad_batch(srcs, k, lead, ny, nx, ny_p, nx_p,
                            ctypes.c_float(undef), ctypes.c_float(fill),
                            out.ctypes.data_as(f32p),
                            mask.ctypes.data_as(u8p), counts)
    return out, mask.view(np.bool_), list(counts)


def decode_resample_batch(arrays, ny_t: int, nx_t: int,
                          undef: float = UNDEF, fill: float = 0.0,
                          out: Optional[np.ndarray] = None,
                          mask: Optional[np.ndarray] = None,
                          ) -> Tuple[np.ndarray, np.ndarray, list]:
    """Aligned ingest in one pass: decode + mask-aware bilinear re-grid
    of K same-shape sentinel stacks ``[..., ny, nx]`` onto the
    tile-aligned ``[K, ..., ny_t, nx_t]`` (values, mask) block — the
    native fusion of :func:`ingest.resample_align` with the decode
    (staging ``align=True``).  Same semantics as the numpy reference
    (identical axis coordinates via ``ingest._axis_coords``; undefined
    iff total defined weight <= 1e-6); values may differ in the last
    ulp (FP contraction).  Fallback: numpy resample + decode per field.
    """
    from .ingest import _axis_coords
    vs = [_f32c(a) for a in arrays]
    shape = vs[0].shape
    for a in vs:
        if a.shape != shape:
            raise ValueError("decode_resample_batch: arrays must share "
                             "a shape")
    ny, nx = shape[-2:]
    k = len(vs)
    lead = int(np.prod(shape[:-2], dtype=np.int64)) if len(shape) > 2 else 1
    oshape = (k,) + shape[:-2] + (ny_t, nx_t)
    if out is None:
        out = np.empty(oshape, np.float32)
    if mask is None:
        mask = np.empty(oshape, np.uint8)
    if out.shape != oshape or out.dtype != np.float32:
        raise ValueError("decode_resample_batch: bad `out` buffer")
    if mask.shape != oshape or mask.dtype not in (np.uint8, np.bool_):
        raise ValueError("decode_resample_batch: bad `mask` buffer")
    lib = _load()
    if lib is None:
        from .ingest import resample_align
        counts = []
        for i, a in enumerate(vs):
            o, m, n = decode(resample_align(a, undef,
                                            shape_to=(ny_t, nx_t)),
                             undef, fill)
            out[i] = o
            mask[i] = m
            counts.append(n)
        return out, mask.view(np.bool_), counts
    y0, y1, wy = _axis_coords(ny, ny_t)
    x0, x1, wx = _axis_coords(nx, nx_t)
    y0 = np.ascontiguousarray(y0, np.int64)
    y1 = np.ascontiguousarray(y1, np.int64)
    x0 = np.ascontiguousarray(x0, np.int64)
    x1 = np.ascontiguousarray(x1, np.int64)
    wy = np.ascontiguousarray(wy, np.float32)
    wx = np.ascontiguousarray(wx, np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    srcs = (f32p * k)(*[a.ctypes.data_as(f32p) for a in vs])
    counts = (ctypes.c_int64 * k)()
    lib.mf_decode_resample_batch(
        srcs, k, lead, ny, nx, ny_t, nx_t,
        y0.ctypes.data_as(i64p), y1.ctypes.data_as(i64p),
        wy.ctypes.data_as(f32p),
        x0.ctypes.data_as(i64p), x1.ctypes.data_as(i64p),
        wx.ctypes.data_as(f32p),
        ctypes.c_float(undef), ctypes.c_float(fill),
        out.ctypes.data_as(f32p), mask.ctypes.data_as(u8p), counts)
    return out, mask.view(np.bool_), list(counts)


def decode_pad_levpack_batch(arrays, ny_p: Optional[int] = None,
                             nx_p: Optional[int] = None,
                             undef: float = UNDEF, fill: float = 0.0,
                             out: Optional[np.ndarray] = None,
                             pmask: Optional[np.ndarray] = None,
                             ) -> Tuple[np.ndarray, np.ndarray, list]:
    """Stage K same-shape ``[nlev, ny, nx]`` sentinel stacks into ONE
    contiguous tile-aligned values block ``[K, nlev, ny_p, nx_p]`` plus
    LEV-bit-packed mask planes ``[K, ny_p, nx_p]`` uint32 (bit L =
    level L defined; dead rows/lanes all-zero) in a single parallel
    pass, so a consumer of packed masks ships nlev/32 of the uint8
    block per step (no device program consumes the planes yet).  Requires 3-D
    inputs with nlev <= 32; returns ``(values, pmask, counts)``.
    """
    from .layout import padded_shape
    vs = [_f32c(a) for a in arrays]
    shape = vs[0].shape
    for a in vs:
        if a.shape != shape:
            raise ValueError(
                "decode_pad_levpack_batch: arrays must share a shape")
    if len(shape) != 3:
        raise ValueError("decode_pad_levpack_batch: inputs must be "
                         "[nlev, ny, nx]")
    nlev, ny, nx = shape
    if nlev > 32:
        raise ValueError("decode_pad_levpack_batch: nlev must be <= 32")
    if ny_p is None or nx_p is None:
        d_ny, d_nx = padded_shape(ny, nx)
        ny_p = d_ny if ny_p is None else ny_p
        nx_p = d_nx if nx_p is None else nx_p
    if ny_p < ny or nx_p < nx:
        raise ValueError(f"padded shape ({ny_p}, {nx_p}) smaller than "
                         f"logical ({ny}, {nx})")
    k = len(vs)
    oshape = (k, nlev, ny_p, nx_p)
    mshape = (k, ny_p, nx_p)
    if out is None:
        out = np.empty(oshape, np.float32)
    if pmask is None:
        pmask = np.empty(mshape, np.uint32)
    if out.shape != oshape or out.dtype != np.float32:
        raise ValueError("decode_pad_levpack_batch: bad `out` buffer")
    if pmask.shape != mshape or pmask.dtype != np.uint32:
        raise ValueError("decode_pad_levpack_batch: bad `pmask` buffer")
    lib = _load()
    if lib is None:
        counts = []
        bits = (np.uint32(1) << np.arange(nlev, dtype=np.uint32)
                )[:, None, None]
        for i, a in enumerate(vs):
            o, m, n = decode_pad(a, ny_p, nx_p, undef, fill)
            out[i] = o
            pmask[i] = (m.astype(np.uint32) * bits).sum(
                0, dtype=np.uint32)
            counts.append(n)
        return out, pmask, counts
    f32p = ctypes.POINTER(ctypes.c_float)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    srcs = (f32p * k)(*[a.ctypes.data_as(f32p) for a in vs])
    counts = (ctypes.c_int64 * k)()
    lib.mf_decode_pad_levpack_batch(
        srcs, k, nlev, ny, nx, ny_p, nx_p, ctypes.c_float(undef),
        ctypes.c_float(fill), out.ctypes.data_as(f32p),
        pmask.ctypes.data_as(u32p), counts)
    return out, pmask, list(counts)


def encode_trim_batch(values, mask, ny: int, nx: int,
                      undef: float = UNDEF, mask_map=None) -> list:
    """K padded device results ``[K, ..., ny_p, nx_p]`` (one contiguous
    values block + one mask block) -> list of K logical ``[..., ny, nx]``
    sentinel arrays in one parallel pass (:func:`decode_pad_batch`'s
    output-side dual).

    ``mask_map`` (length K, or None for the identity) lets the mask
    block carry FEWER planes than the values block: ``mask_map[f]`` is
    value plane f's plane index in the mask block, and ``-1`` means
    "constant defined" (plain trim, no sentinel pass).  This serves the
    pipeline's deduplicated 9-plane stack
    (``DerivedFieldsStacked.MASK9``) and the all-defined 2-plane stack
    (``MASK2``) without expanding masks host-side.

    A **uint32** mask block of shape ``[km, ny_p, nx_p]`` against 4-D
    values ``[K, nlev, ny_p, nx_p]`` is a LEV-packed layout (bit L of
    plane ``mask_map[f]`` = level L of field f defined); it is consumed
    in place — no host-side unpack pass."""
    v = _f32c(values)
    ny_p, nx_p = v.shape[-2:]
    if ny_p < ny or nx_p < nx:
        raise ValueError(f"padded shape ({ny_p}, {nx_p}) smaller than "
                         f"logical ({ny}, {nx})")
    k = v.shape[0]
    m = np.ascontiguousarray(mask)
    if m.dtype == np.uint32:
        if v.ndim != 4 or m.ndim != 3 or m.shape[-2:] != v.shape[-2:]:
            raise ValueError("encode_trim_batch: LEV-packed masks need "
                             "[K, nlev, ny_p, nx_p] values and "
                             "[km, ny_p, nx_p] uint32 masks")
        if mask_map is None:
            raise ValueError("encode_trim_batch: LEV-packed masks "
                             "require mask_map")
        return _encode_trim_batch_levpack(v, m, ny, nx, undef, mask_map)
    if mask_map is None:
        if m.shape != v.shape:
            m = np.ascontiguousarray(np.broadcast_to(m, v.shape))
        mmap = np.arange(k, dtype=np.int64)
    else:
        mmap = np.asarray(mask_map, np.int64)
        if mmap.shape != (k,):
            raise ValueError(f"mask_map must have length {k}")
        if m.shape[1:] != v.shape[1:] or \
                (mmap.max(initial=-1) >= m.shape[0]):
            raise ValueError("mask block does not cover mask_map")
    m = m.astype(np.uint8, copy=False)
    lead = int(np.prod(v.shape[1:-2], dtype=np.int64)) if v.ndim > 3 else 1
    lib = _load()
    if lib is None:
        return [v[f, ..., :ny, :nx].copy() if mmap[f] < 0 else
                encode_trim(v[f], m[mmap[f]], ny, nx, undef)
                for f in range(k)]
    outs = [np.empty(v.shape[1:-2] + (ny, nx), np.float32)
            for _ in range(k)]
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    optrs = (f32p * k)(*[o.ctypes.data_as(f32p) for o in outs])
    if mask_map is None:
        lib.mf_encode_trim_batch(v.ctypes.data_as(f32p),
                                 m.ctypes.data_as(u8p), k, lead, ny, nx,
                                 ny_p, nx_p, ctypes.c_float(undef), optrs)
    else:
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.mf_encode_trim_batch_map(
            v.ctypes.data_as(f32p), m.ctypes.data_as(u8p),
            mmap.ctypes.data_as(i64p), k, lead, ny, nx,
            ny_p, nx_p, ctypes.c_float(undef), optrs)
    return outs


def _encode_trim_batch_levpack(v, pm, ny, nx, undef, mask_map) -> list:
    """encode_trim_batch's LEV-packed branch: values [K, nlev, ny_p,
    nx_p] + uint32 planes [km, ny_p, nx_p] (bit L = level L defined)."""
    k, nlev, ny_p, nx_p = v.shape
    mmap = np.asarray(mask_map, np.int64)
    if mmap.shape != (k,):
        raise ValueError(f"mask_map must have length {k}")
    if mmap.max(initial=-1) >= pm.shape[0]:
        raise ValueError("mask block does not cover mask_map")
    lib = _load()
    if lib is None:
        outs = []
        bits = (np.uint32(1) << np.arange(nlev, dtype=np.uint32)
                )[:, None, None]
        for f in range(k):
            if mmap[f] < 0:
                outs.append(v[f, :, :ny, :nx].copy())
            else:
                m = (pm[mmap[f], None, :ny, :nx] & bits[:, :ny, :nx]) != 0
                outs.append(np.where(m, v[f, :, :ny, :nx],
                                     np.float32(undef)))
        return outs
    outs = [np.empty((nlev, ny, nx), np.float32) for _ in range(k)]
    f32p = ctypes.POINTER(ctypes.c_float)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    optrs = (f32p * k)(*[o.ctypes.data_as(f32p) for o in outs])
    lib.mf_encode_trim_batch_levpack(
        v.ctypes.data_as(f32p), pm.ctypes.data_as(u32p),
        mmap.ctypes.data_as(i64p), k, nlev, ny, nx, ny_p, nx_p,
        ctypes.c_float(undef), optrs)
    return outs


def encode_trim(values, mask, ny: int, nx: int,
                undef: float = UNDEF) -> np.ndarray:
    """Padded device results ``[..., ny_p, nx_p]`` -> logical
    ``[..., ny, nx]`` sentinel array in one pass (:func:`decode_pad`'s
    output-side dual)."""
    v = _f32c(values)
    ny_p, nx_p = v.shape[-2:]
    if ny_p < ny or nx_p < nx:
        raise ValueError(f"padded shape ({ny_p}, {nx_p}) smaller than "
                         f"logical ({ny}, {nx})")
    m = np.ascontiguousarray(mask)
    if m.shape != v.shape:
        m = np.ascontiguousarray(np.broadcast_to(m, v.shape))
    m = m.astype(np.uint8, copy=False)
    lib = _load()
    if lib is None:
        trimmed_v = v[..., :ny, :nx]
        trimmed_m = m[..., :ny, :nx]
        return np.where(trimmed_m != 0, trimmed_v, np.float32(undef))
    lead = int(np.prod(v.shape[:-2], dtype=np.int64)) if v.ndim > 2 else 1
    out = np.empty(v.shape[:-2] + (ny, nx), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mf_encode_trim(v.ctypes.data_as(f32p), m.ctypes.data_as(u8p),
                       lead, ny, nx, ny_p, nx_p, ctypes.c_float(undef),
                       out.ctypes.data_as(f32p))
    return out


def encode(values, mask, undef: float = UNDEF) -> np.ndarray:
    """(values, mask) -> sentinel array (``Field.to_sentinel`` host dual)."""
    v = _f32c(values)
    m = np.ascontiguousarray(mask)
    if m.shape != v.shape:
        m = np.broadcast_to(m, v.shape)
        m = np.ascontiguousarray(m)
    m = m.astype(np.uint8, copy=False)
    lib = _load()
    if lib is None:
        return np.where(m != 0, v, np.float32(undef))
    out = np.empty_like(v)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mf_encode(v.ctypes.data_as(f32p), m.ctypes.data_as(u8p), v.size,
                  ctypes.c_float(undef), out.ctypes.data_as(f32p))
    return out


def count_defined(values, undef: float = UNDEF) -> int:
    """Defined-point count of a sentinel array (no outputs written)."""
    v = _f32c(values)
    lib = _load()
    if lib is None:
        return int((~np.isnan(v) & (v != np.float32(undef))).sum())
    f32p = ctypes.POINTER(ctypes.c_float)
    return int(lib.mf_count_defined(v.ctypes.data_as(f32p), v.size,
                                    ctypes.c_float(undef)))


def defined_state_host(values, undef: float = UNDEF) -> ValuesDefined:
    """``checkDefined(const float*, n)`` (FieldDefined.cc:41-57) on the
    host: tri-state summary of a sentinel-encoded numpy array."""
    v = _f32c(values)
    n_def = count_defined(v, undef)
    if n_def == v.size:
        return ValuesDefined.ALL_DEFINED
    if n_def == 0:
        return ValuesDefined.NONE_DEFINED
    return ValuesDefined.SOME_DEFINED
