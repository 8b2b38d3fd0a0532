"""Native host codec (native/fieldcodec.cc via mi_fieldcalc_tpu.native).

Checks the compiled path against the numpy fallback formulas and against
the device-side Field codec, including NaN handling, in the presence of
all three tri-state regimes (ALL/NONE/SOME defined).
"""

import numpy as np
import pytest

from mi_fieldcalc_tpu import native
from mi_fieldcalc_tpu.field import UNDEF, ValuesDefined, from_sentinel


def _sentinel_grid(rng, shape, frac_undef=0.3, with_nan=True):
    v = rng.normal(size=shape).astype(np.float32)
    u = rng.uniform(size=shape)
    v[u < frac_undef] = np.float32(UNDEF)
    if with_nan:
        v[u > 1.0 - frac_undef / 4] = np.nan
    return v


def test_native_builds():
    assert native.available(), "native codec failed to build/load"


@pytest.mark.parametrize("shape", [(1,), (7, 13), (719, 929), (3, 64, 64)])
def test_decode_matches_numpy(shape):
    rng = np.random.default_rng(0)
    v = _sentinel_grid(rng, shape)
    out, mask, n_def = native.decode(v, UNDEF, fill=-1.5)
    ref_mask = ~np.isnan(v) & (v != np.float32(UNDEF))
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_array_equal(out, np.where(ref_mask, v, np.float32(-1.5)))
    assert n_def == int(ref_mask.sum())


def test_decode_matches_device_codec():
    rng = np.random.default_rng(1)
    v = _sentinel_grid(rng, (33, 41))
    _, mask, _ = native.decode(v)
    f = from_sentinel(v)
    np.testing.assert_array_equal(mask, np.asarray(f.mask))


def test_encode_roundtrip():
    rng = np.random.default_rng(2)
    v = _sentinel_grid(rng, (50, 60), with_nan=False)
    out, mask, _ = native.decode(v, UNDEF, fill=0.0)
    back = native.encode(out, mask, UNDEF)
    np.testing.assert_array_equal(back, v)


def test_encode_broadcast_mask():
    v = np.arange(12, dtype=np.float32).reshape(3, 4)
    enc = native.encode(v, np.array([True, False, True, False]), UNDEF)
    assert (enc[:, 1] == np.float32(UNDEF)).all()
    np.testing.assert_array_equal(enc[:, 0], v[:, 0])


@pytest.mark.parametrize("frac,expect", [
    (0.0, ValuesDefined.ALL_DEFINED),
    (1.0, ValuesDefined.NONE_DEFINED),
    (0.5, ValuesDefined.SOME_DEFINED),
])
def test_defined_state_host(frac, expect):
    rng = np.random.default_rng(3)
    v = rng.normal(size=(40, 40)).astype(np.float32)
    u = rng.uniform(size=v.shape)
    v[u < frac] = np.float32(UNDEF)
    if frac == 1.0:
        v[:] = np.float32(UNDEF)
    assert native.defined_state_host(v, UNDEF) == expect
    assert native.count_defined(v, UNDEF) == int(
        (~np.isnan(v) & (v != np.float32(UNDEF))).sum())


def test_large_threaded_consistency():
    # crosses every thread-count threshold (1e3/1e4/1e5 points)
    rng = np.random.default_rng(4)
    for n in (999, 1001, 10001, 100001, 500000):
        v = _sentinel_grid(rng, (n,))
        out, mask, n_def = native.decode(v)
        assert n_def == int((~np.isnan(v) & (v != np.float32(UNDEF))).sum())
        assert (out[~mask] == 0.0).all()
        nan_free = np.nan_to_num(v, nan=np.float32(UNDEF))
        np.testing.assert_array_equal(out[mask], nan_free[mask])


@pytest.mark.parametrize("shape,padded", [
    ((45, 130), None),            # default canonical padded shape
    ((3, 45, 130), (48, 256)),    # explicit, 3-D stack
    ((8, 128), None),             # already aligned: pure decode
])
def test_decode_pad(shape, padded):
    from mi_fieldcalc_tpu.layout import padded_shape

    rng = np.random.default_rng(7)
    v = _sentinel_grid(rng, shape)
    ny, nx = shape[-2:]
    ny_p, nx_p = padded if padded else padded_shape(ny, nx)
    out, mask, n_def = native.decode_pad(
        v, *(padded if padded else (None, None)), fill=0.0)
    assert out.shape == shape[:-2] + (ny_p, nx_p)
    assert mask.dtype == np.bool_
    # logical region decodes exactly like decode()
    ref_out, ref_mask, ref_n = native.decode(v)
    np.testing.assert_array_equal(out[..., :ny, :nx], ref_out)
    np.testing.assert_array_equal(mask[..., :ny, :nx], ref_mask)
    assert n_def == ref_n
    # dead rows/lanes: mask False, values fill
    assert not mask[..., ny:, :].any() and not mask[..., :, nx:].any()
    assert (out[..., ny:, :] == 0.0).all() and (out[..., :, nx:] == 0.0).all()


def test_decode_pad_encode_trim_roundtrip():
    rng = np.random.default_rng(8)
    v = _sentinel_grid(rng, (5, 41, 200), with_nan=False)
    out, mask, _ = native.decode_pad(v)
    back = native.encode_trim(out, mask, 41, 200)
    np.testing.assert_array_equal(back, v)


def test_decode_pad_rejects_too_small():
    v = np.zeros((16, 200), np.float32)
    with pytest.raises(ValueError):
        native.decode_pad(v, 16, 128)
    with pytest.raises(ValueError):
        native.encode_trim(v, np.ones_like(v, bool), 32, 200)


def test_encode_trim_matches_fallback():
    rng = np.random.default_rng(9)
    vp = rng.normal(size=(2, 48, 256)).astype(np.float32)
    mp = rng.uniform(size=vp.shape) > 0.3
    got = native.encode_trim(vp, mp, 45, 130)
    want = np.where(mp[..., :45, :130], vp[..., :45, :130],
                    np.float32(UNDEF))
    np.testing.assert_array_equal(got, want)


def test_decode_pad_batch_matches_per_field():
    rng = np.random.default_rng(10)
    arrays = [_sentinel_grid(rng, (3, 45, 130)) for _ in range(5)]
    vals, mask, counts = native.decode_pad_batch(arrays, fill=-2.0)
    assert vals.shape == (5, 3, 48, 256) and mask.shape == vals.shape
    for k, a in enumerate(arrays):
        rv, rm, rn = native.decode_pad(a, fill=-2.0)
        np.testing.assert_array_equal(vals[k], rv)
        np.testing.assert_array_equal(mask[k], rm)
        assert counts[k] == rn


def test_decode_pad_batch_reuses_buffers():
    rng = np.random.default_rng(11)
    arrays = [_sentinel_grid(rng, (45, 130)) for _ in range(3)]
    out = np.empty((3, 48, 256), np.float32)
    m = np.empty((3, 48, 256), np.uint8)
    vals, mask, _ = native.decode_pad_batch(arrays, out=out, mask=m)
    if native.available():
        assert vals is out and mask.base is m
    with pytest.raises(ValueError):
        native.decode_pad_batch(arrays, out=np.empty((2, 48, 256),
                                                     np.float32), mask=m)


def test_encode_trim_batch_roundtrip():
    rng = np.random.default_rng(12)
    arrays = [_sentinel_grid(rng, (2, 41, 140), with_nan=False)
              for _ in range(4)]
    vals, mask, _ = native.decode_pad_batch(arrays)
    back = native.encode_trim_batch(vals, mask, 41, 140)
    assert len(back) == 4
    for a, b in zip(arrays, back):
        np.testing.assert_array_equal(a, b)


def test_pool_off_matches_pool_on(monkeypatch):
    """MF_NATIVE_POOL=0 falls back to spawn-per-call with identical
    results (the pool is an executor, not a semantics change)."""
    import importlib
    rng = np.random.default_rng(13)
    v = _sentinel_grid(rng, (64, 200))
    ref = native.decode(v)
    monkeypatch.setenv("MF_NATIVE_POOL", "0")
    # env is read per call inside the C++ entry; no reload needed
    got = native.decode(v)
    np.testing.assert_array_equal(ref[0], got[0])
    np.testing.assert_array_equal(ref[1], got[1])
    assert ref[2] == got[2]


def test_concurrent_codec_calls_overlap_correctly():
    """ctypes releases the GIL: two threads in the codec at once must
    not corrupt each other (the pool try-locks; the loser spawns)."""
    import concurrent.futures as cf
    rng = np.random.default_rng(14)
    arrays = [_sentinel_grid(rng, (300, 400)) for _ in range(8)]
    want = [native.decode(a) for a in arrays]
    with cf.ThreadPoolExecutor(4) as ex:
        got = list(ex.map(native.decode, arrays))
    for (wv, wm, wn), (gv, gm, gn) in zip(want, got):
        np.testing.assert_array_equal(wv, gv)
        np.testing.assert_array_equal(wm, gm)
        assert wn == gn


def test_encode_trim_batch_mask_map():
    """mask_map consumes deduplicated / partial mask stacks (ABI v4):
    plane f uses mask plane mask_map[f]; -1 means constant defined
    (plain trim).  Native and numpy fallback agree."""
    rng = np.random.default_rng(21)
    k, lead, ny, nx, ny_p, nx_p = 4, 2, 21, 140, 24, 256
    vals = rng.normal(size=(k, lead, ny_p, nx_p)).astype(np.float32)
    masks = (rng.uniform(size=(2, lead, ny_p, nx_p)) > 0.3)
    mask_map = (0, 1, 0, -1)

    outs = native.encode_trim_batch(vals, masks, ny, nx,
                                    mask_map=mask_map)
    assert len(outs) == k
    for f, mf in enumerate(mask_map):
        want = vals[f, :, :ny, :nx].copy()
        if mf >= 0:
            want = np.where(masks[mf, :, :ny, :nx], want,
                            np.float32(native.UNDEF))
        np.testing.assert_array_equal(outs[f], want)

    # numpy fallback path (forced by hiding the lib)
    import mi_fieldcalc_tpu.native as nat
    saved = nat._lib, nat._tried
    try:
        nat._lib, nat._tried = None, True
        fb = nat.encode_trim_batch(vals, masks, ny, nx,
                                   mask_map=mask_map)
    finally:
        nat._lib, nat._tried = saved
    for a, b in zip(outs, fb):
        np.testing.assert_array_equal(a, b)

    with pytest.raises(ValueError):
        native.encode_trim_batch(vals, masks, ny, nx, mask_map=(0, 1))
    with pytest.raises(ValueError):
        native.encode_trim_batch(vals, masks, ny, nx,
                                 mask_map=(0, 1, 2, -1))


def test_decode_pad_levpack_batch_matches_batch():
    """LEV-packed staging (ABI v5): values and counts equal the plain
    batch decode; the uint32 planes equal the manual bit pack (bit L =
    level L defined), with dead rows/lanes all-zero; native ==
    fallback."""
    rng = np.random.default_rng(11)
    nlev, ny, nx = 5, 13, 37
    arrays = [_sentinel_grid(rng, (nlev, ny, nx)) for _ in range(3)]
    vals, pm, counts = native.decode_pad_levpack_batch(arrays, 16, 128)
    v2, m2, c2 = native.decode_pad_batch(arrays, 16, 128)
    np.testing.assert_array_equal(vals, v2)
    assert counts == c2
    assert pm.dtype == np.uint32 and pm.shape == (3, 16, 128)
    bits = (np.uint32(1) << np.arange(nlev, dtype=np.uint32)
            )[:, None, None]
    for k in range(3):
        want = (m2[k].astype(np.uint32) * bits).sum(0, dtype=np.uint32)
        np.testing.assert_array_equal(pm[k], want)
    assert not pm[:, ny:, :].any() and not pm[:, :, nx:].any()

    # numpy fallback path (forced by hiding the lib)
    import mi_fieldcalc_tpu.native as nat
    saved = nat._lib, nat._tried
    try:
        nat._lib, nat._tried = None, True
        fv, fp, fcnt = nat.decode_pad_levpack_batch(arrays, 16, 128)
    finally:
        nat._lib, nat._tried = saved
    np.testing.assert_array_equal(fv, vals)
    np.testing.assert_array_equal(fp, pm)
    assert fcnt == counts

    with pytest.raises(ValueError):
        native.decode_pad_levpack_batch([arrays[0][0]])      # 2-D input
    with pytest.raises(ValueError):
        native.decode_pad_levpack_batch(
            [np.zeros((33, 4, 4), np.float32)])              # nlev > 32


def test_encode_trim_batch_levpack_roundtrip():
    """encode_trim_batch consumes the LEV-packed uint32 mask layout:
    round-trips the levpack decode bit-exactly, honors shared planes and
    -1 (constant defined), native == fallback."""
    rng = np.random.default_rng(12)
    nlev, ny, nx = 4, 11, 30
    arrays = [_sentinel_grid(rng, (nlev, ny, nx), with_nan=False)
              for _ in range(3)]
    vals, pm, _ = native.decode_pad_levpack_batch(arrays, 16, 128)
    outs = native.encode_trim_batch(vals, pm, ny, nx,
                                    mask_map=list(range(3)))
    for a, o in zip(arrays, outs):
        np.testing.assert_array_equal(o, a)

    # shared plane + constant-defined entries
    outs2 = native.encode_trim_batch(vals, pm[:1], ny, nx,
                                     mask_map=[0, -1, 0])
    np.testing.assert_array_equal(outs2[1], vals[1][:, :ny, :nx])
    bits = (np.uint32(1) << np.arange(nlev, dtype=np.uint32)
            )[:, None, None]
    m0 = (pm[0, None, :ny, :nx] & bits) != 0
    m0 = m0.reshape(nlev, ny, nx)
    np.testing.assert_array_equal(
        outs2[2], np.where(m0, vals[2][:, :ny, :nx],
                           np.float32(native.UNDEF)))

    import mi_fieldcalc_tpu.native as nat
    saved = nat._lib, nat._tried
    try:
        nat._lib, nat._tried = None, True
        fb = nat.encode_trim_batch(vals, pm[:1], ny, nx,
                                   mask_map=[0, -1, 0])
    finally:
        nat._lib, nat._tried = saved
    for a, b in zip(outs2, fb):
        np.testing.assert_array_equal(a, b)

    with pytest.raises(ValueError):      # packed masks require mask_map
        native.encode_trim_batch(vals, pm, ny, nx)
    with pytest.raises(ValueError):      # map names a missing plane
        native.encode_trim_batch(vals, pm[:1], ny, nx, mask_map=[0, 1, 0])


def test_decode_resample_batch_matches_numpy_reference():
    """ABI v6 aligned-ingest pass: native fused decode+re-grid equals
    the numpy reference (ingest.resample_align + decode) — masks and
    counts exactly, values to FP-contraction tolerance — and the
    no-library fallback equals it too."""
    from mi_fieldcalc_tpu.ingest import resample_align

    rng = np.random.default_rng(33)
    UNDEF = native.UNDEF
    a = rng.uniform(200.0, 300.0, (3, 37, 53)).astype(np.float32)
    b = rng.uniform(0.0, 10.0, (3, 37, 53)).astype(np.float32)
    for arr in (a, b):
        arr[..., 5, 5] = UNDEF
        arr[0, 10, 20] = np.nan
        arr[..., :, 50] = UNDEF          # a whole undef column
    ny_t, nx_t = 40, 128
    out, mask, counts = native.decode_resample_batch([a, b], ny_t, nx_t)
    assert out.shape == (2, 3, ny_t, nx_t)
    for i, arr in enumerate((a, b)):
        ref = resample_align(arr, UNDEF, shape_to=(ny_t, nx_t))
        rmask = (ref != np.float32(UNDEF)) & ~np.isnan(ref)
        np.testing.assert_array_equal(mask[i], rmask)
        assert counts[i] == int(rmask.sum())
        d = np.abs(out[i][rmask] - ref[rmask])
        rel = d / np.maximum(np.abs(ref[rmask]), 1e-6)
        assert rel.max() <= 2e-6

    import mi_fieldcalc_tpu.native as nat
    saved = nat._lib, nat._tried
    try:
        nat._lib, nat._tried = None, True
        fout, fmask, fcounts = nat.decode_resample_batch([a, b],
                                                         ny_t, nx_t)
    finally:
        nat._lib, nat._tried = saved
    np.testing.assert_array_equal(mask, fmask)
    assert list(counts) == list(fcounts)
    d = np.abs(out[mask] - fout[fmask])
    assert (d / np.maximum(np.abs(fout[fmask]), 1e-6)).max() <= 2e-6
