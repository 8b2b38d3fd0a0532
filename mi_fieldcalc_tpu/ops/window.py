"""Neighbourhood (windowed) functions.

Reference: FieldCalculations.cc — neighbourProbFunctions (2862, summed-area
-table box mean) and neighbourFunctions (2955, strided window stats with
block fill).

Design notes:

* the summed-area table becomes two ``jnp.cumsum`` passes — used ONLY
  for the 0/1 indicator fields (probability modes), where the prefix
  sums are exact small integers.  The raw-value window MEAN sums each
  window directly via ``lax.reduce_window`` like the reference's per-
  window loop (cc:3031): reconstructing a ~1e2 window sum as a
  difference of ~1e6 SAT corners loses ~1e-3 relative in f32 on
  production-size grids — far outside the 2e-5 conformance tolerance,
* window max/min use ``lax.reduce_window``,
* the strided sample + block-fill of ``neighbourFunctions`` becomes a
  gather from the per-point window statistic (every output point maps to
  exactly one sample point),
* the window percentile sorts stacked shifted copies of the field —
  fine for the small radii the reference uses; the (2R+1)^2 memory blowup
  is the documented limit.

Both functions require ALL_DEFINED input (reference cc:2868, 2964), so
masks only appear in the undef border of the output.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from ..field import Field
from ._harness import require
from .stencil import _SHARD_CTX

__all__ = ["neighbour_prob_functions", "neighbour_functions"]

_f32 = jnp.float32


def _grid_ctx(shape):
    """(row0, col0, nyg, nxg): the local block's global origin and the
    global extents.  Unsharded these are (0, 0, ny, nx); under
    ``run_sharded`` the installed :class:`..ops.stencil.ShardCtx`
    supplies them — the border-undef ring and the strided block grid are
    GLOBAL-coordinate semantics (reference cc:2992-3011, 3003), so a
    local iota would put borders at shard seams and shift every shard's
    sample grid."""
    ctx = _SHARD_CTX.get()
    ny, nx = shape[-2], shape[-1]
    if ctx is None:
        return 0, 0, ny, nx
    return ctx.row0, ctx.col0, ctx.nyg, ctx.nxg


def _box_sum_sat(ind, rng: int):
    """Box sum over [-rng, rng]^2 windows via a summed-area table, matching
    the reference's inclusion/exclusion on the SAT (cc:2898-2928).  Valid
    for points at distance >= rng from the border; other points contain
    garbage that callers mask out."""
    # SAT[j, i] = sum over rows <= j, cols <= i  (cumsum y then x, cc order)
    sat = jnp.cumsum(jnp.cumsum(ind, axis=-2), axis=-1)
    ny, nx = ind.shape[-2], ind.shape[-1]
    pad = jnp.pad(sat, [(0, 0)] * (ind.ndim - 2) + [(1, 0), (1, 0)])

    def window_sum(a):
        # sum over window rows [j-rng, j+rng], cols [i-rng, i+rng]
        jmax = a[..., 2 * rng + 1:, 2 * rng + 1:]
        jmin = a[..., : - (2 * rng + 1), : - (2 * rng + 1)]
        jxm = a[..., 2 * rng + 1:, : - (2 * rng + 1)]
        jmx = a[..., : - (2 * rng + 1), 2 * rng + 1:]
        return jmax + jmin - jxm - jmx

    core = window_sum(pad)  # shape [..., ny-2rng, nx-2rng]
    out = jnp.zeros(ind.shape, ind.dtype)
    return out.at[..., rng:ny - rng, rng:nx - rng].set(core)


def _border_mask(shape, rng: int):
    ny, nx = shape[-2], shape[-1]
    row0, col0, nyg, nxg = _grid_ctx(shape)
    y = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 0) + row0
    x = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 1) + col0
    inner = (y >= rng) & (y < nyg - rng) & (x >= rng) & (x < nxg - rng)
    return jnp.broadcast_to(inner, shape)


def neighbour_prob_functions(f: Field, constants: Sequence[float],
                             compute: int) -> Field:
    """Thresholded box-mean probability via summed-area table
    (FieldCalculations.cc:2862-2953).

    compute: 5 probability above, 6 probability below; ``constants`` =
    (limit, range).  Both are truncated to int as in the reference
    (cc:2877-2878).  The ``range``-wide border is undefined.
    """
    require(compute in (5, 6), f"neighbourProbFunctions: bad compute {compute}")
    require(len(constants) >= 2, "neighbourProbFunctions: needs 2 constants")
    limit = int(constants[0])
    rng = int(constants[1])
    # negative range is out-of-bounds UB in the reference's SAT loops —
    # reject (degenerate slices here would return garbage marked defined)
    require(rng >= 0, "neighbourProbFunctions: bad range")

    v = f.values
    ind = jnp.where(v > limit if compute == 5 else v < limit,
                    _f32(1), _f32(0))
    if rng == 0:
        return Field(ind, jnp.ones(f.shape, bool))

    n_win = _f32((2 * rng + 1) ** 2)
    box = _box_sum_sat(ind, rng) / n_win
    inner = _border_mask(f.shape, rng)
    return Field(box, inner)


def _window_stack(v, rng: int):
    """All (2R+1)^2 window members as a leading axis, ordered like the
    reference's (k = window row, j = window col) loops (cc:3028-3029).

    Small radii unroll (cheap, XLA-fusable); larger ones build the stack
    with a ``fori_loop`` — an unrolled 49+-roll graph hits the remote
    compiler's minutes-long pathology (CLAUDE.md loop rule).  The caller
    sorts the stack, so member order is irrelevant to the result either
    way (kept reference-ordered regardless)."""
    w = 2 * rng + 1
    n = w * w
    if n <= 16:
        parts = []
        for dy in range(-rng, rng + 1):
            for dx in range(-rng, rng + 1):
                parts.append(jnp.roll(jnp.roll(v, -dy, axis=-2),
                                      -dx, axis=-1))
        return jnp.stack(parts)

    def body(k, acc):
        dy = k // w - rng
        dx = k % w - rng
        shifted = jnp.roll(jnp.roll(v, -dy, axis=-2), -dx, axis=-1)
        return acc.at[k].set(shifted)

    return jax.lax.fori_loop(
        0, n, body, jnp.zeros((n,) + v.shape, v.dtype))


def neighbour_functions(f: Field, constants: Sequence[float],
                        compute: int) -> Field:
    """Strided windowed statistics with block fill
    (FieldCalculations.cc:2955-3061).

    compute: 1 mean, 2 max, 3 min, 4 percentile, 5 prob above, 6 prob below.
    constants: (range[, step]) for compute<4, else (limit, range[, step]).
    Sample points advance by ``step``; each sample's value is block-filled
    into the surrounding step x step cells.  The border of width ``range``
    (and any cells beyond the last block) is undefined.
    """
    require(1 <= compute <= 6, f"neighbourFunctions: bad compute {compute}")
    require(len(constants) >= 1 and not (len(constants) < 2 and compute > 3),
            "neighbourFunctions: not enough constants")
    rng, step, limit = 3, 3, 0
    if compute < 4:
        rng = int(constants[0])
        if len(constants) == 2:
            step = int(constants[1])
    else:
        limit = int(constants[0])
        rng = int(constants[1])
        if len(constants) == 3:
            step = int(constants[2])
    ny, nx = f.shape[-2], f.shape[-1]
    row0, col0, nyg, nxg = _grid_ctx(f.shape)
    require(rng <= nxg and rng <= nyg and rng >= 1,
            "neighbourFunctions: bad range")
    require(step >= 1, "neighbourFunctions: bad step")

    v = f.values
    n_win = _f32((2 * rng + 1) ** 2)

    # per-point window statistic (valid on the rng-inset interior)
    if compute == 1:
        # direct per-window summation (see module docstring: the SAT
        # corner-difference cancels catastrophically on real grids)
        stat = jax.lax.reduce_window(
            v, _f32(0), jax.lax.add,
            window_dimensions=(1,) * (v.ndim - 2) + (2 * rng + 1,
                                                     2 * rng + 1),
            window_strides=(1,) * v.ndim,
            padding="SAME") / n_win
    elif compute in (2, 3):
        init = _f32(-jnp.inf) if compute == 2 else _f32(jnp.inf)
        op = jax.lax.max if compute == 2 else jax.lax.min
        stat = jax.lax.reduce_window(
            v, init, op,
            window_dimensions=(1,) * (v.ndim - 2) + (2 * rng + 1, 2 * rng + 1),
            window_strides=(1,) * v.ndim,
            padding="SAME")
    elif compute == 4:
        # reference cc:3044 indexes sorted[n_win*limit/100]: limit
        # outside [0, 100) is out-of-bounds UB there — reject per the
        # invalid-params-raise policy (negative limit would otherwise
        # silently wrap to a high percentile here)
        require(0 <= limit < 100, "neighbourFunctions: bad percentile")
        win = _window_stack(v, rng)
        win = jnp.sort(win, axis=0)
        # python-int arithmetic: int(n_win) on the staged jnp scalar is
        # a ConcretizationTypeError under jit
        ii = ((2 * rng + 1) ** 2) * limit // 100
        stat = win[ii]
    else:  # 5 / 6: probability
        ind = jnp.where(v > limit if compute == 5 else v < limit,
                        _f32(1), _f32(0))
        stat = _box_sum_sat(ind, rng) / n_win

    # map each output point to its sample point (strided block fill).
    # Every block is a contiguous step x step cell around a sample, so the
    # fill is a strided slice + repeat — no full-grid gather.  Coordinates are
    # GLOBAL: under run_sharded the block grid must not restart at shard
    # seams, so the sharded form selects among ``step`` rolled copies per
    # axis by the (traced) phase of the global block grid instead of the
    # static strided slice.  Sharded callers pass composed radius
    # ``rng + step - 1`` (the sample point of a seam cell sits up to
    # step-1 rows into the neighbour shard).
    first = rng
    y = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 0) + row0
    x = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 1) + col0

    def axis_meta(dim):
        n_blocks = max((dim - 2 * rng + step - 1) // step, 0)
        lo = first - (step - 1) // 2
        return n_blocks, lo

    def valid_of(coord, dim):
        n_blocks, lo = axis_meta(dim)
        bid = (coord - lo) // step
        valid = (bid >= 0) & (bid < n_blocks) & (coord >= lo)
        s = first + jnp.clip(bid, 0, max(n_blocks - 1, 0)) * step
        hi = s - (step - 1) // 2 + step  # exclusive end of the block
        return valid & (coord < hi)

    valid = valid_of(y, nyg) & valid_of(x, nxg)
    sharded = _SHARD_CTX.get() is not None
    if step == 1:
        gathered = stat          # every point is its own sample
    elif sharded:
        # gathered[l] = stat[l + (t - o)] with o = (g - lo) % step the
        # within-block offset and t = first - lo static: select among
        # the step possible shifts per axis (2*step rolled copies — a
        # post-processing op, not the hot path)
        t = (step - 1) // 2

        def fill_axis(a, axis, origin):
            lo = first - (step - 1) // 2
            o = (jax.lax.broadcasted_iota(jnp.int32, a.shape, axis)
                 + (origin - lo) % step) % step
            res = a if t == 0 else jnp.roll(a, -t, axis=axis)
            for k in range(1, step):
                res = jnp.where(o == k, jnp.roll(a, k - t, axis=axis), res)
            return res

        gathered = fill_axis(fill_axis(stat, stat.ndim - 2, row0),
                             stat.ndim - 1, col0)
    else:
        nby, lo_y = axis_meta(nyg)
        nbx, lo_x = axis_meta(nxg)
        samples = stat[..., rng:rng + (nby - 1) * step + 1:step,
                       rng:rng + (nbx - 1) * step + 1:step]
        up = jnp.repeat(jnp.repeat(samples, step, axis=-2), step, axis=-1)

        def paste(dim, lo, nb):
            src0, dst0 = max(0, -lo), max(0, lo)
            return src0, dst0, min(dim - dst0, nb * step - src0)

        sy0, dy0, ly = paste(ny, lo_y, nby)
        sx0, dx0, lx = paste(nx, lo_x, nbx)
        gathered = jnp.zeros(stat.shape, stat.dtype)
        gathered = gathered.at[..., dy0:dy0 + ly, dx0:dx0 + lx].set(
            up[..., sy0:sy0 + ly, sx0:sx0 + lx])
    out = jnp.where(valid, gathered, _f32(0))
    return Field(out, jnp.broadcast_to(valid, out.shape))
