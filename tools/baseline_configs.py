"""Time the BASELINE.json configs that fit on one GPU.

Prints one JSON line per config (device step time under
``block_until_ready``, median of the timed reps, with the device named):

1. potential temperature + dewpoint, one pressure level, small grid
   with undefs (mirrors FieldCalculationsTest; dispatch-bound),
1b. the config-1 class at the production call pattern: a 22-call
   drop-in storm through ``api.batch()``,
2. the humidity/temperature conversion suite (aleveltemp + alevelhum
   modes) over 10 levels with undef masking,
3. the horizontal stencil set (geostrophic wind x/y, relative
   vorticity, divergence, gradient modes 1-4) on the global 0.25
   degree grid,
4. the 3-D vertical pipeline (137 hybrid levels -> 11 isobaric
   surfaces -> the 12 derived fields).

Usage: ``python tools/baseline_configs.py`` on a machine with a GPU.
"""
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np

UNDEF = np.float32(1e35)
STORM_NY, STORM_NX = 96, 128


def storm(fc, g):
    """A 22-call mixed drop-in storm (the Diana-caller pattern); returns
    the list of results."""
    t5, t7, t8, rh7, rh8, q8, z7, z10, u8, v8, u5, v5, td8, td5 = g
    r = []
    r.append(fc.kIndex(t5, t7, rh7, t8, rh8, 500., 700., 850., 1))
    r.append(fc.ductingIndex(t8, rh8, 850., 1))
    r.append(fc.showalterIndex(t5, t8, rh8, 500., 850., 1))
    r.append(fc.boydenIndex(t7, z7, z10, 700., 1000., 1))
    r.append(fc.sweatIndex(t8, t5, td8, td5, u8, v8, u5, v5))
    c8 = fc.cvtemp(t8, 2)
    r.append(c8)
    r.append(fc.abshum(t8, rh8, fc.UNDEF))
    r.append(fc.windCooling(c8, u8, v8, 2))
    for c in (1, 3, 5):
        r.append(fc.plevelhum(t8, rh8 if c in (3, 5) else q8, 850., "", c))
    for c in (1, 3, 4):
        r.append(fc.pleveltemp(t8, 850., "", c))
    r.append(fc.vectorabs(u8, v8))
    r.append(fc.underCooledRain(q8, q8, t8, 1e-5, 1e-3, 275.0))
    for const in (0.5, 2.0):
        r.append(fc.fieldOPERconstant(2, t8, const))
    r.append(fc.sumFields([t5, t7, t8]))
    r.append(fc.minvalueFields(t5, t8))
    r.append(fc.maxvalueFields(t5, t8))
    r.append(fc.absvalueField(u8))
    return r


def storm_inputs(ny=STORM_NY, nx=STORM_NX, seed=7):
    """The storm's 14 sentinel grids (one undef point each)."""
    rng = np.random.default_rng(seed)

    def u(lo, hi):
        x = rng.uniform(lo, hi, (ny, nx)).astype(np.float32)
        x[0, 0] = UNDEF
        return x

    return (u(240, 260), u(250, 275), u(260, 290), u(5, 95), u(5, 95),
            u(1e-4, 8e-3), u(2800, 3200), u(0, 300), u(-20, 20),
            u(-20, 20), u(-40, 40), u(-40, 40), u(255, 285), u(230, 255))


def _sent(rng, lo, hi, shape, undef_frac=0.02):
    a = rng.uniform(lo, hi, shape).astype(np.float32)
    a[rng.random(shape) < undef_frac] = UNDEF
    return a


def timed(fn, reps=20):
    """(median, min) seconds of ``fn`` over ``reps`` runs after one
    warm-up, each ended by ``block_until_ready``."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), min(ts)


def emit(config, desc, pts, t, extra=None):
    import jax
    d = jax.devices()[0]
    row = {"config": config, "desc": desc, "points": pts,
           "ms_per_step": t[0] * 1e3, "ms_min": t[1] * 1e3,
           "points_per_sec": pts / t[0],
           "device": {"platform": d.platform, "kind": d.device_kind}}
    if extra:
        row.update(extra)
    print(json.dumps(row), flush=True)


def config1():
    import jax
    from mi_fieldcalc_tpu import from_sentinel
    from mi_fieldcalc_tpu.ops import plevelhum, pleveltemp

    rng = np.random.default_rng(0)
    ny, nx = 96, 128
    tk = from_sentinel(_sent(rng, 250, 300, (ny, nx)))
    q = from_sentinel(_sent(rng, 1e-4, 1e-2, (ny, nx)))

    @jax.jit
    def step(tk, q):
        return (pleveltemp(tk, 850.0, compute=3),
                plevelhum(tk, q, 850.0, compute=11))

    emit(1, "theta+dewpoint, 1 plevel, 96x128 with undefs", ny * nx,
         timed(lambda: step(tk, q)))


def config1b():
    import mi_fieldcalc_tpu.api as fc

    g = storm_inputs()
    ncalls = len(storm(fc, g))
    eager = timed(lambda: storm(fc, g), reps=5)

    def batched():
        with fc.batch():
            out = storm(fc, g)
        return [np.asarray(o) for o in out]

    emit("1b", f"{ncalls}-call drop-in storm via api.batch(), 96x128",
         ncalls * STORM_NY * STORM_NX, timed(batched, reps=10),
         {"eager_ms": eager[0] * 1e3})


def config2():
    from mi_fieldcalc_tpu import from_sentinel
    from mi_fieldcalc_tpu.ops.fused_suite import alevel_suite_fused

    rng = np.random.default_rng(1)
    nlev, ny, nx = 10, 719, 929
    tk = from_sentinel(_sent(rng, 250, 300, (nlev, ny, nx)))
    q = from_sentinel(_sent(rng, 1e-4, 1e-2, (nlev, ny, nx)))
    rh = from_sentinel(_sent(rng, 5, 95, (nlev, ny, nx)))
    p = from_sentinel(rng.uniform(300, 1000, (nlev, ny, nx)
                                  ).astype(np.float32))
    kw = CONFIG2_MODES
    emit(2, "humidity/temperature suite (8 conversions), 10 levels, "
            "719x929, undef masking", 8 * nlev * ny * nx,
         timed(lambda: alevel_suite_fused(tk, q, rh, p, **kw)))


#: config 2's conversions (alevelhum numbering: 5/6/9/10 take q,
#: 7/8/11/12 take RH — levels.py _levelhum_core)
CONFIG2_MODES = dict(temps=(3, 4), hums_q=(1, 5, 9), hums_rh=(3, 7, 11))


def config3():
    import jax
    import jax.numpy as jnp
    from mi_fieldcalc_tpu import from_sentinel
    from mi_fieldcalc_tpu.ops import (divergence, gradient,
                                      plevelgwind_xcomp,
                                      plevelgwind_ycomp, relvort)

    rng = np.random.default_rng(2)
    ny, nx = 721, 1440
    z = from_sentinel(_sent(rng, 4800, 5900, (ny, nx), undef_frac=0.005))
    u = from_sentinel(_sent(rng, -30, 30, (ny, nx), undef_frac=0.005))
    v = from_sentinel(_sent(rng, -30, 30, (ny, nx), undef_frac=0.005))
    tk = from_sentinel(_sent(rng, 250, 300, (ny, nx), undef_frac=0.005))
    xm = jnp.full((ny, nx), 4e-6, jnp.float32)
    ym = jnp.full((ny, nx), 4e-6, jnp.float32)
    fc = jnp.full((ny, nx), 1.2e-4, jnp.float32)

    @jax.jit
    def step(z, u, v, tk):
        outs = [plevelgwind_xcomp(z, xm, ym, fc),
                plevelgwind_ycomp(z, xm, ym, fc),
                relvort(u, v, xm, ym), divergence(u, v, xm, ym)]
        return outs + [gradient(tk, xm, ym, compute=c) for c in (1, 2, 3, 4)]

    emit(3, "stencil set (8 fields) on global 0.25deg 721x1440",
         8 * ny * nx, timed(lambda: step(z, u, v, tk)))


def config4():
    import functools

    import jax
    import jax.numpy as jnp
    from mi_fieldcalc_tpu import from_sentinel
    from mi_fieldcalc_tpu.models.pipeline import (STANDARD_PLEVELS,
                                                  derived_fields_isobaric)

    rng = np.random.default_rng(3)
    nlev, ny, nx = 137, 719, 929

    def fld(lo, hi):
        return from_sentinel(_sent(rng, lo, hi, (nlev, ny, nx),
                                   undef_frac=0.005))

    tk, q = fld(220, 300), fld(1e-4, 1e-2)
    u, v = fld(-40, 40), fld(-40, 40)
    ps = from_sentinel(rng.uniform(950, 1030, (ny, nx)).astype(np.float32))
    al = jnp.asarray(np.linspace(50, 300, nlev), jnp.float32)
    bl = jnp.asarray(np.linspace(0.0, 0.7, nlev) ** 1.5, jnp.float32)
    xm = jnp.full((ny, nx), 4e-7, jnp.float32)
    fc = jnp.full((ny, nx), 1.2e-4, jnp.float32)
    step = jax.jit(functools.partial(derived_fields_isobaric,
                                     plevels=STANDARD_PLEVELS))
    emit(4, "137L hybrid -> 11 plevels -> 12 derived fields, 719x929",
         nlev * ny * nx,
         timed(lambda: step(tk, q, u, v, ps, al, bl, xm, xm, fc), reps=10),
         {"plevels": len(STANDARD_PLEVELS)})


def main():
    from mi_fieldcalc_tpu.backend import require_gpu
    from mi_fieldcalc_tpu.utils.compile_cache import enable
    enable()
    require_gpu("tools/baseline_configs.py")
    for f in (config1, config1b, config2, config3, config4):
        f()


if __name__ == "__main__":
    main()
