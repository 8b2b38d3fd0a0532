"""End-to-end tour: derived forecast products three ways.

1. the drop-in numpy API (what existing mi-fieldcalc users call),
2. the native Field surface, batched over levels and jitted,
3. the sharded pipeline over a device mesh.

Runs anywhere (CPU included): ``python examples/forecast_products.py``.
"""

import numpy as np

import jax
import jax.numpy as jnp


def synthetic_state(nlev=10, ny=96, nx=128, seed=0):
    """A vaguely atmospheric synthetic model state on hybrid levels."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(-1, 1, ny)[:, None]
    xx = np.linspace(-1, 1, nx)[None, :]
    blob = np.exp(-(yy ** 2 + xx ** 2) * 3).astype(np.float32)
    lev = np.linspace(0.3, 1.0, nlev)[:, None, None].astype(np.float32)
    tk = 220 + 70 * lev + 8 * blob[None] \
        + rng.normal(0, 0.5, (nlev, ny, nx)).astype(np.float32)
    q = (1e-3 * lev * (1 + blob[None])).astype(np.float32)
    u = 15 * (1 - lev) + 5 * np.gradient(blob, axis=0)[None]
    v = 5 * np.gradient(blob, axis=1)[None] * np.ones_like(lev)
    ps = (1000 + 12 * blob).astype(np.float32)
    alevel = np.linspace(20.0, 0.0, nlev).astype(np.float32)
    blevel = np.linspace(0.25, 1.0, nlev).astype(np.float32)
    mapr = np.full((ny, nx), 4e-7, np.float32)
    fcor = np.full((ny, nx), 1.2e-4, np.float32)
    # a patch of missing data (e.g. satellite gap)
    tk[:, 10:14, 20:26] = 1.0e35
    return (tk.astype(np.float32), q, u.astype(np.float32),
            v.astype(np.float32), ps, alevel, blevel, mapr, fcor)


def main():
    tk, q, u, v, ps, alevel, blevel, mapr, fcor = synthetic_state()
    nlev, ny, nx = tk.shape

    # -- 1. drop-in numpy API (one level at a time, like the reference) --
    import mi_fieldcalc_tpu.api as fc
    rh0 = fc.hlevelhum(tk[-1], q[-1], ps, float(alevel[-1]),
                       float(blevel[-1]), "kelvin", 1)
    chill = fc.windCooling(tk[-1], u[-1], v[-1], 1)
    print(f"lowest-level RH%:   mean {np.nanmean(rh0[rh0 < 1e34]):6.1f}")
    print(f"wind chill (K):     min  {chill[chill < 1e34].min():6.1f}")

    # -- 2. native surface: all levels in one jitted program -------------
    from mi_fieldcalc_tpu import from_sentinel
    from mi_fieldcalc_tpu.models import derived_fields, derived_fields_isobaric

    fields = (from_sentinel(tk), from_sentinel(q), from_sentinel(u),
              from_sentinel(v), from_sentinel(ps))
    coefs = (jnp.asarray(alevel), jnp.asarray(blevel))
    geo = (jnp.asarray(mapr), jnp.asarray(mapr), jnp.asarray(fcor))

    out = jax.jit(derived_fields)(*fields, *coefs, *geo)
    thetae = np.asarray(out.thetae.to_sentinel())
    print(f"theta_e (K):        max  {thetae[thetae < 1e34].max():6.1f} "
          f"({int((thetae >= 1e34).sum())} undef pts propagate the gap)")

    iso = jax.jit(lambda *a: derived_fields_isobaric(
        *a, plevels=(850.0, 500.0)))(*fields, *coefs, *geo)
    print(f"850 hPa dewpoint:   mean "
          f"{np.asarray(iso.td.values)[0][np.asarray(iso.td.mask)[0]].mean():6.1f} K")

    # -- 3. sharded: same math, domain-decomposed over every device ------
    from mi_fieldcalc_tpu.models.pipeline import RADIUS
    from mi_fieldcalc_tpu.parallel import grid_mesh, run_sharded

    mesh = grid_mesh(grid_shape=(ny, nx))
    n = len(jax.devices())
    sh = jax.jit(lambda *a: run_sharded(derived_fields, mesh, RADIUS, *a))(
        *fields, *coefs, *geo)
    agree = np.allclose(
        np.asarray(sh.vort.values)[np.asarray(out.vort.mask)],
        np.asarray(out.vort.values)[np.asarray(out.vort.mask)], rtol=2e-5)
    print(f"sharded over {n} device(s) [{mesh.shape}] — matches single-"
          f"device vorticity: {agree}")

    # -- 4. batch boundaries: one call per product FAMILY -----------------
    # any set of hybrid-level conversions in ONE program (sentinel
    # numpy in/out; fully defined steps auto-route to the fast path)
    from mi_fieldcalc_tpu.staging import run_hlevel_suite_np

    suite = run_hlevel_suite_np(tk, q, None, ps, alevel, blevel,
                                temps=(3,), hums_q=(1, 9))
    td = suite["hum_q9"]
    print(f"suite dewpoint (K): mean {td[td < 1e34].mean():6.1f} "
          f"({sorted(suite)})")

    # -- 5. call storms: many small drop-in calls, ONE device program ------
    # the Diana-caller pattern
    t850 = np.asarray(tk[-1])
    rh850 = np.clip(np.abs(np.asarray(q[-1])) * 1e4, 5.0, 95.0)
    with fc.batch():
        tc = fc.cvtemp(t850, 1)                 # K -> C, deferred
        hum = fc.plevelhum(t850, rh850, 850.0, "", 3)
        back = fc.cvtemp(tc, 2)                 # C -> K chains on device
    hv = np.asarray(hum)
    defined = hv[hv < 1e34]
    print(f"storm of 3 ran as one program: cvtemp roundtrip max|d| = "
          f"{np.abs(np.asarray(back) - t850).max():.2g}, "
          f"q850 mean {defined.mean():.2e} kg/kg")

    # -- 6. forecast cycles: device-resident inputs across storms ----------
    # cache_inputs=True pins concrete inputs on device (identity-keyed);
    # a repeated cycle ships only the arrays that changed, and results
    # from one batch() feed the next without a host round trip
    for cycle in range(2):
        t_new = t850 + np.float32(0.1 * cycle)   # "changed" field
        with fc.batch(cache_inputs=True):
            c = fc.cvtemp(t_new, 2)              # t_new ships; rh850
            h = fc.plevelhum(t_new, rh850, 850.0, "", 3)   # rides cache
        hm = np.asarray(h)                       # mask from THIS result
        print(f"cycle {cycle}: q850 mean "
              f"{hm[hm < 1e34].mean():.2e} kg/kg")

    # -- 7. subset consumers: fetch only the planes you read --------------
    # a display consumer that uses 2 of a storm's products fetches just
    # those planes in one transfer (fc.fetch), instead of pulling every
    # same-shape sibling via np.asarray
    with fc.batch(cache_inputs=True):
        c1 = fc.cvtemp(t850, 1)                 # K -> C
        h1 = fc.plevelhum(t850, rh850, 850.0, "", 3)
        _ = fc.cvtemp(rh850, 2)                 # computed, never fetched
    cv, hv1 = fc.fetch(c1, h1)                  # ONE transfer, 2 planes
    print(f"subset fetch: tc mean {cv[cv < 1e34].mean():6.1f} C, "
          f"q850 mean {hv1[hv1 < 1e34].mean():.2e} kg/kg")

    # -- 8. aligned ingest: the production-grid option --------------------
    # re-grid ragged producer grids once at staging onto the
    # tile-aligned logical grid (mask-aware bilinear; map ratios
    # rescaled).  The product grid changes (e.g. 719x929 -> 720x1024):
    from mi_fieldcalc_tpu.staging import run_derived_fields_np
    rag = np.s_[..., :95, :121]                 # a ragged producer grid
    out_al = run_derived_fields_np(tk[rag], q[rag], u[rag], v[rag],
                                   ps[rag], alevel, blevel, mapr[rag],
                                   mapr[rag], fcor[rag], align=True)
    print(f"aligned ingest: product grid {out_al['th'].shape[-2:]} "
          f"(from {tk[rag].shape[-2:]})")


if __name__ == "__main__":
    main()
