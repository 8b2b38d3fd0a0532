"""Equivalence of the jitted level-conversion suites
(ops/fused_suite.py) with the per-op calls they compose.

The suites call the exact ``levels.*`` implementations inside one
program.  XLA fuses that program differently from a single-op one, so
results agree to rtol 2e-5 rather than bit for bit, and an output in
degrees Celsius within two ulps of its Kelvin operand (``CELSIUS``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mi_fieldcalc_tpu.field import UNDEF, Field, from_sentinel
from mi_fieldcalc_tpu.ops import alevelhum, aleveltemp
from mi_fieldcalc_tpu.ops.fused_suite import alevel_suite_fused


#: outputs in degrees Celsius: temperature mode 1 and the dewpoint modes
#: 5-8 (9-12 add t0 back).  Each is a Kelvin-scale value minus t0, and
#: XLA may contract ``tk * pidcp - t0`` into one FMA in one program and
#: not in another.  That moves the result by up to an ulp of the Kelvin
#: operand, not of the small Celsius result: on this module's inputs
#: aleveltemp mode 1 differs at 8013 of 9912 points, at most 1.3e-5
#: (13967 ulps of the -0.0101 C result, 0.43 ulp of 273 K).
CELSIUS = frozenset({("temp", 1), ("hum", 5), ("hum", 6), ("hum", 7),
                     ("hum", 8)})


def _assert_contract(got, ref, tag, celsius=False):
    """Defined points of a suite output against the per-op call: values
    to rtol 2e-5 (CONFORMANCE.md's one-program contract), and a Celsius
    output also within two ulps of its Kelvin operand."""
    tol = 2e-5 * np.abs(ref)
    if celsius:
        tol = tol + 2 * np.spacing(np.abs(ref) + np.float32(273.15))
    with np.errstate(invalid="ignore"):
        ok = ((got == ref) | (np.abs(got - ref) <= tol)
              | (np.isnan(got) & np.isnan(ref)))
    assert ok.all(), (tag, got[~ok][:5], ref[~ok][:5])


def _inputs(nlev=3, ny=25, nx=140, seed=0):
    rng = np.random.default_rng(seed)

    def sent(lo, hi, frac=0.03):
        a = rng.uniform(lo, hi, (nlev, ny, nx)).astype(np.float32)
        a[rng.random(a.shape) < frac] = UNDEF
        return from_sentinel(a)

    tk = sent(250, 300)
    v = np.asarray(tk.values).copy()
    v[0, 2, 2] = 520.0            # beyond the e_sat table: ok gate
    tk = Field(jnp.asarray(v), tk.mask)
    return tk, sent(1e-4, 1e-2), sent(5, 95), sent(300, 1000)


@pytest.mark.parametrize("temps,hq,hr", [
    ((3, 4), (1, 5, 9), (3, 7, 11)),    # BASELINE config-2 suite
    ((1, 2, 5), (), ()),                # temperature-only, incl. theta-in
    ((), (2, 6, 10), (4, 8, 12)),       # theta-input humidity modes
])
def test_suite_kernel_matches_jnp(temps, hq, hr):
    tk, q, rh, p = _inputs(seed=len(temps) + len(hq))
    got = alevel_suite_fused(tk, q, rh, p, temps=temps, hums_q=hq,
                             hums_rh=hr)
    ref = [jax.jit(lambda tk, p, c=c: aleveltemp(tk, p, compute=c))(tk, p)
           for c in temps]
    ref += [jax.jit(lambda tk, h, p, c=c:
                    alevelhum(tk, h, p, compute=c))(tk, q, p) for c in hq]
    ref += [jax.jit(lambda tk, h, p, c=c:
                    alevelhum(tk, h, p, compute=c))(tk, rh, p) for c in hr]
    assert len(got) == len(ref)
    modes = ([("temp", c) for c in temps]
             + [("hum", c) for c in tuple(hq) + tuple(hr)])
    for k, (r, g) in enumerate(zip(ref, got)):
        rm = np.asarray(r.mask)
        assert np.array_equal(rm, np.asarray(g.mask)), (k, "mask")
        _assert_contract(np.asarray(g.values)[rm], np.asarray(r.values)[rm],
                         modes[k], celsius=modes[k] in CELSIUS)


def test_suite_kernel_padded_layout():
    """Pointwise suite on the canonical padded layout: dead-lane masks
    stay False through the input-mask ANDs with no extra arguments."""
    from mi_fieldcalc_tpu.layout import pad_field

    nlev, ny, nx = 2, 21, 150
    tk, q, rh, p = _inputs(nlev, ny, nx, seed=9)
    ref = alevel_suite_fused(tk, q, rh, p, temps=(3,), hums_q=(1, 9))
    pf = [pad_field(f) for f in (tk, q, rh, p)]
    got = alevel_suite_fused(*pf, temps=(3,), hums_q=(1, 9))
    for r, g in zip(ref, got):
        gm = np.asarray(g.mask)
        assert not gm[..., ny:, :].any() and not gm[..., :, nx:].any()
        rm = np.asarray(r.mask)
        assert np.array_equal(rm, gm[..., :ny, :nx])
        assert np.array_equal(np.asarray(r.values)[rm],
                              np.asarray(g.values)[..., :ny, :nx][rm])


def test_suite_kernel_validation():
    tk, q, rh, p = _inputs()
    with pytest.raises(ValueError):
        alevel_suite_fused(tk, q, rh, p)              # nothing requested
    with pytest.raises(ValueError):
        alevel_suite_fused(tk, q, rh, p, temps=(9,))  # bad compute
    with pytest.raises(ValueError):
        # RH-taking mode in the q slot: the family split encodes which
        # input each mode consumes, so the mismatch raises instead of
        # silently clamping (the a/h-level numbering differs from
        # plevelhum; this exact confusion produced a wrong benchmark
        # artifact once)
        alevel_suite_fused(tk, q, rh, p, hums_q=(7,))
    with pytest.raises(ValueError):
        alevel_suite_fused(tk, q, rh, p, ducts_rh=(1,))


def test_suite_kernel_the_and_ducting():
    """The suite kernel covers the whole pointwise a-level family: THE
    and ducting modes trace to the same jnp ops bitwise."""
    from mi_fieldcalc_tpu.ops import alevelducting, alevelthe

    tk, q, rh, p = _inputs(seed=3)
    got = alevel_suite_fused(tk, q, rh, p, temps=(3,), thes=(1, 2),
                             ducts_q=(1, 2), ducts_rh=(3, 4))
    ref = [jax.jit(lambda tk, p: aleveltemp(tk, p, compute=3))(tk, p)]
    ref += [jax.jit(lambda tk, q, p, c=c:
                    alevelthe(tk, q, p, compute=c))(tk, q, p)
            for c in (1, 2)]
    ref += [jax.jit(lambda tk, h, p, c=c:
                    alevelducting(tk, h, p, compute=c))(tk, q, p)
            for c in (1, 2)]
    ref += [jax.jit(lambda tk, h, p, c=c:
                    alevelducting(tk, h, p, compute=c))(tk, rh, p)
            for c in (3, 4)]
    for k, (r, g) in enumerate(zip(ref, got)):
        rm = np.asarray(r.mask)
        assert np.array_equal(rm, np.asarray(g.mask)), (k, "mask")
        assert np.array_equal(np.asarray(r.values)[rm],
                              np.asarray(g.values)[rm]), (k, "values")


def test_hlevel_suite_matches_per_level_ops():
    """hlevel_suite_fused (prognostic ps + per-level hybrid
    coefficients; p never materialized) bitwise-matches the per-level
    hleveltemp/hlevelhum/hlevelthe/hlevelducting calls — including
    hlevelhum's ps gate (defined ps required except modes 7/11), which
    is INVERTED vs alevelhum's."""
    from mi_fieldcalc_tpu.ops import (hlevelducting, hlevelhum,
                                      hlevel_suite_fused, hlevelthe,
                                      hleveltemp)

    rng = np.random.default_rng(4)
    nlev, ny, nx = 3, 25, 140

    def sent3(lo, hi, frac=0.03):
        a = rng.uniform(lo, hi, (nlev, ny, nx)).astype(np.float32)
        a[rng.random(a.shape) < frac] = UNDEF
        return from_sentinel(a)

    tk, q, rh = sent3(250, 300), sent3(1e-4, 1e-2), sent3(5, 95)
    psn = rng.uniform(950, 1030, (ny, nx)).astype(np.float32)
    psn[3, 3] = UNDEF                  # exercises the ps gate inversion
    ps = from_sentinel(psn)
    al = np.linspace(30, 0, nlev).astype(np.float32)
    bl = np.linspace(0.02, 1.0, nlev).astype(np.float32)

    temps, hq, hr = (3, 4), (1, 5, 9), (3, 7, 11)
    thes, dq, dr = (1, 2), (1,), (3,)
    got = hlevel_suite_fused(tk, q, rh, ps, al, bl, temps=temps,
                             hums_q=hq, hums_rh=hr, thes=thes,
                             ducts_q=dq, ducts_rh=dr)

    def lvl(f3, k):
        return Field(f3.values[k], f3.mask[k])

    def per_level(make):
        outs = [make(k) for k in range(nlev)]
        return Field(jnp.stack([o.values for o in outs]),
                     jnp.stack([o.mask for o in outs]))

    ref = [per_level(lambda k, c=c: jax.jit(
        lambda a, b: hleveltemp(a, b, float(al[k]), float(bl[k]),
                                compute=c))(lvl(tk, k), ps))
        for c in temps]
    for h3, cs, fn in ((q, hq, hlevelhum), (rh, hr, hlevelhum),
                       (q, thes, hlevelthe), (q, dq, hlevelducting),
                       (rh, dr, hlevelducting)):
        for c in cs:
            ref.append(per_level(lambda k, c=c, h3=h3, fn=fn: jax.jit(
                lambda a, h, b: fn(a, h, b, float(al[k]), float(bl[k]),
                                   compute=c))(lvl(tk, k), lvl(h3, k),
                                               ps)))

    assert len(got) == len(ref) == 12
    for k, (r, g) in enumerate(zip(ref, got)):
        rm = np.asarray(r.mask)
        assert np.array_equal(rm, np.asarray(g.mask)), (k, "mask")
        assert np.array_equal(np.asarray(r.values)[rm],
                              np.asarray(g.values)[rm]), (k, "values")

    with pytest.raises(ValueError):
        hlevel_suite_fused(tk, q, rh, ps, al[:-1], bl[:-1], temps=(3,))   # nlev mismatch
    with pytest.raises(ValueError):
        hlevel_suite_fused(tk, q, rh, ps, -al - 1, bl * 0 - 1,
                           temps=(3,))  # bad a/b


def test_suite_kernel_shards_via_run_sharded():
    """The suite is pointwise (radius 0): run_sharded shards it over a
    (gy, gx) mesh with no halo exchange, bitwise-equal per output."""
    import functools
    from mi_fieldcalc_tpu.parallel import grid_mesh, run_sharded

    if len(jax.devices()) < 4:
        pytest.skip("not enough devices")
    tk, q, rh, p = _inputs(2, 32, 64, seed=8)
    op = functools.partial(alevel_suite_fused, temps=(3,), hums_q=(1, 9), hums_rh=(7,))
    ref = op(tk, q, rh, p)
    mesh = grid_mesh((1, 2, 2), devices=jax.devices()[:4])
    got = run_sharded(op, mesh, 0, tk, q, rh, p)
    for k, (r, g) in enumerate(zip(ref, got)):
        rm = np.asarray(r.mask)
        assert np.array_equal(rm, np.asarray(g.mask)), k
        assert np.array_equal(np.asarray(r.values)[rm],
                              np.asarray(g.values)[rm]), k


def test_hlevel_suite_dynamic_coefficients_and_sharding():
    """alevel/blevel are data: the same compiled kernel serves distinct
    coefficient sets, invalid modes still raise, and the hlevel form
    shards via run_sharded with the coefficients as 1-D leaves."""
    import functools
    from mi_fieldcalc_tpu.ops import hlevel_suite_fused
    from mi_fieldcalc_tpu.parallel import grid_mesh, run_sharded

    rng = np.random.default_rng(6)
    nlev, ny, nx = 2, 32, 64

    def sent3(lo, hi):
        a = rng.uniform(lo, hi, (nlev, ny, nx)).astype(np.float32)
        a[rng.random(a.shape) < 0.03] = UNDEF
        return from_sentinel(a)

    tk, q = sent3(250, 300), sent3(1e-4, 1e-2)
    ps = from_sentinel(rng.uniform(950, 1030, (ny, nx)
                                   ).astype(np.float32))
    al1 = np.linspace(30, 0, nlev).astype(np.float32)
    bl1 = np.linspace(0.02, 1.0, nlev).astype(np.float32)
    al2, bl2 = al1 * 1.5, bl1 * 0.9

    op = functools.partial(hlevel_suite_fused, temps=(3,), hums_q=(1, 9))
    out1 = op(tk, q, q, ps, al1, bl1)
    out2 = op(tk, q, q, ps, al2, bl2)   # same jit cache entry: data args
    # different coefficients -> different pressures -> different values
    assert not np.array_equal(np.asarray(out1[0].values),
                              np.asarray(out2[0].values))

    with pytest.raises(ValueError):
        op(tk, q, q, ps, -al1 - 1, bl1 * 0 - 1)    # bad a/b (concrete)
    with pytest.raises(ValueError):
        hlevel_suite_fused(tk, q, q, ps, al1, bl1, temps=(7,))          # bad mode

    if len(jax.devices()) >= 4:
        mesh = grid_mesh((1, 2, 2), devices=jax.devices()[:4])
        got = run_sharded(op, mesh, 0, tk, q, q, ps, al1, bl1)
        for k, (r, g) in enumerate(zip(out1, got)):
            rm = np.asarray(r.mask)
            assert np.array_equal(rm, np.asarray(g.mask)), k
            assert np.array_equal(np.asarray(r.values)[rm],
                                  np.asarray(g.values)[rm]), k


@pytest.mark.parametrize("suite", ["alevel", "hlevel"])
def test_suite_all_defined_fast_path(suite):
    """all_defined=True: no input mask planes, output masks collapse to
    at most 3 gate planes (T / theta / temp-5 spellings of the ewt
    range predicate) — bitwise equal to the masked path on fully
    defined inputs, including an out-of-table temperature so every gate
    kind actually fires."""
    from mi_fieldcalc_tpu.ops import hlevel_suite_fused

    rng = np.random.default_rng(12)
    nlev, ny, nx = 2, 24, 140

    def mk(lo, hi):
        return from_sentinel(rng.uniform(lo, hi, (nlev, ny, nx)
                                         ).astype(np.float32))

    tk, q, rh = mk(250, 300), mk(1e-4, 1e-2), mk(5, 95)
    v = np.asarray(tk.values).copy()
    v[0, 2, 2] = 520.0            # beyond the table: fires every gate
    tk = Field(jnp.asarray(v), tk.mask)
    kw = dict(temps=(1, 3, 4, 5), hums_q=(1, 9), hums_rh=(4, 7),
              thes=(1,), ducts_q=(2,), ducts_rh=(3, 4))

    if suite == "alevel":
        p = mk(300, 1000)
        ref = alevel_suite_fused(tk, q, rh, p, **kw)
        got = alevel_suite_fused(tk, q, rh, p, all_defined=True, **kw)
    else:
        ps = from_sentinel(rng.uniform(950, 1030, (ny, nx)
                                       ).astype(np.float32))
        al = np.linspace(30, 0, nlev).astype(np.float32)
        bl = np.linspace(0.02, 1.0, nlev).astype(np.float32)
        ref = hlevel_suite_fused(tk, q, rh, ps, al, bl, **kw)
        got = hlevel_suite_fused(tk, q, rh, ps, al, bl,
                                 all_defined=True, **kw)

    assert len(got) == len(ref) == 12
    fired = 0
    for k, (r, g) in enumerate(zip(ref, got)):
        rm = np.asarray(r.mask)
        assert np.array_equal(rm, np.asarray(g.mask)), (k, "mask")
        assert np.array_equal(np.asarray(r.values)[rm],
                              np.asarray(g.values)[rm]), (k, "values")
        fired += not rm.all()
    assert fired >= 8          # the gates actually gated something


def test_suite_all_defined_padded_region():
    """Fast path on arrays with dead trailing rows/lanes: the logical
    region equals the unpadded run bitwise (the suite is pointwise)."""
    from mi_fieldcalc_tpu.layout import pad_field

    nlev, ny, nx = 2, 21, 150
    tk, q, rh, p = _inputs(nlev, ny, nx, seed=15, )
    # strip undefs: the fast path asserts all defined
    def clean(f):
        return Field(f.values, jnp.ones_like(f.mask))
    tk, q, rh, p = (clean(f) for f in (tk, q, rh, p))
    pf = [pad_field(f) for f in (tk, q, rh, p)]
    kw = dict(temps=(3, 4), hums_q=(1, 9))
    ref = alevel_suite_fused(tk, q, rh, p, all_defined=True, **kw)
    got = alevel_suite_fused(*pf, all_defined=True, **kw)
    for k, (r, g) in enumerate(zip(ref, got)):
        gm = np.asarray(g.mask)
        rm = np.asarray(r.mask)
        assert np.array_equal(rm, gm[..., :ny, :nx]), k
        assert np.array_equal(np.asarray(r.values)[rm],
                              np.asarray(g.values)[..., :ny, :nx][rm]), k


def test_suite_all_defined_gates_only():
    """With all_defined the input masks are not read: undefined points
    in them change nothing, and the only undefined outputs are the
    saturation-table gate (here one out-of-table temperature)."""
    nlev, ny, nx = 1, 16, 128
    tk, q, rh, p = _inputs(nlev, ny, nx, seed=21)
    kw = dict(temps=(3, 4), thes=(1,), hums_q=(1,), all_defined=True)
    got = alevel_suite_fused(tk, q, rh, p, **kw)
    ones = [Field(f.values, jnp.ones_like(f.mask)) for f in (tk, q, rh, p)]
    ref = alevel_suite_fused(*ones, **kw)
    for k, (r, g) in enumerate(zip(ref, got)):
        rm = np.asarray(r.mask)
        assert np.array_equal(rm, np.asarray(g.mask)), k
        assert np.array_equal(np.asarray(r.values)[rm],
                              np.asarray(g.values)[rm]), k
    assert np.asarray(got[0].mask).all()           # temp 3: no gate
    assert np.asarray(got[3].mask).all()           # the 1: no gate
    # the table gate of temp 4 and hum_q 1 reads only T: it fires at the
    # out-of-table point and at the sentinel values behind tk's undefs
    expect = np.asarray(tk.mask).copy()
    expect[0, 2, 2] = False
    for k in (1, 2):
        assert np.array_equal(np.asarray(got[k].mask), expect), k


@pytest.mark.parametrize("suite", ["alevel", "hlevel"])
def test_suite_all_defined_sharded_padded(suite):
    """all_defined composes with the (gy, gx) decomposition on a ragged
    grid padded to split evenly: the fast sharded run matches the MASKED
    sharded run bitwise on the logical region."""
    import functools
    from mi_fieldcalc_tpu.layout import pad_field
    from mi_fieldcalc_tpu.ops import hlevel_suite_fused
    from mi_fieldcalc_tpu.parallel import grid_mesh, run_sharded

    if len(jax.devices()) < 4:
        pytest.skip("not enough devices")
    rng = np.random.default_rng(31)
    nlev, ny, nx = 2, 21, 150    # ragged: pads to (24, 256)

    def mk(lo, hi, shape=None):
        a = rng.uniform(lo, hi, shape or (nlev, ny, nx)).astype(np.float32)
        return from_sentinel(a)

    tk, q, rh = mk(250, 300), mk(1e-4, 1e-2), mk(5, 95)
    v = np.asarray(tk.values).copy()
    v[0, 2, 2] = 520.0           # out-of-table: the gate planes fire
    tk = Field(jnp.asarray(v), tk.mask)
    kw = dict(temps=(3, 4), hums_q=(1, 9), thes=(1,))
    mesh = grid_mesh((1, 2, 2), devices=jax.devices()[:4])

    if suite == "alevel":
        p = mk(300, 1000)
        pf = [pad_field(f) for f in (tk, q, rh, p)]
        op = functools.partial(alevel_suite_fused, **kw)
        args = pf
    else:
        ps = mk(950, 1030, (ny, nx))
        pf = [pad_field(f) for f in (tk, q, rh, ps)]
        al = np.linspace(30, 0, nlev).astype(np.float32)
        bl = np.linspace(0.02, 1.0, nlev).astype(np.float32)
        op = functools.partial(hlevel_suite_fused, **kw)
        args = pf + [al, bl]

    masked = run_sharded(op, mesh, 0, *args)
    fast = run_sharded(functools.partial(op, all_defined=True), mesh, 0,
                       *args)
    for k, (r, g) in enumerate(zip(masked, fast)):
        rm = np.asarray(r.mask)[..., :ny, :nx]
        gm = np.asarray(g.mask)[..., :ny, :nx]
        assert np.array_equal(rm, gm), k
        assert np.array_equal(np.asarray(r.values)[..., :ny, :nx][rm],
                              np.asarray(g.values)[..., :ny, :nx][rm]), k


def test_run_hlevel_suite_np_validation():
    """The numpy runner validates exactly like the suites and rejects
    None for a consumed input."""
    import pytest
    from mi_fieldcalc_tpu.staging import run_hlevel_suite_np

    rng = np.random.default_rng(1)
    nlev, ny, nx = 2, 8, 16
    tk = rng.uniform(250, 300, (nlev, ny, nx)).astype(np.float32)
    q = rng.uniform(1e-4, 1e-2, (nlev, ny, nx)).astype(np.float32)
    ps = rng.uniform(950, 1030, (ny, nx)).astype(np.float32)
    al = np.linspace(30, 0, nlev).astype(np.float32)
    bl = np.linspace(0.02, 1.0, nlev).astype(np.float32)

    with pytest.raises(ValueError):   # RH-taking mode in the q slot
        run_hlevel_suite_np(tk, q, None, ps, al, bl, hums_q=(7,))
    with pytest.raises(ValueError):   # nothing requested
        run_hlevel_suite_np(tk, q, None, ps, al, bl)
    with pytest.raises(ValueError):   # THE consumes q
        run_hlevel_suite_np(tk, None, None, ps, al, bl, thes=(1,))


def test_suite_random_request_sets():
    """Property check: 5 random request sets (any family mix, random
    valid modes) are bitwise-equal to the jitted per-op composition —
    masked and fast paths both."""
    from mi_fieldcalc_tpu.ops import alevelducting, alevelthe
    from mi_fieldcalc_tpu.ops.fused_suite import _VALID

    rng = np.random.default_rng(99)
    tk, q, rh, p = _inputs(seed=99)
    clean = [Field(f.values, jnp.ones_like(f.mask))
             for f in (tk, q, rh, p)]

    for trial in range(5):
        kw = {}
        for arg, fam in (("temps", "temp"), ("hums_q", "hum_q"),
                         ("hums_rh", "hum_rh"), ("thes", "the"),
                         ("ducts_q", "duct_q"), ("ducts_rh", "duct_rh")):
            pool = sorted(_VALID[fam])
            n = int(rng.integers(0, len(pool) + 1))
            kw[arg] = tuple(sorted(rng.choice(pool, n, replace=False)))
        if not any(kw.values()):
            kw["temps"] = (3,)

        def ref_for(fields):
            t_, q_, rh_, p_ = fields
            outs = []
            for c in kw["temps"]:
                outs.append(jax.jit(lambda t, p, c=c: aleveltemp(
                    t, p, compute=c))(t_, p_))
            for c in kw["hums_q"]:
                outs.append(jax.jit(lambda t, h, p, c=c: alevelhum(
                    t, h, p, compute=c))(t_, q_, p_))
            for c in kw["hums_rh"]:
                outs.append(jax.jit(lambda t, h, p, c=c: alevelhum(
                    t, h, p, compute=c))(t_, rh_, p_))
            for c in kw["thes"]:
                outs.append(jax.jit(lambda t, h, p, c=c: alevelthe(
                    t, h, p, compute=c))(t_, q_, p_))
            for c in kw["ducts_q"]:
                outs.append(jax.jit(lambda t, h, p, c=c: alevelducting(
                    t, h, p, compute=c))(t_, q_, p_))
            for c in kw["ducts_rh"]:
                outs.append(jax.jit(lambda t, h, p, c=c: alevelducting(
                    t, h, p, compute=c))(t_, rh_, p_))
            return outs

        modes = ([("temp", c) for c in kw["temps"]]
                 + [("hum", c) for c in kw["hums_q"] + kw["hums_rh"]]
                 + [("other", c) for c in kw["thes"] + kw["ducts_q"]
                    + kw["ducts_rh"]])
        for fields, allm in (((tk, q, rh, p), False), (clean, True)):
            got = alevel_suite_fused(*fields, all_defined=allm, **kw)
            ref = ref_for(fields)
            assert len(got) == len(ref)
            for k, (r, g) in enumerate(zip(ref, got)):
                rm = np.asarray(r.mask)
                assert np.array_equal(rm, np.asarray(g.mask)), \
                    (trial, allm, k, kw)
                # clean-path inputs force-define planted garbage, so
                # NaN outputs are legitimate: compare equal_nan
                _assert_contract(np.asarray(g.values)[rm],
                                 np.asarray(r.values)[rm],
                                 (trial, allm, k, kw),
                                 celsius=modes[k] in CELSIUS)


def test_suite_kernel_pidcp_edge_lanes_bitwise():
    """The round-5 pidcp p <= 0 edge contract, locked at the suite
    kernel level: DEFINED lanes carrying p == 0 (theta -> inf via
    0**kappa = +0) and p < 0 (NaN) produce the SAME bits through the
    fused suite kernel and the jnp ops — the edge select is constants
    only, so it cannot perturb XLA fusion of the shared pow chain on
    ordinary lanes (the regression this test would have caught)."""
    tk, q, rh, p = _inputs(seed=11)
    edges = [(0, 0, 0), (0, 0, 1), (1, 3, 130)]
    pv = np.asarray(p.values).copy()
    pv[edges[0]] = 0.0             # 0**kappa = +0 -> theta inf
    pv[edges[1]] = -250.0          # negative p -> NaN theta
    pv[edges[2]] = 0.0             # remainder-lane chunk too
    # the planted lanes must be DEFINED in every input or the edge
    # never reaches a defined output
    def force(f):
        m = np.asarray(f.mask).copy()
        for e in edges:
            m[e] = True
        return Field(f.values, jnp.asarray(m))
    tk, q, rh = force(tk), force(q), force(rh)
    p = force(Field(jnp.asarray(pv), p.mask))

    got = alevel_suite_fused(tk, q, rh, p, temps=(3, 4), thes=(1,))
    from mi_fieldcalc_tpu.ops import alevelthe
    ref = [jax.jit(lambda tk, p, c=c: aleveltemp(tk, p, compute=c))(tk, p)
           for c in (3, 4)]
    ref.append(jax.jit(lambda tk, q, p: alevelthe(tk, q, p,
                                                  compute=1))(tk, q, p))
    saw_inf = saw_nan = False
    for k, (r, g) in enumerate(zip(ref, got)):
        rm = np.asarray(r.mask)
        assert np.array_equal(rm, np.asarray(g.mask)), (k, "mask")
        rv, gv = np.asarray(r.values)[rm], np.asarray(g.values)[rm]
        assert np.array_equal(rv, gv, equal_nan=True), (k, "values")
        saw_inf |= bool(np.isinf(rv).any())
        saw_nan |= bool(np.isnan(rv).any())
    # the edge lanes must actually be defined in at least one output,
    # or this test proves nothing
    assert saw_inf and saw_nan
