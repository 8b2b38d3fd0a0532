#!/usr/bin/env python3
"""Smoke test of the derived-field pipeline on one NVIDIA GPU.

Drives the system's entry points at the operational grid (MET Norway's
719x929, 32 hybrid levels) with seeded synthetic fields, checks every
result against the per-field jnp pipeline on the same card and the
oracle goldens, and times the device programs and the served step.  One
process uses the card throughout.

Phases:

1. device and set-up: the card, JAX, XLA flags, the native host codec;
2. the main path: ``staging.run_derived_fields_np`` with undefs and fully
   defined, 3 streamed steps, against ``jax.jit(models.derived_fields)``
   on the same staged arrays;
3. device step of the pipeline at the headline size in both mask
   layouts, the served step's stages, and the ensemble summary;
4. the oracle goldens replayed on the card (tests/test_conformance*.py);
5. the other entry points: a 22-call ``api.batch()`` storm, the
   hybrid-level suite, the isobaric pipeline, the vessel-icing products;
6. the tests marked ``gpu``.

``--four`` runs only the multi-device path on a (1, 2, 2) mesh of four
cards and compares it with one card.

Usage: ``python chip_smoke.py [--four]``.  Exits non-zero, printing no
result, when JAX finds no GPU or a phase fails.  The last line of
standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
NLEV, NY, NX = 32, 719, 929
UNDEF = 1e35
#: one program vs another on the same card (CONFORMANCE.md): masks bit
#: for bit, values to this relative tolerance
RTOL = 2e-5


class PhaseError(AssertionError):
    pass


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def timed(fn, reps=20):
    """(median, min) seconds over ``reps`` runs after one warm-up, each
    ended by ``block_until_ready``."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), min(ts)


def compiled(fn, *args):
    """(executable, compile seconds) of ``jax.jit(fn)`` at ``args``."""
    import jax
    t0 = time.perf_counter()
    c = jax.jit(fn).lower(*args).compile()
    return c, time.perf_counter() - t0


def ms(t):
    return [round(x * 1e3, 3) for x in t]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def pipeline_inputs(nlev=None, seed=0, undefs=True):
    """The 10 sentinel-numpy pipeline arguments at ``nlev x NY x NX``:
    the distributions of ``__graft_entry__._example_inputs``, with
    scattered undefs, a 3x3 undef patch and an undefined surface-pressure
    point."""
    import numpy as np
    nlev, ny, nx = nlev or NLEV, NY, NX
    rng = np.random.default_rng(seed)
    tk = rng.normal(275.0, 15.0, (nlev, ny, nx)).astype(np.float32)
    q = rng.uniform(1e-4, 1e-2, (nlev, ny, nx)).astype(np.float32)
    u = rng.normal(0.0, 12.0, (nlev, ny, nx)).astype(np.float32)
    v = rng.normal(0.0, 12.0, (nlev, ny, nx)).astype(np.float32)
    ps = rng.normal(1000.0, 15.0, (ny, nx)).astype(np.float32)
    if undefs:
        for a in (tk, q, u, v):
            a.reshape(-1)[rng.integers(0, a.size, a.size // 1000)] = UNDEF
        tk[:, ny // 3:ny // 3 + 3, nx // 3:nx // 3 + 3] = UNDEF
        ps[ny // 2, nx // 2] = UNDEF
    alevel = np.linspace(0.0, 50.0, nlev).astype(np.float32)
    blevel = np.linspace(1.0, 0.5, nlev).astype(np.float32)
    xm = np.full((ny, nx), 4.0e-7, np.float32)
    ym = np.full((ny, nx), 3.6e-7, np.float32)
    fc = np.full((ny, nx), 1.2e-4, np.float32)
    return tk, q, u, v, ps, alevel, blevel, xm, ym, fc


def to_fields(np_args):
    import jax.numpy as jnp
    from mi_fieldcalc_tpu import from_sentinel
    return (tuple(from_sentinel(a) for a in np_args[:5])
            + tuple(jnp.asarray(a) for a in np_args[5:]))


def compare_fields(got, ref, tag, rtol=RTOL):
    """Masks bit for bit, values to ``rtol`` on defined points; ``got``
    and ``ref`` are sequences of Fields (or DerivedFieldsStacked)."""
    import numpy as np
    bad = []
    for i, name in enumerate(ref._fields):
        g = got.field(i) if hasattr(got, "field") else got[i]
        rm, gm = np.asarray(ref[i].mask), np.asarray(g.mask)
        if not np.array_equal(rm, gm):
            bad.append(f"{name}: {int((rm != gm).sum())} mask points")
            continue
        rv, gv = np.asarray(ref[i].values)[rm], np.asarray(g.values)[rm]
        if not np.allclose(gv, rv, rtol=rtol, atol=0, equal_nan=True):
            err = np.abs(gv - rv) / np.maximum(np.abs(rv), 1e-30)
            bad.append(f"{name}: max rel err {float(np.nanmax(err)):.3g}")
    log(f"  {tag}: {'OK' if not bad else bad}")
    check(not bad, f"{tag}: {bad}")


def compare_sentinel(got, ref, tag, rtol=RTOL):
    """Sentinel dicts: undef positions identical, values to ``rtol``."""
    import numpy as np
    bad = []
    for name, r in ref.items():
        g = got[name]
        rm, gm = r < 1e34, g < 1e34
        if r.shape != g.shape or not np.array_equal(rm, gm):
            bad.append(f"{name}: undef pattern differs")
        elif not np.allclose(g[rm], r[rm], rtol=rtol, atol=0):
            bad.append(f"{name}: values differ")
    log(f"  {tag}: {'OK' if not bad else bad}")
    check(not bad, f"{tag}: {bad}")


def close(got, ref, celsius=False):
    """Sentinel arrays of one output from two programs: undef positions
    identical, values to RTOL.  A Celsius output (a Kelvin-scale value
    minus t0) may also move by two ulps of its Kelvin operand, where one
    program contracts the subtraction into an FMA and the other does
    not (tests/test_fused_suite.py, CONFORMANCE.md)."""
    import numpy as np
    rm = ref < 1e34
    if not np.array_equal(rm, got < 1e34):
        return False
    r, g = ref[rm], got[rm]
    tol = RTOL * np.abs(r)
    if celsius:
        tol = tol + 2 * np.spacing(np.abs(r) + np.float32(273.15))
    return bool(np.all(np.abs(g - r) <= tol))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_setup():
    import jax
    from mi_fieldcalc_tpu import native
    from mi_fieldcalc_tpu.utils.compile_cache import enable
    log(f"  jax {jax.__version__}, devices {jax.devices()}")
    log(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"  compile cache: {enable()}")
    r = subprocess.run(["sh", os.path.join(HERE, "native", "build.sh")],
                       capture_output=True, text=True)
    log(f"  native build rc={r.returncode} {r.stdout.strip()} "
        f"{r.stderr.strip()[-400:]}")
    check(r.returncode == 0, "native codec did not build")
    check(native.available(), "native codec did not load")


def encoded_reference(staged, ny, nx):
    """``jax.jit(models.derived_fields)`` on staged arrays, encoded to
    sentinel arrays as staging does with the 12-plane mask layout."""
    import jax
    import numpy as np
    from mi_fieldcalc_tpu import staging
    from mi_fieldcalc_tpu.models import derived_fields
    out = jax.jit(derived_fields)(*staged)
    return staging._encode_step(np.stack([np.asarray(f.values) for f in out]),
                                np.stack([np.asarray(f.mask) for f in out]),
                                ny, nx, UNDEF)


def phase_main_path():
    import numpy as np
    from mi_fieldcalc_tpu import staging
    from mi_fieldcalc_tpu.staging import (run_derived_fields_np,
                                          stream_derived_fields_np)

    # the served path (2 or 9 mask planes) against the per-field
    # pipeline on the same staged arrays (12 planes)
    for undefs in (True, False):
        a = pipeline_inputs(undefs=undefs)
        staged, (ny, nx), alldef = staging._stage_step(
            a, staging.HostStager(4, UNDEF, pad=False), UNDEF)
        check(alldef == (not undefs), "all_defined gate")
        compare_sentinel(run_derived_fields_np(*a),
                         encoded_reference(staged, ny, nx),
                         f"run_derived_fields_np undefs={undefs} vs "
                         f"jax.jit(derived_fields)")
    steps = [pipeline_inputs(seed=s, undefs=s != 2) for s in range(3)]
    singles = [run_derived_fields_np(*s) for s in steps]
    for k, out in enumerate(stream_derived_fields_np(iter(steps))):
        for name, arr in out.items():
            check(np.array_equal(arr, singles[k][name]),
                  f"stream step {k} {name} differs from a single step")
    log("  stream_derived_fields_np: 3 steps equal single steps")


def stage_breakdown(npa, tag, reps=7):
    """Median wall time of each stage of one served step: decode +
    device_put, device program + fetch, encode."""
    import jax
    from mi_fieldcalc_tpu import staging

    stager = staging.HostStager(4, UNDEF, pad=False)
    parts = {"decode+put": [], "device+fetch": [], "encode": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        staged, (ny, nx), alldef = staging._stage_step(npa, stager, UNDEF)
        jax.block_until_ready(staged)
        t1 = time.perf_counter()
        v, m = staging._compute_fetch(staged, alldef)
        t2 = time.perf_counter()
        staging._encode_step(v, m, ny, nx, UNDEF)
        t3 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k].append(dt)
    total = [sum(x) for x in zip(*parts.values())]
    log(f"  served step stages ({tag}), median ms: "
        + ", ".join(f"{k} {statistics.median(v) * 1e3:.2f}"
                    for k, v in parts.items())
        + f"; whole step {statistics.median(total) * 1e3:.2f}")


def phase_device_step():
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np
    from mi_fieldcalc_tpu.field import Field
    from mi_fieldcalc_tpu.models import derived_fields, derived_fields_stacked
    from mi_fieldcalc_tpu.models.ensemble import ensemble_derived_summary

    npa = pipeline_inputs()
    fargs = jax.device_put(to_fields(npa))
    clean = tuple(Field(a.values, jnp.ones_like(a.mask))
                  if isinstance(a, Field) else a for a in fargs)
    for tag, fn, args in (
            ("derived_fields (12 masks)", derived_fields, fargs),
            ("derived_fields_stacked (9 mask planes)",
             derived_fields_stacked, fargs),
            ("derived_fields_stacked all_defined (2 mask planes)",
             functools.partial(derived_fields_stacked, all_defined=True),
             clean)):
        c, tc = compiled(fn, *args)
        log(f"  headline 32x719x929 {tag}: compile {tc:.2f} s, step "
            f"median/min {ms(timed(lambda: c(*args)))} ms")
        if "9 mask" in tag:
            log(f"  step memory: {c.memory_analysis()}")
    stage_breakdown(npa, "undefs")
    stage_breakdown(pipeline_inputs(undefs=False), "fully defined")

    # ensemble: 8 members x 8 levels
    nmem, nl = 8, 8
    mem = [to_fields(pipeline_inputs(nlev=nl, seed=10 + m))
           for m in range(nmem)]
    stack = [Field(jnp.stack([m[i].values for m in mem]),
                   jnp.stack([m[i].mask for m in mem])) for i in range(5)]
    eargs = jax.device_put(tuple(stack) + mem[0][5:])
    c, tc = compiled(ensemble_derived_summary, *eargs)
    summ = c(*eargs)
    log(f"  ensemble 8x8x719x929 summary: compile {tc:.2f} s, step "
        f"median/min {ms(timed(lambda: c(*eargs)))} ms")
    # (a spread may be inf where the reference's quirks let sentinel
    # values into defined points: divergence's mask, alevelhum's p gate)
    for f in list(summ.mean) + list(summ.spread) + [summ.prob_wind,
                                                      summ.prob_t_freeze]:
        check(f.values.shape == (nl, NY, NX) and np.asarray(f.mask).any(),
              "ensemble summary: shape or no defined point")
    for f in (summ.prob_wind, summ.prob_t_freeze):
        pv = np.asarray(f.values)[np.asarray(f.mask)]
        check(((pv >= 0) & (pv <= 100)).all(), "probability outside 0..100")
    log("  ensemble summary: shapes, probabilities in [0, 100]")


class _Tally:
    """pytest plugin: per-op pass/fail counts of the golden replay."""

    def __init__(self):
        self.counts = {}
        self.failed = []

    def pytest_runtest_logreport(self, report):
        if report.when != "call" and not report.failed:
            return
        nid = report.nodeid
        op = (nid.split("[", 1)[1].rstrip("]").rsplit("_", 1)[0]
              if "[" in nid else nid)
        ok, bad = self.counts.get(op, (0, 0))
        if report.failed:
            self.counts[op] = (ok, bad + 1)
            self.failed.append(nid)
        elif report.when == "call":
            self.counts[op] = (ok + 1, bad)


def run_pytest(paths, extra=()):
    import pytest
    tally = _Tally()
    os.environ["MF_TEST_DEVICE"] = "gpu"
    rc = pytest.main([*paths, "-q", "-p", "no:cacheprovider",
                      "-p", "no:randomly", *extra], plugins=[tally])
    return rc, tally


def phase_goldens():
    rc, tally = run_pytest([os.path.join(HERE, "tests", f) for f in
                            ("test_conformance.py",
                             "test_conformance_large.py")])
    for op, (ok, bad) in sorted(tally.counts.items()):
        if bad:
            log(f"  {op}: {bad} outside the contract, {ok} conform")
    n_ok = sum(c[0] for c in tally.counts.values())
    n_bad = sum(c[1] for c in tally.counts.values())
    log(f"  golden replay: {n_ok} conform, {n_bad} outside the contract")
    check(rc == 0 and n_bad == 0, f"golden replay failed: {tally.failed}")


def phase_entry_points():
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np
    import mi_fieldcalc_tpu.api as fc
    from mi_fieldcalc_tpu import from_sentinel, ops
    from mi_fieldcalc_tpu.field import Field
    from mi_fieldcalc_tpu.models.pipeline import (STANDARD_PLEVELS,
                                                  derived_fields_isobaric)
    from mi_fieldcalc_tpu.staging import (run_hlevel_suite_np,
                                          run_vessel_icing_np)
    sys.path.insert(0, HERE)
    from tools.baseline_configs import (CONFIG2_MODES, storm,
                                        storm_inputs)
    #: storm outputs that are temperature differences or Celsius
    #: temperatures (kIndex, showalterIndex, boydenIndex, cvtemp,
    #: windCooling, pleveltemp mode 1)
    STORM_CELSIUS = {0, 2, 3, 5, 7, 11}

    # 22-call api.batch() storm at 719x929, against eager calls
    g = storm_inputs(NY, NX)
    eager = [np.asarray(o) for o in storm(fc, g)]
    with fc.batch():
        out = storm(fc, g)
    out = [np.asarray(o) for o in out]
    for k, (e, b) in enumerate(zip(eager, out)):
        em = e < 1e34
        check(close(b, e, celsius=k in STORM_CELSIUS),
              f"storm call {k}: batch differs from eager (max |d| "
              f"{float(np.max(np.abs(b[em] - e[em]), initial=0.0)):.3g})")
    t = timed(lambda: [np.asarray(o) for o in storm(fc, g)], reps=5)

    def batched():
        with fc.batch():
            o = storm(fc, g)
        return [np.asarray(x) for x in o]

    log(f"  api.batch() {len(out)}-call storm 719x929: equals eager; "
        f"eager {ms(t)} ms, batched {ms(timed(batched, reps=5))} ms")

    # hybrid-level suite, BASELINE config 2's modes, 10 levels
    a = pipeline_inputs(nlev=10, seed=3)
    with np.errstate(over="ignore"):
        rh = np.clip(np.abs(a[1]) * 1e4, 5.0, 95.0).astype(np.float32)
    rh[a[1] >= 1e34] = UNDEF
    got = run_hlevel_suite_np(a[0], a[1], rh, a[4], a[5], a[6],
                              **CONFIG2_MODES)
    tkf, qf, rhf, psf = (from_sentinel(x) for x in (a[0], a[1], rh, a[4]))
    for key, arr in got.items():
        fam, c = key.rstrip("0123456789"), int(key[len(key.rstrip(
            "0123456789")):])
        for k in (0, 9):
            lv = lambda f: Field(f.values[k], f.mask[k])  # noqa: E731
            al, bl = float(a[5][k]), float(a[6][k])
            if fam == "temp":
                ref = ops.hleveltemp(lv(tkf), psf, al, bl, c)
            else:
                h = qf if fam == "hum_q" else rhf
                ref = ops.hlevelhum(lv(tkf), lv(h), psf, al, bl, c)
            r = np.asarray(ref.to_sentinel(UNDEF))
            celsius = (fam == "temp" and c == 1) or (fam != "temp"
                                                     and 5 <= c <= 8)
            check(close(arr[k], r, celsius),
                  f"run_hlevel_suite_np {key} level {k}")
    log(f"  run_hlevel_suite_np 10x719x929 {sorted(got)}: matches "
        f"per-level ops; step median/min "
        f"{ms(timed(lambda: run_hlevel_suite_np(a[0], a[1], rh, a[4], a[5], a[6], **CONFIG2_MODES), reps=5))} ms")

    # isobaric: 65 hybrid levels -> the 11 standard pressure levels
    nl = 65
    b = list(pipeline_inputs(nlev=nl, seed=4, undefs=False))
    b[5] = np.linspace(50.0, 300.0, nl).astype(np.float32)
    b[6] = (np.linspace(0.0, 0.7, nl) ** 1.5).astype(np.float32)
    iargs = jax.device_put(to_fields(b))
    c, tc = compiled(functools.partial(
        derived_fields_isobaric, plevels=STANDARD_PLEVELS), *iargs)
    iso = c(*iargs)
    log(f"  isobaric 65L -> 11 plevels, 719x929: compile {tc:.2f} s, step "
        f"median/min {ms(timed(lambda: c(*iargs), reps=10))} ms")
    m = np.asarray(iso.th.mask)
    check(iso.th.values.shape == (11, NY, NX) and m.any()
          and np.isfinite(np.asarray(iso.th.values)[m]).all(),
          "isobaric: shape or non-finite theta")

    # vessel icing, all four products
    rng = np.random.default_rng(5)

    def f(lo, hi):
        x = rng.uniform(lo, hi, (NY, NX)).astype(np.float32)
        x.reshape(-1)[rng.integers(0, x.size, x.size // 97)] = UNDEF
        return x

    icing = (f(0.0, 35.0), f(0.1, 8.0), f(-25.0, 25.0), f(-25.0, 25.0),
             f(-25.0, 2.0), f(0.3, 1.0), f(-1.0, 8.0), f(960.0, 1040.0),
             f(2.0, 12.0), f(0.0, 0.5), f(5.0, 500.0))
    scal = dict(vs=5.0, alpha=0.52, zmin=2.0, zmax=11.0, alt=1)
    t0 = time.perf_counter()
    prods = run_vessel_icing_np(*icing, **scal)
    t_first = time.perf_counter() - t0
    for name, arr in prods.items():
        d = arr < 1e34
        check(arr.shape == (NY, NX) and d.any()
              and np.isfinite(arr[d]).all(), f"icing {name}")
    t0 = time.perf_counter()
    run_vessel_icing_np(*icing, **scal)
    log(f"  run_vessel_icing_np {sorted(prods)} 719x929: finite; first "
        f"call {t_first:.2f} s, second "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms; defined share "
        + str({k: round(float((v < 1e34).mean()), 4)
               for k, v in prods.items()}))


def phase_gpu_tests():
    rc, tally = run_pytest([os.path.join(HERE, "tests")], ["-m", "gpu"])
    n_ok = sum(c[0] for c in tally.counts.values())
    log(f"  gpu-marked tests: {n_ok} passed, failed {tally.failed}")
    check(rc == 0 and n_ok > 0, f"gpu tests failed: {tally.failed}")


def phase_four():
    """The multi-device path on a (1, 2, 2) mesh, against one card."""
    import jax
    import numpy as np
    from mi_fieldcalc_tpu.models import derived_fields
    from mi_fieldcalc_tpu.models.pipeline import RADIUS
    from mi_fieldcalc_tpu.parallel import grid_mesh, run_sharded

    check(len(jax.devices()) >= 4, f"--four needs 4 GPUs, found "
          f"{len(jax.devices())}")
    mesh = grid_mesh((1, 2, 2), devices=jax.devices()[:4])
    log(f"  mesh {dict(mesh.shape)} over {mesh.devices.ravel().tolist()}")
    npa = pipeline_inputs()
    # 719x929 does not split in two: pad one dead row and column at the
    # far edges (undefined), on both sides of the comparison
    pad = [np.pad(a, [(0, 0)] * (a.ndim - 2) + [(0, 1), (0, 1)],
                  constant_values=UNDEF if k < 5 else 0)
           for k, a in enumerate(npa[:5])]
    pad += [npa[5], npa[6]] + [np.pad(a, [(0, 1), (0, 1)], mode="edge")
                               for a in npa[7:]]
    pargs = to_fields(pad)
    one = jax.jit(derived_fields)
    sharded = jax.jit(lambda *a: run_sharded(derived_fields, mesh, RADIUS,
                                             *a))
    compare_fields(sharded(*pargs), one(*pargs),
                   "run_sharded(derived_fields) 4 cards vs 1")
    log(f"  run_sharded step median/min "
        f"{ms(timed(lambda: sharded(*pargs), reps=10))} ms; one card "
        f"{ms(timed(lambda: one(*pargs)))} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the (1, 2, 2) four-card path")
    opts = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "mi_fieldcalc_tpu")):
        print("chip_smoke.py: the mi_fieldcalc_tpu package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import jax
    try:
        dev = jax.devices()[0]
    except RuntimeError as e:
        print(f"chip_smoke.py: JAX found no device: {e}", file=sys.stderr)
        return 2
    if dev.platform != "gpu":
        print(f"chip_smoke.py: needs a GPU; JAX's default device is "
              f"{dev.platform!r}", file=sys.stderr)
        return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    log(f"card: {smi}")
    phases = ([phase_setup, phase_four] if opts.four else
              [phase_setup, phase_main_path, phase_device_step,
               phase_goldens, phase_entry_points, phase_gpu_tests])
    failed = []
    for ph in phases:
        name = ph.__name__[len("phase_"):]
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            ph()
        except Exception as e:  # a failed phase fails the run
            import traceback
            traceback.print_exc()
            failed.append(f"{name}: {type(e).__name__}: {e}"[:500])
        log(f"   ({time.perf_counter() - t0:.1f} s)")
    log(f"card: {smi}")
    if failed:
        print("chip_smoke.py: failed phases:\n  " + "\n  ".join(failed),
              file=sys.stderr)
        return 1
    n = len(jax.devices())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": n}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
