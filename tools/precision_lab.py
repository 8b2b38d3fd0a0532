"""Precision evaluation for the double-intermediate operators (SURVEY §7
hard-part 3; VERDICT r2 item 4).

The reference computes seaSoundSpeed (FieldCalculations.cc:1581-1593) and
the vessel-icing solvers (FieldCalculationsVesselIcing.cc:95-103, 218-328)
with double intermediates; this framework is float32.  This lab quantifies what that costs, per op, on
ADVERSARIAL grids (ranges wider than production, plus targeted bands at
the solver thresholds), against two truths:

* the compiled reference oracle (double intermediates, f32-rounded
  output) — the conformance truth, and
* a numpy-f64 replica of our own formula (sound speed only) — isolates
  precision loss from formula/reassociation differences.

It also measures a compensated-f32 variant of seaSoundSpeed (Dekker
two-float products + Neumaier summation — no f64) to
answer "would compensation buy an order of magnitude?" with a number.

Usage:  python tools/precision_lab.py [--ny 96] [--nx 128] [--seed 5]
Writes PRECISION.json next to the repo root and prints one markdown
table row per op.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

UNDEF = 1e35
ORACLE = os.environ.get("ORACLE_SO", "/tmp/ref_build/liboracle.so")

cf = ctypes.c_float
ci = ctypes.c_int


def ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# ---------------------------------------------------------------------------
# adversarial inputs: production ranges stretched to the physical extremes,
# plus structured bands pinned at the solver thresholds (freezing point,
# spray-flux cutoffs, stall bands) where iterative error is worst
# ---------------------------------------------------------------------------

def adversarial_inputs(ny, nx, seed):
    rng = np.random.default_rng(seed)

    def u(lo, hi):
        return rng.uniform(lo, hi, (ny, nx)).astype(np.float32)

    g = {
        "sal": u(0.0, 40.0),          # fresh meltwater .. hypersaline
        "wave": u(0.05, 14.0),        # calm .. extreme sea state
        "xw": u(-45.0, 45.0),
        "yw": u(-45.0, 45.0),
        "at": u(-45.0, 1.5),          # deep cold .. above-freezing edge
        "rh": u(20.0, 100.0),
        "sst": u(-1.9, 18.0),         # at the freezing edge .. warm
        "p": u(930.0, 1060.0),
        "pw": u(930.0, 1060.0),
        "aice": u(0.0, 1.0),
        "depth": u(3.0, 2000.0),
        "tc": u(-2.5, 42.0),          # sound speed: polar .. tropical
    }
    # threshold bands: first rows pinned where the solvers branch
    g["sst"][0, :] = np.linspace(-1.95, 0.2, nx)      # near freezing point
    g["at"][1, :] = np.linspace(-0.8, 0.8, nx)        # icing on/off edge
    g["wave"][2, :] = np.linspace(0.05, 0.5, nx)      # spray-flux cutoff
    g["aice"][3, :] = np.linspace(0.35, 0.75, nx)     # ice-cover damping
    g["sal"][4, :] = np.linspace(0.0, 3.0, nx)        # fresh-water fp
    g["tc"][0, :] = np.linspace(-2.5, 0.0, nx)
    return g


# ---------------------------------------------------------------------------
# oracle calls
# ---------------------------------------------------------------------------

def oracle_lib():
    if not os.path.exists(ORACLE):
        raise SystemExit(f"oracle not built: {ORACLE} "
                         "(run sh tools/oracle/build.sh)")
    return ctypes.CDLL(ORACLE)


def o_call(lib, name, ny, nx, fields, scalars=(), int_scalars=()):
    out = np.full((ny, nx), np.nan, np.float32)
    fd = ctypes.c_int(2)      # SOME_DEFINED
    args = [ci(nx), ci(ny)]
    args += [ptr(np.ascontiguousarray(f, np.float32)) for f in fields]
    args += [cf(s) for s in scalars]
    args += [ci(s) for s in int_scalars]
    args += [ptr(out), ctypes.byref(fd), cf(UNDEF)]
    ok = getattr(lib, "o_" + name)(*args)
    assert ok, name
    return out


# ---------------------------------------------------------------------------
# compensated-f32 sound speed (Dekker/Neumaier, no f64 anywhere)
# ---------------------------------------------------------------------------

def _split(a):
    """Dekker split of f32 into hi+lo with exact 12/12-bit halves."""
    c = np.float32(4097.0) * a          # 2^12 + 1
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """a*b as (product, exact f32 rounding error), fma-free."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _two_sum(a, b):
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def sound_speed_comp_f32(tc, s):
    """Ross sound speed, f32 compensated: every product tracked with its
    Dekker error term, the 8 addends Neumaier-summed.  ~6x the flop count
    of the plain evaluation — irrelevant for a DMA-bound pointwise op."""
    f = np.float32
    T, S = tc.astype(np.float32), s.astype(np.float32)
    terms = []          # (value, error) pairs

    t2, e2 = _two_prod(T, T)
    t3, e3 = _two_prod(t2, T)                      # T^3 (+ e2*T error)
    for c, v, ev in ((f(4.565), T, None), (f(-0.0517), t2, e2),
                     (f(0.000221), t3, e3 + e2 * T)):
        p, pe = _two_prod(f(c), v)
        terms.append((p, pe + (f(c) * ev if ev is not None else f(0))))

    s35 = S - f(35.0)
    cs_poly = f(1.338) - f(0.013) * T + f(0.0001) * t2   # small factor
    p, pe = _two_prod(cs_poly, s35)
    terms.append((p, pe))

    z = abs(50.0)
    terms.append((f(0.01635 * z + 0.000000175 * z * z), f(0)))
    terms.append((f(1449.1), f(0)))

    acc = np.zeros_like(T)
    comp = np.zeros_like(T)
    for v, e in terms:
        acc, err = _two_sum(acc, v)
        comp = comp + err + e
    return acc + comp


def sound_speed_f64(tc, s):
    """numpy-f64 replica of ops.levels.sea_sound_speed (z=50, Celsius)."""
    T = tc.astype(np.float64)
    S = s.astype(np.float64)
    z = 50.0
    cz = 0.01635 * z + 0.000000175 * z * z
    ct = 4.565 * T - 0.0517 * T * T + 0.000221 * T ** 3
    cs = (1.338 - 0.013 * T + 0.0001 * T * T) * (S - 35.0)
    return 1449.1 + ct + cs + cz


# ---------------------------------------------------------------------------


def stats(ours, truth, tol, rtol=1e-4, return_map=False):
    """Allclose-style criterion: a point conforms when |d| <= atol OR
    rel <= rtol — equivalently when the CONFORMANCE RATIO
    ``r = |d| / max(atol, rtol*|truth|)`` is <= 1.

    The atol is the production-magnitude conformance tolerance
    (CONFORMANCE.md); the rtol covers the adversarial tail where the
    physically-out-of-range inputs drive outputs to 1e3-1e4 and a pure
    atol would demand more relative precision than f32 carries.

    Raw |d| percentiles are kept for scale, but ADJUDICATION reads the
    ratio percentiles (``p99_conf``/``p999_conf``/``max_conf``): a row
    with p99 raw error above atol but p99_conf <= 1 is conforming
    large-magnitude output, not a failure (VERDICT r4 weak #4).
    ``return_map=True`` additionally returns the per-lane nonconforming
    boolean map so callers can attribute each red lane to a quantified
    irreducible band (knife-edge / luck-band adjudication below)."""
    d = np.abs(ours.astype(np.float64) - truth.astype(np.float64))
    both = (ours != UNDEF) & (truth != UNDEF) & np.isfinite(d)
    mask_mismatch = int(((ours == UNDEF) != (truth == UNDEF)).sum())
    denom = np.maximum(tol, rtol * np.abs(truth.astype(np.float64)))
    conf = d / denom                      # conformance ratio; <=1 passes
    nonconf = both & (conf > 1.0)
    rel = d / np.maximum(np.abs(truth.astype(np.float64)), 1e-12)
    d = d[both]
    confb = conf[both]
    relb = rel[both]
    st = {
        "n": int(both.sum()),
        "mask_mismatch": mask_mismatch,
        "max": float(d.max()) if d.size else 0.0,
        "p999": float(np.percentile(d, 99.9)) if d.size else 0.0,
        "p99": float(np.percentile(d, 99)) if d.size else 0.0,
        "max_rel": float(relb.max()) if relb.size else 0.0,
        "max_conf": float(confb.max()) if confb.size else 0.0,
        "p999_conf": float(np.percentile(confb, 99.9)) if confb.size else 0.0,
        "p99_conf": float(np.percentile(confb, 99)) if confb.size else 0.0,
        "tolerance": tol,
        "rtol": rtol,
        "nonconforming": int(nonconf.sum()),
        "within": bool(nonconf.sum() == 0),
    }
    return (st, nonconf) if return_map else st


def wave_f64_replica(pw, depth, cap=10000, band=0.02):
    """Exact f64 replica of the reference's shallow-water wave loop
    (VI:221-237, Mincog cap 1000 at VI:494-508): iterate
    ``c <- c0*tanh(a/c)`` from c=1 until |dc| <= 1e-5, cap => c=0.

    Returns per-lane maps: ``shallow`` (in the iterated branch), ``c``
    (the reference's f64 exit iterate, cap semantics applied — the
    deep-water c0 elsewhere), ``j`` (iteration count), and ``in_band``
    (true count within ``band`` of the cap — the knife-edge band where
    our ~1.5%-accurate integral count predictor, icing.py
    ``_wave_cap_predict``, may legitimately disagree with the
    reference; the reference itself flips these lanes under any
    perturbation)."""
    c0 = 9.81 / (2 * np.pi) * pw.astype(np.float64)
    shallow = (depth.astype(np.float64) <= c0 * pw) & (c0 != 0)
    a = 2 * np.pi * depth.astype(np.float64) / np.where(pw != 0, pw, 1)
    c = np.ones_like(c0)
    live = shallow.copy()
    j = np.zeros(c0.shape, np.int64)
    for it in range(int(cap * (1 + band)) + 2):
        if not live.any():
            break
        cn = np.where(live, c0 * np.tanh(a / np.where(c != 0, c, 1)), c)
        err = np.abs(cn - c)
        conv = live & (err <= 1e-5)
        c = np.where(live, cn, c)
        j = np.where(live, j + 1, j)
        live &= ~conv
    capped = shallow & (j > cap)
    c_ref = np.where(shallow, np.where(capped, 0.0, c), c0)
    in_band = shallow & (np.abs(j - cap) <= band * cap)
    return {"shallow": shallow, "c": c_ref, "j": j, "in_band": in_band,
            "c0": c0, "a": a}


def mincog_luck_band(rep, factor=3.0, threshold=3e-5):
    """Per-lane map of the MINCOG f32-luck band: the reference's own
    V=float wave iterates random-walk at a stationary step
    ``(1+s)*eps*r/(1-s)`` and stall to the cap wherever it exceeds
    ~tol; our solver models that with a calibrated 3e-5 threshold
    (icing.py `_wave_speed_fixed_point` ref_f32).  Lanes whose floor
    step falls within ``factor`` of the threshold are implementation
    luck — the calibration showed an exactly-rounded tanh emulation
    already disagrees with libc tanhf on 0.74% of lanes there, i.e.
    the reference's own outcome flips with single-ulp libm deltas
    across platforms.  ``rep`` is a :func:`wave_f64_replica` result
    (cap=1000)."""
    r = np.maximum(np.where(rep["c"] > 0, rep["c"], 1e-5), 1e-5)
    t = np.tanh(rep["a"] / r)
    s = rep["c0"] * rep["a"] * (1.0 - t * t) / (r * r)
    floor_step = (1.0 + s) * 1.19e-7 * r / np.maximum(1.0 - s, 1e-12)
    return rep["shallow"] & (floor_step >= threshold / factor) \
        & (floor_step <= threshold * factor)


def adjudicate(st, nonconf_map, bands):
    """Attribute each nonconforming lane to a quantified irreducible
    band (VERDICT r4 item 3).  ``bands`` is {name: bool map}; adds
    per-band counts plus ``nonconforming_unexplained`` and
    ``within_adjudicated`` (true iff every red lane sits in a band)."""
    explained = np.zeros_like(nonconf_map)
    for name, m in bands.items():
        st[f"nonconforming_{name}"] = int((nonconf_map & m).sum())
        explained |= m
    unexplained = int((nonconf_map & ~explained).sum())
    st["nonconforming_unexplained"] = unexplained
    st["within_adjudicated"] = bool(st["within"] or unexplained == 0)
    return st


def physical_inputs(ny, nx, seed):
    """Production-plausible ranges: in particular a REAL wave period
    (2-25 s) and coastal depths — the adversarial set feeds ~1000 s
    periods which put the wave fixed point in regimes the reference
    never sees operationally."""
    g = adversarial_inputs(ny, nx, seed + 1000)
    rng = np.random.default_rng(seed + 2000)
    g["pw"] = rng.uniform(2.0, 25.0, (ny, nx)).astype(np.float32)
    g["depth"] = rng.uniform(0.5, 500.0, (ny, nx)).astype(np.float32)
    g["at"] = rng.uniform(-25.0, 1.5, (ny, nx)).astype(np.float32)
    # shallow-water stress band: decimeter depths at long periods (the
    # cap-boundary regime for physical inputs)
    g["depth"][0, :] = np.linspace(0.05, 2.0, nx)
    g["pw"][0, :] = np.linspace(15.0, 25.0, nx)
    return g


def run_suite(fc, lib, g, ny, nx, results, sound_speed=True,
              x64_wave=True):
    if sound_speed:
        for c in (1, 2):
            t_in = g["tc"] if c == 1 else g["tc"] + np.float32(273.15)
            ref = o_call(lib, "seaSoundSpeed", ny, nx, [t_in, g["sal"]],
                         scalars=(50.0,), int_scalars=(c,))
            ours = np.asarray(fc.seaSoundSpeed(t_in, g["sal"], 50.0, c))
            truth64 = sound_speed_f64(
                t_in - (np.float32(273.15) if c == 2 else np.float32(0)),
                g["sal"])
            comp = sound_speed_comp_f32(
                t_in - (np.float32(273.15) if c == 2 else np.float32(0)),
                g["sal"])
            results[f"seaSoundSpeed_c{c}"] = {
                "vs_oracle": stats(ours, ref, 5e-3, 1e-6),
                "vs_own_f64": stats(ours, truth64.astype(np.float32),
                                    5e-3, 1e-6),
                "compensated_vs_own_f64": stats(
                    comp, truth64.astype(np.float32), 5e-3, 1e-6),
            }

    i6 = [g["at"], g["sst"], g["xw"], g["yw"], g["sal"], g["aice"]]
    for name, op in (("vesselIcingOverland", fc.vesselIcingOverland),
                     ("vesselIcingMertins", fc.vesselIcingMertins)):
        ref = o_call(lib, name, ny, nx, i6)
        ours = np.asarray(op(*i6))
        results[name] = {"vs_oracle": stats(ours, ref, 1e-4, 1e-5)}

    i11 = [g["sal"], g["wave"], g["xw"], g["yw"], g["at"], g["rh"],
           g["sst"], g["p"], g["pw"], g["aice"], g["depth"]]
    vsz = (5.0, 90.0, 2.0, 4.0)

    # -- ModStall: f64 reference -> knife-edge adjudication + the
    #    selective-x64 wave-stage experiment (VERDICT r4 item 3)
    t0 = time.perf_counter()
    rep10k = wave_f64_replica(g["pw"], g["depth"], cap=10000)
    t_replica = time.perf_counter() - t0
    ref = o_call(lib, "vesselIcingModStall", ny, nx, i11, scalars=vsz)
    np.asarray(fc.vesselIcingModStall(*i11, *vsz))      # warm the jit
    t0 = time.perf_counter()
    ours = np.asarray(fc.vesselIcingModStall(*i11, *vsz))
    t_f32 = time.perf_counter() - t0
    st, ncmap = stats(ours, ref, 2e-3, 1e-4, return_map=True)
    st["wave_cap_knife_edge_lanes"] = int(rep10k["in_band"].sum())
    st["shallow_lanes"] = int(rep10k["shallow"].sum())
    adjudicate(st, ncmap, {"in_knife_edge": rep10k["in_band"]})
    row = {"vs_oracle": st}

    if x64_wave:
        # selective x64: ONLY the wave stage runs as the exact f64
        # replica of the reference loop (host numpy); every later
        # stage stays the shipped f32.
        # Answers "how much of the residual is the wave stage" with a
        # number, and prices the fix.
        import jax.numpy as jnp
        from mi_fieldcalc_tpu import from_sentinel
        from mi_fieldcalc_tpu.ops import icing as icing_ops
        fields = [from_sentinel(x) for x in i11]
        cw = jnp.asarray(rep10k["c"].astype(np.float32))
        outf = icing_ops.vessel_icing_modstall(*fields, *vsz,
                                               _wave_speed=cw)
        ours64 = np.asarray(outf.to_sentinel(UNDEF))
        st64 = stats(ours64, ref, 2e-3, 1e-4)
        st64["wave_replica_host_ms"] = round(t_replica * 1e3, 2)
        st64["f32_full_op_ms"] = round(t_f32 * 1e3, 2)
        row["x64_wave_vs_oracle"] = st64
    results["vesselIcingModStall"] = row

    # -- MINCOG: V=float reference -> luck-band + knife-edge adjudication
    rep1k = wave_f64_replica(g["pw"], g["depth"], cap=1000)
    luck = mincog_luck_band(rep1k)
    for alt in (1, 2):
        ref = o_call(lib, "vesselIcingMincog", ny, nx, i11,
                     scalars=vsz, int_scalars=(alt,))
        ours = np.asarray(fc.vesselIcingMincog(*i11, *vsz, alt))
        st, ncmap = stats(ours, ref, 2e-3, 1e-4, return_map=True)
        st["luck_band_lanes"] = int(luck.sum())
        adjudicate(st, ncmap, {"in_luck_band": luck,
                               "in_knife_edge": rep1k["in_band"]})
        results[f"vesselIcingMincog_alt{alt}"] = {"vs_oracle": st}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ny", type=int, default=96)
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--seed", type=int, default=5)
    a = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from mi_fieldcalc_tpu.utils.compile_cache import enable
    enable()
    import mi_fieldcalc_tpu.api as fc

    lib = oracle_lib()
    ny, nx = a.ny, a.nx

    results = {}
    run_suite(fc, lib, adversarial_inputs(ny, nx, a.seed), ny, nx, results)
    physical = {}
    run_suite(fc, lib, physical_inputs(ny, nx, a.seed), ny, nx, physical,
              sound_speed=False)
    results.update({f"physical/{k}": v for k, v in physical.items()})

    import jax as _jax
    out = {"grid": [ny, nx], "seed": a.seed,
           "platform": _jax.devices()[0].platform, "results": results}
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))),
        "PRECISION.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)

    print("| op | truth | n | max err | p99.9 | p99 | p99.9 conf "
          "| tol | within | adjudicated |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for op, tr in results.items():
        for truth, st in tr.items():
            adj = st.get("within_adjudicated", st["within"])
            print(f"| {op} | {truth} | {st['n']} | {st['max']:.3g} "
                  f"| {st['p999']:.3g} | {st['p99']:.3g} "
                  f"| {st.get('p999_conf', 0):.3g} "
                  f"| {st['tolerance']:g} | {st['within']} | {adj} "
                  f"(mask mism {st['mask_mismatch']}) |")


if __name__ == "__main__":
    main()
