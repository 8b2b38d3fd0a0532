"""Vessel-icing operators: Overland, Mertins, Modified Stallabrass, MINCOG.

Reference: FieldCalculationsVesselIcing.cc — vesselIcingOverland (77),
vesselIcingMertins (114), vesselIcingModStall (182), FreezeFracZero (339),
bisection (381), runge_kutta (450), vesselIcingMincog (465, 677).

These are the reference's per-point *iterative numerical solvers*.  The
vectorized formulation replaces data-dependent scalar loops with:

* whole-array ``lax.while_loop`` fixed points with per-lane convergence
  masks (trip count = slowest unconverged lane, bounded by the reference's
  own iteration caps, with the reference's diverged => 0 semantics),
* fixed-trip-count Runge-Kutta (50 steps) unchanged,
* the bisection root find as a *fixed* 17-step unrolled bracket update —
  the reference computes its iteration count from the static bracket
  ``log2(1.8/1e-5)`` (VI:391), so the trip count is data-independent.

Precision: MINCOG's scalar template is instantiated at ``float`` by the
reference wrapper (VI:697), so float32 here is faithful; Overland /
Mertins / ModStall use double intermediates in the reference — float32
here, with conformance tolerances documented in the test suite (the
formulas are condition-number benign).
"""

from __future__ import annotations

import math
import os

import jax
import jax.numpy as jnp

from ..constants import t0
from ..field import Field
from ._harness import and_masks, out_field, require

__all__ = [
    "vessel_icing_overland", "vessel_icing_mertins",
    "vessel_icing_modstall", "vessel_icing_mincog",
]

_f32 = jnp.float32


# Platform-deterministic f32 transcendentals (round 4): the icing
# solvers' sensitive stages (wave fixed point, droplet RK, freeze-
# fraction Newton) amplify last-ulp exp/tanh differences into visible
# output deltas, so the solver cores use the shared Cephes-structured
# implementations (.._libm — the same arithmetic on every backend).
from .._libm import exp_f32 as _exp_f32, tanh_f32 as _tanh_f32  # noqa: E402


def _icing_f1(t):
    """Magnus-type saturation vapor pressure (VI:53-57)."""
    return _f32(0.6112) * _exp_f32(_f32(17.67) * t / (t + _f32(243.5)))


def _kt4(t_celsius):
    """Stefan-Boltzmann T^4 (VI:65-70)."""
    tk = t_celsius + t0
    t2 = tk * tk
    return _f32(5.67e-8) * t2 * t2


def _stallabrass_tf(sal):
    """Freezing point of sea water, Stallabrass (1980) (VI:95)."""
    return (_f32(-0.002) - _f32(0.0524) * sal) - _f32(6.0e-5) * sal * sal


def vessel_icing_overland(airtemp: Field, seatemp: Field, u: Field, v: Field,
                          sal: Field, aice: Field) -> Field:
    """Overland (1990) icing rate; cubic in the icing predictor
    (VI:77-112).  Undefined where ice cover >= 0.4 or SST below the brine
    freezing point."""
    mask = and_masks(airtemp, seatemp, u, v, sal, aice)
    gate = mask & (aice.values < _f32(0.4))
    tf = _stallabrass_tf(sal.values)
    gate = gate & ~(seatemp.values < tf)
    ff = jnp.sqrt(u.values**2 + v.values**2)
    ppr = ff * (tf - airtemp.values) \
        / (1 + _f32(0.3) * (seatemp.values - tf))
    out = _f32(2.73e-2) * ppr + _f32(2.91e-4) * (ppr * ppr) \
        + _f32(1.84e-6) * ppr * ppr * ppr
    return out_field(out, gate)


def vessel_icing_mertins(airtemp: Field, seatemp: Field, u: Field, v: Field,
                         sal: Field, aice: Field) -> Field:
    """Mertins (1968) discrete icing-rate lookup: 4 wind bands x SST-scaled
    temperature thresholds (VI:114-180)."""
    mask = and_masks(airtemp, seatemp, u, v, sal, aice)
    gate = mask & (aice.values < _f32(0.4))
    tf = _stallabrass_tf(sal.values)
    gate = gate & ~(seatemp.values < tf)

    ff = jnp.sqrt(u.values**2 + v.values**2)
    tt = airtemp.values
    sst = seatemp.values

    # wind bands (VI:136-154): thresholds temp1/temp2/temp3 per band
    b0 = (_f32(-1.15) * sst - _f32(4.3), _f32(-1.5) * sst - _f32(10),
          jnp.full_like(sst, _f32(-10000.0)))
    b1 = (_f32(-0.6) * sst - _f32(3.2), _f32(-1.05) * sst - _f32(5.6),
          _f32(-1.75) * sst - _f32(12.5))
    b2 = (_f32(-0.3) * sst - _f32(2.6), _f32(-0.66) * sst - _f32(3.32),
          _f32(-1.325) * sst - _f32(7.651))
    b3 = (_f32(-0.14) * sst - _f32(2.28), _f32(-0.3) * sst - _f32(2.6),
          _f32(-1.16) * sst - _f32(5.22))

    in1 = ff < _f32(17.2)
    in2 = ff < _f32(20.8)
    in3 = ff < _f32(28.5)

    def pick(i):
        return jnp.where(in1, b0[i], jnp.where(in2, b1[i],
                         jnp.where(in3, b2[i], b3[i])))

    temp1, temp2, temp3 = pick(0), pick(1), pick(2)
    # lowest band quirk (VI:163): "temperature <= temp3 || ff < 17.2" selects
    # 4.375 cm/h instead of 6.25 for the first wind band.
    low = jnp.where((tt <= temp3) | in1, _f32(4.375), _f32(6.25))
    rate = jnp.where(tt > _f32(-2), _f32(0),
                     jnp.where(tt > temp1, _f32(0.8333),
                               jnp.where(tt > temp2, _f32(2.0833), low)))
    out = jnp.where(ff >= _f32(10.8), rate, _f32(0))
    return out_field(out, gate)


# ---------------------------------------------------------------------------
# shared solver building blocks
# ---------------------------------------------------------------------------

def _solver_unrolls(default=(1, 1, 1)):
    """(fp, rk, newton) loop-unroll factors for the iterative solvers —
    steps per loop-carry handoff.  The binding cost of these loops is the CARRY handoff per iteration, and
    unrolling amortizes it with per-lane-identical results (done lanes
    hold, so up-to-u-1 extra fixed-point steps after convergence are
    no-ops; newton <= 4 keeps the fori so XLA cannot re-fuse the whole
    solve with excess precision).  On the whole-array path unrolling the
    wave FP pays u wasted FULL-GRID passes per early exit, so the default
    is (1, 1, 1).  Trace-time env override ``MF_SOLVER_UNROLL=fp,rk,newton``
    for experiments."""
    s = os.environ.get("MF_SOLVER_UNROLL", "")
    if s:
        fp, rk, nt = (int(x) for x in s.split(","))
        return fp, rk, nt
    return default


def _unrolled_fori(n: int, body, init, unroll: int):
    """``fori_loop(0, n, body, init)`` with ``unroll`` steps per carry
    handoff (identical op sequence; ``body`` must ignore its index)."""
    u = max(1, min(unroll, n))
    state = init
    if u >= n:
        for _ in range(n):
            state = body(0, state)
        return state

    def body_u(i, st):
        for _ in range(u):
            st = body(0, st)
        return st

    state = jax.lax.fori_loop(0, n // u, body_u, state)
    for _ in range((n // u) * u, n):
        state = body(0, state)
    return state


def _wave_speed_fixed_point(c0, a, needs_iter, max_iter: int, tol: float,
                            unroll: int = 1, warmup: int = 32,
                            ref_f32: bool = False):
    """Shallow-water wave speed c = c0 * tanh(a / c), iterated from c = 1
    until |dc| <= tol with the reference's diverged => 0 semantics
    (ModStall VI:221-237, Mincog VI:494-508).

    ``ref_f32`` selects which REFERENCE is being conformed to: ModStall
    iterates in double (VI:221 ``double c``) so cap-vs-converge follows
    the f64 flow; Mincog is ``template<typename V>`` instantiated with
    V=float (VI:464-468, call at VI:697), so the reference's own f32
    iterates random-walk at a stationary amplitude ~eps*root/(1-s) and
    STALL to the 1000-iteration cap => c = 0 whenever the stationary
    step (1+s)*eps*root/(1-s) exceeds tol — even where the f64 flow
    converges in a few hundred steps.  With ``ref_f32=True`` that stall
    test gates convergence (round-3 precision lab, physical/Mincog_alt2).

    ``needs_iter`` marks lanes in the shallow-water branch; others return
    ``c0`` untouched.  Structure: ``warmup`` EXACT map iterations (fast
    lanes exit on the reference's own |dc| <= tol criterion with exact
    trajectories), then survivors switch to Newton on
    ``h(c) = c - c0*tanh(a/c)``.  Since g' <= 0 everywhere, h' = 1 - g'
    >= 1 and h is concave increasing, so Newton is globally convergent
    and the loop exit stays the reference's own residual criterion
    (|g(c) - c| <= tol, i.e. the next map step would move < tol).

    Why Newton instead of iterating the map: the map's contraction at
    the root, s = |g'(root)|, tends to 1- in the sqrt(g*depth) regime
    (a << root), where the f64 reference needs thousands of iterations
    and an f32 iterate STALLS at a noise floor of ~eps*c/(1-s) >> tol —
    it can never satisfy the exit criterion (observed: f64 converges at
    j=4954 to c=117.6 while f32 cycles forever; round-3 precision lab).
    A secant/Aitken projection from the still-nonlinear oscillation
    lands on a wrong root (259 vs 117.6) — hence analytic-slope Newton.

    The reference's cap semantics (j > max_iter => c = 0, VI:232-235)
    is decided by PREDICTION for Newton-resolved lanes: the f64
    trajectory's iteration count from the switch iterate c_sw down to
    the tol exit is computed as the log-amplitude ODE integral
    ``j ~ warmup + 2 * int d(ln u) / (-ln q(u))`` where ``q(u)`` is the
    two-map-step amplitude decay at amplitude u, evaluated at 17
    log-spaced quadrature nodes with the cancellation-free tanh
    subtraction identity (:func:`_wave_cap_predict`).  Measured
    accuracy: within ~1.5% of the true f64 count across the whole
    (c0, a) range, so only lanes whose true count lands within ~2% of
    the cap can flip cap-vs-converge vs the reference — for physical
    inputs (wave period <= 25 s) that band is depths of a few
    decimeters (PRECISION.md quantifies it on adversarial grids).

    The ``done`` carry rides as int32 and finiteness tests avoid
    ``isfinite``/``sinh``, so the function also lowers inside a Pallas
    kernel should one ever trace it.
    """
    c_init = jnp.where(needs_iter, _f32(1.0), c0)
    done0 = (~needs_iter).astype(jnp.int32)
    tolf = _f32(tol)
    # Newton converges in <= ~15 steps from any warmup endpoint; 64 is
    # margin.  `forced` below is a safety net only.
    loop_cap = warmup + 64

    def cond(state):
        c, c_sw, done_i, j = state
        return jnp.logical_and(j < loop_cap, ~jnp.all(done_i != 0))

    def body(state):
        c, c_sw, done_i, j = state
        done = done_i != 0
        t = _tanh_f32(a / c)
        g = c0 * t
        # |g'(c)| = c0 * a * sech^2(a/c) / c^2   (g' is always <= 0)
        gp = (c0 * a) * (_f32(1.0) - t * t) / (c * c)
        err1 = jnp.abs(g - c)
        j1 = j + 1
        newton_phase = j1 > warmup
        # switch-point iterate: where the f64 trajectory stands after
        # `warmup` exact steps — start amplitude for the cap prediction
        c_sw = jnp.where((~done) & (j1 == warmup + 1), c, c_sw)
        # warmup: the reference's own |dc| <= tol exit.  Newton phase:
        # the f32 residual |g(c) - c| bottoms out at the backend tanh's
        # relative error times c (measured ~2e-6*c on XLA:CPU — it can
        # exceed tol when the root is large), so accept the root once
        # the residual is below 2e-5*|c|; that is still far inside the
        # reference's own exit slack of tol*s/(1-s) for every lane that
        # reaches the Newton phase (those have s > ~0.56).  The
        # threshold only controls how EARLY Newton stops: lanes that
        # never meet it resolve at loop_cap with the stalled iterate
        # (di=2 below), never with a wrong 0.
        conv = (~done) & (err1 <= jnp.maximum(
            tolf, jnp.where(newton_phase,
                            _f32(2e-5) * jnp.abs(c), _f32(0.0))))
        # next iterate: exact map in warmup, Newton afterwards; root is
        # in (0, c0], clamp for safety
        newt = jnp.clip(c - (c - g) / (_f32(1.0) + gp), tolf, c0)
        c_next = jnp.where(newton_phase, newt, g)
        forced = (~done) & (j1 >= loop_cap)
        # freeze values: reference exit iterate g during warmup, the
        # Newton root c afterwards (cap decision applied post-loop).
        # Newton is globally convergent here, so a lane still live at
        # loop_cap sits at the f32 residual floor around the root —
        # resolve it as Newton-converged too.
        c_out = jnp.where(
            done, c,
            jnp.where(conv & ~newton_phase, g,
                      jnp.where(forced & ~newton_phase, _f32(0.0), c)))
        c_out = jnp.where((~done) & ~(conv | forced), c_next, c_out)
        di = jnp.where(done, done_i,
                       jnp.where((conv | forced) & newton_phase,
                                 jnp.int32(2),
                                 jnp.where(conv | forced, jnp.int32(1),
                                           jnp.int32(0))))
        return (c_out, c_sw, di, j1)

    if unroll > 1:
        # u steps per cond check: done lanes hold, the per-step j/cap
        # logic is inside `body`, so per-lane results are identical —
        # at most u-1 wasted steps after the last lane converges
        step = body

        def body(state):
            for _ in range(unroll):
                state = step(state)
            return state

    c, c_sw, done_i, _ = jax.lax.while_loop(
        cond, body, (c_init, c_init, done0, jnp.int32(0)))
    # cap-vs-converge for Newton-resolved lanes (di == 2): would the
    # reference have reached |dc| <= tol within max_iter?
    jpred = _wave_cap_predict(c0, a, c, c_sw, tol, warmup)
    conv_ok = jpred <= _f32(max_iter)
    if ref_f32:
        # the f32 reference additionally stalls when its stationary
        # noise step eps*r*(1+s)/(1-s) stays above ~tol.  The 3e-5
        # threshold is CALIBRATED against an emulated libc-tanhf f32
        # reference over 13824 f64-convergent shallow lanes (round-3
        # precision lab): it misclassifies 159 (1.2%) — and that band
        # is irreducible implementation luck: near the boundary the
        # reference's own outcome flips with single-ulp tanhf
        # differences (an exactly-rounded-tanh emulation still
        # disagrees with libc on 0.74% of lanes)
        rr = jnp.maximum(c, _f32(tol))
        t_r = _tanh_f32(a / rr)
        s = (c0 * a) * (_f32(1.0) - t_r * t_r) / (rr * rr)
        floor_step = (_f32(1.0) + s) * _f32(1.19e-7) * rr \
            / jnp.maximum(_f32(1.0) - s, _f32(1e-7))
        conv_ok = conv_ok & (floor_step < _f32(3e-5))
    newton_val = jnp.where(conv_ok, c, _f32(0.0))
    out = jnp.where(done_i == 2, newton_val, c)
    return jnp.where(needs_iter, out, c0)


def _wave_cap_predict(c0, a, r, c_sw, tol: float, warmup: int, nodes=16):
    """Predicted f64 iteration count of the wave-speed map from the
    switch iterate ``c_sw`` (after ``warmup`` exact steps) to the
    |dc| <= tol exit, given the Newton-resolved root ``r``.

    Model: near-1 contraction makes the discrete iteration a flow —
    per two map steps the amplitude u = |c - r| decays by
    ``q(u) = |g(g(r +- u)) - r| / u``, so the count is the ODE integral
    ``j ~ warmup + 2 * int_{u_end}^{u_sw} d(ln u) / (-ln q(u))`` with
    ``u_end = tol / (1 + s)`` (the amplitude where the map step first
    satisfies |dc| <= tol).  Trapezoid on ``nodes`` log-spaced
    intervals; ``g(x) - r`` is evaluated cancellation-free via
    ``tanh A - tanh B = tanh(A - B) * (1 - tanh A * tanh B)``.
    Validated within ~1.5% of exact f64 counts over the full (c0, a)
    range including knife-edge cap cases (round-3 precision lab).

    tanh/exp/log/select only, no sinh/isfinite/inf.
    Lanes whose ``r`` is not a Newton root (masked callers) produce
    garbage-but-finite values — callers gate on their own flags.
    """
    tolf = _f32(tol)
    rr = jnp.maximum(r, tolf)
    t_r = _tanh_f32(a / rr)
    s = (c0 * a) * (_f32(1.0) - t_r * t_r) / (rr * rr)
    u_end = tolf / (_f32(1.0) + s)
    u_sw = jnp.maximum(jnp.abs(c_sw - rr), u_end)
    side = jnp.where(c_sw >= rr, _f32(1.0), _f32(-1.0))
    ln_lo = jnp.log(u_end)
    dln = (jnp.log(u_sw) - ln_lo) / _f32(nodes)

    def gdiff(du):
        # g(r + du) - r for a signed amplitude du, cancellation-free:
        # the tanh-argument difference a/(r+du) - a/r = -a*du/((r+du)*r)
        # is formed from du directly, never as a difference of two
        # nearly-equal f32 quotients
        x = rr + du
        xs = jnp.maximum(jnp.abs(x), _f32(1e-20)) * jnp.where(
            x < 0, _f32(-1.0), _f32(1.0))
        tx = _tanh_f32(a / xs)
        td = _tanh_f32(-(a * du) / (xs * rr))
        return c0 * td * (_f32(1.0) - tx * t_r)

    def node(i, acc):
        u = _exp_f32(ln_lo + i.astype(_f32) * dln)
        d1 = gdiff(side * u)
        d2 = gdiff(d1)
        q = jnp.abs(d2) / u
        mln = jnp.maximum(-jnp.log(jnp.minimum(q, _f32(1.0 - 1e-7))),
                          _f32(1e-7))
        w = jnp.where((i == 0) | (i == nodes), _f32(0.5), _f32(1.0))
        return acc + w * (_f32(2.0) / mln)

    acc = jax.lax.fori_loop(0, nodes + 1, node,
                            jnp.zeros_like(c0 + r))
    jpred = _f32(warmup) + dln * acc
    # s >= 1: the map diverges at the root — the reference always caps
    return jnp.where(s < _f32(1.0), jpred, _f32(1e9))


def _modstall_static(sal, wave, x_wind, y_wind, airtemp, rh, p, pw, depth,
                     gate):
    """The c-independent ModStall prologue."""
    pwv = pw
    c0 = _f32(9.81 / (2 * math.pi)) * pwv
    shallow = (depth <= c0 * pwv) & (c0 != 0) & gate
    a = _f32(2 * math.pi) * depth / jnp.where(pwv != 0, pwv, _f32(1)) \
        * jnp.where(pwv != 0, _f32(1), _f32(jnp.inf))

    v = jnp.sqrt(x_wind**2 + y_wind**2)
    tf = _stallabrass_tf(sal)
    ha = _f32(5.17) * jnp.power(v, _f32(0.8))  # VI:248
    tau = _f32(11.25) - v / _f32(4.0)          # VI:256
    K = _f32(311000.0) / ((p / _f32(10.0)) * _f32(1005.0))
    M = _f32(0.2) * airtemp + K * rh * _icing_f1(airtemp)
    return v, c0, shallow, a, tf, ha, tau, K, M


def _modstall_core(c0, a, shallow, gate, wave, v, sst, airtemp, rh, tf,
                   ha, tau, K, M, vsca: float, decay, c_override=None):
    """The c-dependent ModStall solve: wave fixed point, droplet RK, and
    the per-height freezing-fraction fixed point (VI:218-326), one
    ``fori_loop`` body over heights so the whole-array traffic stays one
    height wide."""
    number = len(decay)
    # MF_MODSTALL_ABLATE (trace-time env, comma-separated: fp, rk,
    # heights) stubs out solver stages for perf attribution ONLY —
    # outputs are wrong with any ablation active.
    ablate = set(filter(None, os.environ.get(
        "MF_MODSTALL_ABLATE", "").split(",")))
    fp_u, rk_u, _ = _solver_unrolls()
    if "fp" in ablate:
        c = jnp.where(shallow, c0 * _f32(0.5), c0)
    elif c_override is not None:
        # precision-lab hook (selective-x64 experiment): inject an
        # externally computed wave speed (e.g. the exact f64 replica of
        # VI:221-237) so the remaining f32 stages can be measured in
        # isolation.  Never set on a production path.
        c = jnp.where(shallow, c_override, c0)
    else:
        # the wave FP keeps its exact 32-iteration warmup: arming the
        # projection earlier was measured catastrophic for MINCOG (7e-2
        # of adversarial points >2e-3 — a cap misprediction zeroes c and
        # with it the lane's whole icing rate), and the same cap-to-skip
        # amplification applies here
        c = _wave_speed_fixed_point(c0, a, shallow, 10000, 1e-5,
                                    unroll=fp_u)
    vr = c - _f32(vsca)
    ratio = _f32(89.5 / 5.17)                  # VI:251

    # droplet temperature: inline RK, 50 fixed steps (VI:262-281)
    h = jnp.where(tau > 0, tau / _f32(50.0), _f32(0.0))

    def f10mk(y):
        return (M - _f32(0.2) * y) - K * _icing_f1(y)

    def rk_body(_, y):
        k1 = f10mk(y)
        y2 = y + _f32(0.5) * h * k1
        k2 = f10mk(y2)
        y3 = y + _f32(0.5) * h * k2
        k3 = f10mk(y3)
        y4 = y + h * k3
        return y + h * (_f32(1.0 / 6.0)
                        * (((k1 + _f32(2.0) * k2) + _f32(2.0) * k3)
                           + f10mk(y4)))

    if "rk" in ablate:
        td = sst * _f32(0.99)
    else:
        td = _unrolled_fori(50, rk_body, sst, rk_u)
        td = jnp.where(tau > 0, td, sst)

    # per-height freezing fraction fixed point (VI:288-326)
    at = airtemp
    rhv = rh
    f1_air = _icing_f1(at)
    decay_arr = jnp.asarray(decay, _f32)
    rw_base = _f32(6.46e-5) * wave * (vr * vr)

    def run_fp(rw, warmup=32):
        """The freezing-fraction fixed point for spray flux ``rw`` — any
        shape broadcasting against the lane planes: ``(ny, nx)`` per
        height, ``(number, ny, nx)`` stacked.  Returns clip(n, 0, 1).

        Round-3 redesign (same pattern as `_wave_speed_fixed_point`,
        validated by tools/precision_lab.py): ``warmup`` EXACT map
        iterations preserve the reference's trajectory semantics
        bit-for-bit — early escapes outside [0, 1] are common from the
        cold start (VI:302-315) — then survivors switch to
        Newton-accelerated iterates with the ANALYTIC slope
        ``B = d(ri/rw)/dN = tf*(0.012012*rw + (ha/333000)*(1 +
        ratio*f1'(Ts)))/rw`` (B <= 0 since tf <= 0; f1' reuses the
        f1(Ts) exp already computed for ri).  No secant from noisy f32
        differences, no unverified Aitken root: the loop still exits on
        the reference's own |n1 - n| criterion, so a projected iterate
        is accepted only when the map itself confirms it.

        Newton fires only when (a) the map is locally contracting
        (|B| < 1 — for |B| >= 1 the reference's trajectory escapes by
        growth and the escape SIDE is trajectory semantics, so those
        lanes keep exact steps) and (b) the remaining oscillation
        envelope root +- err1*|B|/(1-|B|) provably stays inside [0, 1]
        (a contracting lane can still escape mid-oscillation when the
        envelope crosses the boundary; the reference then clamps — the
        old Aitken path projected those to the interior root).

        Cap semantics (j > 1000 => N = 0): single-rate prediction
        ``j_sw + ln(tol/err_sw)/ln|B|`` with the analytic |B| — the
        N-map is near-affine over its Ts excursion (f1 curvature over
        ~3 C is small), so the single rate is accurate where the wave
        map needed a quadrature.  Slowly-growing |B| >= 1 lanes whose
        predicted escape exceeds the cap resolve to 0 the same way.
        f32 convergence floor: |n1 - n| bottoms out at ~eps * (sum of
        |ri| term magnitudes)/rw, which can exceed tol when ri's terms
        cancel — the Newton-phase criterion widens to that floor and
        the cap prediction (f64 flow) still decides the outcome.

        NOTE: warm-STARTING heights from the previous height's iterate
        was tried and is WRONG — 25% of lanes differ >2e-3 because the
        early escapes are trajectory semantics."""
        if "heights" in ablate:
            return jnp.clip(rw, _f32(0.0), _f32(1.0))

        tolf = _f32(1e-5)
        loop_cap = warmup + 96
        hk = ha / _f32(333000.0)
        d_f1 = _f32(17.67 * 243.5)

        def _map(n):
            """One map application + analytic slope + residual floor.
            All terms reuse the single f1(Ts) exp."""
            ts = (_f32(1.0) + n) * tf
            f1ts = _icing_f1(ts)
            ri = (_f32(0.012012012) * rw * (ts - td)
                  + hk * ((ts - at) + ratio * (f1ts - rhv * f1_air)))
            n1 = ri / rw
            tsq = ts + _f32(243.5)
            f1p = f1ts * d_f1 / (tsq * tsq)
            B = tf * (_f32(0.012012012) * rw
                      + hk * (_f32(1.0) + ratio * f1p)) / rw
            ri_mag = (_f32(0.012012012) * rw * jnp.abs(ts - td)
                      + hk * (jnp.abs(ts - at)
                              + ratio * (f1ts + rhv * f1_air)))
            return n1, B, _f32(8e-7) * ri_mag / rw

        def n_cond(state):
            n, err_sw, j, done_i = state
            return jnp.logical_and(j < loop_cap, ~jnp.all(done_i != 0))

        def n_body(state):
            # HOT LOOP: map + Newton only — no logs; the cap/escape
            # predictions run ONCE post-loop (in-loop they were
            # measured several times slower)
            n, err_sw, j, done_i = state
            done = done_i != 0
            n1, B, floor = _map(n)
            err1 = jnp.abs(n1 - n)
            j1 = j + 1
            newton_phase = j1 > warmup
            absB = jnp.abs(B)
            contracting = absB < _f32(1.0 - 1e-6)
            # switch-point residual for the post-loop cap prediction
            err_sw = jnp.where((~done) & (j1 == warmup + 1), err1, err_sw)
            # f32 residual floor: ri's terms can cancel (see docstring)
            conv = (~done) & (err1 <= jnp.where(
                newton_phase, jnp.maximum(tolf, floor), tolf))
            # Newton step, gated on the map contracting AND the
            # oscillation envelope staying inside [0, 1] (escapes are
            # trajectory semantics).  For the oscillatory map (B <= 0)
            # |n - root| = err1/(1 + |B|) and excursions decay by |B|
            # per step, so once n1 itself is inside, every skipped
            # future iterate lies within root +- B^2*err1/(1+|B|).
            root = (n1 - B * n) / (_f32(1.0) - B)
            amp_env = absB * absB * err1 / (_f32(1.0) + absB)
            inside = (n1 >= _f32(0.0)) & (n1 <= _f32(1.0))
            env_ok = (inside & (root + amp_env <= _f32(1.0))
                      & (root - amp_env >= _f32(0.0)))
            use_newton = newton_phase & contracting & env_ok
            n_next = jnp.where(use_newton, root, n1)
            forced = (~done) & (j1 >= loop_cap)
            # freeze at the map output; di=2 marks post-warmup stops
            # whose cap-vs-converge the post-loop prediction decides
            n_out = jnp.where(done, n,
                              jnp.where(conv | forced, n1, n_next))
            di = jnp.where(done, done_i,
                           jnp.where((conv | forced) & newton_phase,
                                     jnp.int32(2),
                                     jnp.where(conv | (n1 < 0) | (n1 > 1),
                                               jnp.int32(1),
                                               jnp.int32(0))))
            return (n_out, err_sw, j1, di)

        if fp_u > 1:
            # u fixed-point steps per cond check (see
            # _wave_speed_fixed_point: per-lane identical, done holds)
            def n_body_u(state, _step=n_body):
                for _ in range(fp_u):
                    state = _step(state)
                return state
        else:
            n_body_u = n_body

        n_init = jnp.zeros_like(rw)
        done0 = jnp.broadcast_to((~gate).astype(jnp.int32), rw.shape)
        n, err_sw, _, di = jax.lax.while_loop(
            n_cond, n_body_u,
            (n_init, jnp.ones_like(rw), jnp.int32(0), done0))
        # post-loop cap resolution for di=2 lanes (ONE extra map eval):
        # contracting lanes get the single-rate f64 count prediction
        # warmup + ln(tol/err_sw)/ln|B|; diverging lanes whose
        # escape-by-growth cannot reach the [0,1] boundary before the
        # cap get the reference's cap => 0 as well
        n1f, Bf, _ = _map(n)
        absB = jnp.abs(Bf)
        lB = jnp.log(jnp.maximum(absB, _f32(1e-30)))
        rem = jnp.log(tolf / jnp.maximum(err_sw, tolf)) \
            / jnp.where(lB < 0, lB, _f32(-1e-30))
        capped_c = (absB < _f32(1.0)) \
            & (_f32(warmup) + rem > _f32(1000.0))
        errf = jnp.abs(n1f - n)
        amp = errf / (_f32(1.0) + absB)
        esc_rem = jnp.log(_f32(2.0) / jnp.maximum(amp, _f32(1e-30))) \
            / jnp.where(lB > 0, lB, _f32(1e-30))
        capped_d = (absB >= _f32(1.0)) & (errf > tolf) \
            & (_f32(loop_cap) + esc_rem > _f32(1000.0))
        n = jnp.where((di == 2) & (capped_c | capped_d), _f32(0.0), n)
        return jnp.clip(n, _f32(0.0), _f32(1.0))

    # cold start every height (the early out-of-range escapes ARE
    # reference semantics and happen on exact iterates)
    def height_body(counter, ice):
        rw = rw_base * jax.lax.dynamic_index_in_dim(
            decay_arr, counter, keepdims=False) * v
        n = run_fp(rw)
        return ice + n * (rw / _f32(890.0)) * _f32(3600.0) * _f32(100.0)

    ice = jax.lax.fori_loop(0, number, height_body, jnp.zeros_like(v))
    return jnp.abs(ice / _f32(number))


def vessel_icing_modstall(sal: Field, wave: Field, x_wind: Field,
                          y_wind: Field, airtemp: Field, rh: Field,
                          sst: Field, p: Field, pw: Field, aice: Field,
                          depth: Field, vs: float, alpha: float,
                          zmin: float, zmax: float,
                          _wave_speed=None) -> Field:
    """Modified Stallabrass freezing sea-spray (Henry 1995, Samuelsen 2015;
    VI:182-337).  ``vs`` ship speed, ``alpha`` relative heading, heights
    sampled at 0.5 m steps in [zmin, zmax].  ``_wave_speed`` is the
    precision lab's selective-x64 injection hook (see _modstall_core)."""
    num = zmax - zmin
    require(zmax >= zmin and math.fmod(num, 1.0) == 0.0,
            "vesselIcingModStall: bad zmin/zmax")
    require(vs >= 0 and alpha >= 0 and zmin >= 0 and zmax >= 0,
            "vesselIcingModStall: negative parameter")
    number = int(num * 2 + 1)

    mask = and_masks(sal, wave, x_wind, y_wind, airtemp, rh, sst, p,
                     aice, depth)
    gate = mask & (aice.values < _f32(0.4))

    v, c0, shallow, a, tf, ha, tau, K, M = _modstall_static(
        sal.values, wave.values, x_wind.values, y_wind.values,
        airtemp.values, rh.values, p.values, pw.values, depth.values, gate)
    out = _modstall_core(c0, a, shallow, gate, wave.values, v, sst.values,
                         airtemp.values, rh.values, tf, ha, tau, K, M,
                         float(vs * math.cos(alpha)),
                         tuple(_mincog_decay(zmin, number)),
                         c_override=_wave_speed)
    return out_field(out, gate)


# ---------------------------------------------------------------------------
# MINCOG (Samuelsen et al. 2017)
# ---------------------------------------------------------------------------

_BISECT_A, _BISECT_B = -0.5, 1.3
# the reference derives the trip count from the static bracket (VI:391)
_BISECT_ITERS = min(int(math.log2((_BISECT_B - _BISECT_A) / 1e-5)), 100)


def _freeze_frac_zero(n, sw, ta, ha, he, ea, rh, rw, tsp, lwdown, swdown,
                      with_grad: bool = False):
    """MINCOG heat-balance residual (VI:339-361); optionally also its
    analytic d(residual)/dn for the safeguarded-Newton solver."""
    lfs = _f32(3.33e5 * 0.7)
    inv07 = _f32(1.0) - n * _f32(0.7)
    sb = sw / inv07
    den = _f32(1000.0) - sb
    ts = _f32(-54.1126) * (sb / den)
    es = _f32(10.0) * _icing_f1(ts)
    qc = ha * (ts - ta)
    qe = he * (es - rh * ea)
    qd = rw * _f32(4000.0) * (ts - tsp)
    qr = _kt4(ts) - lwdown - _f32(0.44) * swdown
    ri = (_f32(1.0) / lfs) * (qc + qe + qd + qr)
    res = ri / rw - n
    if not with_grad:
        return res
    # chain rule: dts/dn = dts/dsb * dsb/dn
    dsb_dn = _f32(0.7) * sb / inv07
    dts_dsb = _f32(-54.1126) * _f32(1000.0) / (den * den)
    dts_dn = dts_dsb * dsb_dn
    # d(qsum)/dts: Magnus derivative f1' = f1 * 17.67*243.5/(ts+243.5)^2,
    # Stefan-Boltzmann derivative 4*sigma*(ts+t0)^3
    tp = ts + _f32(243.5)
    des_dts = es * _f32(17.67 * 243.5) / (tp * tp)
    tk = ts + t0
    dqr_dts = _f32(4.0 * 5.67e-8) * tk * tk * tk
    dq_dts = ha + he * des_dts + rw * _f32(4000.0) + dqr_dts
    dres = dq_dts * dts_dn / (lfs * rw) - _f32(1.0)
    return res, dres


def _bisection_lanes(fn, shape, a0: float, b0: float):
    """Sign-change bisection with the reference's fixed iteration count and
    no-bracket => 0 semantics (VI:381-415), vectorized over lanes."""
    a = jnp.full(shape, _f32(a0))
    b = jnp.full(shape, _f32(b0))
    ffa = fn(a)
    ffb = fn(b)
    # sign-equality via int32 select (see _rtsafe_lanes)
    sb0 = (ffb > 0).astype(jnp.int32)
    no_root = jnp.where(ffa > 0, sb0, 1 - sb0) != 0
    c = jnp.zeros(shape, _f32)
    frozen = jnp.zeros(shape, bool)

    def body(_, state):
        a, b, c, ffa, frozen = state
        c_new = (a + b) / _f32(2.0)
        ffc = fn(c_new)
        exact = ffc == 0
        c = jnp.where(frozen, c, c_new)
        sfa = (ffa > 0).astype(jnp.int32)
        take_b = jnp.where(ffc > 0, 1 - sfa, sfa) != 0
        upd = ~(frozen | exact)
        b = jnp.where(upd & take_b, c_new, b)
        a = jnp.where(upd & ~take_b, c_new, a)
        ffa = jnp.where(upd & ~take_b, ffc, ffa)
        return a, b, c, ffa, frozen | exact

    a, b, c, ffa, frozen = jax.lax.fori_loop(
        0, _BISECT_ITERS, body, (a, b, c, ffa, frozen))
    return jnp.where(no_root, _f32(0.0), c)


def regula_falsi_lanes(fn, a, b, eps, iters: int = 100):
    """Illinois-variant false position, vectorized over lanes.

    Reproduces the reference's ``regula_falsi`` (VI:417-448) — present
    in the reference but only reachable from a ``#if 0`` Aitken
    bracketing path (VI:632-666), so no shipped solver uses it; it is
    provided (and unit-tested against a scalar replay of the same
    recurrence) for inventory completeness.  Per lane: the secant point
    ``c = (f(a)·b − f(b)·a)/(f(a) − f(b))`` replaces the endpoint whose
    residual shares ``f(c)``'s sign; a retained endpoint has its
    residual halved on consecutive retentions (the Illinois trick);
    exits on ``|b−a| < eps·|b+a|``, a sign-degenerate step, or 100
    iterations.  Sign-equality is spelled as an int32 select
    (see :func:`_rtsafe_lanes`)."""
    a = jnp.asarray(a, _f32)
    b = jnp.asarray(b, _f32)
    eps = _f32(eps)
    ffa = fn(a)
    ffb = fn(b)
    side = jnp.zeros(a.shape, jnp.int32)
    c = a
    frozen = jnp.zeros(a.shape, bool)

    def body(_, st):
        a, b, ffa, ffb, side, c, frozen = st
        c_new = (ffa * b - ffb * a) / (ffa - ffb)
        c = jnp.where(frozen, c, c_new)
        conv = jnp.abs(b - a) < eps * jnp.abs(b + a)
        ffc = fn(c_new)
        sgb = (ffb > 0).astype(jnp.int32)
        sga = (ffa > 0).astype(jnp.int32)
        cpos = ffc > 0
        same_cb = jnp.where(cpos, sgb, 1 - sgb) != 0
        same_ac = jnp.where(cpos, sga, 1 - sga) != 0
        upd = ~(frozen | conv)
        take_b = upd & same_cb
        take_a = upd & ~same_cb & same_ac
        # Illinois halving uses the PREVIOUS side (VI:434-436, 441-443)
        ffa = jnp.where(take_b & (side == -1), ffa / 2, ffa)
        ffb = jnp.where(take_a & (side == 1), ffb / 2, ffb)
        b = jnp.where(take_b, c_new, b)
        ffb = jnp.where(take_b, ffc, ffb)
        a = jnp.where(take_a, c_new, a)
        ffa = jnp.where(take_a, ffc, ffa)
        side = jnp.where(take_b, -1, jnp.where(take_a, 1, side))
        frozen = frozen | conv | (upd & ~same_cb & ~same_ac)
        return a, b, ffa, ffb, side, c, frozen

    st = (a, b, ffa, ffb, side, c, frozen)
    return jax.lax.fori_loop(0, iters, body, st)[5]


def _freeze_frac_ts(ts, sw, ta, ha, he, ea, rh, rw, tsp, lwdown, swdown):
    """MINCOG heat-balance residual in brine-temperature space.

    The reference bisects on the freezing fraction N (VI:381-415), which
    reaches the brine temperature through ``sb = sw/(1-0.7N)``,
    ``ts = -54.1126*sb/(1000-sb)`` (VI:344-346) — a map with a pole at
    N = 10/7, so for small spray flux ``rw`` the N-space residual is
    near-vertical at its root and Newton steps degenerate to bisection.
    Solving the same equation ``qsum(ts)/(lfs*rw) = N(ts)`` in ts-space
    keeps both sides smooth and near-linear over the whole bracket for
    every physical lane.  Returns ``(residual, d(residual)/dts, N(ts))``.
    """
    lfs = _f32(3.33e5 * 0.7)
    den = ts - _f32(54.1126)
    sb = _f32(1000.0) * ts / den
    sb_safe = jnp.where(sb == 0, _f32(1.0), sb)
    n = (_f32(1.0) - sw / sb_safe) * _f32(1.0 / 0.7)
    es = _f32(10.0) * _icing_f1(ts)
    qsum = (ha * (ts - ta) + he * (es - rh * ea)
            + rw * _f32(4000.0) * (ts - tsp)
            + _kt4(ts) - lwdown - _f32(0.44) * swdown)
    res = qsum / (lfs * rw) - n
    # derivatives: dsb/dts = -54112.6/(ts-54.1126)^2; dn/dts via sw/sb^2
    dsb_dts = _f32(-54112.6) / (den * den)
    dn_dts = (sw / (sb_safe * sb_safe)) * _f32(1.0 / 0.7) * dsb_dts
    tp = ts + _f32(243.5)
    des_dts = es * _f32(17.67 * 243.5) / (tp * tp)
    tk = ts + t0
    dq_dts = ha + he * des_dts + rw * _f32(4000.0) \
        + _f32(4.0 * 5.67e-8) * tk * tk * tk
    dres = dq_dts / (lfs * rw) - dn_dts
    return res, dres, n


def _ts_of_n(n, sw):
    """The reference's N -> brine-temperature map (VI:344-346)."""
    sb = sw / (_f32(1.0) - _f32(0.7) * _f32(n))
    return _f32(-54.1126) * sb / (_f32(1000.0) - sb)


_NEWTON_ITERS = 8


def _rtsafe_lanes(fn_grad, a, b, iters: int = _NEWTON_ITERS,
                  unroll: int = 1, x0=None):
    """Bracket-safeguarded Newton root find, vectorized over lanes.

    Solves the same roots as :func:`_bisection_lanes` (the reference's
    ``bisection``, VI:381-415) in ~8 residual evaluations instead of 19:
    ``fn_grad`` returns ``(f, df/dx)``; each step takes the Newton update
    when it lands inside the current sign-change bracket (closed: a lane
    whose Newton step underflows to zero has converged to f32 precision
    and must HOLD its root — a strict-interior test would evict it to the
    midpoint of a still-wide bracket and force it to re-converge) and the
    bracket midpoint otherwise, so worst-case lanes degrade to plain
    bisection.  ``a``/``b`` are per-lane bracket arrays (``a < b`` not
    required in sign — only ``a <= b`` ordering).  No-sign-change lanes
    return ``nan`` for the caller to overwrite (the reference returns 0).
    """
    fa, _ = fn_grad(a)
    fb, _ = fn_grad(b)
    # "same sign" as a select on int32 (XLA folds `cast(p) == cast(q)`
    # straight back to an i1 compare)
    sa = (fa > 0).astype(jnp.int32)
    no_root = jnp.where(fb > 0, sa, 1 - sa) != 0
    eps = _f32(1e-6) * (b - a)
    if x0 is None:
        # secant initial guess (clipped into the bracket interior)
        denom = jnp.where(fb == fa, _f32(1.0), fb - fa)
        x0 = a - fa * (b - a) / denom
    x = jnp.clip(x0, a + eps, b - eps)

    def body(_, state):
        a, b, x = state
        f, df = fn_grad(x)
        # shrink the bracket with x's sign
        same = jnp.where(f > 0, sa, 1 - sa) != 0
        a = jnp.where(same, x, a)
        b = jnp.where(same, b, x)
        step = f / jnp.where(df == 0, _f32(1.0), df)
        xn = x - step
        # xn == x: the Newton step underflowed — the lane is converged to
        # f32 precision and must HOLD (after the bracket update above one
        # endpoint IS x, so the strict-interior test below would evict it)
        ok = ((xn > a) & (xn < b) & (jnp.abs(xn) < _f32(jnp.inf))
              & (df != 0)) | (xn == x)
        x = jnp.where(f == 0, x,
                      jnp.where(ok, xn, (a + b) * _f32(0.5)))
        return a, b, x

    a, b, x = _unrolled_fori(iters, body, (a, b, x), unroll)
    return jnp.where(no_root, _f32(jnp.nan), x)


def _mincog_static(sal, wave, x_wind, y_wind, airtemp, rh, p, pw, depth,
                   vs: float, alpha: float, gate):
    """The c-independent MINCOG prologue: every plane that does NOT feed
    through the wave-speed fixed point (spray geometry VI:510-576, the
    heat-transfer and humidity coefficients), handed to
    :func:`_mincog_core` as ready-made planes."""
    v = jnp.sqrt(x_wind**2 + y_wind**2)
    skip0 = (v < _f32(1.0)) | (wave < _f32(0.1))  # VI:479-482 => icing 0

    # wave-speed setup (VI:489-508)
    c0 = _f32(9.81 / (2 * math.pi)) * pw
    shallow = (depth <= c0 * pw) & (c0 != 0) & gate & ~skip0
    a = _f32(2 * math.pi) * depth / jnp.where(pw != 0, pw, _f32(1)) \
        * jnp.where(pw != 0, _f32(1), _f32(jnp.inf))

    beta = alpha
    sin_beta = _f32(math.sin(beta))
    wrx = jnp.abs(v * _f32(math.cos(beta)) - _f32(vs))
    wry = jnp.abs(v * sin_beta)
    wr_inv = _f32(1.0) / jnp.sqrt(wrx * wrx + wry * wry)

    hax = _f32(6.0617) * jnp.power(wrx, _f32(1.82))
    hay = _f32(4.8496) * jnp.power(wry, _f32(1.8))
    ha = (hax + hay) / (wrx + wry)

    # simplified droplet trajectory (VI:539-576)
    beta_r = _f32(math.pi) - jnp.arcsin(v * sin_beta * wr_inv)
    br = jnp.where(beta_r <= _f32(math.pi / 2), _f32(91 * math.pi / 180),
                   jnp.where(beta_r > _f32(math.pi), _f32(math.pi), beta_r))
    sin_br = jnp.sin(br)
    sin_beta_r_2 = sin_br * sin_br
    cos_beta_r = jnp.cos(br)
    cos_2_beta_r = jnp.cos(_f32(2.0) * br)

    # KV Nordkapp perimeter ellipse (VI:561-567)
    r0_, a0_, b0_ = _f32(13.18), _f32(32.88), _f32(6.605)
    a0_2, b0_2, r0_2 = a0_ * a0_, b0_ * b0_, r0_ * r0_
    c0_ell = _f32(math.sqrt(2.0)) * a0_ * b0_ * jnp.sqrt(
        (b0_2 - a0_2) * cos_2_beta_r + a0_2 + b0_2 - _f32(2.0) * r0_2 * sin_beta_r_2)
    r_ = (r0_ * _f32(2.0) * b0_2 * cos_beta_r + c0_ell) \
        / ((b0_2 - a0_2) * cos_2_beta_r + a0_2 + b0_2)

    tau_const = r_ * wr_inv
    beta_deg = _f32(beta * (180.0 / math.pi))
    drag = _f32(-0.0046) * beta_deg + _f32(2.1912)
    tau = tau_const * drag

    ea = _f32(10.0) * _icing_f1(airtemp)
    K = _f32(0.2 * 0.622 * 2.5e6) / (p * _f32(1005.0))
    M = _f32(0.2) * airtemp + K * rh * ea

    vdcomp = wrx * _f32(0.9962) + _f32(6.67) * _f32(0.0872)  # VI:590-591
    he = ha * _f32(1738.6) / p

    return (v, skip0, c0, shallow, a, ha, tau, ea, K, M, vdcomp, he)


def _mincog_core(c0, a, shallow, skip0, wave, pw, depth, v, sst, sal,
                 airtemp, rh, ha, he, ea, M, K, tau, vd,
                 vsca: float, alt: int, decay):
    """The c-dependent MINCOG solve: wave-speed fixed point, droplet RK,
    and the per-height Newton sweep (VI:489-675).  ``decay`` is the
    static tuple of per-height LWC decay factors (:func:`_mincog_decay`);
    one ``fori_loop`` body iterates over heights so the whole-array
    traffic stays one height wide.

    ``MF_MINCOG_ABLATE`` (trace-time env, comma-separated: fp, rk,
    newton) stubs out solver stages for perf attribution ONLY — outputs
    are wrong with any ablation active.
    """
    number = len(decay)
    ablate = set(filter(None, os.environ.get(
        "MF_MINCOG_ABLATE", "").split(",")))
    fp_u, rk_u, nt_u = _solver_unrolls()
    if "fp" in ablate:
        c = jnp.where(shallow, c0 * _f32(0.5), c0)
    else:
        # exact 32-warmup: early-arming the wave FP zeroes c on cap
        # mispredictions and the whole lane's icing with it — measured
        # 6.98e-2 of adversarial points >2e-3 for a 0.6 ms win
        # (2026-08-18); `warmup` stays available for labs only
        # ref_f32: the reference Mincog is template<V=float> (VI:697),
        # so conformance follows ITS f32 stall-to-cap behavior
        c = _wave_speed_fixed_point(c0, a, shallow, 1000, 1e-5,
                                    unroll=fp_u, ref_f32=True)

    vr = c - _f32(vsca)
    tper = jnp.abs(c * pw / vr)
    skip = skip0 | (tper <= 0)

    tdur = _f32(0.1230) + _f32(0.7008) * jnp.abs(vr * wave) \
        / jnp.maximum(v, _f32(5.0))
    nf = _f32(1.0) / (_f32(4.0) * tper)

    # droplet cooling, reference runge_kutta template (VI:450-463)
    def f10mk(t):
        return (M - _f32(0.2) * t) - K * _f32(10.0) * _icing_f1(t)

    h = tau / _f32(50.0)
    h2 = h / _f32(2.0)

    def rk_body(_, y):
        k1 = h2 * f10mk(y)
        k2 = h * f10mk(y + k1)
        k3 = h * f10mk(y + k2 / _f32(2.0))
        k4 = h2 * f10mk(y + k3)
        return y + (k1 + k2 + k3 + k4) / _f32(3.0)

    if "rk" in ablate:
        td = sst * _f32(0.99)
    else:
        td = _unrolled_fori(50, rk_body, sst, rk_u)
    tsp = _f32(0.5) * (td + sst)

    if alt == 1:
        lwc0 = _f32(6.36e-5) * wave * (vr * vr)
    else:
        lam = c * pw
        dl = _f32(4.0 * math.pi) * depth / lam
        # sinh via exp; overflow behavior matches:
        # dl/sinh(dl) -> 0 either way once exp saturates
        sh = (_exp_f32(dl) - _exp_f32(-dl)) * _f32(0.5)
        cg = (c / _f32(2.0)) * (_f32(1.0) + dl / sh)
        vgr = cg - _f32(vsca)
        lwc0 = _f32(9.5205e-4) * (wave * wave) * jnp.sqrt(wave / lam) * vgr
    lwc0 = jnp.abs(lwc0)

    lwdown = _f32(0.7) * _kt4(airtemp)  # eps_atm * kT4 (VI:612-614)
    swdown = jnp.zeros_like(airtemp)    # Swdown_model = 0 (VI:611, 615)

    use_bisect = os.environ.get("MF_MINCOG_BISECT", "") == "1"
    # ts-space bracket (per lane: depends only on salinity, not height)
    ts_hi = _ts_of_n(_BISECT_A, sal)   # N = -0.5 (ts closest to 0)
    ts_lo = _ts_of_n(_BISECT_B, sal)   # N = 1.3 (coldest)
    sw0 = sal <= 0

    def solve_n(rw, x0=None, iters=_NEWTON_ITERS):
        """Freezing fraction for spray flux ``rw`` — any shape that
        broadcasts against the lane planes (``(...,)`` per height, or
        ``(number, ...)`` stacked).  Returns ``(n, ts_carry)`` where
        ``ts_carry`` is a finite warm-start value for the next height's
        Newton solve (midpoint of the bracket on no-root lanes)."""
        mid = _f32(0.5) * (ts_lo + ts_hi)
        if "newton" in ablate:
            return jnp.clip(rw, _f32(0.0), _f32(1.0)), \
                jnp.broadcast_to(mid, rw.shape)
        if use_bisect:
            def ffz(n):
                return _freeze_frac_zero(n, sal, airtemp, ha, he, ea, rh,
                                         rw, tsp, lwdown, swdown)

            return _bisection_lanes(ffz, rw.shape, _BISECT_A,
                                    _BISECT_B), \
                jnp.broadcast_to(mid, rw.shape)

        def fg(ts):
            r, dr, _ = _freeze_frac_ts(ts, sal, airtemp, ha, he, ea,
                                       rh, rw, tsp, lwdown, swdown)
            return r, dr

        ts_root = _rtsafe_lanes(fg, jnp.broadcast_to(ts_lo, rw.shape),
                                jnp.broadcast_to(ts_hi, rw.shape),
                                iters=iters, unroll=nt_u, x0=x0)
        _, _, n_ts = _freeze_frac_ts(ts_root, sal, airtemp, ha, he,
                                     ea, rh, rw, tsp, lwdown, swdown)
        # sal == 0 collapses ts to 0 for every N: the residual is
        # linear in N and the root is closed-form (reference lanes
        # solve the same degenerate equation by bisection)
        r0, _, _ = _freeze_frac_ts(jnp.zeros_like(rw), sal, airtemp,
                                   ha, he, ea, rh, rw, tsp, lwdown,
                                   swdown)
        k_lin = r0 + _f32(1.0 / 0.7)   # res|sw=0 = K - 1/0.7 (sb_safe)
        sl = (k_lin - _f32(_BISECT_B) > 0).astype(jnp.int32)
        lin_root = jnp.where(k_lin - _f32(_BISECT_A) > 0,
                             1 - sl, sl) != 0
        n_lin = jnp.where(lin_root, k_lin, _f32(0.0))
        n = jnp.where(sw0, n_lin,
                      jnp.where(jnp.isnan(n_ts), _f32(0.0), n_ts))
        carry = jnp.where(jnp.abs(ts_root) < _f32(jnp.inf), ts_root, mid)
        return n, carry

    rw_base = lwc0 * vd * nf * tdur
    # one fori_loop body so the graph stays `iters` x 1-height wide (not
    # `number` unrolled solvers)
    decay_arr = jnp.asarray(decay, _f32)

    def height_body(counter, icing):
        rw = rw_base * jax.lax.dynamic_index_in_dim(decay_arr, counter,
                                                    keepdims=False)
        n, _ = solve_n(rw)
        return icing + rw * jnp.clip(n, _f32(0.0), _f32(1.0))

    icing = jax.lax.fori_loop(0, number, height_body, jnp.zeros_like(v))

    out = jnp.abs(icing / _f32(number)) * _f32(3600.0 * 100.0 / 890.0)
    return jnp.where(skip, _f32(0.0), out)


def _mincog_decay(zmin: float, number: int):
    """Per-height LWC decay factors, host-evaluated in f64 like the
    reference's math.exp then rounded once to f32."""
    return [math.exp(-0.55 * (zmin + 0.5 * k)) for k in range(number)]


def _mincog_point(sal, wave, x_wind, y_wind, airtemp, rh, sst, p, pw, depth,
                  vs: float, alpha: float, zmin: float, zmax: float,
                  alt: int, gate):
    """Vectorized MINCOG scalar template (VI:465-675): XLA prologue +
    shared c-dependent solve; all lanes computed, the caller selects by
    gate/early-exit masks."""
    (v, skip0, c0, shallow, a, ha, tau, ea, K, M, vd, he) = _mincog_static(
        sal, wave, x_wind, y_wind, airtemp, rh, p, pw, depth, vs, alpha,
        gate)
    number = int((zmax - zmin) * 2 + 1)
    return _mincog_core(c0, a, shallow, skip0, wave, pw, depth, v, sst, sal,
                        airtemp, rh, ha, he, ea, M, K, tau, vd,
                        float(vs * math.cos(alpha)), alt,
                        tuple(_mincog_decay(zmin, number)))


def vessel_icing_mincog(sal: Field, wave: Field, x_wind: Field,
                        y_wind: Field, airtemp: Field, rh: Field,
                        sst: Field, p: Field, pw: Field, aice: Field,
                        depth: Field, vs: float, alpha: float,
                        zmin: float, zmax: float, alt: int) -> Field:
    """MINCOG icing rate (Samuelsen et al. 2017), org (alt=1) or adjusted
    (alt=2) liquid-water content (VI:465-705)."""
    require(vs >= 0 and alpha >= 0 and zmin >= 0 and zmax >= 0
            and zmax >= zmin and math.fmod(zmax - zmin, 1.0) == 0.0,
            "vesselIcingMincog: bad parameters")
    mask = and_masks(sal, wave, x_wind, y_wind, airtemp, rh, sst, p,
                     aice, depth)
    brine_freeze = _f32(-54.1126) * sal.values / (_f32(1000.0) - sal.values)
    gate = mask & (aice.values < _f32(0.4)) & (sst.values > brine_freeze)
    out = _mincog_point(sal.values, wave.values, x_wind.values,
                        y_wind.values, airtemp.values, rh.values,
                        sst.values, p.values, pw.values, depth.values,
                        vs, alpha, zmin, zmax, alt, gate)
    return out_field(out, gate)
