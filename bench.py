"""Headline benchmark: the derived-field pipeline on one GPU.

Workload (BASELINE.json config 4's pipeline): the 12-output hybrid-level
derived-field pipeline (pressure, theta, RH, Td, theta_e, ducting, wind
speed, vorticity, divergence, T-advection, |grad T|, TFP) on a 32-level
stack of MET Norway's operational 719x929 grid, with undef masks live,
under ``jit`` in the staging layer's stacked output layout
(``models.derived_fields_stacked``).

Timing: the median device step over 30 runs after warm-up, each ended by
``block_until_ready``.  The step is set against the least time the card
could take — the pipeline's intrinsic bytes (every input read once,
every output written once) over the card's published memory bandwidth
(utils/profiling.py).  Refuses to run on anything but a GPU.

Prints one JSON line:
  {"metric": ..., "value": points/s, "unit": "points/s", "step_ms": ...,
   "roofline_share": ..., "device": {...}}
"""

import json
import statistics
import subprocess
import time

NLEV, NY, NX = 32, 719, 929


def hbm_bytes_per_step(nlev, ny, nx):
    """Intrinsic traffic: each input read once, each output written once
    (the stacked layout: 12 value planes and 9 int8 mask planes)."""
    pts3, pts2 = nlev * ny * nx, ny * nx
    reads = 4 * pts3 * (4 + 1)                 # tk, q, u, v values+masks
    reads += pts2 * (4 + 1) + 2 * pts2 * 4     # ps, map factors
    writes = 12 * pts3 * 4 + 9 * pts3          # values, mask planes
    return reads + writes


def main():
    import jax
    from __graft_entry__ import _example_inputs
    from mi_fieldcalc_tpu.backend import require_gpu
    from mi_fieldcalc_tpu.models import derived_fields_stacked
    from mi_fieldcalc_tpu.utils.compile_cache import enable
    from mi_fieldcalc_tpu.utils.profiling import device_hbm_gbps

    enable()
    require_gpu("bench.py")
    step = jax.jit(derived_fields_stacked)
    args = jax.device_put(_example_inputs(NLEV, NY, NX))
    jax.block_until_ready(step(*args))
    ts = []
    for _ in range(30):
        t0 = time.perf_counter()
        jax.block_until_ready(step(*args))
        ts.append(time.perf_counter() - t0)
    dt = statistics.median(ts)
    dev = jax.devices()[0]
    floor = hbm_bytes_per_step(NLEV, NY, NX) / device_hbm_gbps(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "metric": "derived_field_pipeline_points_per_sec",
        "value": NLEV * NY * NX / dt, "unit": "points/s",
        "step_ms": dt * 1e3, "roofline_share": floor / dt,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "nvidia_smi": smi}}))


if __name__ == "__main__":
    main()
