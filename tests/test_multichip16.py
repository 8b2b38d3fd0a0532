"""16-device virtual-mesh run: the lev=2 x 2-D-spatial composition of
the sharded pipeline (``run_sharded``).

The conftest pins this process to 8 virtual devices, so the 16-device
mesh runs in a subprocess with its own XLA_FLAGS.  Smaller meshes are
covered by tests/test_parallel_fused.py.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

from __graft_entry__ import _example_inputs
from mi_fieldcalc_tpu.parallel import grid_mesh, run_sharded
from mi_fieldcalc_tpu.models import derived_fields
from mi_fieldcalc_tpu.models.pipeline import RADIUS

n = 16
assert len(jax.devices()) == n, jax.devices()
mesh = grid_mesh((2, 2, 4), devices=jax.devices()[:n])
ny, nx = 16, 32                       # 8 rows x 8 lanes per shard
args = _example_inputs(4, ny, nx)
xm = jnp.broadcast_to(args[7], (ny, nx))
ym = jnp.broadcast_to(args[8], (ny, nx))
fc = jnp.broadcast_to(args[9], (ny, nx))
out = jax.jit(lambda *a: run_sharded(derived_fields, mesh, RADIUS, *a))(
    *args[:7], xm, ym, fc)
jax.block_until_ready(out)
assert out.th.values.shape == (4, ny, nx)

# values equal the unsharded jnp reference (the halo seams, the
# lev-batch split, and the physical-edge fills all compose correctly)
ref = jax.jit(derived_fields)(*args)
for name in ref._fields:
    r, g = getattr(ref, name), getattr(out, name)
    rm = np.asarray(r.mask)
    assert np.array_equal(rm, np.asarray(g.mask)), name
    np.testing.assert_allclose(np.asarray(g.values)[rm],
                               np.asarray(r.values)[rm],
                               rtol=2e-5, atol=1e-5, err_msg=name)
print("OK lev2x2x4 @16")
"""


def test_lev2_spatial_overlap_16_devices():
    """lev=2 x (2, 4) spatial mesh on 16 virtual devices: the sharded
    pipeline equals the unsharded one."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "OK lev2x2x4 @16" in res.stdout
