"""Profiling and roofline accounting.

Usage::

    from mi_fieldcalc_tpu.utils import trace, roofline_for_op

    with trace("/tmp/jax-trace"):          # view in xprof/tensorboard
        out = jax.block_until_ready(step(*args))

    rl = roofline_for_op(n_inputs=2, n_outputs=1, points=719 * 929)
    print(rl.points_per_sec, rl.seconds)   # speed-of-light for this op
"""

from __future__ import annotations

import contextlib
import dataclasses

__all__ = ["trace", "Roofline", "roofline_for_op", "device_hbm_gbps"]

#: Published peak device-memory bandwidth (bytes/s), matched on
#: ``device_kind`` (NVIDIA H100 data sheet: SXM 3.35 TB/s, PCIe 2.0 TB/s).
_HBM_TABLE = (
    ("h100 pcie", 2.0e12),
    ("h100", 3.35e12),
)


def device_hbm_gbps(device=None) -> float:
    """Published peak memory bandwidth (bytes/s) of ``device`` (default:
    first device).  A device missing from the table is an error: a
    roofline against a guessed peak is not a measurement."""
    import jax
    if device is None:
        device = jax.devices()[0]
    kind = getattr(device, "device_kind", "").lower()
    for key, bw in _HBM_TABLE:
        if key in kind:
            return bw
    raise ValueError(f"no published memory bandwidth for device kind "
                     f"{kind!r}")


@contextlib.contextmanager
def trace(log_dir: str):
    """``jax.profiler`` trace context; writes an xprof trace to log_dir."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Speed-of-light estimate for a memory-bound field operator."""
    bytes_accessed: int
    hbm_bytes_per_sec: float
    points: int

    @property
    def seconds(self) -> float:
        return self.bytes_accessed / self.hbm_bytes_per_sec

    @property
    def points_per_sec(self) -> float:
        return self.points / self.seconds

    def fraction(self, measured_seconds: float) -> float:
        """Measured fraction of speed-of-light (1.0 = at the roofline)."""
        return self.seconds / measured_seconds


def roofline_for_op(n_inputs: int, n_outputs: int, points: int,
                    bytes_per_value: int = 4, bytes_per_mask: int = 1,
                    device=None) -> Roofline:
    """Roofline for a fused mask-aware field operator: every input field
    (values+mask) read once, every output written once.  Field operators
    have trivial arithmetic intensity, so HBM streaming is the bound."""
    per_field = points * (bytes_per_value + bytes_per_mask)
    return Roofline(
        bytes_accessed=(n_inputs + n_outputs) * per_field,
        hbm_bytes_per_sec=device_hbm_gbps(device),
        points=points,
    )
