"""The one place that reads the device's platform.

The library is a NumPy drop-in and runs the same jnp programs under
``jit`` wherever JAX does; nothing in it branches on the platform.
Measurement scripts call :func:`require_gpu` so that they never report
numbers from another backend.
"""

from __future__ import annotations

__all__ = ["require_gpu"]


def require_gpu(what: str) -> None:
    """Raise unless the default device is a GPU."""
    import jax
    p = jax.devices()[0].platform
    if p != "gpu":
        raise RuntimeError(f"{what} needs a GPU; JAX's default device is "
                           f"{p!r}")
