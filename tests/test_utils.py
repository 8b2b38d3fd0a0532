"""The measurement helpers: published bandwidths, the compile-cache
location and the GPU guard of the measurement scripts."""

import os
from types import SimpleNamespace

import pytest

from mi_fieldcalc_tpu.backend import require_gpu
from mi_fieldcalc_tpu.utils import compile_cache
from mi_fieldcalc_tpu.utils.profiling import device_hbm_gbps, roofline_for_op


@pytest.mark.parametrize("kind,bw", [
    ("NVIDIA H100 80GB HBM3", 3.35e12),
    ("NVIDIA H100 PCIe", 2.0e12),
])
def test_hbm_table_knows_the_h100(kind, bw):
    assert device_hbm_gbps(SimpleNamespace(device_kind=kind)) == bw


def test_hbm_table_refuses_unknown_devices():
    """A roofline against a guessed peak is not a measurement."""
    with pytest.raises(ValueError, match="no published memory bandwidth"):
        device_hbm_gbps(SimpleNamespace(device_kind="cpu"))
    with pytest.raises(ValueError):
        roofline_for_op(1, 1, 100)      # the test backend is the CPU


def test_compile_cache_honours_the_environment(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert compile_cache.cache_dir() == "/some/where"


def test_compile_cache_default_is_the_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.cache_dir() == os.path.join(repo, ".jax_cache")


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        require_gpu("this test")
