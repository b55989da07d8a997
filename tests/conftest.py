"""Test harness setup: run everything on an 8-device virtual CPU mesh.

The tests force the CPU backend with 8 virtual devices so multi-device
sharding paths execute for real (collectives included) without hardware,
per the standard JAX testing recipe.  What only the card can run is marked
``gpu`` (the ``gpu`` fixture skips it here) and is covered on the card by
``python chip_smoke.py``.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
# CLI tests call run.main, which points the persistent compile cache into
# the checkout; tests compile afresh and write no cache
jax.config.update("jax_enable_compilation_cache", False)
assert jax.devices()[0].platform == "cpu"
assert len(jax.devices()) == 8, jax.devices()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_ROOT = "/root/reference"
FIXTURE_SINGLE = os.path.join(REFERENCE_ROOT, "ref/pytorch_reference_single.hdf5")
FIXTURE_MULTI = os.path.join(REFERENCE_ROOT, "ref/pytorch_reference_multi.hdf5")


def has_fixtures() -> bool:
    return os.path.exists(FIXTURE_SINGLE) and os.path.exists(FIXTURE_MULTI)


requires_fixtures = pytest.mark.skipif(
    not has_fixtures(), reason="PyTorch reference HDF5 fixtures not available")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end tests (bench smoke)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped here by the gpu "
        "fixture, run on the card with `python chip_smoke.py`")


@pytest.fixture
def gpu():
    """The visible GPU devices; skips the test where there are none.  The
    check runs here, at test time — never at import or collection, where
    it would give the test workers different test lists."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (covered by chip_smoke.py)")
    return devs


@pytest.fixture
def rng():
    return np.random.default_rng(51234)
