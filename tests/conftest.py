import os
import sys

# Tests run on the CPU backend with 8 virtual devices, so the multi-device
# sharding paths compile and execute without a card, and they keep no
# persistent compile cache: CPU programs compiled here must never land in
# the program's cache directory.  A process that already runs JAX
# (chip_smoke.py, running the `gpu`-marked tests on the card) keeps its
# own backend.
if "jax" not in sys.modules:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

GOLDEN_DIR = pathlib.Path(__file__).resolve().parent / "golden"
DATA_DIR = pathlib.Path(__file__).resolve().parent / "data"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere, and chip_smoke.py "
        "runs these tests on the card")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test on any other backend."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (chip_smoke.py runs this on the card)")
    return jax.devices()[0]
