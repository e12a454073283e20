"""Test harness config: run JAX on a virtual 8-device CPU mesh.

Must set flags before JAX initializes (SURVEY.md §4.4 distributed-test
strategy: simulate the mesh with xla_force_host_platform_device_count).
``APPROX_COUNTER_TESTS_ON_GPU=1`` leaves the platform to JAX instead, to
run the ``gpu``-marked tests on a card (README "Testing").
"""

import os

if os.environ.get("APPROX_COUNTER_TESTS_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: APPROX_COUNTER_TESTS_ON_GPU=1 python -m "
                    "pytest -m gpu tests/ on the card")
    return dev
