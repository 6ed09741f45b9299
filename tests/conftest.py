"""Test harness.

Default: the CPU backend with an 8-device virtual mesh (the JAX analogue of
the reference's "multi-node without a cluster" testing; SURVEY.md §4).  A
caller who sets ``JAX_PLATFORMS`` keeps it: ``JAX_PLATFORMS=cuda,cpu python
-m pytest -m gpu tests/`` runs the card tests, whose ``gpu_device`` fixture
skips them with a reason wherever no GPU is present.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda,cpu)")
    return devs[0]
