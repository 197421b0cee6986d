"""Test configuration: run on an 8-device virtual CPU mesh by default.

Tests exercise the full multi-device sharding path on CPU. When
``JAX_PLATFORMS`` is set, it is respected, so ``JAX_PLATFORMS=cuda pytest
-m gpu`` runs the tests that need the card on the card; tests marked
``gpu`` skip wherever no GPU is present (see the ``gpu_device`` fixture).
Must run before jax is imported anywhere.
"""

import os
from pathlib import Path

if not os.environ.get("JAX_PLATFORMS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest

from theia_jax import compile_cache

# persistent compilation cache: the suite is compile-dominated (dozens of
# distinct tracer configurations), so re-runs skip straight to execution
compile_cache.enable(Path(__file__).resolve().parents[1])


@pytest.fixture
def rng() -> np.random.Generator:
    return np.random.default_rng(0xC0FFEE)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where there is none."""
    import jax

    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on the card)")
    return gpus[0]
