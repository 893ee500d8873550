"""Test harness configuration.

Tests run on CPU with 8 virtual XLA devices so every sharding/collective
path (tensor parallel, data parallel, KV sharding) is exercised without
accelerator hardware — the strategy SURVEY.md §4 calls for (the
reference ships zero tests).  Pallas kernels run through the Pallas
interpreter; tests that need a GPU carry the `gpu` marker and skip here.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Unit tests run on the 8-device virtual CPU mesh (fast local compiles,
# multi-device sharding coverage) even where a GPU is present.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
