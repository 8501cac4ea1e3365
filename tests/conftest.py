"""Test configuration.

Tests run on the CPU backend by default, on a virtual 8-device CPU mesh so
multi-device sharding is exercised without accelerators. Must be set before
jax initializes its backend. Tests marked ``gpu`` need a card: run them
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu -n 0`` (they skip
elsewhere; the ``gpu_device`` fixture decides at run time).
"""

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# keep the suite off the shape-history file (tests that exercise the
# history opt in with a tmp path via monkeypatch)
os.environ.setdefault("KMTRICKS_SHAPE_HISTORY", "0")

import jax

# re-assert the platform through jax.config too, in case jax was
# imported (and its config read) before this file
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import pathlib

import pytest

REFERENCE = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def reference_data():
    """Path to the reference repo's tests/data, if mounted."""
    p = REFERENCE / "tests" / "data"
    if not p.exists():
        pytest.skip("reference test data not available")
    return p


@pytest.fixture()
def gpu_device():
    """The first GPU device, or a skip when JAX sees none (decided here,
    at run time, never while modules are imported)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform})")
    return dev
