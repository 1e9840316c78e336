import os

# Tests default to the CPU with 8 virtual devices (the sharding tests'
# mesh) and f64.  A JAX_PLATFORMS that is already set is kept, so the
# `gpu`-marked tests can run on a card:  JAX_PLATFORMS=cuda,cpu pytest -m gpu
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# jax may already have been imported by a pytest plugin before this
# conftest ran, in which case the env var above came too late — the
# config update below works as long as no backend was initialised yet.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# Exact algebraic identity tests (sweep equivalence, Galerkin products,
# distribution-invariance fixed points) need f64.
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none.  Decided
    here, at run time, so every xdist worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev
