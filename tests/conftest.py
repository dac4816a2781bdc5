"""Test harness config: force CPU with 8 virtual devices.

SURVEY.md §4: multi-chip tests run on a simulated 8-device CPU mesh
(the JAX-native analogue of a fake distributed backend). Must be set
before jax initialises, hence module-level in conftest.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

assert jax.default_backend() == "cpu"
