"""Test config: run on the CPU with 8 virtual devices so mesh/sharding tests
work without GPUs (SURVEY.md §4).

The platform is also set in jax.config after import, before any backend
initializes, so the tests run on the CPU whatever JAX_PLATFORMS says.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
