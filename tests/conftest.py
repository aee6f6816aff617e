import os

# Tests run on the single real CPU device — the 512-device override is
# strictly scoped to repro.launch.dryrun (see system prompt contract).
assert "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""), \
    "dry-run XLA flags must not leak into the test environment"

import jax

jax.config.update("jax_platform_name", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a Hopper (sm_90) CUDA card; skips elsewhere")
