"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

The tests run on the CPU: parity targets (<1e-9 in phase/DM, BASELINE.md)
require x64, and the multi-device sharding tests run on the 8-device
virtual CPU mesh.  The GPU path is checked by chip_smoke.py on the card.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# pin the CPU after import too (backends initialize lazily), in case a
# site configuration set jax_platforms
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
