"""Test configuration: CPU only, virtual 8-device CPU mesh, x64 enabled.

The tests always run on the CPU, even on a machine with a GPU: the test
runner's worker processes must never open the card (a JAX process
reserves most of its memory).  GPU checks live in chip_smoke.py.
Multi-chip sharding is validated on host CPU devices
(xla_force_host_platform_device_count); numerical tests run in float64
to match the reference's -fdefault-real-8 build.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
