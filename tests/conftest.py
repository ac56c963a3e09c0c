"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-device sharding logic is tested without accelerators via XLA's
host platform device count (SURVEY.md section 4).  The environment is
set before jax is imported; if some earlier import already created a
backend, the platform is forced through jax.config and the backends are
rebuilt under the new XLA_FLAGS.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from argon_monte_carlo_tpu.utils.cache import enable_compile_cache  # noqa: E402

# The suite's wall time is dominated by XLA:CPU compiles of the
# equivalence tests' many engine configs; the persistent cache (the
# repo's one cache location) lets repeat runs load them from disk.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

if jax.devices()[0].platform != "cpu" or len(jax.devices()) < 8:
    import jax.extend.backend as _jeb

    jax.config.update("jax_platforms", "cpu")
    _jeb.clear_backends()

assert jax.devices()[0].platform == "cpu" and len(jax.devices()) >= 8, (
    "test harness failed to obtain the 8-device virtual CPU mesh: "
    f"{jax.devices()}"
)
