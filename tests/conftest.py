import os

# Tests run on the CPU with a virtual 8-device mesh, so multi-device
# sharding paths compile and execute without a GPU. Tests that need the
# card carry the `gpu` marker and opt in with an explicit empty
# JAX_PLATFORMS (JAX's own "auto"): `JAX_PLATFORMS= python -m pytest -m gpu`.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
_EXPLICIT_AUTO = os.environ.get("JAX_PLATFORMS") == ""
if not _EXPLICIT_AUTO:
    os.environ["JAX_PLATFORMS"] = "cpu"

# The full suite compiles hundreds of XLA:CPU executables in ONE process;
# LLVM JIT section mmaps exhaust the default vm.max_map_count (65530) near
# the end of the run, failing with "Cannot allocate memory" /
# "Unable to allocate section memory" or a segfault inside
# backend_compile_and_load. Raise the limit when permitted (root).
try:
    with open("/proc/sys/vm/max_map_count", "r+") as _fh:
        if int(_fh.read()) < 1048576:
            _fh.seek(0)
            _fh.write("1048576")
except (OSError, ValueError):
    pass

import jax  # noqa: E402

if not _EXPLICIT_AUTO:
    # XLA:CPU executable (de)serialization in the persistent compile cache
    # intermittently segfaults, and CPU compiles are cheap: keep it off
    jax.config.update("jax_enable_compilation_cache", False)
