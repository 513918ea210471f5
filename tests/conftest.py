"""Test harness config: run everything on a virtual 8-device CPU mesh so
sharding tests exercise real collectives without accelerator hardware.

Tests that need the GPU take the `gpu` fixture (marker `gpu`); it skips
on the CPU.  Run them on the card with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:cacheprovider``.
"""

import os

if os.environ.setdefault("JAX_PLATFORMS", "cpu") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags = (flags + " --xla_force_host_platform_device_count=8").strip()
    # the quick gate is XLA-CPU-compile-bound; optimization level 0 cuts
    # the compile ~36% and only slows the trivial execution.  Both sides of
    # every equality assertion run under the same flags.
    if "xla_backend_optimization_level" not in flags:
        flags += " --xla_backend_optimization_level=0"
    os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

# persistent XLA compile cache: the gate is compile-bound; a key miss just
# recompiles -- correctness never depends on the cache
jax.config.update(
    "jax_compilation_cache_dir",
    os.environ.get(
        "JAX_COMPILATION_CACHE_DIR",
        os.path.join(os.path.dirname(__file__), ".jax_cache"),
    ),
)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.25)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first device, when it is a GPU; skips the test otherwise (decided
    here, at run time, never at import or collection)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {dev.platform})")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop jit/trace caches between test FILES: accumulated compiled
    programs inflate later compiles several-fold on a small CPU.  Shapes
    rarely repeat across files, so the recompiles this forces are ones the
    suite paid anyway."""
    yield
    if os.environ.get("OFDM_TEST_NO_CACHE_CLEAR", "0") != "1":
        jax.clear_caches()
