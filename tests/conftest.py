"""Test harness config: force CPU JAX with 8 virtual devices so sharding
tests run without several GPUs."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# The persistent compile cache stays off for tests, also where an app's
# main() points it at a directory: every test process compiles afresh,
# so a test never runs an executable that a different tree compiled.
jax.config.update("jax_enable_compilation_cache", False)


import numpy as np  # noqa: E402
import pytest  # noqa: E402

@pytest.fixture(scope="session")
def cornell_scene():
    """The generated cornell box (scene/generate.py cornell_box_doc)."""
    from dustraytracer.scene.generate import cornell_box_doc
    from dustraytracer.scene.scene import build_scene

    return build_scene(cornell_box_doc())


@pytest.fixture(scope="session")
def tri_scene():
    """Tiny two-triangle scene built directly from arrays (no file IO)."""
    from tests.util_scenes import make_tri_scene

    return make_tri_scene()


@pytest.fixture
def rng():
    return np.random.default_rng(0)
