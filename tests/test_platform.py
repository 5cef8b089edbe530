"""The platform module: one place decides "gpu" or "cpu", picks the
traversal, and places the compile cache."""

import os

import jax
import jax.numpy as jnp
import pytest

import dustraytracer.platform as plat
import dustraytracer.render.integrator as ig
from dustraytracer.scene.settings import RenderSettings
from tests.util_scenes import make_random_tri_doc, make_tri_scene


@pytest.fixture(scope="module")
def soup():
    from dustraytracer.scene.scene import build_scene

    return build_scene(make_random_tri_doc(700, seed=4), use_native=False)


def test_platform_is_cpu_in_tests():
    assert plat.platform() == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        plat.require_gpu()


@pytest.mark.parametrize("backend", ["tpu", "rocm", "METAL"])
def test_unknown_platform_raises(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        plat.platform()


@pytest.mark.parametrize("platform,want", [("cpu", "cluster"),
                                           ("gpu", "kernel")])
def test_auto_traversal_per_platform(monkeypatch, soup, platform, want):
    """auto: the plain XLA cluster walk on the CPU, the kernel on the
    GPU; tiny scenes take brute force on both; explicit choices pass
    through; a scene without cluster tables walks the gather BVH."""
    monkeypatch.setattr(ig, "platform", lambda: platform)
    assert ig.traversal_backend(soup, RenderSettings()) == want
    assert ig.traversal_backend(make_tri_scene(), RenderSettings()) == "brute"
    assert ig.traversal_backend(
        soup, RenderSettings(traversal="gather")) == "gather"
    assert ig.traversal_backend(
        soup.replace(cluster=None), RenderSettings()) == "gather"
    with pytest.raises(ValueError, match="cluster tables"):
        ig.traversal_backend(soup.replace(cluster=None),
                             RenderSettings(traversal="kernel"))
    with pytest.raises(ValueError, match="unknown"):
        ig.traversal_backend(soup, RenderSettings(traversal="sweep"))


def test_gpu_main_path_compiles_the_kernel(monkeypatch, soup):
    """On the GPU the default render path runs the Triton kernel
    compiled: its lowering for CUDA holds the Triton custom call, which
    the Pallas interpreter would not emit."""
    from dustraytracer.render.integrator import render_sample
    from dustraytracer.scene.camera import make_camera
    from dustraytracer.scene.settings import LightParams

    monkeypatch.setattr(ig, "platform", lambda: "gpu")
    s = RenderSettings(bounces=1)
    cam = make_camera(position=(0, 1, 9), look_at=(0, 0, 0))
    text = jax.jit(
        lambda sc, c, li: render_sample(sc, c, li, jnp.uint32(0), width=8,
                                        height=8, settings=s)
    ).trace(soup, cam, LightParams.from_settings(s)).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text


def _cache_dir():
    return jax.config.jax_compilation_cache_dir


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = _cache_dir()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert plat.use_compile_cache() == str(tmp_path)
    assert _cache_dir() == before  # JAX reads the variable itself


def test_compile_cache_fixed_path_otherwise(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = _cache_dir()
    try:
        path = plat.use_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            plat.__file__)))
        assert path == os.path.join(root, ".jax_cache")
        assert _cache_dir() == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
