"""Integrator behavior: smoke, determinism, debug heads, accumulation,
sky model, RNG statistics."""

import numpy as np
import jax.numpy as jnp
import pytest

from dustraytracer.render.film import (film_add, film_image, film_init,
                                       render_progressive)
from dustraytracer.render.integrator import render_sample
from dustraytracer.scene.camera import make_camera
from dustraytracer.scene.settings import (DebugMode, LightParams,
                                          RenderMode, RenderSettings)

W = H = 32


@pytest.fixture(scope="module")
def cam():
    return make_camera(position=(0, 2, 6), look_at=(0, 1, 0), vfov_deg=50.0)


def _render(scene, cam, settings, frame=0):
    lights = LightParams.from_settings(settings)
    return render_sample(scene, cam, lights, jnp.uint32(frame),
                         width=W, height=H, settings=settings)


def test_smoke_finite(tri_scene, cam):
    img = _render(tri_scene, cam, RenderSettings(bounces=2))
    assert img.shape == (H, W, 3)
    assert np.isfinite(np.asarray(img)).all()
    assert float(img.max()) > 0.0


def test_deterministic(tri_scene, cam):
    s = RenderSettings(bounces=2)
    a = np.asarray(_render(tri_scene, cam, s, frame=5))
    b = np.asarray(_render(tri_scene, cam, s, frame=5))
    np.testing.assert_array_equal(a, b)


def test_frames_decorrelated(tri_scene, cam):
    s = RenderSettings(bounces=2)
    a = np.asarray(_render(tri_scene, cam, s, frame=0))
    b = np.asarray(_render(tri_scene, cam, s, frame=1))
    assert not np.array_equal(a, b)


def test_sky_only_upward():
    """Rays that see no geometry return the gradient sky: straight-up rays
    get sky_color^2 * intensity, tonemapped (RayGen.cuh:54-61,104-106)."""
    from tests.util_scenes import make_tri_scene

    scene = make_tri_scene()
    up_cam = make_camera(position=(0, 5, 0), forward=(0, 1, 0), vfov_deg=30)
    s = RenderSettings(bounces=1, enable_tonemap=False, enable_gamma=False)
    img = np.asarray(_render(scene, up_cam, s))
    sky = np.asarray(s.sky_color, np.float32)
    expect = (sky ** 2) * s.sky_intensity
    center = img[H // 2, W // 2]
    np.testing.assert_allclose(center, expect, rtol=0.05)


@pytest.mark.parametrize("mode", [DebugMode.ALBEDO, DebugMode.NORMAL,
                                  DebugMode.BARYCENTRIC, DebugMode.UVS,
                                  DebugMode.BVH])
def test_debug_modes(tri_scene, cam, mode):
    s = RenderSettings(render_mode=RenderMode.DEBUG, debug_mode=mode)
    img = np.asarray(_render(tri_scene, cam, s))
    assert np.isfinite(img).all()
    if mode == DebugMode.BARYCENTRIC:
        assert img.min() >= 0.0 and img.max() <= 1.0 + 1e-5
    if mode == DebugMode.NORMAL:
        assert img.max() <= 1.0 + 1e-5 and img.min() >= -1.0 - 1e-5


def test_film_running_mean(tri_scene, cam):
    s = RenderSettings(bounces=1)
    lights = LightParams.from_settings(s)
    film = film_init(W, H)
    samples = []
    for f in range(3):
        smp = render_sample(tri_scene, cam, lights, jnp.uint32(f),
                            width=W, height=H, settings=s)
        samples.append(np.asarray(smp))
        film = film_add(film, smp)
    np.testing.assert_allclose(np.asarray(film_image(film)),
                               np.mean(samples, axis=0), rtol=1e-5)
    assert int(film.frame) == 3


def test_batched_accumulate_matches_per_sample(tri_scene, cam):
    """film_accumulate (k samples in one dispatch, traced count) must
    reproduce the sample-by-sample accumulation bit-for-bit: same RNG
    frame indices, same adds, just fused into one device program."""
    s = RenderSettings(bounces=1)
    lights = LightParams.from_settings(s)
    ref = film_init(W, H)
    for f in range(5):
        smp = render_sample(tri_scene, cam, lights, jnp.uint32(f),
                            width=W, height=H, settings=s)
        ref = film_add(ref, smp)
    batched = render_progressive(tri_scene, cam, s, width=W, height=H,
                                 spp=5, samples_per_dispatch=3)
    assert int(batched.frame) == 5
    np.testing.assert_allclose(np.asarray(film_image(batched)),
                               np.asarray(film_image(ref)), rtol=1e-6)


def test_max_samples_gate(tri_scene, cam):
    """render_progressive must stop at settings.max_samples
    (`Renderer.cu:82`)."""
    s = RenderSettings(bounces=1, max_samples=2)
    film = render_progressive(tri_scene, cam, s, width=W, height=H, spp=10)
    assert int(film.frame) == 2


def test_sun_light_adds_energy(tri_scene, cam):
    base = RenderSettings(bounces=1, enable_sunlight=False,
                          enable_tonemap=False, enable_gamma=False)
    lit = base.replace(enable_sunlight=True)
    a = np.asarray(_render(tri_scene, cam, base)).mean()
    b = np.asarray(_render(tri_scene, cam, lit)).mean()
    assert b > a  # NEE must add (unoccluded ground plane)


def test_russian_roulette_unbiased_mean(tri_scene, cam):
    """RR should preserve the expected image within noise."""
    s0 = RenderSettings(bounces=4, enable_tonemap=False, enable_gamma=False)
    s1 = s0.replace(russian_roulette=True, rr_start_bounce=1)
    lights = LightParams.from_settings(s0)
    acc0 = np.zeros((H, W, 3))
    acc1 = np.zeros((H, W, 3))
    n = 48
    for f in range(n):
        acc0 += np.asarray(render_sample(tri_scene, cam, lights,
                                         jnp.uint32(f), width=W, height=H,
                                         settings=s0))
        acc1 += np.asarray(render_sample(tri_scene, cam, lights,
                                         jnp.uint32(f), width=W, height=H,
                                         settings=s1))
    m0, m1 = acc0.mean() / n, acc1.mean() / n
    assert abs(m0 - m1) / m0 < 0.08


def test_rng_uniformity():
    from dustraytracer.ops.rng import random_float, seed_pixels

    state = seed_pixels(jnp.arange(100_000, dtype=jnp.uint32), 0)
    _, u = random_float(state)
    u = np.asarray(u)
    assert 0.49 < u.mean() < 0.51
    assert u.min() >= 0.0 and u.max() < 1.0
    hist, _ = np.histogram(u, bins=16, range=(0, 1))
    assert hist.min() > 100_000 / 16 * 0.9


def test_unit_sphere_sampler():
    from dustraytracer.ops.rng import random_unit_vec3, seed_pixels

    state = seed_pixels(jnp.arange(50_000, dtype=jnp.uint32), 1)
    _, v = random_unit_vec3(state)
    v = np.asarray(v)
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)
    assert np.abs(v.mean(axis=0)).max() < 0.02  # isotropy
