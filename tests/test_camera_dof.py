"""Thin-lens depth of field + exposure coverage (VERDICT r3 item 6:
`defocus_angle > 0` and the exposure knob shipped with zero tests — a
sign error in lens_offset would have gone green).

Parity targets: `Camera::GetRay` defocus disk
(`/root/reference/DustRayTracer/src/Core/Scene/Camera.cu:101-115`) and
the exposure-scaled Uncharted2 filmic tonemap (`RayGen.cuh:23-52`,
`Camera.cuh` exposure member).
"""

import numpy as np
import jax.numpy as jnp

from dustraytracer.ops.rng import seed_pixels
from dustraytracer.ops.tonemap import uncharted2_filmic
from dustraytracer.render.integrator import render_sample
from dustraytracer.scene.camera import generate_rays, make_camera
from dustraytracer.scene.settings import LightParams, RenderSettings
from tests.util_scenes import make_tri_scene


def _rays(cam, n=256, frame=0):
    ids = jnp.arange(n, dtype=jnp.int32)
    rng = seed_pixels(ids.astype(jnp.uint32), jnp.uint32(frame))
    _r, o, d = generate_rays(cam, 16, 16, rng, pixel_ids=ids)
    return np.asarray(o), np.asarray(d)


def test_dof_off_origins_are_pinhole():
    cam = make_camera(position=(1.0, 2.0, 3.0), look_at=(0, 0, 0),
                      defocus_angle=0.0)
    o, _ = _rays(cam)
    np.testing.assert_allclose(
        o, np.broadcast_to(np.asarray(cam.position), o.shape), atol=1e-7)


def test_dof_origins_sample_the_lens_disk():
    """Origins spread over a disk of radius focus_dist*tan(angle/2) in
    the right/up plane (`Camera.cu:101-115` semantics, bug-free form)."""
    cam = make_camera(position=(0.0, 1.0, 5.0), look_at=(0, 1, 0),
                      focus_dist=5.0, defocus_angle=8.0)
    o, _ = _rays(cam)
    off = o - np.asarray(cam.position)[None, :]
    fwd, right, up = (np.asarray(v) for v in cam.basis())
    # offsets live in the lens plane (no forward component)
    np.testing.assert_allclose(off @ fwd, 0.0, atol=1e-6)
    r = np.hypot(off @ right, off @ up)
    r_max = 5.0 * np.tan(np.deg2rad(8.0) / 2.0)
    assert r.max() <= r_max * (1 + 1e-5)
    assert r.max() > 0.5 * r_max  # actually samples the disk
    assert r.std() > 0.0


def test_dof_rays_converge_at_the_focal_plane():
    """Thin-lens invariant: every lens sample of a pixel's ray passes
    through the same focal-plane point. Intersect each ray with the
    plane at focus_dist along forward; per-pixel scatter must collapse
    to ~zero while the lens origins themselves spread widely."""
    cam = make_camera(position=(0.0, 1.0, 5.0), look_at=(0, 1, -1),
                      focus_dist=4.0, defocus_angle=10.0)
    fwd, _, _ = (np.asarray(v) for v in cam.basis())
    pos = np.asarray(cam.position)

    pts = []
    for frame in range(6):  # 6 independent lens+jitter draws per pixel
        ids = jnp.zeros((64,), jnp.int32)  # same pixel, 64 lanes
        rng = seed_pixels(jnp.arange(64, dtype=jnp.uint32) + 1,
                          jnp.uint32(frame))
        _r, o, d = generate_rays(cam, 16, 16, rng, pixel_ids=ids,
                                 jitter=False)
        o, d = np.asarray(o), np.asarray(d)
        s = (4.0 - (o - pos) @ fwd) / (d @ fwd)
        pts.append(o + s[:, None] * d)
    pts = np.concatenate(pts, axis=0)
    origin_spread = np.std(np.asarray(o), axis=0).max()
    focal_spread = np.std(pts, axis=0).max()
    assert origin_spread > 0.05          # lens really samples a disk
    assert focal_spread < 1e-4 * max(origin_spread, 1.0), (
        focal_spread, origin_spread)


def test_dof_render_blurs_out_of_focus_geometry():
    """End-to-end: with the wall in focus, inter-sample variance at the
    GROUND (out of focus) dwarfs the in-focus wall's; with DoF off both
    stay at the AA-jitter noise floor."""
    scene = make_tri_scene()  # ground plane + wall at (0, 1, -2)
    settings = RenderSettings(bounces=1, enable_sunlight=False,
                              enable_tonemap=False, enable_gamma=False)
    lights = LightParams.from_settings(settings)

    def sample_std(defocus):
        cam = make_camera(position=(0.0, 1.0, 3.0), look_at=(0, 1, -2),
                          focus_dist=5.0, defocus_angle=defocus,
                          vfov_deg=50.0)
        imgs = [np.asarray(render_sample(scene, cam, lights,
                                         jnp.uint32(f), width=48,
                                         height=48, settings=settings))
                for f in range(6)]
        return np.std(np.stack(imgs), axis=0).mean(axis=-1)

    std_dof = sample_std(10.0)
    std_pin = sample_std(0.0)
    # The scene is flat-shaded, so inter-sample variance concentrates at
    # silhouettes; a defocused lens WIDENS the noisy band around every
    # out-of-focus edge while a pinhole's noise stays within the 1-pixel
    # AA jitter (measured: 1090 vs 77 noisy pixels at this setup).
    noisy_dof = int((std_dof > 0.1).sum())
    noisy_pin = int((std_pin > 0.1).sum())
    assert noisy_dof > 5 * max(noisy_pin, 1), (noisy_dof, noisy_pin)
    # the in-focus wall interior stays converged under the lens blur
    assert std_dof[20:28, 20:28].mean() < 1e-3


def test_exposure_scales_tonemapped_brightness():
    """uncharted2_filmic(x, exposure): monotone in exposure, matches the
    reference's closed form (`RayGen.cuh:23-47` Uncharted2Tonemap with
    W=11.2, exposure bias multiplying the linear input)."""
    x = jnp.asarray([[0.05, 0.18, 0.5], [1.0, 2.0, 8.0]], jnp.float32)
    lo = np.asarray(uncharted2_filmic(x, jnp.float32(0.5)))
    mid = np.asarray(uncharted2_filmic(x, jnp.float32(2.0)))
    hi = np.asarray(uncharted2_filmic(x, jnp.float32(6.0)))
    assert np.all(mid > lo) and np.all(hi > mid)

    # closed-form pin (Uncharted2 constants A..F, W = 11.2)
    def u2(v):
        A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
        return ((v * (A * v + C * B) + D * E)
                / (v * (A * v + B) + D * F)) - E / F

    ref = u2(2.0 * np.asarray(x)) * (1.0 / u2(11.2))
    np.testing.assert_allclose(mid, ref, rtol=1e-5, atol=1e-6)


def test_camera_exposure_reaches_the_render():
    """camera.exposure feeds the tonemap inside render_sample."""
    scene = make_tri_scene()
    settings = RenderSettings(bounces=1)
    lights = LightParams.from_settings(settings)
    base = dict(position=(0.0, 1.0, 3.0), look_at=(0, 1, -2),
                vfov_deg=50.0)
    img_lo = np.asarray(render_sample(
        scene, make_camera(exposure=0.25, **base), lights, jnp.uint32(0),
        width=32, height=32, settings=settings))
    img_hi = np.asarray(render_sample(
        scene, make_camera(exposure=4.0, **base), lights, jnp.uint32(0),
        width=32, height=32, settings=settings))
    assert img_hi.mean() > img_lo.mean() + 0.05
