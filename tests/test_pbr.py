"""PBR shading mode (emissive + metallic/roughness) and learnable float
textures — the capabilities the reference parsed but never shaded
(Material.cuh:10-22)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dustraytracer.render.integrator import render_sample
from dustraytracer.render.texture import decode_textures, sample_texture
from dustraytracer.scene import make_camera
from dustraytracer.scene.settings import LightParams, RenderSettings
from tests.util_scenes import make_courtyard_small_scene

W = H = 32


@pytest.fixture(scope="module")
def cam():
    return make_camera(position=(0, 2, 6), look_at=(0, 1, 0), vfov_deg=50.0)


def _render(scene, cam, s, frame=0):
    lights = LightParams.from_settings(s)
    return render_sample(scene, cam, lights, jnp.uint32(frame),
                         width=W, height=H, settings=s)


def test_emissive_adds_light(tri_scene, cam):
    base = RenderSettings(bounces=2, enable_tonemap=False,
                          enable_gamma=False, enable_sunlight=False)
    pbr = base.replace(shading="pbr")
    glowing = tri_scene.replace(
        mat_emissive=jnp.asarray([[5.0, 0.0, 0.0], [0.0, 0.0, 0.0]]))
    ref = np.asarray(_render(glowing, cam, base))
    lit = np.asarray(_render(glowing, cam, pbr))
    assert lit.mean() > ref.mean()  # emission only shades in pbr mode
    # red emitter -> red channel gains most
    gain = lit - ref
    assert gain[..., 0].sum() > gain[..., 1].sum()


def test_emissive_scene_renders(cam):
    scene = make_courtyard_small_scene()
    assert float(jnp.abs(scene.mat_emissive).max()) > 0, \
        "the generated courtyard carries an emissive material"
    s = RenderSettings(bounces=2, shading="pbr", enable_tonemap=False,
                       enable_gamma=False, enable_sunlight=False)
    lo = np.asarray(scene.node_min[0]); hi = np.asarray(scene.node_max[0])
    center = (lo + hi) / 2
    c = make_camera(position=center + (hi - lo) * 0.8, look_at=center,
                    vfov_deg=50)
    img = np.asarray(_render(scene, c, s))
    assert np.isfinite(img).all()


def test_metallic_changes_bounce(tri_scene, cam):
    s = RenderSettings(bounces=2, shading="pbr", enable_tonemap=False,
                       enable_gamma=False)
    metal = tri_scene.replace(mat_metallic=jnp.asarray([1.0, 1.0]),
                              mat_roughness=jnp.asarray([0.0, 0.0]))
    a = np.asarray(_render(tri_scene, cam, s))
    b = np.asarray(_render(metal, cam, s))
    assert np.isfinite(b).all()
    assert not np.array_equal(a, b)


def test_pbr_reference_mode_unchanged(tri_scene, cam):
    """shading='reference' must be bit-identical to the pre-PBR output
    even when materials carry metallic/emissive values."""
    s = RenderSettings(bounces=2, enable_tonemap=False, enable_gamma=False)
    hot = tri_scene.replace(
        mat_emissive=jnp.asarray([[3.0, 3.0, 3.0]] * 2),
        mat_metallic=jnp.asarray([1.0, 1.0]))
    np.testing.assert_array_equal(np.asarray(_render(tri_scene, cam, s)),
                                  np.asarray(_render(hot, cam, s)))


def test_float_textures_match_u8(cornell_scene, cam):
    """decode_textures must not change the rendered image."""
    s = RenderSettings(bounces=2, enable_tonemap=False, enable_gamma=False)
    c = make_camera(position=(0, 1.25, 1.18), look_at=(0, 1.1, -1.25),
                    vfov_deg=75.0)
    a = np.asarray(_render(cornell_scene, c, s))
    b = np.asarray(_render(decode_textures(cornell_scene), c, s))
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_texture_gradients_flow(cornell_scene):
    """Texel values are differentiable parameters after decode_textures
    (BASELINE config 5: texture grads)."""
    scene = decode_textures(cornell_scene)
    s = RenderSettings(bounces=2, enable_tonemap=False, enable_gamma=False)
    lights = LightParams.from_settings(s)
    c = make_camera(position=(0, 1.25, 1.18), look_at=(0, 1.1, -1.25),
                    vfov_deg=75.0)

    def f(stack):
        img = render_sample(scene.replace(tex_stack=stack), c, lights,
                            jnp.uint32(0), width=W, height=H, settings=s)
        return jnp.mean(img)

    g = jax.grad(f)(scene.tex_stack)
    gm = float(jnp.abs(g).max())
    assert np.isfinite(np.asarray(g)).all()
    assert gm > 0, "texture gradient should be nonzero"
