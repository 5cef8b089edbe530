"""Texture sampling: the packed u8 texel fetch against the reference's
point-sample semantics (`Texture.cu:33-58`), and the learnable float
stack's gradient, a plain gather whose VJP scatter-adds into the stack
(the `--optimize textures` path)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from dustraytracer.render.texture import decode_textures, sample_texture
from dustraytracer.scene.scene import build_scene
from tests.util_scenes import make_random_tri_doc


def _scene_with_stack(stack, hw):
    scene = build_scene(make_random_tri_doc(10, seed=1), use_native=False)
    return dataclasses.replace(scene, tex_stack=jnp.asarray(stack),
                               tex_hw=jnp.asarray(hw))


def test_packed_texel_fetch_matches_reference_semantics():
    """The flat-u32 texel gather (render/texture.py packed_texels) must
    reproduce the reference's point-sample + gamma-2 decode exactly
    (`Texture.cu:33-58`) — byte order and index math included."""
    rng = np.random.default_rng(3)
    stack = rng.integers(0, 255, (3, 8, 16, 4), dtype=np.uint8)
    hw = np.array([[8, 16], [5, 7], [8, 16]], np.int32)  # ragged dims
    scene = _scene_with_stack(stack, hw)

    n = 257
    tex = rng.integers(0, 3, (n,)).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)  # wraps
    got = np.asarray(sample_texture(scene, jnp.asarray(tex),
                                    jnp.asarray(uv)))

    # numpy reference: wrap, scale by the texture's TRUE dims, clip,
    # point sample, /255, square
    fu = uv[:, 0] - np.floor(uv[:, 0])
    fv = uv[:, 1] - np.floor(uv[:, 1])
    h = hw[tex, 0].astype(np.float32)
    w = hw[tex, 1].astype(np.float32)
    xi = np.clip((fu * w).astype(np.int32), 0, hw[tex, 1] - 1)
    yi = np.clip((fv * h).astype(np.int32), 0, hw[tex, 0] - 1)
    ref = stack[tex, yi, xi, :3].astype(np.float32) / 255.0
    ref = ref * ref
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_float_stack_matches_u8_values():
    """decode_textures' linear float stack samples the same values as
    the u8 path's gamma-2 decode."""
    rng = np.random.default_rng(4)
    stack = rng.integers(0, 255, (2, 8, 8, 4), dtype=np.uint8)
    scene = _scene_with_stack(stack, np.array([[8, 8], [8, 8]], np.int32))
    tex = jnp.asarray(rng.integers(0, 2, (64,)).astype(np.int32))
    uv = jnp.asarray(rng.uniform(0, 1, (64, 2)).astype(np.float32))
    a = np.asarray(sample_texture(scene, tex, uv))
    b = np.asarray(sample_texture(decode_textures(scene), tex, uv))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_float_texel_grad_is_scatter_add():
    """d(sum(fetch * cot))/d(stack) accumulates each fetch's cotangent
    into its texel's RGB (alpha gets none), duplicates summed."""
    rng = np.random.default_rng(5)
    T, H, W, U = 3, 6, 5, 400
    stack = rng.uniform(0, 1, (T, H, W, 4)).astype(np.float32)
    scene = _scene_with_stack(stack, np.array([[H, W]] * T, np.int32))
    tex = rng.integers(0, T, (U,)).astype(np.int32)
    xi = rng.integers(0, W, (U,))
    yi = rng.integers(0, H, (U,))
    uv = np.stack([(xi + 0.5) / W, (yi + 0.5) / H], -1).astype(np.float32)
    cot = rng.normal(size=(U, 3)).astype(np.float32)

    def loss(st):
        rgb = sample_texture(scene.replace(tex_stack=st), jnp.asarray(tex),
                             jnp.asarray(uv))
        return jnp.sum(rgb * cot)

    g = np.asarray(jax.grad(loss)(jnp.asarray(stack)))
    ref = np.zeros_like(stack)
    np.add.at(ref, (tex, yi, xi, slice(0, 3)), cot)
    np.testing.assert_allclose(g, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(g[..., 3], 0.0)


def test_render_texture_grads_finite_and_nonzero():
    """Full pipeline: d(image)/d(tex_stack) through render_pixels on a
    textured random soup."""
    from dustraytracer.render.integrator import render_pixels
    from dustraytracer.scene.camera import make_camera
    from dustraytracer.scene.gltf import GltfMaterial
    from dustraytracer.scene.settings import LightParams, RenderSettings

    doc = make_random_tri_doc(120, seed=3)
    rng = np.random.default_rng(0)
    img8 = rng.integers(0, 255, (8, 8, 4), dtype=np.uint8)
    img8[..., 3] = 255
    doc = doc.__class__(meshes=doc.meshes,
                        materials=[GltfMaterial(base_color_texture=0)],
                        images=[img8], cameras=doc.cameras)
    scene = decode_textures(build_scene(doc, use_native=False))
    cam = make_camera(position=(0, 2, 12), look_at=(0, 0, 0), vfov_deg=50)
    s = RenderSettings(bounces=2, enable_tonemap=False, enable_gamma=False)
    lights = LightParams.from_settings(s)
    ids = jnp.arange(24 * 24, dtype=jnp.int32)

    def loss(stack):
        img = render_pixels(scene.replace(tex_stack=stack), cam, lights,
                            jnp.uint32(0), ids, width=24, height=24,
                            settings=s)
        return jnp.mean(img)

    g = np.asarray(jax.grad(loss)(scene.tex_stack))
    assert np.isfinite(g).all()
    assert np.abs(g[..., :3]).max() > 0.0
