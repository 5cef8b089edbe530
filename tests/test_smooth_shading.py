"""Smooth (interpolated vertex-normal) shading — the consumer of the
Scene.tri_nrm attribute that glTF provides but the reference ignores
(`ClosestHit.cuh:17-25` shades with the face normal only).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from dustraytracer.render.integrator import render_sample, shade_hits
from dustraytracer.scene.camera import make_camera
from dustraytracer.scene.gltf import (GltfDocument, GltfMaterial,
                                      GltfPrimitive)
from dustraytracer.scene.scene import build_scene
from dustraytracer.scene.settings import (DebugMode, LightParams,
                                          RenderMode, RenderSettings)

W = H = 24


@pytest.fixture(scope="module")
def bent_quad_scene():
    """One triangle whose corner normals fan outward: flat shading gives
    one constant normal, smooth shading varies across the surface."""
    pos = np.array([[[-1, 0, 0], [1, 0, 0], [0, 2, 0]]], np.float32)
    nrm = np.array([[[-0.5, 0, 1], [0.5, 0, 1], [0, 0.5, 1]]], np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    uv = np.zeros((1, 3, 2), np.float32)
    doc = GltfDocument(
        meshes=[("tri", [GltfPrimitive(positions=pos, normals=nrm,
                                       uvs=uv, material=0)])],
        materials=[GltfMaterial(base_color=np.array([0.8, 0.8, 0.8],
                                                    np.float32))],
        images=[], cameras=[])
    return build_scene(doc, use_native=False)


def test_shade_hits_smooth_normals_interpolate(bent_quad_scene):
    s = bent_quad_scene
    o = jnp.array([[-0.5, 0.3, 3.0], [0.5, 0.3, 3.0], [0.0, 1.5, 3.0]])
    d = jnp.array([[0.0, 0.0, -1.0]] * 3)
    hit = jnp.zeros((3,), jnp.int32)
    flat = shade_hits(s, o, d, hit, smooth=False)
    sm = shade_hits(s, o, d, hit, smooth=True)
    nf = np.asarray(flat["normal"])
    ns = np.asarray(sm["normal"])
    # flat: identical normal everywhere; smooth: varies with position
    assert np.allclose(nf[0], nf[1], atol=1e-6)
    assert not np.allclose(ns[0], ns[1], atol=1e-3)
    # all unit length, all viewer-facing
    assert np.allclose(np.linalg.norm(ns, axis=-1), 1.0, atol=1e-5)
    assert (np.sum(ns * np.asarray(d), axis=-1) <= 0).all()


def test_smooth_shading_changes_render(bent_quad_scene):
    cam = make_camera(position=(0, 0.7, 3), look_at=(0, 0.7, 0),
                      vfov_deg=45.0)
    base = RenderSettings(bounces=2, enable_tonemap=False,
                          enable_gamma=False, nee_cosine=True)
    li = LightParams.from_settings(base)

    def render(settings):
        return np.asarray(render_sample(bent_quad_scene, cam, li,
                                        jnp.uint32(0), width=W, height=H,
                                        settings=settings))

    flat = render(base)
    smooth = render(base.replace(smooth_shading=True))
    assert np.isfinite(smooth).all()
    # the N*L term sees different normals -> different image
    assert np.abs(flat - smooth).max() > 1e-3

    # debug NORMAL view shows the interpolation directly
    dbg = base.replace(render_mode=RenderMode.DEBUG,
                       debug_mode=DebugMode.NORMAL, smooth_shading=True)
    nimg = render(dbg)
    hits = nimg.reshape(-1, 3)
    hits = hits[np.linalg.norm(hits, axis=-1) > 0.5]
    assert len(np.unique(hits.round(3), axis=0)) > 10  # varying normals
