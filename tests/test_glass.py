"""Glass (transmission) shading: the capability the reference declared
but never implemented (`Material.cuh:10-22` Transmission/refractive_index
parsed; `Random.cu` refract/reflectance declared; `TraceRay.cu:34` "does
not support glass material")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dustraytracer.render.integrator import render_pixels
from dustraytracer.scene.camera import make_camera
from dustraytracer.scene.gltf import (GltfDocument, GltfMaterial,
                                      GltfPrimitive)
from dustraytracer.scene.scene import build_scene
from dustraytracer.scene.settings import LightParams, RenderSettings

from util_scenes import make_quad


def glass_scene(transmission=1.0, ior=1.5, roughness=0.0, pane=True):
    """A glass pane in front of the camera and an emissive red wall
    behind it. The emissive wall (albedo black) terminates path
    throughput, so renders are RNG-robust: what the camera sees is
    exactly the wall's emission carried through whatever the pane does."""
    meshes = [("wall", [make_quad((0, 1, -3), 8, axis=2, mat=1)])]
    if pane:
        meshes.insert(0, ("pane", [make_quad((0, 1, -1), 4, axis=2,
                                             mat=0)]))
    doc = GltfDocument(
        meshes=meshes,
        materials=[
            GltfMaterial(name="glass",
                         base_color=np.ones(3, np.float32),
                         roughness=roughness, transmission=transmission,
                         ior=ior),
            GltfMaterial(name="wall",
                         base_color=np.zeros(3, np.float32),
                         emissive=np.array([4.5, 0.5, 0.5], np.float32),
                         roughness=1.0),
        ],
        images=[], cameras=[])
    return build_scene(doc, use_native=False)


def _render(scene, settings, w=24, h=24, frame=0):
    cam = make_camera(position=(0, 1, 2), look_at=(0, 1, -1), vfov_deg=40)
    lights = LightParams.from_settings(settings)
    ids = jnp.arange(w * h, dtype=jnp.int32)
    img = render_pixels(scene, cam, lights, jnp.uint32(frame), ids,
                        width=w, height=h, settings=settings)
    return np.asarray(img)


PBR = RenderSettings(bounces=3, shading="pbr", enable_tonemap=False,
                     enable_gamma=False, enable_sunlight=False)


def test_ior_one_glass_is_invisible():
    """A fully-transmissive white pane with ior=1 bends nothing and
    absorbs nothing: the render equals the paneless scene (Snell with
    eta=1 is the identity; Schlick r0=0 means no Fresnel reflection)."""
    with_pane = _render(glass_scene(transmission=1.0, ior=1.0), PBR)
    without = _render(glass_scene(pane=False), PBR)
    assert np.isfinite(with_pane).all()
    np.testing.assert_allclose(with_pane, without, atol=1e-4)


def test_transmission_reveals_wall():
    """Opaque pane (white diffuse) vs glass pane: the red wall behind is
    visible only through glass."""
    opaque = _render(glass_scene(transmission=0.0), PBR)
    glass = _render(glass_scene(transmission=1.0, ior=1.0), PBR)
    c = slice(8, 16)
    red_frac_glass = glass[..., 0] / np.maximum(glass.sum(-1), 1e-6)
    red_frac_opaque = opaque[..., 0] / np.maximum(opaque.sum(-1), 1e-6)
    assert red_frac_glass.reshape(24, 24)[c, c].mean() \
        > red_frac_opaque.reshape(24, 24)[c, c].mean() + 0.15


def test_refraction_bends_rays():
    """ior=1.5 render differs from ior=1.0 (Snell bending is active),
    while staying finite."""
    straight = _render(glass_scene(transmission=1.0, ior=1.0), PBR)
    bent = _render(glass_scene(transmission=1.0, ior=1.5), PBR)
    assert np.isfinite(bent).all()
    assert np.abs(bent - straight).max() > 1e-3


def test_trace_shade_phases_agree_with_glass():
    """The shade phase replays the trace phase's stochastic lobe choices
    exactly: rendering twice with the same frame index is deterministic."""
    a = _render(glass_scene(transmission=0.7, ior=1.5), PBR, frame=5)
    b = _render(glass_scene(transmission=0.7, ior=1.5), PBR, frame=5)
    np.testing.assert_array_equal(a, b)


def test_transmission_gradient_flows():
    """d(image)/d(transmission) is finite and nonzero (the w/stop_grad(w)
    reweight makes the discrete lobe choice differentiable)."""
    scene = glass_scene(transmission=0.5, ior=1.5)
    cam = make_camera(position=(0, 1, 2), look_at=(0, 1, -1), vfov_deg=40)
    lights = LightParams.from_settings(PBR)
    ids = jnp.arange(16 * 16, dtype=jnp.int32)

    def loss(transm):
        sc = scene.replace(mat_transmission=transm)
        img = render_pixels(sc, cam, lights, jnp.uint32(0), ids,
                            width=16, height=16, settings=PBR)
        return jnp.mean(img)

    g = jax.grad(loss)(scene.mat_transmission)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g[0]) > 0.0  # the glass material's knob moves the image


def test_ior_gradient_flows():
    scene = glass_scene(transmission=1.0, ior=1.5)
    cam = make_camera(position=(0, 1, 2), look_at=(0, 1, -1), vfov_deg=40)
    lights = LightParams.from_settings(PBR)
    ids = jnp.arange(16 * 16, dtype=jnp.int32)

    def loss(ior):
        sc = scene.replace(mat_ior=ior)
        img = render_pixels(sc, cam, lights, jnp.uint32(0), ids,
                            width=16, height=16, settings=PBR)
        return jnp.mean(img)

    g = np.asarray(jax.grad(loss)(scene.mat_ior))
    assert np.isfinite(g).all()
    assert np.abs(g[0]) > 0.0


def test_metal_lane_transmission_gradient_unbiased():
    """A fully-metallic pane never flips the glass coin, so its
    transmission parameter must receive ZERO gradient. (Regression: the
    glass reweight w_g applied a (1-transmission) branch likelihood to
    metal lanes whose branch never involved the coin, injecting spurious
    d/d(transmission) bias whenever metallic > 0.)"""
    scene = glass_scene(transmission=0.5, ior=1.5)
    scene = scene.replace(
        mat_metallic=scene.mat_metallic.at[0].set(1.0))
    cam = make_camera(position=(0, 1, 2), look_at=(0, 1, -1), vfov_deg=40)
    lights = LightParams.from_settings(PBR)
    ids = jnp.arange(16 * 16, dtype=jnp.int32)

    def loss(transm):
        sc = scene.replace(mat_transmission=transm)
        img = render_pixels(sc, cam, lights, jnp.uint32(0), ids,
                            width=16, height=16, settings=PBR)
        return jnp.mean(img)

    g = np.asarray(jax.grad(loss)(scene.mat_transmission))
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g[0], 0.0, atol=1e-7)


def test_sun_nee_scaled_by_transmission():
    """Clear glass (transmission=1, ior=1) must not collect the diffuse
    sun NEE term: with sunlight on, the pane render equals the paneless
    one. (Regression: NEE previously added the full sun contribution at
    glass hit points as if the surface were diffuse.)"""
    sun = RenderSettings(bounces=3, shading="pbr", enable_tonemap=False,
                         enable_gamma=False, enable_sunlight=True)
    with_pane = _render(glass_scene(transmission=1.0, ior=1.0), sun)
    without = _render(glass_scene(pane=False), sun)
    assert np.isfinite(with_pane).all()
    np.testing.assert_allclose(with_pane, without, atol=1e-4)


def test_gltf_transmission_extension_parsed(tmp_path):
    """KHR_materials_transmission / KHR_materials_ior land in the scene
    material tables."""
    import json
    import struct

    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    blob = tri.tobytes()
    gltf = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0}, "material": 0}]}],
        "materials": [{
            "pbrMetallicRoughness": {"baseColorFactor": [1, 1, 1, 1]},
            "extensions": {
                "KHR_materials_transmission": {"transmissionFactor": 0.8},
                "KHR_materials_ior": {"ior": 1.31},
            }}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3,
                       "type": "VEC3", "min": [0, 0, 0], "max": [1, 1, 0]}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0,
                         "byteLength": len(blob)}],
        "buffers": [{"byteLength": len(blob)}],
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((4 - len(js) % 4) % 4)
    blob += b"\0" * ((4 - len(blob) % 4) % 4)
    out = b"glTF" + struct.pack("<II", 2, 12 + 8 + len(js) + 8 + len(blob))
    out += struct.pack("<I", len(js)) + b"JSON" + js
    out += struct.pack("<I", len(blob)) + b"BIN\0" + blob
    p = tmp_path / "glass.glb"
    p.write_bytes(out)

    from dustraytracer.scene import load_scene
    sc = load_scene(str(p))
    assert float(sc.mat_transmission[0]) == pytest.approx(0.8)
    assert float(sc.mat_ior[0]) == pytest.approx(1.31)


def test_transmission_descent_recovery():
    """Inverse rendering: recover a scrambled transmission by gradient
    descent against a rendered target (BASELINE north-star style)."""
    import optax

    true_t = 0.85
    scene = glass_scene(transmission=true_t, ior=1.0)
    cam = make_camera(position=(0, 1, 2), look_at=(0, 1, -1), vfov_deg=40)
    lights = LightParams.from_settings(PBR)
    ids = jnp.arange(24 * 24, dtype=jnp.int32)

    def render(transm, frame):
        sc = scene.replace(mat_transmission=transm)
        return render_pixels(sc, cam, lights, frame, ids,
                             width=24, height=24, settings=PBR)

    def render_batch(transm, frame0, k=2):
        return sum(render(transm, frame0 + jnp.uint32(j))
                   for j in range(k)) / k

    target = render_batch(scene.mat_transmission, jnp.uint32(9999), k=4)

    def loss(transm, frame):
        # two-sample unbiased MSE: E[(A-y)(B-y)] = (mu-y)^2 for
        # INDEPENDENT renders A, B. Plain mean((X-y)^2) carries a
        # +Var(X) term whose t(1-t) shape drives the stochastic-branch
        # parameter to the domain boundary (observed: t -> 1.0).
        a = render_batch(transm, frame)
        b = render_batch(transm, frame + jnp.uint32(1000000))
        return jnp.mean((a - target) * (b - target))

    # stochastic frames: each step redraws the discrete lobe pattern, so
    # the w/stop_grad(w) estimator averages over branch configurations
    # instead of being pinned to one recorded pattern
    tx = optax.adam(5e-2)
    params = scene.mat_transmission.at[0].set(0.2)
    state = tx.init(params)
    step = jax.jit(lambda p, s, f: (lambda g: tx.update(g, s, p))(
        jax.grad(loss)(p, f)))
    for i in range(80):
        upd, state = step(params, state, jnp.uint32(4 * i))
        params = jnp.clip(optax.apply_updates(params, upd), 0.0, 1.0)
    assert abs(float(params[0]) - true_t) < 0.12
