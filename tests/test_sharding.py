"""Multi-device sharding tests on the 8-way CPU-simulated mesh."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from dustraytracer.parallel.mesh import make_render_mesh, replicate_scene
from dustraytracer.parallel.shard import (sharded_render_sample,
                                          sharded_train_step)
from dustraytracer.render.integrator import render_sample
from dustraytracer.scene.camera import make_camera
from dustraytracer.scene.settings import LightParams, RenderSettings

W = H = 32


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must fake 8 cpu devices"
    return make_render_mesh(8)


@pytest.fixture(scope="module")
def cam():
    return make_camera(position=(0, 2, 6), look_at=(0, 1, 0), vfov_deg=50.0)


def test_sharded_render_matches_single_device(tri_scene, cam, mesh):
    """Tile sharding must be bit-compatible with the single-device render
    (determinism across shardings — SURVEY §5.2)."""
    s = RenderSettings(bounces=2)
    lights = LightParams.from_settings(s)
    ref = np.asarray(render_sample(tri_scene, cam, lights, jnp.uint32(3),
                                   width=W, height=H, settings=s))
    scene_r = replicate_scene(tri_scene, mesh)
    got = np.asarray(sharded_render_sample(
        scene_r, cam, lights, jnp.uint32(3), mesh=mesh,
        width=W, height=H, settings=s))
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_sharded_output_layout(tri_scene, cam, mesh):
    s = RenderSettings(bounces=1)
    lights = LightParams.from_settings(s)
    out = sharded_render_sample(tri_scene, cam, lights, jnp.uint32(0),
                                mesh=mesh, width=W, height=H, settings=s)
    assert out.shape == (H, W, 3)
    # output is actually sharded across devices, not replicated
    assert len(out.sharding.device_set) == 8


def test_sharded_train_step_decreases_loss(tri_scene, cam, mesh):
    s = RenderSettings(bounces=2, enable_tonemap=False, enable_gamma=False)
    lights = LightParams.from_settings(s)
    # target: render with the TRUE albedo; start optimization from wrong one
    target = render_sample(tri_scene, cam, lights, jnp.uint32(0),
                           width=W, height=H, settings=s)
    params = {"mat_albedo": tri_scene.mat_albedo * 0.3}
    losses = []
    for step in range(10):
        params, loss = sharded_train_step(
            params, tri_scene, cam, lights, target, jnp.uint32(0),
            jnp.float32(2e-4), mesh=mesh, width=W, height=H, settings=s)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses


def test_sharded_grads_match_single_device(tri_scene, cam, mesh):
    """psum'd sharded gradient == plain jax.grad on one device."""
    s = RenderSettings(bounces=2, enable_tonemap=False, enable_gamma=False)
    lights = LightParams.from_settings(s)
    target = render_sample(tri_scene, cam, lights, jnp.uint32(0),
                           width=W, height=H, settings=s) * 0.0

    def loss_single(albedo):
        sc = tri_scene.replace(mat_albedo=albedo)
        img = render_sample(sc, cam, lights, jnp.uint32(0),
                            width=W, height=H, settings=s)
        return jnp.mean(jnp.sum((img - target) ** 2, axis=-1)) / 3.0 * 3.0 \
            / (W * H) * (W * H)

    # same normalization as sharded loss: sum of squared diff / n_pixels
    def loss_single(albedo):  # noqa: F811
        sc = tri_scene.replace(mat_albedo=albedo)
        img = render_sample(sc, cam, lights, jnp.uint32(0),
                            width=W, height=H, settings=s)
        return jnp.sum((img - target) ** 2) / (W * H)

    g_ref = jax.grad(loss_single)(tri_scene.mat_albedo)
    params = {"mat_albedo": tri_scene.mat_albedo}
    p1, _ = sharded_train_step(
        params, tri_scene, cam, lights, target, jnp.uint32(0),
        jnp.float32(1.0), mesh=mesh, width=W, height=H, settings=s)
    g_shard = (tri_scene.mat_albedo - p1["mat_albedo"])  # lr=1 -> grad
    # psum reduction order differs from the single-device sum; f32 only
    np.testing.assert_allclose(np.asarray(g_shard), np.asarray(g_ref),
                               rtol=1e-5)


@pytest.mark.parametrize("step", ["render", "train"])
def test_sharded_kernel_path_lowers_for_gpu(tri_scene, cam, mesh,
                                            monkeypatch, step):
    """The GPU path under shard_map: with the traversal kernel compiled
    (not interpreted), the sharded render and train step trace with the
    kernel's outputs typed as varying over the tile axis and lower to
    Triton for CUDA. (The Pallas interpreter cannot run under shard_map
    with vma checking, so the CPU checks types and lowering only; the
    chip smoke test runs the compiled path.)"""
    import dustraytracer.render.integrator as ig

    monkeypatch.setattr(ig, "platform", lambda: "gpu")
    s = RenderSettings(bounces=2, traversal="kernel", alpha_test=True)
    lights = LightParams.from_settings(s)
    if step == "render":
        traced = sharded_render_sample.trace(
            tri_scene, cam, lights, jnp.uint32(0), mesh=mesh, width=16,
            height=16, settings=s)
    else:
        params = {"mat_albedo": tri_scene.mat_albedo * 0.5,
                  "lights": lights}
        traced = sharded_train_step.trace(
            params, tri_scene, cam, lights, jnp.zeros((16, 16, 3)),
            jnp.uint32(0), jnp.float32(0.1), mesh=mesh, width=16,
            height=16, settings=s)
    text = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert "traverse_kernel" in text
