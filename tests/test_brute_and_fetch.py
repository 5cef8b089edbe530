"""Brute-force tracer: equivalence oracles against the BVH walks
(hit ids exact, floats close)."""

import jax.numpy as jnp
import numpy as np
import pytest

from dustraytracer.ops.traverse import traverse_closest
from dustraytracer.ops.traverse_brute import traverse_brute
from dustraytracer.ops.traverse_cluster import traverse_cluster
from dustraytracer.render.integrator import render_sample
from dustraytracer.scene.camera import make_camera
from dustraytracer.scene.settings import LightParams, RenderSettings

from util_scenes import make_random_tri_doc


@pytest.fixture(scope="module")
def scene():
    # random soup exercises multi-cluster tables + real hit distribution
    from dustraytracer.scene.scene import build_scene

    return build_scene(make_random_tri_doc(300, seed=3), use_native=False)


@pytest.fixture(scope="module")
def rays(scene):
    rng = np.random.default_rng(7)
    lo = np.asarray(scene.node_min[0])
    hi = np.asarray(scene.node_max[0])
    center = 0.5 * (lo + hi)
    o = center + (hi - lo) * rng.uniform(-1.2, 1.2, size=(2048, 3))
    d = rng.normal(size=(2048, 3))
    return jnp.asarray(o.astype(np.float32)), jnp.asarray(
        d.astype(np.float32))


def test_brute_matches_gather_walk(scene, rays):
    o, d = rays
    rb = traverse_brute(scene.cluster, o, d)
    rg = traverse_closest(scene, o, d)
    np.testing.assert_array_equal(np.asarray(rb["hit_idx"]),
                                  np.asarray(rg["hit_idx"]))
    hit = np.asarray(rb["hit_idx"]) >= 0
    np.testing.assert_allclose(np.asarray(rb["t"])[hit],
                               np.asarray(rg["t"])[hit], rtol=1e-5)


def test_brute_matches_cluster_walk(scene, rays):
    o, d = rays
    rb = traverse_brute(scene.cluster, o, d)
    rc = traverse_cluster(scene.cluster, o, d)
    np.testing.assert_array_equal(np.asarray(rb["hit_idx"]),
                                  np.asarray(rc["hit_idx"]))


def test_brute_respects_t_max(scene, rays):
    o, d = rays
    r_all = traverse_brute(scene.cluster, o, d)
    hit = np.asarray(r_all["hit_idx"]) >= 0
    # cap below every hit distance -> nothing survives
    r_cap = traverse_brute(scene.cluster, o, d, t_max=jnp.float32(1e-5))
    assert not np.any(np.asarray(r_cap["hit_idx"])[hit] >= 0)


def test_render_brute_matches_cluster(scene):
    cam = make_camera(position=(0.0, 1.0, 4.0), look_at=(0.0, 0.5, 0.0),
                      vfov_deg=60.0)
    imgs = {}
    for trav in ("cluster", "brute"):
        st = RenderSettings(bounces=2, enable_tonemap=False,
                            enable_gamma=False, traversal=trav)
        lights = LightParams.from_settings(st)
        imgs[trav] = np.asarray(render_sample(
            scene, cam, lights, jnp.uint32(5), width=64, height=64,
            settings=st))
    np.testing.assert_allclose(imgs["cluster"], imgs["brute"],
                               rtol=1e-5, atol=1e-5)
