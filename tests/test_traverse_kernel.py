"""The Hopper traversal kernel (ops/traverse_kernel.py) in the Pallas
interpreter on the CPU, against brute force and the XLA walks.

The compiled kernel runs only on the GPU; chip_smoke.py checks it there
against the same references at full scene size. Contract: identical hit
ids to brute force (ties aside), `t_max` bounds both modes, any-hit ends
at the first accepted hit, and zero gradients (discrete selector).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dustraytracer.accel.cluster import build_cluster_bvh
from dustraytracer.ops.traverse import traverse_closest
from dustraytracer.ops.traverse_brute import traverse_brute
from dustraytracer.ops.traverse_cluster import traverse_cluster
from dustraytracer.ops.traverse_kernel import (BLOCK, pack_tables,
                                               traverse_kernel)
from dustraytracer.scene.scene import build_scene
from tests.util_scenes import make_random_tri_doc, make_tri_scene


@pytest.fixture(scope="module")
def soup():
    scene = build_scene(make_random_tri_doc(600, seed=2), use_native=False)
    return scene, scene.cluster


def _rays(n, seed):
    """Rays from around the soup aimed into it, so most of them hit."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.uniform(-4, 4, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("k", [8, 32])
def test_kernel_matches_brute_force(soup, k):
    """Closest hit: ids equal to brute force, t equal, for two cluster
    sizes, with a ray count that is not a BLOCK multiple."""
    scene, _ = soup
    cb = build_cluster_bvh(np.asarray(scene.tri_pos), k=k)
    o, d = _rays(3 * BLOCK + 5, 7)
    rk = traverse_kernel(cb, o, d, interpret=True)
    rb = traverse_brute(cb, o, d)
    ik, ib = np.asarray(rk["hit_idx"]), np.asarray(rb["hit_idx"])
    assert (ib >= 0).mean() > 0.3
    np.testing.assert_array_equal(ik, ib)
    m = ib >= 0
    np.testing.assert_allclose(np.asarray(rk["t"])[m],
                               np.asarray(rb["t"])[m], rtol=1e-6)


def test_kernel_matches_cluster_walk_exactly(soup):
    """Same tables, same order, same arithmetic: the XLA cluster walk
    and the kernel agree on ids, distances and visit counts."""
    _, cb = soup
    o, d = _rays(200, 9)
    rk = traverse_kernel(cb, o, d, interpret=True)
    rc = traverse_cluster(cb, o, d)
    np.testing.assert_array_equal(np.asarray(rk["hit_idx"]),
                                  np.asarray(rc["hit_idx"]))
    m = np.asarray(rc["hit_idx"]) >= 0
    np.testing.assert_allclose(np.asarray(rk["t"])[m],
                               np.asarray(rc["t"])[m], rtol=1e-6)


def test_kernel_matches_gather_walk(soup):
    """Against the plain threaded walk over the scene's own BVH."""
    scene, cb = soup
    o, d = _rays(150, 4)
    rk = traverse_kernel(cb, o, d, interpret=True)
    rg = traverse_closest(scene, o, d)
    np.testing.assert_array_equal(np.asarray(rk["hit_idx"]),
                                  np.asarray(rg["hit_idx"]))


def test_kernel_anyhit_matches_existence_of_hit(soup):
    _, cb = soup
    o, d = _rays(150, 11)
    ra = traverse_kernel(cb, o, d, anyhit=True, interpret=True)
    rb = traverse_brute(cb, o, d)
    np.testing.assert_array_equal(np.asarray(ra["hit_idx"]) >= 0,
                                  np.asarray(rb["hit_idx"]) >= 0)


@pytest.mark.parametrize("anyhit", [False, True])
def test_kernel_t_max(soup, anyhit):
    """Hits at or beyond t_max are ignored in both modes; a miss reports
    t_max as its t."""
    _, cb = soup
    o, d = _rays(120, 12)
    t_max = jnp.float32(6.0)
    rk = traverse_kernel(cb, o, d, anyhit=anyhit, t_max=t_max,
                         interpret=True)
    rb = traverse_brute(cb, o, d, t_max=t_max)
    np.testing.assert_array_equal(np.asarray(rk["hit_idx"]) >= 0,
                                  np.asarray(rb["hit_idx"]) >= 0)
    miss = np.asarray(rk["hit_idx"]) < 0
    np.testing.assert_array_equal(np.asarray(rk["t"])[miss], 6.0)
    if not anyhit:
        assert (np.asarray(rk["t"]) <= 6.0).all()


def test_kernel_analytic_hit_and_visits():
    scene = make_tri_scene()
    cb = build_cluster_bvh(np.asarray(scene.tri_pos), k=8)
    res = traverse_kernel(cb, jnp.array([[0.0, 3.0, 0.0]]),
                          jnp.array([[0.0, -1.0, 0.0]]), interpret=True)
    assert int(res["hit_idx"][0]) >= 0
    np.testing.assert_allclose(float(res["t"][0]), 3.0, rtol=1e-6)
    assert 1 <= int(res["visits"][0]) <= cb.n_nodes  # BVH heat view


def test_kernel_miss():
    scene = make_tri_scene()
    res = traverse_kernel(scene.cluster, jnp.array([[0.0, 3.0, 0.0]]),
                          jnp.array([[0.0, 1.0, 0.0]]), interpret=True)
    assert int(res["hit_idx"][0]) == -1
    assert float(res["t"][0]) > 1e38


def test_kernel_padding_never_hits(soup):
    """Padded triangle slots (tri_idx == -1) and padded ray lanes never
    produce a hit; ids stay inside the real triangle range."""
    scene, cb = soup
    assert (np.asarray(cb.tri_idx) < 0).any()  # the soup has padding
    o, d = _rays(BLOCK + 1, 21)  # one real ray in the last block
    idx = np.asarray(traverse_kernel(cb, o, d, interpret=True)["hit_idx"])
    assert idx.shape == (BLOCK + 1,)
    assert (idx < scene.n_tris).all()
    # zero-length directions through the scene are degenerate: no hit
    z = traverse_kernel(cb, o[:4], jnp.zeros((4, 3)), interpret=True)
    np.testing.assert_array_equal(np.asarray(z["hit_idx"]), -1)


def test_kernel_zero_gradient_contract(soup):
    """Opaque to AD: zero cotangents for the tables and the rays."""
    import dataclasses

    _, cb = soup
    o, d = _rays(40, 3)

    def f(origin, v0):
        r = traverse_kernel(dataclasses.replace(cb, v0=v0), origin, d,
                            interpret=True)
        return jnp.sum(jnp.where(r["t"] < 1e30, r["t"], 0.0))

    go, gv = jax.grad(f, argnums=(0, 1))(o, cb.v0)
    np.testing.assert_array_equal(np.asarray(go), 0.0)
    np.testing.assert_array_equal(np.asarray(gv), 0.0)


def test_pack_tables_layout(soup):
    """One 8-float record per node of each octant threading, one
    12-float record per triangle slot, ids stored exactly."""
    _, cb = soup
    nodes, tris = pack_tables(cb)
    m, c, k = cb.n_nodes, cb.n_clusters, cb.k
    assert nodes.shape == (8 * m * 8,)
    assert tris.shape == (c * k * 12,)
    rec = np.asarray(tris).reshape(c * k, 12)
    np.testing.assert_array_equal(rec[:, 9].astype(np.int32),
                                  np.asarray(cb.tri_idx[:c]).reshape(-1))
    nrec = np.asarray(nodes).reshape(8, m, 8)
    np.testing.assert_array_equal(nrec[..., 6].astype(np.int32),
                                  np.asarray(cb.oct_skip[:, :m]))


def test_alpha_retrace_over_kernel():
    """Alpha cutout on the kernel path: a ray through a fully
    transparent quad reaches the opaque quad behind it (the kernel's
    in-walk alpha test rejects the transparent hit and walks on)."""
    from dustraytracer.render.integrator import _make_tracers
    from dustraytracer.scene.gltf import GltfDocument, GltfMaterial
    from dustraytracer.scene.settings import RenderSettings
    from tests.util_scenes import make_quad

    doc = GltfDocument(
        meshes=[("cutout", [make_quad((0, 0, -1.0), 4, axis=2, mat=0)]),
                ("opaque", [make_quad((0, 0, -1.5), 4, axis=2, mat=1)])],
        materials=[GltfMaterial(base_color=np.ones(3, np.float32),
                                base_color_texture=0),
                   GltfMaterial(base_color=np.ones(3, np.float32))],
        images=[np.zeros((4, 4, 4), np.uint8)],  # alpha 0 everywhere
        cameras=[])
    scene = build_scene(doc, use_native=False)
    o = jnp.asarray([[0.0, 0.0, 2.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    for alpha in (True, False):
        s = RenderSettings(alpha_test=alpha, traversal="kernel")
        closest, anyhit = _make_tracers(scene, s)
        r = closest(o, d)
        np.testing.assert_allclose(float(r["t"][0]), 3.5 if alpha else 3.0,
                                   rtol=1e-5)
        assert bool(np.asarray(anyhit(o, d))[0])


@pytest.mark.parametrize("anyhit", [False, True])
def test_cutout_kernel_lowers_for_cuda(soup, anyhit):
    """The kernel with its alpha-test tables lowers to one Triton call
    for CUDA (the CPU cannot compile it; the chip smoke test runs it)."""
    from tests.util_scenes import with_alpha_texture

    scene = with_alpha_texture(soup[0])
    o, d = _rays(64, 1)
    text = jax.jit(lambda sc, o, d: traverse_kernel(
        sc.cluster, o, d, anyhit=anyhit, cutout=sc)).trace(
        scene, o, d).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1


def test_render_with_kernel_matches_plain_path():
    """A small render_sample with traversal forced to the kernel (in the
    interpreter) equals the same frame on the XLA cluster walk and on
    the gather walk."""
    from dustraytracer.render.integrator import render_sample
    from dustraytracer.scene.camera import make_camera
    from dustraytracer.scene.settings import LightParams, RenderSettings

    scene = build_scene(make_random_tri_doc(300, seed=3), use_native=False)
    cam = make_camera(position=(0.0, 1.0, 9.0), look_at=(0.0, 0.0, 0.0),
                      vfov_deg=60.0)
    imgs = {}
    for trav in ("kernel", "cluster", "gather"):
        st = RenderSettings(bounces=2, enable_tonemap=False,
                            enable_gamma=False, traversal=trav)
        imgs[trav] = np.asarray(render_sample(
            scene, cam, LightParams.from_settings(st), jnp.uint32(2),
            width=24, height=24, settings=st))
    assert np.isfinite(imgs["kernel"]).all()
    np.testing.assert_allclose(imgs["kernel"], imgs["cluster"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(imgs["kernel"], imgs["gather"],
                               rtol=1e-5, atol=1e-5)
