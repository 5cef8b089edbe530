"""Alpha-cutout any-hit coverage + golden-render regression tests.

The reference has no automated tests; its de-facto fixtures are the
bundled probe scenes (SURVEY §4). Generated scenes stand in for them:
- the courtyard's cutout foliage exercises the AnyHit alpha path
  (`AnyHit.cuh:8-28`),
- golden statistics of tiny deterministic renders catch unintended
  behavior changes in the full pipeline (update deliberately when
  semantics change).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from dustraytracer.render.integrator import render_sample
from dustraytracer.scene import make_camera
from dustraytracer.scene.settings import LightParams, RenderSettings
from tests.util_scenes import make_cornell_scene, make_courtyard_small_scene


@pytest.fixture(scope="module")
def mc_scene():
    return make_courtyard_small_scene()


def test_alpha_scene_has_alpha_textures(mc_scene):
    assert bool(np.asarray(mc_scene.tex_has_alpha).any())


def test_alpha_test_changes_image(mc_scene):
    """Enabling alpha-cutout must let rays pass through cutout texels —
    the rendered image must differ from the opaque render."""
    # aim at the scene bbox center
    lo = np.asarray(mc_scene.node_min[0])
    hi = np.asarray(mc_scene.node_max[0])
    center = (lo + hi) / 2
    size = float(np.linalg.norm(hi - lo))
    cam = make_camera(position=center + np.array([0, 0.15 * size, 0.8 * size]),
                      look_at=center, vfov_deg=55.0)
    base = RenderSettings(bounces=2, enable_tonemap=False,
                          enable_gamma=False)
    lights = LightParams.from_settings(base)
    opaque = np.asarray(render_sample(mc_scene, cam, lights, jnp.uint32(0),
                                      width=64, height=64, settings=base))
    cut = np.asarray(render_sample(
        mc_scene, cam, lights, jnp.uint32(0), width=64, height=64,
        settings=base.replace(alpha_test=True)))
    assert np.isfinite(cut).all()
    assert not np.array_equal(opaque, cut)


def test_alpha_fast_path_matches_gather(mc_scene):
    """Every backend applies the cutout inside its walk; the cluster walk
    must render the gather walk's image."""
    lo = np.asarray(mc_scene.node_min[0])
    hi = np.asarray(mc_scene.node_max[0])
    center = (lo + hi) / 2
    size = float(np.linalg.norm(hi - lo))
    cam = make_camera(position=center + np.array([0, 0.15 * size, 0.8 * size]),
                      look_at=center, vfov_deg=55.0)
    base = RenderSettings(bounces=2, enable_tonemap=False,
                          enable_gamma=False, alpha_test=True)
    lights = LightParams.from_settings(base)
    fast = np.asarray(render_sample(
        mc_scene, cam, lights, jnp.uint32(0), width=64, height=64,
        settings=base.replace(traversal="cluster")))
    gather = np.asarray(render_sample(
        mc_scene, cam, lights, jnp.uint32(0), width=64, height=64,
        settings=base.replace(traversal="gather")))
    # identical RNG -> identical decisions except at exact ties of t,
    # where the winner is traversal-order-defined (as in the reference's
    # stack order): allow a tiny fraction of differing pixels, not none
    diff = np.abs(fast - gather).max(axis=-1)
    assert (diff > 1e-3).mean() < 0.005
    assert np.isfinite(fast).all()


def test_alpha_anyhit_direct():
    """Unit-level: a ray through a fully-transparent texel region is not
    occluded; through an opaque texel it is — the same on every
    traversal backend."""
    from dustraytracer.render.integrator import _make_tracers
    from tests.util_scenes import make_tri_scene

    scene = make_tri_scene()
    # give material 1 (the wall quad at z=-2) an alpha texture: left half
    # transparent (alpha 0), right half opaque
    tex = np.zeros((1, 8, 8, 4), np.uint8)
    tex[..., :3] = 128
    tex[:, :, 4:, 3] = 255  # u >= 0.5 opaque
    scene = scene.replace(
        tex_stack=jnp.asarray(tex),
        tex_hw=jnp.asarray([[8, 8]], np.int32),
        tex_has_alpha=jnp.asarray([True]),
        mat_albedo_tex=jnp.asarray([-1, 0], np.int32),
    )
    # wall spans x in [-1, 1], uv.u = 0..1 left-to-right
    o = jnp.asarray([[-0.5, 1.0, 2.0], [0.5, 1.0, 2.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], jnp.float32)
    def occluded(alpha, traversal):
        s = RenderSettings(alpha_test=alpha, traversal=traversal)
        return np.asarray(_make_tracers(scene, s)[1](o, d))

    for traversal in ("gather", "cluster", "kernel", "brute"):
        occ = occluded(True, traversal)
        assert not occ[0], f"{traversal}: transparent texel occludes"
        assert occ[1], f"{traversal}: opaque texel must occlude"
        assert occluded(False, traversal).all(), \
            f"{traversal}: without alpha test both rays hit the wall"


GOLDEN = {
    # generated scene -> (mean, std) of a 32x32 1-bounce render, frame 0,
    # default settings minus sun (deterministic, fast)
    "cornell": (0.3267, 0.4904),
    "courtyard_small": (0.7978, 0.4600),
}
BUILDERS = {"cornell": make_cornell_scene,
            "courtyard_small": make_courtyard_small_scene}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_stats(name):
    scene = BUILDERS[name]()
    lo = np.asarray(scene.node_min[0])
    hi = np.asarray(scene.node_max[0])
    center = (lo + hi) / 2
    size = float(np.linalg.norm(hi - lo))
    cam = make_camera(position=center + np.array([0.3, 0.2, 0.9]) * size,
                      look_at=center, vfov_deg=50.0)
    s = RenderSettings(bounces=1, enable_sunlight=False)
    lights = LightParams.from_settings(s)
    img = np.asarray(render_sample(scene, cam, lights, jnp.uint32(0),
                                   width=32, height=32, settings=s))
    mean, std = GOLDEN[name]
    assert abs(float(img.mean()) - mean) < 2e-3, \
        f"{name}: mean {img.mean():.4f} != golden {mean}"
    assert abs(float(img.std()) - std) < 2e-3, \
        f"{name}: std {img.std():.4f} != golden {std}"


def _cutout_pair(sep):
    """A fully transparent textured quad at z=-1 and an opaque quad `sep`
    behind it, both 4 wide, facing a ray from z=2 (t = 3 and 3 + sep)."""
    from dustraytracer.scene.gltf import GltfDocument, GltfMaterial
    from dustraytracer.scene.scene import build_scene
    from tests.util_scenes import make_quad

    doc = GltfDocument(
        meshes=[("cutout", [make_quad((0, 0, -1.0), 4, axis=2, mat=0)]),
                ("opaque", [make_quad((0, 0, -1.0 - sep), 4, axis=2,
                                      mat=1)])],
        materials=[GltfMaterial(base_color=np.ones(3, np.float32),
                                base_color_texture=0),
                   GltfMaterial(base_color=np.ones(3, np.float32))],
        images=[np.zeros((4, 4, 4), np.uint8)],  # alpha 0 everywhere
        cameras=[])
    return build_scene(doc, use_native=False)


BACKENDS = ("gather", "cluster", "brute", "kernel")


def test_alpha_retrace_epsilon_contract():
    """Opaque geometry behind a fully transparent cutout is found at its
    exact distance on every backend, however close behind the cutout it
    lies: the alpha test rejects the transparent candidate inside the
    walk (`AnyHit.cuh:8-28`), with no skip window."""
    from dustraytracer.render.integrator import _make_tracers
    from dustraytracer.scene.settings import RenderSettings

    o = jnp.asarray([[0.0, 0.0, 2.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    for sep in (1e-6, 1e-3, 1e-2, 0.1, 1.0):
        scene = _cutout_pair(sep)
        for traversal in BACKENDS:
            s = RenderSettings(alpha_test=True, traversal=traversal)
            closest, anyhit = _make_tracers(scene, s)
            r = closest(o, d)
            what = f"{traversal}, sep={sep}"
            assert int(np.asarray(r["hit_idx"])[0]) >= 0, what
            np.testing.assert_allclose(float(np.asarray(r["t"])[0]),
                                       3.0 + sep, rtol=1e-6, err_msg=what)
            assert bool(np.asarray(anyhit(o, d))[0]), what


def test_alpha_retrace_epsilon_boundary():
    """The boundary case: an opaque quad exactly coplanar with the
    transparent cutout ties with it at t = 3. The cutout candidate is
    rejected and the opaque one taken, on every backend."""
    from dustraytracer.render.integrator import _make_tracers
    from dustraytracer.scene.settings import RenderSettings

    scene = _cutout_pair(0.0)
    o = jnp.asarray([[0.3, 0.2, 2.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    opaque_mat = 1
    for traversal in BACKENDS:
        s = RenderSettings(alpha_test=True, traversal=traversal)
        r = _make_tracers(scene, s)[0](o, d)
        hit = int(np.asarray(r["hit_idx"])[0])
        assert hit >= 0, traversal
        assert int(np.asarray(scene.tri_mat)[hit]) == opaque_mat, traversal
        np.testing.assert_allclose(float(np.asarray(r["t"])[0]), 3.0,
                                   rtol=1e-6)


@pytest.mark.parametrize("anyhit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("backend", ["kernel", "cluster", "brute"])
def test_cutout_matches_gather_walk(backend, anyhit):
    """Random rays through a triangle soup under a random alpha texture:
    each cluster-table backend's in-walk cutout gives the gather walk's
    hits (ids and t) and occlusion bits."""
    from dustraytracer.ops.traverse import traverse_anyhit, traverse_closest
    from dustraytracer.ops.traverse_brute import traverse_brute
    from dustraytracer.ops.traverse_cluster import traverse_cluster
    from dustraytracer.ops.traverse_kernel import traverse_kernel
    from dustraytracer.scene.scene import build_scene
    from tests.util_scenes import make_random_tri_doc, with_alpha_texture

    scene = with_alpha_texture(
        build_scene(make_random_tri_doc(400, seed=5), use_native=False))
    rng = np.random.default_rng(6)
    o = rng.uniform(-12, 12, (300, 3)).astype(np.float32)
    d = rng.uniform(-4, 4, (300, 3)).astype(np.float32) - o
    o, d = jnp.asarray(o), jnp.asarray(d)
    run = {"kernel": lambda **kw: traverse_kernel(scene.cluster, o, d,
                                                  interpret=True, **kw),
           "cluster": lambda **kw: traverse_cluster(scene.cluster, o, d,
                                                    **kw),
           "brute": lambda **kw: traverse_brute(scene.cluster, o, d,
                                                **kw)}[backend]
    got = run(anyhit=anyhit, cutout=scene)
    blind = run(anyhit=anyhit)
    if anyhit:
        want = np.asarray(traverse_anyhit(scene, o, d, alpha_test=True))
        np.testing.assert_array_equal(np.asarray(got["hit_idx"]) >= 0, want)
    else:
        want = traverse_closest(scene, o, d, alpha_test=True)
        np.testing.assert_array_equal(np.asarray(got["hit_idx"]),
                                      np.asarray(want["hit_idx"]))
        np.testing.assert_allclose(np.asarray(got["t"]),
                                   np.asarray(want["t"]), rtol=1e-6)
    # the cutout must matter on these rays
    assert not np.array_equal(np.asarray(got["hit_idx"]),
                              np.asarray(blind["hit_idx"]))
