"""BVH traversal vs brute-force oracle — the correctness core."""

import numpy as np
import jax.numpy as jnp
import pytest

from dustraytracer.ops.intersect import moller_trumbore
from dustraytracer.ops.traverse import traverse_anyhit, traverse_closest
from dustraytracer.scene.scene import build_scene
from tests.util_scenes import make_random_tri_doc


@pytest.fixture(scope="module")
def soup():
    doc = make_random_tri_doc(300, seed=1)
    scene = build_scene(doc, use_native=False)
    return scene


def _random_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _brute_force(scene, o, d):
    """All-pairs Möller–Trumbore oracle (numpy via jnp, small sizes)."""
    nt = scene.n_tris
    v0 = scene.tri_pos[:nt, 0][None]
    v1 = scene.tri_pos[:nt, 1][None]
    v2 = scene.tri_pos[:nt, 2][None]
    valid, t, _, _ = moller_trumbore(
        jnp.asarray(o)[:, None, :], jnp.asarray(d)[:, None, :], v0, v1, v2)
    t = jnp.where(valid, t, 3.4e38)
    best = jnp.argmin(t, axis=1)
    rows = jnp.arange(o.shape[0])
    best_t = t[rows, best]
    hit = best_t < 3.4e37
    return np.where(np.asarray(hit), np.asarray(best), -1), np.asarray(best_t)


def test_closest_matches_brute_force(soup):
    o, d = _random_rays(256, seed=7)
    res = traverse_closest(soup, jnp.asarray(o), jnp.asarray(d))
    ref_idx, ref_t = _brute_force(soup, o, d)
    got_t = np.asarray(res["t"])
    got_idx = np.asarray(res["hit_idx"])
    hits = ref_idx >= 0
    assert (got_idx >= 0).sum() == hits.sum()
    # distances must agree everywhere (indices may differ on exact ties)
    np.testing.assert_allclose(got_t[hits], ref_t[hits], rtol=1e-4)
    assert (got_idx[~hits] == -1).all()


def test_anyhit_consistent_with_closest(soup):
    o, d = _random_rays(256, seed=11)
    res = traverse_closest(soup, jnp.asarray(o), jnp.asarray(d))
    occ = traverse_anyhit(soup, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(np.asarray(occ),
                                  np.asarray(res["hit_idx"]) >= 0)


def test_visits_bounded(soup):
    o, d = _random_rays(64, seed=3)
    res = traverse_closest(soup, jnp.asarray(o), jnp.asarray(d))
    v = np.asarray(res["visits"])
    assert (v >= 1).all()
    assert (v <= soup.n_nodes).all()


def test_cornell_wall_hit(cornell_scene):
    """A ray fired at the green wall (z = -1.25) from inside must hit at
    the analytic distance."""
    o = jnp.array([[0.0, 1.25, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    res = traverse_closest(cornell_scene, o, d)
    assert int(res["hit_idx"][0]) >= 0
    np.testing.assert_allclose(float(res["t"][0]), 1.25, rtol=1e-4)
