"""BVH builder invariants + numpy/native cross-check."""

import numpy as np
import pytest

from dustraytracer.accel.bvh import _build_bvh_numpy, build_bvh
from dustraytracer.accel.native.build import build_bvh_native


def _random_tris(n, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (n, 1, 3))
    return (centers + rng.normal(0, 0.4, (n, 3, 3))).astype(np.float32)


def _check_invariants(bvh, tri_pos, leaf_target):
    n = tri_pos.shape[0]
    # perm is a permutation
    assert sorted(bvh.perm.tolist()) == list(range(n))
    # leaves partition [0, n) exactly
    leaf = bvh.node_count[: bvh.n_nodes] > 0
    ranges = sorted(
        (int(f), int(f + c))
        for f, c in zip(bvh.node_first[: bvh.n_nodes][leaf],
                        bvh.node_count[: bvh.n_nodes][leaf]))
    covered = 0
    for lo, hi in ranges:
        assert lo == covered, "leaf ranges must be contiguous"
        covered = hi
    assert covered == n
    # leaf size bound (required by the fixed-width leaf gather)
    assert bvh.node_count[: bvh.n_nodes].max() <= leaf_target
    # every triangle inside its leaf AABB
    tmin = tri_pos[bvh.perm].min(axis=1)
    tmax = tri_pos[bvh.perm].max(axis=1)
    for i in np.nonzero(leaf)[0]:
        f, c = int(bvh.node_first[i]), int(bvh.node_count[i])
        assert (tmin[f : f + c] >= bvh.node_min[i] - 1e-4).all()
        assert (tmax[f : f + c] <= bvh.node_max[i] + 1e-4).all()
    # children contained in parents
    inner = np.nonzero(~leaf & (np.arange(len(leaf)) < bvh.n_nodes))[0]
    for i in inner:
        for ch in (bvh.node_left[i], bvh.node_right[i]):
            assert 0 <= ch < bvh.n_nodes
            assert (bvh.node_min[ch] >= bvh.node_min[i] - 1e-4).all()
            assert (bvh.node_max[ch] <= bvh.node_max[i] + 1e-4).all()


@pytest.mark.parametrize("n", [1, 2, 7, 100, 2000])
def test_numpy_builder_invariants(n):
    tris = _random_tris(n)
    bvh = _build_bvh_numpy(tris, leaf_target=8, bins=16)
    _check_invariants(bvh, tris, leaf_target=8)


def test_degenerate_identical_centroids():
    """All triangles at the same spot must still satisfy the leaf bound
    (median-split fallback)."""
    tri = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    tris = np.repeat(tri, 100, axis=0)
    bvh = _build_bvh_numpy(tris, leaf_target=8, bins=16)
    _check_invariants(bvh, tris, leaf_target=8)


def test_native_matches_numpy():
    tris = _random_tris(500, seed=3)
    native = build_bvh_native(tris, 8, 16)
    if native is None:
        pytest.skip("native builder unavailable")
    ref = _build_bvh_numpy(tris, leaf_target=8, bins=16)
    _check_invariants(native, tris, leaf_target=8)
    assert native.n_nodes == ref.n_nodes
    np.testing.assert_array_equal(native.perm, ref.perm)
    np.testing.assert_array_equal(native.node_left, ref.node_left)
    np.testing.assert_array_equal(native.node_count, ref.node_count)
    np.testing.assert_allclose(native.node_min, ref.node_min, rtol=1e-6)


def test_build_bvh_dispatch():
    tris = _random_tris(64)
    bvh = build_bvh(tris, leaf_target=8, bins=16)
    _check_invariants(bvh, tris, leaf_target=8)


def test_thread_bvh_preorder_invariants():
    """Skip links: subtree of node i occupies [i, skip_i); first child of
    an internal node is i+1; walking skip links from the root visits every
    node exactly once."""
    tris = _random_tris(777, seed=5)
    bvh = build_bvh(tris, leaf_target=8, bins=16)
    m = bvh.n_nodes
    leaf = bvh.node_count[:m] > 0
    for i in range(m):
        if not leaf[i]:
            assert bvh.node_left[i] == i + 1
            assert bvh.node_right[i] > bvh.node_left[i]
    # full skip-walk (always-descend walk) touches all m nodes once
    visited = 0
    node = 0
    while node != -1:
        visited += 1
        node = int(node + 1) if not leaf[node] else int(bvh.node_skip[node])
        if node != -1 and visited > m:
            break
    assert visited == m
    # skip of node i is i + subtree size
    sizes = np.ones(m, np.int64)
    for i in range(m - 1, -1, -1):
        if not leaf[i]:
            sizes[i] += sizes[bvh.node_left[i]] + sizes[bvh.node_right[i]]
    expect = np.arange(m) + sizes
    expect[expect >= m] = -1
    np.testing.assert_array_equal(bvh.node_skip[:m], expect)
