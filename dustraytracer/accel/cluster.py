"""Cluster BVH: the acceleration structure the traversal kernel walks.

1. The SAH-permuted triangle soup is cut into C fixed-size *clusters* of
   K consecutive triangles (SAH ordering makes runs spatially coherent).
2. A small threaded BVH is built over cluster AABBs (leaf = 1 cluster),
   plus 8 near-child-first threadings of it, one per ray-direction
   octant.
3. Triangle data lives in dense cluster-major tables (C, K, ...) of
   Möller–Trumbore-ready v0 / e1 / e2.

The GPU kernel (ops/traverse_kernel.py) gathers node and triangle
records from these tables per lane; the XLA cluster walk
(ops/traverse_cluster.py) and brute force (ops/traverse_brute.py) read
the same tables. Capability lineage: same role as the reference's flat
BVHNode array + reordered soup (`BVHBuilder.cu:175-214`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

CLUSTER_K = 64  # triangles per cluster (build_scene passes its own k)


@jax.tree_util.register_dataclass
@dataclass
class ClusterBvh:
    """Dense cluster tables + threaded top-level BVH (all padded)."""

    # top-level threaded BVH over clusters (M nodes, pre-order + skip)
    node_min: jax.Array   # (M, 3) f32
    node_max: jax.Array   # (M, 3) f32
    node_skip: jax.Array  # (M,) i32
    node_cluster: jax.Array  # (M,) i32 cluster id for leaves, -1 internal

    # cluster-major triangle data (C clusters x K tris)
    v0: jax.Array  # (C, K, 3) f32
    e1: jax.Array  # (C, K, 3) f32  v1 - v0
    e2: jax.Array  # (C, K, 3) f32  v2 - v0
    tri_idx: jax.Array  # (C, K) i32 original triangle id, -1 for padding

    n_nodes: int = field(metadata=dict(static=True), default=0)
    n_clusters: int = field(metadata=dict(static=True), default=0)
    k: int = field(metadata=dict(static=True), default=CLUSTER_K)

    # static refit plan (refit_cluster_bvh): every node covers a
    # CONTIGUOUS range of the tree-ordered clusters, so node AABBs are
    # O(1) range-min/max queries against a sparse table of power-of-two
    # window reductions over per-cluster boxes (same scheme as
    # accel/bvh.refit_plan; replaced the round-4 (m, C) subtree mask
    # whose masked reduction dominated vertex-step compile+run time).
    # cl_perm = cluster order in the tree; refit_a/refit_b = flat
    # (levels * C)-table indices per node.
    cl_perm: jax.Array | None = None    # (C,) i32
    refit_a: jax.Array | None = None    # (n_nodes,) i32
    refit_b: jax.Array | None = None    # (n_nodes,) i32
    refit_levels: int = field(metadata=dict(static=True), default=0)

    # --- direction-octant node orderings ---
    # The reference traverses near-child-first with hit-distance culling
    # (`BVHTraversal.cuh:30-41` + parallel dist stack :44-62); a single
    # baked pre-order cannot. These are 8 alternative threadings of the
    # SAME tree, one per ray-direction octant, each ordering children
    # near-first for that octant so early hits tighten hit_t before the
    # far subtree's boxes are tested. The kernel picks the table by each
    # block's majority octant.
    # oct_perm0 maps each ordering's node index to the base ordering's
    # (for refit: recompute base boxes once, gather 8 ways).
    oct_min: jax.Array | None = None      # (8, M, 3) f32
    oct_max: jax.Array | None = None      # (8, M, 3) f32
    oct_skip: jax.Array | None = None     # (8, M) i32 (-1 = done)
    oct_cluster: jax.Array | None = None  # (8, M) i32
    oct_perm0: jax.Array | None = None    # (8, M) i32 -> base node id


def _octant_orders(bvh, m: int, node_cluster: np.ndarray):
    """8 near-child-first pre-order threadings of the built tree.

    For each internal node, the split axis is taken as the axis along
    which the children's box centers differ most; 'near first' for a
    ray-direction octant means the child whose center is smaller along
    that axis goes first when the direction component is positive,
    flipped when negative (the same rule the reference applies per ray,
    `BVHTraversal.cuh:30-41` — here baked per octant). Octant bit
    layout: bit2 = x<0, bit1 = y<0, bit0 = z<0 (as the kernel reads it).

    Returns (omin, omax, oskip, ocluster, operm) stacked (8, m, ...);
    operm[o, i] = base node id of ordering o's node i."""
    left = bvh.node_left[:m].astype(np.int64)
    right = bvh.node_right[:m].astype(np.int64)
    leaf = bvh.node_count[:m] > 0
    center = 0.5 * (np.nan_to_num(bvh.node_min[:m], posinf=1e30,
                                  neginf=-1e30)
                    + np.nan_to_num(bvh.node_max[:m], posinf=1e30,
                                    neginf=-1e30))

    size = np.ones(m, np.int64)
    for i in range(m - 1, -1, -1):
        if not leaf[i]:
            size[i] += size[left[i]] + size[right[i]]

    axis = np.zeros(m, np.int64)
    left_smaller = np.ones(m, bool)
    ints = np.nonzero(~leaf)[0]
    if ints.size:
        diff = center[right[ints]] - center[left[ints]]
        axis[ints] = np.abs(diff).argmax(axis=1)
        left_smaller[ints] = np.take_along_axis(
            diff, axis[ints][:, None], axis=1)[:, 0] >= 0.0

    omin = np.empty((8, m, 3), np.float32)
    omax = np.empty((8, m, 3), np.float32)
    oskip = np.empty((8, m), np.int32)
    ocluster = np.empty((8, m), np.int32)
    operm = np.empty((8, m), np.int32)
    nmin = np.nan_to_num(bvh.node_min[:m], posinf=1e30, neginf=-1e30) \
        .astype(np.float32)
    nmax = np.nan_to_num(bvh.node_max[:m], posinf=1e30, neginf=-1e30) \
        .astype(np.float32)
    for oct_id in range(8):
        neg = np.array([(oct_id >> 2) & 1, (oct_id >> 1) & 1, oct_id & 1],
                       bool)
        old_of_new = np.empty(m, np.int64)
        stack = [0]
        nxt = 0
        while stack:
            o = stack.pop()
            old_of_new[nxt] = o
            nxt += 1
            if not leaf[o]:
                first_left = left_smaller[o] != neg[axis[o]]
                a, b = ((left[o], right[o]) if first_left
                        else (right[o], left[o]))
                stack.append(b)
                stack.append(a)
        skip = np.arange(m, dtype=np.int64) + size[old_of_new]
        skip[skip >= m] = -1
        omin[oct_id] = nmin[old_of_new]
        omax[oct_id] = nmax[old_of_new]
        oskip[oct_id] = skip.astype(np.int32)
        ocluster[oct_id] = node_cluster[old_of_new]
        operm[oct_id] = old_of_new.astype(np.int32)
    return omin, omax, oskip, ocluster, operm


def build_cluster_bvh(tri_pos: np.ndarray, k: int = CLUSTER_K,
                      bins: int = 16) -> ClusterBvh:
    """Build cluster tables over an (already SAH-permuted) triangle array.

    `tri_pos` must be the post-BVH-permutation (N, 3, 3) array (the padded
    Scene.tri_pos works: padding triangles are degenerate and never hit).
    """
    from dustraytracer.accel.bvh import _build_bvh_numpy, thread_bvh

    n = tri_pos.shape[0]
    c = max(1, -(-n // k))
    pad_n = c * k
    tp = np.zeros((pad_n, 3, 3), np.float32)
    tp[:n] = tri_pos

    v0 = tp[:, 0].reshape(c, k, 3)
    e1 = (tp[:, 1] - tp[:, 0]).reshape(c, k, 3)
    e2 = (tp[:, 2] - tp[:, 0]).reshape(c, k, 3)
    tri_idx = np.arange(pad_n, dtype=np.int32).reshape(c, k)
    tri_idx[tri_idx >= n] = -1
    # padding tris are all-zero -> MT det==0 -> rejected; also mask by
    # tri_idx in the traversal

    # cluster AABBs; build a tiny BVH treating each cluster as one "tri"
    # with its AABB corners as a degenerate triangle for the builder
    cl_min = tp.reshape(c, k * 3, 3).min(axis=1)
    cl_max = tp.reshape(c, k * 3, 3).max(axis=1)
    # represent each cluster by a 3-corner "triangle" spanning its AABB so
    # the SAH builder sees the right bounds and centroids
    fake = np.stack([cl_min, cl_max, 0.5 * (cl_min + cl_max)], axis=1)
    bvh = thread_bvh(_build_bvh_numpy(fake, leaf_target=1, bins=bins))

    m = bvh.n_nodes
    node_cluster = np.full(bvh.node_min.shape[0], -1, np.int32)
    leaf = bvh.node_count[:m] > 0
    # leaf_target=1 => every leaf holds exactly one cluster (= its
    # node_first index into the permuted cluster order)
    node_cluster[:m][leaf] = bvh.perm[bvh.node_first[:m][leaf]].astype(np.int32)

    # --- static refit plan (refit_cluster_bvh): each node covers a
    # contiguous range of the tree-ordered clusters -> sparse-table
    # range-min indices, shared machinery with the main BVH refit ---
    from dustraytracer.accel.bvh import refit_plan

    refit_levels, refit_a, refit_b, plan_n = refit_plan(
        bvh.node_first, bvh.node_count, bvh.node_skip, m)
    assert plan_n == c, (plan_n, c)
    cl_perm = bvh.perm.astype(np.int32)

    # Padding boxes are FINITE and inverted (min > max): they can never
    # be entered, and the walks' arithmetic on them stays finite.
    node_min_f = np.nan_to_num(bvh.node_min, posinf=1e30, neginf=-1e30)
    node_max_f = np.nan_to_num(bvh.node_max, posinf=1e30, neginf=-1e30)

    omin, omax, oskip, ocluster, operm = _octant_orders(bvh, m,
                                                        node_cluster)

    # Pad both tables to multiples of 128 rows (static shapes that change
    # rarely as a scene grows, so executables are reused).
    def pad128(a, fill=0.0):
        r = (-a.shape[0]) % 128
        if r == 0:
            return a
        return np.concatenate(
            [a, np.full((r,) + a.shape[1:], fill, a.dtype)], axis=0)

    return ClusterBvh(
        node_min=jnp.asarray(pad128(node_min_f, 1e30)),
        node_max=jnp.asarray(pad128(node_max_f, -1e30)),
        node_skip=jnp.asarray(pad128(bvh.node_skip, -1)),
        node_cluster=jnp.asarray(pad128(node_cluster, -1)),
        v0=jnp.asarray(pad128(v0)),
        e1=jnp.asarray(pad128(e1)),
        e2=jnp.asarray(pad128(e2)),
        tri_idx=jnp.asarray(pad128(tri_idx, -1)),
        n_nodes=m,
        n_clusters=c,
        k=k,
        cl_perm=jnp.asarray(cl_perm),
        refit_a=jnp.asarray(refit_a),
        refit_b=jnp.asarray(refit_b),
        refit_levels=refit_levels,
        oct_min=jnp.asarray(_pad8(omin, 1e30)),
        oct_max=jnp.asarray(_pad8(omax, -1e30)),
        oct_skip=jnp.asarray(_pad8(oskip, -1)),
        oct_cluster=jnp.asarray(_pad8(ocluster, -1)),
        oct_perm0=jnp.asarray(_pad8(operm, 0)),
    )


def _pad8(a: np.ndarray, fill) -> np.ndarray:
    """pad128 along axis 1 (the per-octant node axis)."""
    r = (-a.shape[1]) % 128
    if r == 0:
        return a
    pad = np.full((a.shape[0], r) + a.shape[2:], fill, a.dtype)
    return np.concatenate([a, pad], axis=1)


def refit_cluster_bvh(cb: ClusterBvh, tri_pos) -> ClusterBvh:
    """Re-bake the cluster tables + every node AABB from live triangle
    positions, topology fixed. Pure jnp (jit-safe) — the inverse-
    rendering train step calls this so VERTEX optimization runs on the
    fast traversal instead of against stale tables.

    `tri_pos` must be the same SAH-permuted (N, 3, 3) array family the
    tables were built from (clusters are consecutive K-runs of it).
    Padding semantics match build_cluster_bvh exactly: padding triangles
    are zeros (degenerate, never hit) and participate in cluster bounds
    the same way, so refit(cb, original_tri_pos) reproduces the built
    tables. Gradients do NOT flow through the refit tables (traversal is
    an opaque discrete selector); shading recomputes hit attributes from
    tri_pos directly.
    """
    import dataclasses

    if cb.refit_a is None:
        raise ValueError("ClusterBvh was built without a refit plan")
    c, k, m = cb.n_clusters, cb.k, cb.n_nodes
    pad_n = c * k
    take = min(tri_pos.shape[0], pad_n)
    tp = tri_pos[:take].astype(jnp.float32)
    if take < pad_n:
        # padding via zeros_like (derived from tri_pos) so the array
        # carries tri_pos's mesh/vma type under shard_map — a bare
        # jnp.zeros / broadcast_to trips the Manual-context mesh check
        # (same pattern as ops/intersect.py varying_zero)
        pad_rows = jnp.zeros_like(tp, shape=(pad_n - take, 3, 3))
        tp = jnp.concatenate([tp, pad_rows], axis=0)
    v0 = tp[:, 0].reshape(c, k, 3)
    e1 = (tp[:, 1] - tp[:, 0]).reshape(c, k, 3)
    e2 = (tp[:, 2] - tp[:, 0]).reshape(c, k, 3)

    corners = tp.reshape(c, k * 3, 3)
    cl_min = corners.min(axis=1)
    cl_max = corners.max(axis=1)

    # node AABBs as O(1) range queries: permute cluster boxes into tree
    # order, build log2(C) power-of-two window reductions, and answer
    # each node from two overlapping windows (min/max are idempotent).
    def permute(x):
        return x[cb.cl_perm]

    def table(x, reduce_fn):
        lev = [x]
        for lvl in range(1, cb.refit_levels):
            h = 1 << (lvl - 1)
            prev = lev[-1]
            shifted = jnp.concatenate(
                [prev[h:], jnp.repeat(prev[-1:], h, axis=0)], axis=0)
            lev.append(reduce_fn(prev, shifted))
        return jnp.concatenate(lev, axis=0)  # (levels*C, 3)

    fmin = table(permute(cl_min), jnp.minimum)
    fmax = table(permute(cl_max), jnp.maximum)
    nm = jnp.minimum(fmin[cb.refit_a], fmin[cb.refit_b])
    nx = jnp.maximum(fmax[cb.refit_a], fmax[cb.refit_b])
    # slice+concat, NOT .at[].set: the scatter path broadcasts the update
    # with the operand's committed (replicated, Auto-mesh) sharding
    # attached, which the Manual mesh context inside shard_map rejects —
    # concatenate carries no sharding annotation.
    def splice(old, new):
        return jnp.concatenate([new, old[new.shape[0]:]], axis=0)

    extra = {}
    if cb.oct_min is not None:
        # the 8 octant threadings are PERMUTATIONS of the base node set
        # (topology fixed): refit base boxes once, gather 8 ways
        perm = cb.oct_perm0[:, :m].reshape(-1)  # (8m,)

        def sel(x):  # (m, 3) -> (8, m, 3)
            return x[perm].reshape(8, m, 3)

        def splice8(old, new):
            return jnp.concatenate([new, old[:, new.shape[1]:]], axis=1)

        extra["oct_min"] = splice8(cb.oct_min, sel(nm))
        extra["oct_max"] = splice8(cb.oct_max, sel(nx))

    return dataclasses.replace(
        cb,
        node_min=splice(cb.node_min, nm),
        node_max=splice(cb.node_max, nx),
        v0=splice(cb.v0, v0),
        e1=splice(cb.e1, e1),
        e2=splice(cb.e2, e2),
        **extra,
    )
