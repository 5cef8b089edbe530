"""Brute-force traversal: every ray against every triangle, no BVH.

For tiny scenes a BVH walk is pure overhead: testing all T triangles
against all N rays as one dense (ray-tile, T) broadcast is a single
fused XLA loop with no per-node sequencing (settings.brute_max_tris
gates the crossover; its value was not re-measured on the GPU). It is
also the plain reference every other traversal is checked against.

Capability lineage: this is the degenerate case of the reference's
traversal where the whole scene is one leaf
(`DustRayTracer/src/Core/BVH/BVHTraversal.cuh:14-73`
with a root-only tree); Möller–Trumbore semantics are those of
`Shaders/Intersection.cu:4-36` (same epsilons as ops/intersect.py).

Layout: triangles ride the minor dimension (components pre-split, so no
(.., 3)-minor-dim cross products), rays ride the major dimension in
tiles of RAY_TILE sequenced by `lax.map` inside one jit. Closest hit =
masked min over triangles with lowest-triangle-id tie-break (matches
the in-order leaf test of the cluster walk and the kernel).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dustraytracer.accel.cluster import ClusterBvh
from dustraytracer.ops.intersect import TRIANGLE_EPSILON

BIG = 3.4e38
RAY_TILE = 8192  # rays per map step: bounds the (tile, T) live set


def _flatten_tris(cb: ClusterBvh):
    """(C, K, 3) cluster tables -> per-component (1, T) rows (real
    clusters only; padding slots keep tri_idx == -1)."""
    c = cb.n_clusters
    t = c * cb.k

    def comp(a):
        flat = a[:c].reshape(t, 3)
        return flat[:, 0][None, :], flat[:, 1][None, :], flat[:, 2][None, :]

    v0 = comp(cb.v0)
    e1 = comp(cb.e1)
    e2 = comp(cb.e2)
    ids = cb.tri_idx[:c].reshape(t)[None, :]
    return v0, e1, e2, ids


def traverse_brute(cb: ClusterBvh, origin, direction, *,
                   anyhit: bool = False, t_max=None, cutout=None):
    """All-pairs closest-hit (or any-hit) test.

    Same contract as traverse_cluster: dict of stop-gradiented
    `hit_idx` / `t` / `visits`, (N,) each. `visits` reports the number
    of "nodes" touched, which for brute force is defined as 1 (the
    whole scene is one implicit leaf). `cutout`: None, or the Scene
    whose albedo-texture alpha cuts out candidate hits.
    """
    (v0x, v0y, v0z), (e1x, e1y, e1z), (e2x, e2y, e2z), ids = \
        _flatten_tris(cb)
    n = origin.shape[0]
    limit = jnp.broadcast_to(
        jnp.asarray(BIG if t_max is None else t_max, jnp.float32), (n,))

    pad = (-n) % RAY_TILE
    o = jnp.concatenate([origin, jnp.ones((pad, 3))], axis=0)
    d = jnp.concatenate([direction, jnp.ones((pad, 3))], axis=0)
    lim = jnp.concatenate([limit, jnp.full((pad,), BIG)], axis=0)
    o_t = o.reshape(-1, RAY_TILE, 3)
    d_t = d.reshape(-1, RAY_TILE, 3)
    lim_t = lim.reshape(-1, RAY_TILE)

    def tile(args):
        ot, dt, lt = args
        ox, oy, oz = ot[:, 0:1], ot[:, 1:2], ot[:, 2:3]  # (R, 1)
        dx, dy, dz = dt[:, 0:1], dt[:, 1:2], dt[:, 2:3]

        # Moller-Trumbore, (R, 1) x (1, T) -> (R, T), component-wise
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        par = jnp.abs(det) < TRIANGLE_EPSILON
        inv_det = 1.0 / jnp.where(par, 1.0, det)
        tvx = ox - v0x
        tvy = oy - v0y
        tvz = oz - v0z
        u = inv_det * (tvx * px + tvy * py + tvz * pz)
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        v = inv_det * (dx * qx + dy * qy + dz * qz)
        tt = inv_det * (e2x * qx + e2y * qy + e2z * qz)
        valid = (~par) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) \
            & (u + v <= 1.0) & (tt > TRIANGLE_EPSILON) & (ids >= 0) \
            & (tt < lt[:, None])
        if cutout is not None:
            # lazy: render/ imports the ops modules
            from dustraytracer.render.texture import cutout_opaque

            valid = valid & cutout_opaque(
                cutout, jnp.broadcast_to(jnp.maximum(ids, 0), tt.shape),
                jnp.where(valid, u, 0.0), jnp.where(valid, v, 0.0))

        t_masked = jnp.where(valid, tt, BIG)
        best_t = jnp.min(t_masked, axis=1)  # (R,)
        is_best = valid & (t_masked <= best_t[:, None])
        best_id = jnp.min(jnp.where(is_best, ids, jnp.int32(2**30)),
                          axis=1)
        hit = best_id < 2**30
        hit_idx = jnp.where(hit, best_id, -1)
        hit_t = jnp.where(hit, best_t, lt)
        return hit_t, hit_idx

    hit_t, hit_idx = jax.lax.map(tile, (o_t, d_t, lim_t))
    stop = jax.lax.stop_gradient
    hit_idx = stop(hit_idx.reshape(-1)[:n])
    hit_t = stop(hit_t.reshape(-1)[:n])
    visits = jnp.ones((n,), jnp.int32)
    del anyhit  # any-hit == (closest hit exists); no early-out in brute
    return {"hit_idx": hit_idx, "t": hit_t, "visits": visits}
