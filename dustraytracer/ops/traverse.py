"""The plain XLA BVH walk: threaded pre-order, all rays in lockstep.

The reference walks the BVH with one divergent per-thread loop and a
64-deep register stack (`DustRayTracer/src/Core/BVH/BVHTraversal.cuh:
14-134`). XLA has neither per-lane control flow nor cheap per-lane
stacks, so the tree itself is *threaded*: nodes live in DFS pre-order
with an escape ("skip") link past each subtree (`accel/bvh.py::
thread_bvh`). Every ray then carries a single node pointer:

    enter AABB & internal  ->  next = node + 1      (first child)
    miss AABB or leaf      ->  next = skip[node]    (escape subtree)
    next == -1             ->  ray done

All N rays advance in lockstep through one `lax.while_loop`; each step is
one gather of node SoA data + a fused batch of slab tests + (masked)
MAX_LEAF-wide triangle intersections. No scatters, no stacks. The GPU
traversal kernel (ops/traverse_kernel.py) walks the same threaded layout
one block of rays at a time; this walk is its plain reference.

Matching reference semantics:
- entry-distance culling against the current closest hit
  (`BVHTraversal.cuh:63-70`; the near-child *ordering* is deliberately
  dropped — static threading cannot reorder children per ray — the
  distance cull keeps the work bounded),
- leaf intersection keeps the closest passing hit (`:46-55`),
- visit-count "heat" for the BVH debug view (`:43`),
- any-hit variant with early exit on first accepted hit
  (`traverseBVH_raytest`, `:76-134`).

- optional alpha-cutout AnyHit filter (`Shaders/AnyHit.cuh:8-28`):
  a candidate whose albedo-texture alpha is below 1 is rejected inside
  the leaf test and the walk goes on.

Differentiation contract: traversal is a *discrete selector* — it returns
integer hit ids (and distances for control only), wrapped in
stop_gradient. Callers recompute hit attributes differentiably from
`hit_idx` (render/integrator.py::shade_hits).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from dustraytracer.ops.intersect import (moller_trumbore, ray_aabb_entry,
                                         varying_zero)
from dustraytracer.scene.scene import MAX_LEAF

BIG = 3.4e38  # python float, NOT jnp: captured jnp arrays become hoisted
# constants that the jit fastpath mishandles (buffer-count crashes)


def _leaf_intersect(scene, node, origin, direction, hit_t, alpha_test):
    """Intersect the MAX_LEAF-wide triangle window of each ray's leaf.

    Returns (best_t, best_idx, best_valid) per ray. `node` may point at an
    internal node — caller masks. Vectorizes the reference's scalar prim
    loop (`BVHTraversal.cuh:46-55`) into an (N, L) batch.
    """
    first = scene.node_first[node]  # (N,)
    count = scene.node_count[node]
    lanes = jnp.arange(MAX_LEAF, dtype=jnp.int32)
    prim = first[:, None] + lanes[None, :]  # (N, L)
    in_leaf = lanes[None, :] < count[:, None]

    v0 = scene.tri_pos[prim, 0]  # (N, L, 3)
    v1 = scene.tri_pos[prim, 1]
    v2 = scene.tri_pos[prim, 2]
    valid, t, u, v = moller_trumbore(
        origin[:, None, :], direction[:, None, :], v0, v1, v2)
    valid = valid & in_leaf & (t < hit_t[:, None])
    if alpha_test:
        # lazy: render/ imports this module
        from dustraytracer.render.texture import cutout_opaque

        valid = valid & cutout_opaque(scene, jnp.maximum(prim, 0), u, v)

    t_masked = jnp.where(valid, t, BIG)
    j = jnp.argmin(t_masked, axis=1)
    rows = jnp.arange(t_masked.shape[0])
    best_t = t_masked[rows, j]
    best_idx = prim[rows, j]
    return best_t, best_idx, valid.any(axis=1)


@partial(jax.jit, static_argnames=("alpha_test",))
def traverse_closest(scene, origin, direction, *, alpha_test: bool = False):
    """Closest-hit BVH traversal for N rays (stackless threaded walk).

    Args:
      scene: Scene pytree (threaded pre-order SoA BVH + triangles).
      origin, direction: (N, 3) f32. Direction need not be normalized.
      alpha_test: enable the alpha-cutout AnyHit filter.

    Returns dict of (N,) arrays: `hit_idx` (i32, -1 = miss), `t` (f32,
    BIG on miss), `visits` (i32 node-visit heat, `BVHTraversal.cuh:43`).
    All returned values are wrapped in stop_gradient.
    """
    inv_dir = 1.0 / direction  # inf on zero components is slab-guarded

    vz = varying_zero(origin)  # vma-consistent carry init under shard_map
    vzi = vz.astype(jnp.int32)
    node = vzi  # start at root (pre-order 0)
    hit_t = BIG + vz
    hit_idx = vzi - 1
    visits = vzi

    def cond(carry):
        node, *_ = carry
        return jnp.any(node >= 0)

    def body(carry):
        node, hit_t, hit_idx, visits = carry
        active = node >= 0
        nd = jnp.maximum(node, 0)
        visits = visits + active.astype(jnp.int32)

        box_hit, box_t = ray_aabb_entry(origin, inv_dir, scene.node_min[nd],
                                        scene.node_max[nd])
        enter = active & box_hit & (box_t < hit_t)  # distance culling
        is_leaf = scene.node_count[nd] > 0

        # --- leaf: vectorized triangle window (masked) ---
        best_t, best_idx, any_valid = _leaf_intersect(
            scene, nd, origin, direction, hit_t, alpha_test)
        take = enter & is_leaf & any_valid & (best_t < hit_t)
        hit_t = jnp.where(take, best_t, hit_t)
        hit_idx = jnp.where(take, best_idx, hit_idx)

        # --- threaded step: descend or escape ---
        descend = enter & ~is_leaf
        nxt = jnp.where(descend, nd + 1, scene.node_skip[nd])
        node = jnp.where(active, nxt, node)
        return node, hit_t, hit_idx, visits

    _, hit_t, hit_idx, visits = jax.lax.while_loop(
        cond, body, (node, hit_t, hit_idx, visits))
    stop = jax.lax.stop_gradient
    return {"hit_idx": stop(hit_idx), "t": stop(hit_t), "visits": stop(visits)}


@partial(jax.jit, static_argnames=("alpha_test",))
def traverse_anyhit(scene, origin, direction, t_max=None, *,
                    alpha_test: bool = False):
    """Boolean occlusion query (shadow rays), threaded walk.

    Early exit on the first accepted hit — semantics of
    `traverseBVH_raytest` (`BVHTraversal.cuh:76-134`). Returns (N,) bool
    `occluded`.
    """
    n = origin.shape[0]
    inv_dir = 1.0 / direction
    vz = varying_zero(origin)  # vma-consistent carry init under shard_map
    limit = jnp.broadcast_to(BIG if t_max is None else t_max, (n,)) + vz

    node = vz.astype(jnp.int32)
    occluded = vz != 0.0

    def cond(carry):
        node, occ = carry
        return jnp.any((node >= 0) & ~occ)

    def body(carry):
        node, occluded = carry
        active = (node >= 0) & ~occluded
        nd = jnp.maximum(node, 0)

        box_hit, box_t = ray_aabb_entry(origin, inv_dir, scene.node_min[nd],
                                        scene.node_max[nd])
        enter = active & box_hit & (box_t < limit)
        is_leaf = scene.node_count[nd] > 0

        _t, _idx, any_valid = _leaf_intersect(
            scene, nd, origin, direction, limit, alpha_test)
        occluded = occluded | (enter & is_leaf & any_valid)

        descend = enter & ~is_leaf
        nxt = jnp.where(descend, nd + 1, scene.node_skip[nd])
        node = jnp.where(active, nxt, node)
        return node, occluded

    _, occluded = jax.lax.while_loop(cond, body, (node, occluded))
    return jax.lax.stop_gradient(occluded)
