"""Geometric intersection primitives, fully vectorized (any batch shape).

Branch-free re-designs of the reference's scalar device functions:
- AABB slab test: semantics of `Bounds3f::intersect`
  (`DustRayTracer/src/Core/Bounds.cu:18-41`) — NaN-guarded
  min/max ordering, entry-t clamped to 0 when the origin is inside, miss
  encoded out-of-band (the reference returns -1; we return `hit` mask +
  entry-t so downstream math never branches).
- Möller–Trumbore: semantics of `Intersection`
  (`Shaders/Intersection.cu:4-36`) — epsilon det rejection, barycentric
  bounds, t > eps, both faces accepted (no backface culling).

They run elementwise over ray/triangle batches; all comparisons become
lane masks instead of divergent branches.
"""

from __future__ import annotations

import jax.numpy as jnp


def varying_zero(ref):
    """(N,) f32 zero derived from `ref` (N, ...), carrying ref's vma type.

    Loop carries initialized from literal constants are *unvarying* under
    shard_map's varying-manual-axes checker, while the loop body computes
    varying values from the (sharded) rays — a type mismatch. Adding this
    zero to each initial carry component makes the init varying without
    changing any value, so shard_map runs with full vma checking
    (parallel/shard.py) instead of check_vma=False.
    """
    return jnp.zeros_like(ref[..., 0], dtype=jnp.float32)


TRIANGLE_EPSILON = 1e-6  # reference: physical_units.hpp:6-12


def ray_aabb_entry(origin, inv_dir, box_min, box_max):
    """Slab test. Returns (hit, t_enter) with broadcasting over any batch.

    `t_enter` is clamped to 0 when the origin is inside the box (matching
    `Bounds.cu:31-34`); `hit` is False when the slabs do not overlap or the
    box is entirely behind the ray.
    """
    t0 = (box_min - origin) * inv_dir
    t1 = (box_max - origin) * inv_dir
    # 0 * inf produces NaN when the origin lies exactly on a slab plane of
    # an axis-parallel ray; CUDA's fminf/fmaxf suppress NaNs (the behavior
    # `Bounds.cu:23-24` relies on) and jnp.fmin/fmax match that, unlike
    # jnp.minimum/maximum which propagate them.
    tmin = jnp.fmin(t0, t1)
    tmax = jnp.fmax(t0, t1)
    t_enter = jnp.max(tmin, axis=-1)
    t_exit = jnp.min(tmax, axis=-1)
    t_enter_c = jnp.maximum(t_enter, 0.0)
    hit = (t_enter_c <= t_exit) & (t_exit >= 0.0)
    return hit, t_enter_c


def moller_trumbore(origin, direction, v0, v1, v2, eps=TRIANGLE_EPSILON):
    """Möller–Trumbore ray/triangle test.

    Returns (valid, t, u, v) with barycentrics w = 1-u-v for vertex 0
    (`Intersection.cu:27-33` packs UVW = (1-u-v, u, v)). All outputs are
    differentiable w.r.t. origin/direction/vertices; `valid` should be
    treated as stop-gradient by callers.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = jnp.cross(direction, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    parallel = jnp.abs(det) < eps
    inv_det = 1.0 / jnp.where(parallel, 1.0, det)
    tvec = origin - v0
    u = inv_det * jnp.sum(tvec * pvec, axis=-1)
    qvec = jnp.cross(tvec, e1)
    v = inv_det * jnp.sum(direction * qvec, axis=-1)
    t = inv_det * jnp.sum(e2 * qvec, axis=-1)
    valid = (~parallel) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) \
        & (u + v <= 1.0) & (t > eps)
    return valid, t, u, v
