"""XLA cluster walk: the threaded cluster BVH walked with one-hot
selection, the CPU's default traversal.

The companion to `accel/cluster.py`. Rays walk the threaded top-level
BVH in lockstep; node records are per-lane gathers and a leaf's
cluster of triangles is selected by a one-hot matmul:

- leaf triangles:   onehot(cluster, C) @ [v0 | e1 | e2]
- K-wide Möller–Trumbore per ray

Rays are processed in tiles of TILE to bound the (TILE, C) one-hot
intermediates; `lax.map` sequences tiles inside one jit. It walks the
same tables in the same order as the GPU kernel (ops/traverse_kernel.py)
and so returns the same hits, which makes it the kernel's reference on
the CPU. On the GPU it is far slower than the kernel (PERF.md).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from dustraytracer.accel.cluster import ClusterBvh
from dustraytracer.ops.intersect import TRIANGLE_EPSILON, varying_zero

BIG = 3.4e38  # python float, NOT jnp: captured jnp arrays become hoisted
# constants that the jit fastpath mishandles (buffer-count crashes)
TILE = 512


def _onehot_f32(idx, m):
    ids = jax.lax.broadcasted_iota(jnp.int32, (idx.shape[0], m), 1)
    return (ids == idx[:, None]).astype(jnp.float32)


def _mt_cluster(origin, direction, v0, e1, e2):
    """Möller–Trumbore on (T, K) pre-gathered cluster triangles.
    origin/direction: (T, 3); v0/e1/e2: (T, K, 3)."""
    d = direction[:, None, :]
    o = origin[:, None, :]
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    parallel = jnp.abs(det) < TRIANGLE_EPSILON
    inv_det = 1.0 / jnp.where(parallel, 1.0, det)
    tvec = o - v0
    u = inv_det * jnp.sum(tvec * pvec, axis=-1)
    qvec = jnp.cross(tvec, e1)
    v = inv_det * jnp.sum(d * qvec, axis=-1)
    t = inv_det * jnp.sum(e2 * qvec, axis=-1)
    valid = (~parallel) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) \
        & (u + v <= 1.0) & (t > TRIANGLE_EPSILON)
    return valid, t, u, v


def _traverse_tile(cb: ClusterBvh, origin, direction, anyhit: bool,
                   t_limit=None, cutout=None):
    """Walk one tile of rays to completion. Returns (hit_t, hit_idx,
    visits). `cutout`: see traverse_cluster. Node records are per-lane
    gathers; the cluster-triangle fetch is a one-hot matmul.
    """
    tsize = origin.shape[0]
    c = cb.v0.shape[0]
    k = cb.k
    inv_dir = 1.0 / direction
    vz = varying_zero(origin)  # vma-consistent carry init under shard_map
    vzi = vz.astype(jnp.int32)
    limit = jnp.broadcast_to(BIG if t_limit is None else t_limit,
                             (tsize,)) + vz

    tri_tab = jnp.concatenate(
        [cb.v0.reshape(c, k * 3), cb.e1.reshape(c, k * 3),
         cb.e2.reshape(c, k * 3)], axis=1)  # (C, 9K)

    node = vzi
    hit_t = limit
    hit_idx = vzi - 1
    visits = vzi

    def cond(carry):
        node, _t, _i, _v, done = carry
        return jnp.any((node >= 0) & ~done)

    def body(carry):
        node, hit_t, hit_idx, visits, done = carry
        active = (node >= 0) & ~done
        nd = jnp.maximum(node, 0)
        visits = visits + active.astype(jnp.int32)

        bmin = cb.node_min[nd]
        bmax = cb.node_max[nd]
        skip = cb.node_skip[nd]
        cluster = cb.node_cluster[nd]
        is_leaf = cluster >= 0

        # --- slab test ---
        t0 = (bmin - origin) * inv_dir
        t1 = (bmax - origin) * inv_dir
        tmin = jnp.fmin(t0, t1)
        tmax = jnp.fmax(t0, t1)
        t_enter = jnp.maximum(jnp.max(tmin, axis=-1), 0.0)
        t_exit = jnp.min(tmax, axis=-1)
        box_hit = (t_enter <= t_exit) & (t_exit >= 0.0)
        enter = active & box_hit & (t_enter < hit_t)

        # --- leaf: one-hot cluster fetch + K-wide MT ---
        oh_c = _onehot_f32(jnp.where(enter & is_leaf, cluster, -1), c)
        rows = jnp.dot(oh_c, tri_tab,
                       preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)  # (T, 9K)
        v0 = rows[:, 0:3 * k].reshape(tsize, k, 3)
        e1 = rows[:, 3 * k:6 * k].reshape(tsize, k, 3)
        e2 = rows[:, 6 * k:9 * k].reshape(tsize, k, 3)
        valid, t, u, v = _mt_cluster(origin, direction, v0, e1, e2)
        # padding clusters (all-zero rows from onehot of -1) give det=0 ->
        # invalid; real padding tris likewise
        valid = valid & (enter & is_leaf)[:, None] & (t < hit_t[:, None])
        # original tri id via the same one-hot (tri_idx table row fetch;
        # padding slots carry -1)
        idx_rows = jnp.dot(oh_c, cb.tri_idx.astype(jnp.float32),
                           preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
        if cutout is not None:
            # lazy: render/ imports this module
            from dustraytracer.render.texture import cutout_opaque

            valid = valid & cutout_opaque(
                cutout, jnp.maximum(idx_rows, 0), jnp.where(valid, u, 0.0),
                jnp.where(valid, v, 0.0))
        t_masked = jnp.where(valid, t, BIG)
        lane = jnp.argmin(t_masked, axis=1)
        r = jnp.arange(tsize)
        best_t = t_masked[r, lane]
        best_idx = idx_rows[r, lane]
        improve = (best_t < hit_t) & (best_idx >= 0)
        hit_t = jnp.where(improve, best_t, hit_t)
        hit_idx = jnp.where(improve, best_idx, hit_idx)
        if anyhit:
            done = done | improve

        # --- threaded step ---
        descend = enter & ~is_leaf
        nxt = jnp.where(descend, nd + 1, skip)
        node = jnp.where(active, nxt, node)
        return node, hit_t, hit_idx, visits, done

    done0 = vz != 0.0
    _, hit_t, hit_idx, visits, _ = jax.lax.while_loop(
        cond, body, (node, hit_t, hit_idx, visits, done0))
    return hit_t, hit_idx, visits


@partial(jax.jit, static_argnames=("anyhit",))
def traverse_cluster(cb: ClusterBvh, origin, direction, *,
                     anyhit: bool = False, t_max=None, cutout=None):
    """Closest-hit (or any-hit) traversal over the cluster BVH.

    Same contract as ops/traverse.py's traverse_closest: returns dict with
    stop-gradiented `hit_idx`, `t`, `visits` ((N,) each). With
    anyhit=True, `hit_idx >= 0` means occluded (first accepted hit; not
    necessarily closest). `cutout`: None, or the Scene whose
    albedo-texture alpha cuts out candidate hits (render/texture.py
    cutout_opaque), as the gather walk's alpha_test does.
    """

    n = origin.shape[0]
    pad = (-n) % TILE
    o = jnp.concatenate([origin, jnp.ones((pad, 3))], axis=0)
    d = jnp.concatenate([direction, jnp.ones((pad, 3))], axis=0)
    o_t = o.reshape(-1, TILE, 3)
    d_t = d.reshape(-1, TILE, 3)

    def run(args):
        ot, dt = args
        return _traverse_tile(cb, ot, dt, anyhit, t_limit=t_max,
                              cutout=cutout)

    hit_t, hit_idx, visits = jax.lax.map(run, (o_t, d_t))
    stop = jax.lax.stop_gradient
    return {
        "hit_idx": stop(hit_idx.reshape(-1)[:n]),
        "t": stop(hit_t.reshape(-1)[:n]),
        "visits": stop(visits.reshape(-1)[:n]),
    }
