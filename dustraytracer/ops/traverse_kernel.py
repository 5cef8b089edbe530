"""Fused BVH traversal kernel for Hopper (Pallas, Triton route).

One Pallas program walks a block of BLOCK rays through the threaded
cluster BVH (`accel/cluster.py`) to completion:

    enter AABB & internal  ->  next = node + 1      (first child)
    miss AABB or leaf      ->  next = skip[node]    (escape subtree)
    next == -1             ->  ray done

A block-level `lax.while_loop` runs while any lane of the block is live,
so each block retires on its own instead of waiting for the slowest ray
of the whole batch (the plain walk, `ops/traverse.py`, steps every ray
of the wave in lockstep and re-reads its state from device memory each
step). Ray state stays in registers. Each block walks the
near-child-first threading of its rays' majority direction octant
(`accel/cluster.py` `_octant_orders`), so early hits cull the far
subtrees, as the reference's per-ray child ordering does
(`BVHTraversal.cuh:30-41`). Node boxes and cluster triangles
are per-lane gathers from device memory: one node is one 32-byte record
and one triangle one 48-byte record, so a 100k-triangle scene's tables
(a few MB) stay resident in L2.

A leaf visit tests the cluster's K triangles in order with a strict
`t < best` update, so ties resolve to the first triangle in cluster
order, the same rule as the XLA cluster walk (`ops/traverse_cluster.py`).
Closest-hit and any-hit are one kernel: any-hit ends a lane at its first
accepted hit, and `t_max` bounds both. With a cutout scene the leaf test
also applies the alpha-cutout AnyHit filter (`AnyHit.cuh:8-28`): a
candidate whose albedo texture's alpha is below 1 at the hit is rejected
and the walk goes on, as in the XLA walks.

The reference walks one ray per thread with a per-thread stack
(`BVHTraversal.cuh:14-134`); a per-lane stack does not map onto Triton's
block model, the threaded walk does.

Differentiation contract: a discrete selector. The outputs are
stop-gradient and the custom VJP returns zero cotangents; callers
recompute hit attributes differentiably from `hit_idx`
(render/integrator.py::shade_hits).
"""

from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from dustraytracer.accel.cluster import ClusterBvh
from dustraytracer.ops.intersect import TRIANGLE_EPSILON

BIG = 3.4e38  # python float, NOT jnp: captured jnp arrays become hoisted
# constants that the jit fastpath mishandles (buffer-count crashes)
FAR = 3.0e37  # padding lanes start here: the root box test ends them

# Rays per Pallas program and the warps that run them: one warp of 32
# rays measured fastest on the H100 (PERF.md), as in the reference's
# one-ray-per-thread walk
BLOCK = 32
NUM_WARPS = 1
NODE_W = 8   # [min xyz | max xyz | skip | cluster] per node
TRI_W = 12   # [v0 xyz | e1 xyz | e2 xyz | tri_idx | pad pad] per triangle
CUT_W = 8    # [uv0 | uv1 | uv2 | texture | pad] per scene triangle


def pack_tables(cb: ClusterBvh):
    """Flat per-record tables the kernel gathers from: (8*M*8,) nodes of
    the 8 per-octant threadings and (C*K*12,) triangles, f32 (ids
    < 2**24 are exact in f32)."""
    m = cb.n_nodes
    nodes = jnp.concatenate(
        [cb.oct_min[:, :m], cb.oct_max[:, :m],
         cb.oct_skip[:, :m].astype(jnp.float32)[..., None],
         cb.oct_cluster[:, :m].astype(jnp.float32)[..., None]], axis=2)
    c, k = cb.n_clusters, cb.k
    tri = jnp.concatenate(
        [cb.v0[:c].reshape(c * k, 3), cb.e1[:c].reshape(c * k, 3),
         cb.e2[:c].reshape(c * k, 3),
         cb.tri_idx[:c].reshape(c * k).astype(jnp.float32)[:, None],
         jnp.zeros((c * k, 2), jnp.float32)], axis=1)
    return nodes.reshape(-1), tri.reshape(-1)


def cutout_tables(scene):
    """The tables of the in-kernel alpha test: (T*8,) f32 records per
    scene triangle (texture -1 where its albedo texture has no alpha),
    (X*2,) i32 texture dims (h, w) and (X*H*W,) f32 texel alphas of the
    (X, H, W, 4) texture stack."""
    t_n = scene.tri_pos.shape[0]
    tex = scene.mat_albedo_tex[scene.tri_mat]
    tex = jnp.where(scene.tex_has_alpha[jnp.maximum(tex, 0)], tex, -1)
    cut = jnp.concatenate(
        [scene.tri_uv.reshape(t_n, 6), tex.astype(jnp.float32)[:, None],
         jnp.zeros((t_n, 1), jnp.float32)], axis=1)
    alpha = scene.tex_stack[..., 3].astype(jnp.float32)
    if scene.tex_stack.dtype == jnp.uint8:
        alpha = alpha * (1.0 / 255.0)  # not a division: see texture.py
    return (cut.reshape(-1), scene.tex_hw.astype(jnp.int32).reshape(-1),
            alpha.reshape(-1))


def _any(mask):
    # the Triton lowering has no reduce_or; a max over int32 is the same
    return jnp.max(mask.astype(jnp.int32)) > 0


def _opaque(cut_ref, hw_ref, alpha_ref, tex_hw, tid, u, v):
    """Alpha test of candidate hits on triangles `tid` at barycentrics
    (u, v): the point-sampled, wrapped texel fetch of render/texture.py
    sample_alpha. Every index is clamped in range, so lanes without a
    real candidate read valid memory."""
    rec = jnp.maximum(tid, 0) * CUT_W
    tex = cut_ref[rec + 6].astype(jnp.int32)
    w = 1.0 - u - v
    tu = w * cut_ref[rec] + u * cut_ref[rec + 2] + v * cut_ref[rec + 4]
    tv = w * cut_ref[rec + 1] + u * cut_ref[rec + 3] + v * cut_ref[rec + 5]
    st = jnp.maximum(tex, 0)
    h = hw_ref[st * 2]
    wd = hw_ref[st * 2 + 1]
    x = jnp.clip(((tu - jnp.floor(tu)) * wd.astype(jnp.float32))
                 .astype(jnp.int32), 0, wd - 1)
    y = jnp.clip(((tv - jnp.floor(tv)) * h.astype(jnp.float32))
                 .astype(jnp.int32), 0, h - 1)
    a = alpha_ref[(st * tex_hw[0] + y) * tex_hw[1] + x]
    return (tex < 0) | (a >= 1.0)


def _kernel(node_ref, tri_ref, ray_ref, *refs, k: int, m: int,
            anyhit: bool, tex_hw):
    # tex_hw: the texture stack's (H, W) when the cutout tables follow
    # the rays, else None
    if tex_hw is None:
        t_ref, idx_ref, vis_ref = refs
    else:
        cut_ref, hw_ref, alpha_ref, t_ref, idx_ref, vis_ref = refs
    # `+ 0.0`: under shard_map a loaded block keeps the rays' varying
    # mesh axes while values computed in the kernel carry none; the
    # loop and cond carries below must agree
    ox, oy, oz, dx, dy, dz, t_lim = (ray_ref[r, :] + 0.0 for r in range(7))
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    zero_i = jnp.zeros_like(t_lim, dtype=jnp.int32)
    # the block walks the near-child-first threading of its majority
    # direction octant (bit2 = x<0, bit1 = y<0, bit0 = z<0); any
    # threading gives the same hits, only the culling order differs
    half = t_lim.shape[0] // 2

    def neg(dc):
        return (jnp.sum((dc < 0.0).astype(jnp.int32)) > half) \
            .astype(jnp.int32)

    table = (neg(dx) * 4 + neg(dy) * 2 + neg(dz)) * (m * NODE_W)

    def node_step(carry):
        node, hit_t, hit_i, vis = carry
        active = node >= 0
        nd = table + jnp.maximum(node, 0) * NODE_W
        # slab test; fmin/fmax drop the NaN of 0 * inf (origin on a slab
        # plane of an axis-parallel ray), as CUDA's fminf/fmaxf do
        tx0 = (node_ref[nd] - ox) * ix
        ty0 = (node_ref[nd + 1] - oy) * iy
        tz0 = (node_ref[nd + 2] - oz) * iz
        tx1 = (node_ref[nd + 3] - ox) * ix
        ty1 = (node_ref[nd + 4] - oy) * iy
        tz1 = (node_ref[nd + 5] - oz) * iz
        skip = node_ref[nd + 6].astype(jnp.int32)
        cluster = node_ref[nd + 7].astype(jnp.int32)
        t_in = jnp.maximum(jnp.maximum(jnp.fmin(tx0, tx1), jnp.fmin(ty0, ty1)),
                           jnp.fmin(tz0, tz1))
        t_out = jnp.minimum(jnp.minimum(jnp.fmax(tx0, tx1),
                                        jnp.fmax(ty0, ty1)),
                            jnp.fmax(tz0, tz1))
        t_in = jnp.maximum(t_in, 0.0)
        enter = active & (t_in <= t_out) & (t_out >= 0.0) & (t_in < hit_t)
        leaf = enter & (cluster >= 0)
        base = jnp.maximum(cluster, 0) * (k * TRI_W)

        def tri_step(j, c):
            bt, bi = c
            r = base + j * TRI_W
            v0x, v0y, v0z = tri_ref[r], tri_ref[r + 1], tri_ref[r + 2]
            e1x, e1y, e1z = tri_ref[r + 3], tri_ref[r + 4], tri_ref[r + 5]
            e2x, e2y, e2z = tri_ref[r + 6], tri_ref[r + 7], tri_ref[r + 8]
            tid = tri_ref[r + 9].astype(jnp.int32)
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            par = jnp.abs(det) < TRIANGLE_EPSILON
            inv_det = 1.0 / jnp.where(par, 1.0, det)
            tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
            u = inv_det * (tvx * px + tvy * py + tvz * pz)
            qx = tvy * e1z - tvz * e1y
            qy = tvz * e1x - tvx * e1z
            qz = tvx * e1y - tvy * e1x
            v = inv_det * (dx * qx + dy * qy + dz * qz)
            t = inv_det * (e2x * qx + e2y * qy + e2z * qz)
            ok = (leaf & ~par & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
                  & (u + v <= 1.0) & (t > TRIANGLE_EPSILON) & (t < bt)
                  & (tid >= 0))
            if tex_hw is not None:
                # texel fetches only for blocks with a candidate; dead
                # lanes get finite barycentrics, so their indices stay
                # in range
                uu = jnp.where(ok, u, 0.0)
                vv = jnp.where(ok, v, 0.0)
                ok = ok & jax.lax.cond(
                    _any(ok),
                    lambda: _opaque(cut_ref, hw_ref, alpha_ref, tex_hw,
                                    tid, uu, vv),
                    lambda: ok)
            return jnp.where(ok, t, bt), jnp.where(ok, tid, bi)

        def leaf_visit(c):
            # unrolled: K is small and static
            for j in range(k):
                c = tri_step(j, c)
            return c

        new_t, new_i = jax.lax.cond(_any(leaf), leaf_visit,
                                    lambda c: c, (hit_t, hit_i))
        nxt = jnp.where(enter & (cluster < 0), node + 1, skip)
        if anyhit:
            nxt = jnp.where(new_i != hit_i, -1, nxt)
        node = jnp.where(active, nxt, node)
        return node, new_t, new_i, vis + active.astype(jnp.int32)

    def live(carry):
        return _any(carry[0] >= 0)

    _, hit_t, hit_i, vis = jax.lax.while_loop(
        live, node_step, (zero_i, t_lim, zero_i - 1, zero_i))
    t_ref[...] = hit_t
    idx_ref[...] = hit_i
    vis_ref[...] = vis


def _traverse_impl(cb: ClusterBvh, origin, direction, t_max, cutout, *,
                   anyhit: bool, interpret: bool):
    n = origin.shape[0]
    block = BLOCK
    pad = (-n) % block
    ntot = n + pad
    limit = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    rays = jnp.concatenate(
        [jnp.concatenate([origin.T, direction.T, limit[None]], axis=0),
         jnp.concatenate([jnp.full((3, pad), FAR, jnp.float32),
                          jnp.ones((3, pad), jnp.float32),
                          jnp.full((1, pad), BIG, jnp.float32)], axis=0)],
        axis=1)
    rays = jnp.concatenate([rays, jnp.zeros((1, ntot), jnp.float32)])
    nodes, tris = pack_tables(cb)
    tables = () if cutout is None else cutout[:3]
    tex_hw = None if cutout is None else cutout[3]
    # under shard_map the outputs vary over the same mesh axes as the
    # rays (the tables are replicated)
    vma = jax.typeof(rays).vma
    vec = pl.BlockSpec((block,), lambda i: (i,))
    anywhere = pl.BlockSpec(memory_space=pl.ANY)
    t, idx, vis = pl.pallas_call(
        partial(_kernel, k=cb.k, m=cb.n_nodes, anyhit=anyhit,
                tex_hw=tex_hw),
        grid=(ntot // block,),
        in_specs=[anywhere, anywhere,
                  pl.BlockSpec((8, block), lambda i: (0, i))]
        + [anywhere] * len(tables),
        out_specs=[vec, vec, vec],
        out_shape=[jax.ShapeDtypeStruct((ntot,), jnp.float32, vma=vma),
                   jax.ShapeDtypeStruct((ntot,), jnp.int32, vma=vma),
                   jax.ShapeDtypeStruct((ntot,), jnp.int32, vma=vma)],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="traverse_kernel",
    )(nodes, tris, rays, *tables)
    return t[:n], idx[:n], vis[:n]


@functools.cache
def _selector(anyhit: bool, interpret: bool, tex_hw):
    """custom_vjp wrapper: discrete selector with zero cotangents."""

    def impl(cb, origin, direction, t_max, tables):
        cutout = None if tables is None else (*tables, tex_hw)
        return _traverse_impl(cb, origin, direction, t_max, cutout,
                              anyhit=anyhit, interpret=interpret)

    @jax.custom_vjp
    def run(cb, origin, direction, t_max, tables):
        return impl(cb, origin, direction, t_max, tables)

    def fwd(cb, origin, direction, t_max, tables):
        shapes = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(jnp.shape(x), jnp.result_type(x)),
            (cb, origin, direction, t_max, tables))
        return impl(cb, origin, direction, t_max, tables), shapes

    def bwd(shapes, _g):
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    run.defvjp(fwd, bwd)
    return run


def traverse_kernel(cb: ClusterBvh, origin, direction, *,
                    anyhit: bool = False, t_max=None, cutout=None,
                    interpret: bool = False):
    """Closest-hit (or any-hit) traversal of `origin`/`direction` (N, 3).

    Same contract as traverse_cluster: a dict of stop-gradient (N,)
    arrays `hit_idx` (-1 = miss), `t` (t_max on a miss) and `visits`.
    With anyhit=True, `hit_idx >= 0` means occluded (first accepted hit,
    not necessarily the closest). `cutout`: None, or the Scene whose
    albedo-texture alpha cuts out candidate hits. `interpret=True` runs
    the kernel in the Pallas interpreter (tests on a CPU); compiled, it
    needs a GPU.
    """
    if t_max is None:
        t_max = BIG
    tables = tex_hw = None
    if cutout is not None:
        tables = cutout_tables(cutout)
        tex_hw = tuple(cutout.tex_stack.shape[1:3])
    t, idx, vis = _selector(anyhit, interpret, tex_hw)(
        cb, origin, direction, jnp.asarray(t_max, jnp.float32), tables)
    stop = jax.lax.stop_gradient
    return {"hit_idx": stop(idx), "t": stop(t), "visits": stop(vis)}
