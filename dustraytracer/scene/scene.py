"""Scene data model: flat SoA arrays, static shapes, jit-friendly.

The reference stores an AoS triangle soup of full `Triangle` structs in
thrust device vectors plus a `SceneData` POD of raw pointers
(`DustRayTracer/src/Core/Scene/Scene.cuh:19-57`,
`Triangle.cuh:7-19`). The data model here is structure-of-arrays:
each attribute is one padded, statically-shaped jnp array so the
vectorized traversal/shading path gathers contiguous lanes instead of
chasing struct pointers.

`Scene` is a registered dataclass pytree: array leaves flow through
jit/grad/shard, while counts and pad sizes are static aux data (shape
metadata must be trace-time constant under XLA).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import jax
import numpy as np
import jax.numpy as jnp

from dustraytracer.scene.gltf import GltfDocument, load_gltf

# Leaf gathers read MAX_LEAF triangles per visited leaf node in one
# vectorized step; the builder enforces leaf size <= MAX_LEAF. The
# reference used a scalar loop over up to 20 prims per leaf
# (`EditorLayer.cpp:53`); small power-of-two leaves vectorize better.
MAX_LEAF = 8


def _pad_to(arr: np.ndarray, n: int, fill=0.0) -> np.ndarray:
    if arr.shape[0] >= n:
        return arr[:n]
    pad = np.full((n - arr.shape[0],) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad], axis=0)


@jax.tree_util.register_dataclass
@dataclass
class Scene:
    """Flat device scene. All arrays are padded to static sizes.

    Triangle attrs mirror the reference `Triangle`/`Vertex` PODs
    (`Triangle.cuh:7-19`, `Vertex.cuh:4-12`) as SoA; BVH nodes mirror
    `BVHNode` (`BVHNode.cuh:14-43`) as SoA; materials mirror `Material`
    (`Material.cuh:4-23`); textures are a padded stack standing in for
    the reference's per-texture managed buffers (`Texture.cuh:4-20`).
    """

    # --- triangles (P = padded count) ---
    tri_pos: jax.Array  # (P, 3, 3) f32   corner positions
    tri_nrm: jax.Array  # (P, 3, 3) f32   corner shading normals
    tri_uv: jax.Array   # (P, 3, 2) f32   corner UVs
    tri_face_nrm: jax.Array  # (P, 3) f32  geometric normal (orientation-fixed)
    tri_mat: jax.Array  # (P,) i32        material index

    # --- BVH (M = padded node count; DFS pre-order with skip links;
    #     leaf iff count > 0; first child of internal node i is i+1) ---
    node_min: jax.Array    # (M, 3) f32
    node_max: jax.Array    # (M, 3) f32
    node_left: jax.Array   # (M,) i32  left child (internal nodes)
    node_right: jax.Array  # (M,) i32  right child
    node_first: jax.Array  # (M,) i32  first primitive (leaves)
    node_count: jax.Array  # (M,) i32  primitive count (leaves); 0 = internal
    node_skip: jax.Array   # (M,) i32  pre-order escape link (-1 = done)

    # --- materials (K entries) ---
    mat_albedo: jax.Array     # (K, 3) f32
    mat_emissive: jax.Array   # (K, 3) f32
    mat_metallic: jax.Array   # (K,) f32
    mat_roughness: jax.Array  # (K,) f32
    mat_albedo_tex: jax.Array  # (K,) i32  texture index or -1
    # glass (parity with the reference's declared-but-never-shaded
    # Material::Transmission / refractive_index, Material.cuh:10-22)
    mat_transmission: jax.Array  # (K,) f32
    mat_ior: jax.Array           # (K,) f32

    # --- textures (T, H, W, 4) uint8 stack, per-texture true dims ---
    tex_stack: jax.Array  # (T, H, W, 4) u8
    tex_hw: jax.Array     # (T, 2) i32  (height, width)
    tex_has_alpha: jax.Array  # (T,) bool  any texel alpha < 255

    # --- optional gather-free acceleration tables (accel/cluster.py) ---
    cluster: object = None  # ClusterBvh | None (pytree child)

    # --- static refit plan for the threaded BVH boxes (accel/bvh.py
    #     refit_plan): flat sparse-table indices so Scene.replace can
    #     re-derive node_min/node_max from live vertices ---
    bvh_range_a: jax.Array | None = None  # (n_nodes,) i32
    bvh_range_b: jax.Array | None = None  # (n_nodes,) i32
    bvh_levels: int = field(metadata=dict(static=True), default=0)

    # --- static metadata (aux; not traced) ---
    n_tris: int = field(metadata=dict(static=True), default=0)
    n_nodes: int = field(metadata=dict(static=True), default=0)
    n_materials: int = field(metadata=dict(static=True), default=0)
    n_textures: int = field(metadata=dict(static=True), default=0)
    bvh_depth: int = field(metadata=dict(static=True), default=0)
    # per-mesh breakdown for the editor stats panel (objects/mesh names,
    # `EditorLayer.cpp:59-67`); tuples so the pytree aux stays hashable
    mesh_names: tuple = field(metadata=dict(static=True), default=())
    mesh_tri_counts: tuple = field(metadata=dict(static=True), default=())

    def replace(self, **kw) -> "Scene":
        """dataclasses.replace, with one guard: replacing `tri_pos` on a
        scene that carries baked cluster tables RE-BAKES them (jit-safe
        refit, accel/cluster.py) unless the caller passes `cluster`
        explicitly. Without this, a vertex-perturbed scene silently
        rendered the OLD geometry on the sweep/cluster fast path while
        the gather walk saw the new — the round-4 stale-table footgun
        (tests dodged it by forcing traversal='gather')."""
        if ("tri_pos" in kw and "cluster" not in kw
                and self.cluster is not None):
            if self.cluster.refit_a is None:
                raise ValueError(
                    "replacing tri_pos on a scene whose cluster tables "
                    "have no refit plan (refit_a=None) would leave "
                    "them stale; pass cluster=... explicitly")
            from dustraytracer.accel.cluster import refit_cluster_bvh

            kw = dict(kw, cluster=refit_cluster_bvh(self.cluster,
                                                    kw["tri_pos"]))
        if ("tri_pos" in kw and "node_min" not in kw
                and self.bvh_range_a is not None and self.bvh_levels):
            # the threaded BVH's boxes (gather-walk path) refit too —
            # live triangles under stale boxes can MISS hits near the
            # moved geometry (accel/bvh.py refit_bvh_boxes)
            from dustraytracer.accel.bvh import refit_bvh_boxes

            nm, nx = refit_bvh_boxes(
                kw["tri_pos"], self.node_min, self.node_max,
                levels=self.bvh_levels, range_a=self.bvh_range_a,
                range_b=self.bvh_range_b, n_tris=self.n_tris,
                n_nodes=self.n_nodes)
            kw = dict(kw, node_min=nm, node_max=nx)
        return dataclasses.replace(self, **kw)

    @property
    def stats(self) -> dict:
        """Scene statistics panel parity (`EditorLayer.cpp:59-67,167-199`):
        triangle/object/material/texture counts plus the per-mesh table the
        reference shows in its Objects panel."""
        return {
            "triangles": self.n_tris,
            "objects": len(self.mesh_names),
            "bvh_nodes": self.n_nodes,
            "bvh_depth": self.bvh_depth,
            "materials": self.n_materials,
            "textures": self.n_textures,
            "meshes": [
                {"name": nm, "triangles": ct}
                for nm, ct in zip(self.mesh_names, self.mesh_tri_counts)
            ],
        }


def _face_normals(pos: np.ndarray, nrm: np.ndarray) -> np.ndarray:
    """Geometric normals with the reference's orientation rule
    (`Scene.cu:270-302`): cross(e1, e2) normalized, flipped to agree with
    the average vertex normal when they disagree."""
    e1 = pos[:, 1] - pos[:, 0]
    e2 = pos[:, 2] - pos[:, 0]
    fn = np.cross(e1, e2)
    ln = np.linalg.norm(fn, axis=-1, keepdims=True)
    fn = fn / np.maximum(ln, 1e-20)
    avg = nrm.mean(axis=1)
    flip = (fn * avg).sum(-1) < 0.0
    fn[flip] = -fn[flip]
    return fn.astype(np.float32)


def build_scene(doc: GltfDocument, leaf_target: int = MAX_LEAF,
                bins: int = 16, use_native: bool = True,
                cluster_k="auto") -> Scene:
    """Flatten a GltfDocument into a Scene: triangle soup, BVH, materials,
    texture stack. BVH construction reorders the soup so leaves reference
    contiguous ranges (same strategy as `BVHBuilder.cu:175-214`)."""
    from dustraytracer.accel.bvh import build_bvh

    prims = doc.primitives
    if not prims:
        raise ValueError("scene has no triangle primitives")
    mesh_names = tuple(name for name, _ in doc.meshes)
    mesh_tri_counts = tuple(
        int(sum(p.positions.shape[0] for p in mesh_prims))
        for _, mesh_prims in doc.meshes)

    pos = np.concatenate([p.positions for p in prims], axis=0)
    nrm = np.concatenate([p.normals for p in prims], axis=0)
    uv = np.concatenate([p.uvs for p in prims], axis=0)
    mat = np.concatenate(
        [np.full(p.positions.shape[0], max(p.material, 0), np.int32) for p in prims])

    # Some exports have zero normals; replace with face normals pre-fix.
    zero_n = np.linalg.norm(nrm.reshape(-1, 3), axis=-1) < 1e-12
    if zero_n.any():
        e1 = pos[:, 1] - pos[:, 0]
        e2 = pos[:, 2] - pos[:, 0]
        fn = np.cross(e1, e2)
        fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
        rep = np.repeat(fn[:, None, :], 3, axis=1).reshape(-1, 3)
        nrm = nrm.reshape(-1, 3)
        nrm[zero_n] = rep[zero_n]
        nrm = nrm.reshape(-1, 3, 3)

    face_nrm = _face_normals(pos, nrm)

    n_tris = pos.shape[0]
    leaf_target = min(leaf_target, MAX_LEAF)
    bvh = build_bvh(pos, leaf_target=leaf_target, bins=bins, use_native=use_native)
    perm = bvh.perm
    pos, nrm, uv, mat, face_nrm = (pos[perm], nrm[perm], uv[perm], mat[perm],
                                   face_nrm[perm])

    # Pad triangles so a MAX_LEAF-wide gather from the last leaf stays in
    # bounds, and to a multiple of 8 for clean sublane tiling.
    P = ((n_tris + MAX_LEAF + 7) // 8) * 8
    pos_p = _pad_to(pos.astype(np.float32), P)
    nrm_p = _pad_to(nrm.astype(np.float32), P)
    uv_p = _pad_to(uv.astype(np.float32), P)
    mat_p = _pad_to(mat.astype(np.int32), P)
    fn_p = _pad_to(face_nrm, P)

    # --- materials ---
    mats = doc.materials or []
    K = max(len(mats), 1)
    albedo = np.ones((K, 3), np.float32)
    emissive = np.zeros((K, 3), np.float32)
    metallic = np.zeros(K, np.float32)
    roughness = np.ones(K, np.float32)
    alb_tex = np.full(K, -1, np.int32)
    transmission = np.zeros(K, np.float32)
    ior = np.full(K, 1.5, np.float32)
    for i, m in enumerate(mats):
        albedo[i] = m.base_color
        emissive[i] = m.emissive
        metallic[i] = m.metallic
        roughness[i] = m.roughness
        alb_tex[i] = m.base_color_texture
        transmission[i] = m.transmission
        ior[i] = m.ior

    # --- textures: pad the image list to one (T, H, W, 4) stack ---
    images = doc.images or []
    if images:
        H = max(im.shape[0] for im in images)
        W = max(im.shape[1] for im in images)
        T = len(images)
        stack = np.zeros((T, H, W, 4), np.uint8)
        hw = np.zeros((T, 2), np.int32)
        has_alpha = np.zeros(T, bool)
        for i, im in enumerate(images):
            stack[i, : im.shape[0], : im.shape[1]] = im
            hw[i] = (im.shape[0], im.shape[1])
            has_alpha[i] = bool((im[..., 3] < 255).any())
    else:
        stack = np.full((1, 1, 1, 4), 255, np.uint8)
        hw = np.ones((1, 2), np.int32)
        has_alpha = np.zeros(1, bool)

    cluster = None
    if cluster_k == "auto":
        # triangles per cluster leaf for the GPU traversal kernel: on
        # the 100k-triangle generated courtyard, K=2 renders faster than
        # K=4, 8, 16, 32 and 64 (PERF.md)
        cluster_k = 2
    if cluster_k:
        from dustraytracer.accel.cluster import build_cluster_bvh

        cluster = build_cluster_bvh(pos_p, k=cluster_k, bins=bins)

    # static refit plan for the threaded node boxes (Scene.replace)
    from dustraytracer.accel.bvh import refit_plan

    bvh_levels, range_a, range_b, plan_n = refit_plan(
        bvh.node_first, bvh.node_count, bvh.node_skip, bvh.n_nodes)
    assert plan_n == n_tris, (plan_n, n_tris)

    return Scene(
        cluster=cluster,
        tri_pos=jnp.asarray(pos_p),
        tri_nrm=jnp.asarray(nrm_p),
        tri_uv=jnp.asarray(uv_p),
        tri_face_nrm=jnp.asarray(fn_p),
        tri_mat=jnp.asarray(mat_p),
        node_min=jnp.asarray(bvh.node_min),
        node_max=jnp.asarray(bvh.node_max),
        node_left=jnp.asarray(bvh.node_left),
        node_right=jnp.asarray(bvh.node_right),
        node_first=jnp.asarray(bvh.node_first),
        node_count=jnp.asarray(bvh.node_count),
        node_skip=jnp.asarray(bvh.node_skip),
        mat_albedo=jnp.asarray(albedo),
        mat_emissive=jnp.asarray(emissive),
        mat_metallic=jnp.asarray(metallic),
        mat_roughness=jnp.asarray(roughness),
        mat_albedo_tex=jnp.asarray(alb_tex),
        mat_transmission=jnp.asarray(transmission),
        mat_ior=jnp.asarray(ior),
        tex_stack=jnp.asarray(stack),
        tex_hw=jnp.asarray(hw),
        tex_has_alpha=jnp.asarray(has_alpha),
        bvh_range_a=jnp.asarray(range_a),
        bvh_range_b=jnp.asarray(range_b),
        bvh_levels=bvh_levels,
        n_tris=int(n_tris),
        n_nodes=int(bvh.n_nodes),
        n_materials=len(mats),
        n_textures=len(images),
        bvh_depth=int(bvh.depth),
        mesh_names=mesh_names,
        mesh_tri_counts=mesh_tri_counts,
    )


def load_scene(path, **kw) -> Scene:
    """One-call ingest: glTF file -> device Scene (parity with
    `Scene::loadGLTFmodel`, `Scene.cu:181`)."""
    return build_scene(load_gltf(path), **kw)
