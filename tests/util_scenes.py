"""Synthetic scene builders for tests — no file IO, tiny and exact."""

from __future__ import annotations

import numpy as np

from dustraytracer.scene.generate import make_quad  # noqa: F401
from dustraytracer.scene.gltf import GltfDocument, GltfMaterial, GltfPrimitive
from dustraytracer.scene.scene import Scene, build_scene


def make_tri_scene() -> Scene:
    """Two quads: a ground plane and a small wall, two materials."""
    doc = GltfDocument(
        meshes=[
            ("ground", [make_quad((0, 0, 0), 10, axis=1, mat=0)]),
            ("wall", [make_quad((0, 1, -2), 2, axis=2, mat=1)]),
        ],
        materials=[
            GltfMaterial(name="ground", base_color=np.array([0.8, 0.8, 0.8],
                                                            np.float32)),
            GltfMaterial(name="wall", base_color=np.array([0.9, 0.2, 0.2],
                                                          np.float32)),
        ],
        images=[],
        cameras=[],
    )
    return build_scene(doc, use_native=False)


def make_random_tri_doc(n_tris: int, seed=0) -> GltfDocument:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, (n_tris, 1, 3))
    offsets = rng.normal(0, 0.3, (n_tris, 3, 3))
    pos = (centers + offsets).astype(np.float32)
    nrm = np.zeros_like(pos)
    uvs = rng.uniform(0, 1, (n_tris, 3, 2)).astype(np.float32)
    prim = GltfPrimitive(positions=pos, normals=nrm, uvs=uvs, material=0)
    return GltfDocument(meshes=[("soup", [prim])],
                        materials=[GltfMaterial()], images=[], cameras=[])


def make_glass_panes_scene() -> Scene:
    """Deterministic synthetic glass fixture for the golden harness
    ("synthetic:glass_panes"): a tilted glass pane (transmission 0.85,
    ior 1.5) in front of a red emissive wall over a grey ground — covers
    refraction, Fresnel reflection and colored-throughput paths that no
    bundled reference scene reaches (the reference parses Transmission/
    ior but never shades them, Material.cuh:10-22)."""
    pane = make_quad((0, 1.2, -0.8), 2.2, axis=2, mat=0)
    pane_pos = pane.positions.copy()
    # tilt the pane 20 deg about X so Fresnel varies across it
    c, s = np.cos(np.radians(20)), np.sin(np.radians(20))
    y = pane_pos[..., 1] - 1.2
    z = pane_pos[..., 2] + 0.8
    pane_pos[..., 1] = 1.2 + c * y - s * z
    pane_pos[..., 2] = -0.8 + s * y + c * z
    pane = GltfPrimitive(positions=pane_pos, normals=pane.normals,
                         uvs=pane.uvs, material=0)
    doc = GltfDocument(
        meshes=[
            ("pane", [pane]),
            ("wall", [make_quad((0, 1.5, -3), 6, axis=2, mat=1)]),
            ("ground", [make_quad((0, 0, 0), 12, axis=1, mat=2)]),
        ],
        materials=[
            GltfMaterial(name="glass", base_color=np.array(
                [0.95, 0.98, 1.0], np.float32), roughness=0.0,
                transmission=0.85, ior=1.5),
            GltfMaterial(name="wall", base_color=np.zeros(3, np.float32),
                         emissive=np.array([3.5, 0.4, 0.4], np.float32),
                         roughness=1.0),
            GltfMaterial(name="ground", base_color=np.array(
                [0.55, 0.55, 0.55], np.float32), roughness=1.0),
        ],
        images=[], cameras=[])
    return build_scene(doc, use_native=False)


def make_cornell_scene() -> Scene:
    """The generated cornell box ("synthetic:cornell" goldens)."""
    from dustraytracer.scene.generate import cornell_box_doc

    return build_scene(cornell_box_doc())


def make_courtyard_small_scene() -> Scene:
    """A small cut of the generated courtyard: every mechanism of the
    full scene (16 textures, alpha cutout foliage, glass, emitter) at a
    few thousand triangles ("synthetic:courtyard_small" goldens)."""
    from dustraytracer.scene.generate import courtyard_doc

    return build_scene(courtyard_doc(0, detail=0.15, tex_size=32))


def with_alpha_texture(scene: Scene, seed=0) -> Scene:
    """`scene` with every material textured by one random 8x8 RGBA
    texture whose alpha is 0, 128 or 255 per texel (only 255 is opaque
    to the alpha test)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 256, (1, 8, 8, 4)).astype(np.uint8)
    tex[..., 3] = rng.choice(np.array([0, 128, 255], np.uint8), (1, 8, 8))
    n_mat = scene.mat_albedo.shape[0]
    return scene.replace(
        tex_stack=jnp.asarray(tex), tex_hw=jnp.asarray([[8, 8]], np.int32),
        tex_has_alpha=jnp.asarray([True]),
        mat_albedo_tex=jnp.zeros((n_mat,), jnp.int32))


def write_glb(doc: GltfDocument, path) -> None:
    """Write a GltfDocument as a .glb file (one node per mesh, flat
    triangle lists, textures as embedded PNGs), so the file-loading
    entry points (CLI, optimizer, multihost) can run on generated
    scenes. Reading the images back needs Pillow."""
    import json
    import struct

    from dustraytracer.utils.image import encode_png

    chunks, views, accessors, meshes = [], [], [], []
    offset = 0

    def add(data: bytes) -> int:
        nonlocal offset
        pad = b"\x00" * (-len(data) % 4)
        chunks.append(data + pad)
        views.append({"buffer": 0, "byteOffset": offset,
                      "byteLength": len(data)})
        offset += len(data) + len(pad)
        return len(views) - 1

    def accessor(arr, kind) -> int:
        arr = np.ascontiguousarray(arr, np.float32)
        accessors.append({"bufferView": add(arr.tobytes()),
                          "componentType": 5126, "count": arr.shape[0],
                          "type": kind})
        return len(accessors) - 1

    for name, prims in doc.meshes:
        out = []
        for p in prims:
            out.append({"attributes": {
                "POSITION": accessor(p.positions.reshape(-1, 3), "VEC3"),
                "NORMAL": accessor(p.normals.reshape(-1, 3), "VEC3"),
                "TEXCOORD_0": accessor(p.uvs.reshape(-1, 2), "VEC2")},
                "material": int(p.material)})
        meshes.append({"name": name, "primitives": out})
    images = [{"bufferView": add(encode_png(im)), "mimeType": "image/png"}
              for im in doc.images]
    materials = []
    for m in doc.materials:
        pbr = {"baseColorFactor": [*map(float, m.base_color), 1.0],
               "metallicFactor": float(m.metallic),
               "roughnessFactor": float(m.roughness)}
        if m.base_color_texture >= 0:
            pbr["baseColorTexture"] = {"index": int(m.base_color_texture)}
        materials.append({"pbrMetallicRoughness": pbr,
                          "emissiveFactor": [*map(float, m.emissive)]})
    gltf = {"asset": {"version": "2.0"}, "scene": 0,
            "scenes": [{"nodes": list(range(len(meshes)))}],
            "nodes": [{"mesh": i} for i in range(len(meshes))],
            "meshes": meshes, "materials": materials,
            "accessors": accessors, "bufferViews": views,
            "buffers": [{"byteLength": offset}]}
    if images:
        gltf["images"] = images
        gltf["textures"] = [{"source": i} for i in range(len(images))]
    blob = b"".join(chunks)
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2,
                            12 + 8 + len(js) + 8 + len(blob)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(blob), 0x004E4942) + blob)


def cornell_glb(directory) -> str:
    """The generated cornell box written as <directory>/cornell_box.glb."""
    import os

    from dustraytracer.scene.generate import cornell_box_doc

    path = os.path.join(str(directory), "cornell_box.glb")
    write_glb(cornell_box_doc(), path)
    return path
