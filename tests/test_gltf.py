"""glTF ingest tests — parity surface of `Scene.cu:22-178` plus the fixed
index-width and node-transform bugs."""

import io
import json
import struct

import numpy as np
import pytest

from dustraytracer.scene.gltf import load_gltf

def _glb(gltf: dict, bin_data: bytes) -> bytes:
    """Pack a glTF JSON dict and its BIN chunk into GLB bytes."""
    jbytes = json.dumps(gltf).encode()
    jbytes += b" " * (-len(jbytes) % 4)
    bin_data = bin_data + b"\x00" * (-len(bin_data) % 4)
    glb = struct.pack("<III", 0x46546C67, 2,
                      12 + 8 + len(jbytes) + 8 + len(bin_data))
    glb += struct.pack("<II", len(jbytes), 0x4E4F534A) + jbytes
    glb += struct.pack("<II", len(bin_data), 0x004E4942) + bin_data
    return glb


_TRI = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)


def _tri_gltf(extra_nodes=None, **top):
    nodes = extra_nodes or [{"mesh": 0}]
    out = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0]}], "nodes": nodes,
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                    "material": 1}]}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3,
                       "type": "VEC3"}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0,
                         "byteLength": _TRI.nbytes}],
        "buffers": [{"byteLength": _TRI.nbytes}],
    }
    out.update(top)
    return out


def test_load_glb_materials_and_embedded_image(tmp_path):
    """Materials (baseColorFactor, baseColorTexture through the
    texture -> image indirection) and a PNG embedded in the BIN chunk
    (`Scene.cu:59-117` parity)."""
    pytest.importorskip("PIL")
    from dustraytracer.utils.image import encode_png

    img = np.zeros((4, 6, 4), np.uint8)
    img[..., 0] = 200
    img[..., 3] = 255
    img[0, 0, 3] = 0
    png = encode_png(img)
    gltf = _tri_gltf(
        materials=[{"pbrMetallicRoughness": {
                       "baseColorFactor": [1, 0, 0, 1]}},
                   {"pbrMetallicRoughness": {
                       "baseColorTexture": {"index": 0}}}],
        textures=[{"source": 0}],
        images=[{"bufferView": 1, "mimeType": "image/png"}])
    gltf["bufferViews"].append({"buffer": 0, "byteOffset": _TRI.nbytes,
                                "byteLength": len(png)})
    gltf["buffers"][0]["byteLength"] = _TRI.nbytes + len(png)
    p = tmp_path / "mat.glb"
    p.write_bytes(_glb(gltf, _TRI.tobytes() + png))
    doc = load_gltf(p)
    assert doc.triangle_count == 1
    assert len(doc.materials) == 2 and len(doc.images) == 1
    np.testing.assert_array_equal(doc.images[0], img)
    assert np.allclose(doc.materials[0].base_color, [1, 0, 0])
    assert doc.materials[1].base_color_texture == 0
    assert doc.primitives[0].material == 1


def test_load_gltf_ascii_with_external_bin(tmp_path):
    """.gltf JSON with its buffer in a separate .bin file."""
    gltf = _tri_gltf(materials=[{}, {}])
    gltf["buffers"][0]["uri"] = "tri.bin"
    (tmp_path / "tri.bin").write_bytes(_TRI.tobytes())
    (tmp_path / "tri.gltf").write_text(json.dumps(gltf))
    doc = load_gltf(tmp_path / "tri.gltf")
    assert doc.triangle_count == 1
    np.testing.assert_allclose(doc.primitives[0].positions[0], _TRI)


def test_scene_hierarchy_transforms(tmp_path):
    """A child node's transform composes with its parent's: the mesh is
    scaled by the child, then translated by the parent."""
    nodes = [{"children": [1], "translation": [0, 0, -3]},
             {"mesh": 0, "scale": [2, 2, 2]}]
    gltf = _tri_gltf(extra_nodes=nodes, materials=[{}, {}])
    p = tmp_path / "hier.glb"
    p.write_bytes(_glb(gltf, _TRI.tobytes()))
    doc = load_gltf(p)
    np.testing.assert_allclose(doc.primitives[0].positions[0],
                               _TRI * 2 + [0, 0, -3])


@pytest.mark.parametrize("itype,iwidth", [(5121, "B"), (5123, "H"), (5125, "I")])
def test_index_component_types(tmp_path, itype, iwidth):
    """The reference assumed uint16 indices (`Scene.cu:161-171`); we accept
    u8/u16/u32. Build a one-triangle GLB for each width."""
    positions = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    indices = np.array([0, 1, 2])
    ibytes = struct.pack(f"<3{iwidth}", *indices)
    ibytes += b"\x00" * (-len(ibytes) % 4)
    pbytes = positions.tobytes()
    bin_data = pbytes + ibytes

    gltf = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0}, "indices": 1}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": itype, "count": 3,
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(pbytes)},
            {"buffer": 0, "byteOffset": len(pbytes), "byteLength": len(ibytes)},
        ],
        "buffers": [{"byteLength": len(bin_data)}],
    }
    jbytes = json.dumps(gltf).encode()
    jbytes += b" " * (-len(jbytes) % 4)
    glb = struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(jbytes) + 8 + len(bin_data))
    glb += struct.pack("<II", len(jbytes), 0x4E4F534A) + jbytes
    glb += struct.pack("<II", len(bin_data), 0x004E4942) + bin_data

    p = tmp_path / "tri.glb"
    p.write_bytes(glb)
    doc = load_gltf(p)
    assert doc.triangle_count == 1
    np.testing.assert_allclose(doc.primitives[0].positions[0], positions)


def test_node_transform_applied(tmp_path):
    """Translation node transform must move vertices (reference ignored
    node transforms entirely)."""
    positions = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    pbytes = positions.tobytes()
    gltf = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [5, 0, 0],
                   "scale": [2, 2, 2]}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3,
                       "type": "VEC3"}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0,
                         "byteLength": len(pbytes)}],
        "buffers": [{"byteLength": len(pbytes)}],
    }
    jbytes = json.dumps(gltf).encode()
    jbytes += b" " * (-len(jbytes) % 4)
    glb = struct.pack("<III", 0x46546C67, 2,
                      12 + 8 + len(jbytes) + 8 + len(pbytes))
    glb += struct.pack("<II", len(jbytes), 0x4E4F534A) + jbytes
    glb += struct.pack("<II", len(pbytes), 0x004E4942) + pbytes
    p = tmp_path / "t.glb"
    p.write_bytes(glb)
    doc = load_gltf(p)
    np.testing.assert_allclose(doc.primitives[0].positions[0],
                               positions * 2 + [5, 0, 0])


def test_sparse_accessor_position_overlay(tmp_path):
    """glTF sparse accessors (§3.6.2.4): base + index/value overlay.
    tinygltf resolves these transparently for the reference
    (`Scene.cu:22-57`); round 4 raised NotImplementedError. The fixture
    overlays 2 of 4 base positions (one triangle pair), exercising both
    the bufferView base and the replacement path."""
    base = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [9, 9, 9]],
                    np.float32)
    sparse_rows = np.array([1, 3], np.uint16)
    sparse_vals = np.array([[2, 0, 0], [0, 0, 5]], np.float32)
    indices = np.array([0, 1, 2, 0, 2, 3], np.uint16)

    pbytes = base.tobytes()
    rbytes = sparse_rows.tobytes()
    vbytes = sparse_vals.tobytes()
    ibytes = indices.tobytes()
    bin_data = pbytes + rbytes + vbytes + ibytes
    off_r = len(pbytes)
    off_v = off_r + len(rbytes)
    off_i = off_v + len(vbytes)

    gltf = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0}, "indices": 1}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3",
             "sparse": {
                 "count": 2,
                 "indices": {"bufferView": 1, "componentType": 5123},
                 "values": {"bufferView": 2},
             }},
            {"bufferView": 3, "componentType": 5123, "count": 6,
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(pbytes)},
            {"buffer": 0, "byteOffset": off_r, "byteLength": len(rbytes)},
            {"buffer": 0, "byteOffset": off_v, "byteLength": len(vbytes)},
            {"buffer": 0, "byteOffset": off_i, "byteLength": len(ibytes)},
        ],
        "buffers": [{"byteLength": len(bin_data)}],
    }
    jbytes = json.dumps(gltf).encode()
    jbytes += b" " * (-len(jbytes) % 4)
    glb = struct.pack("<III", 0x46546C67, 2,
                      12 + 8 + len(jbytes) + 8 + len(bin_data))
    glb += struct.pack("<II", len(jbytes), 0x4E4F534A) + jbytes
    glb += struct.pack("<II", len(bin_data), 0x004E4942) + bin_data
    p = tmp_path / "sparse.glb"
    p.write_bytes(glb)

    doc = load_gltf(p)
    assert doc.triangle_count == 2
    expect = base.copy()
    expect[1] = [2, 0, 0]
    expect[3] = [0, 0, 5]
    got = doc.primitives[0].positions  # (2, 3, 3) corner positions
    np.testing.assert_allclose(got[0], expect[indices[:3].astype(int)])
    np.testing.assert_allclose(got[1], expect[indices[3:].astype(int)])
