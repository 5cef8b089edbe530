"""Seeded generated scenes and the PIL-free PNG writer."""

import struct
import zlib

import numpy as np
import pytest

from dustraytracer.scene.generate import (ALPHA_TEXTURE, EMISSIVE_MATERIAL,
                                          GLASS_MATERIAL, N_TEXTURES,
                                          cornell_box_doc, courtyard_doc)
from dustraytracer.utils.image import encode_png, save_png


def _same_doc(a, b):
    pa, pb = a.primitives, b.primitives
    return (len(pa) == len(pb)
            and all(np.array_equal(x.positions, y.positions)
                    and np.array_equal(x.uvs, y.uvs)
                    and x.material == y.material for x, y in zip(pa, pb))
            and all(np.array_equal(x, y) for x, y in zip(a.images, b.images)))


def test_courtyard_full_size_counts():
    """detail=1: about 100k triangles, 16 RGBA textures of 256^2, one
    alpha cutout texture, one emissive and one glass material."""
    doc = courtyard_doc(0)
    assert doc.triangle_count == 99_422
    assert len(doc.images) == N_TEXTURES == 16
    assert all(im.shape == (256, 256, 4) and im.dtype == np.uint8
               for im in doc.images)
    with_alpha = [i for i, im in enumerate(doc.images)
                  if (im[..., 3] < 255).any()]
    assert with_alpha == [ALPHA_TEXTURE]
    emissive = [i for i, m in enumerate(doc.materials) if m.emissive.max() > 0]
    glass = [i for i, m in enumerate(doc.materials) if m.transmission > 0]
    assert emissive == [EMISSIVE_MATERIAL] and glass == [GLASS_MATERIAL]


@pytest.mark.parametrize("detail", [0.1, 0.3])
def test_courtyard_deterministic_from_seed(detail):
    a = courtyard_doc(7, detail=detail, tex_size=16)
    b = courtyard_doc(7, detail=detail, tex_size=16)
    c = courtyard_doc(8, detail=detail, tex_size=16)
    assert _same_doc(a, b)
    assert not _same_doc(a, c)
    assert len(a.images) == N_TEXTURES  # detail leaves the counts alone


def test_cornell_box_builds_and_hits_back_wall(cornell_scene):
    from dustraytracer.ops.traverse import traverse_closest
    import jax.numpy as jnp

    assert cornell_box_doc().triangle_count == 36
    assert cornell_scene.n_textures == 2
    r = traverse_closest(cornell_scene, jnp.array([[0.5, 2.0, 0.0]]),
                         jnp.array([[0.0, 0.0, -1.0]]))
    np.testing.assert_allclose(float(r["t"][0]), 1.25, rtol=1e-6)


def _decode_png(data: bytes) -> np.ndarray:
    """Minimal decoder for the unfiltered 8-bit PNGs encode_png writes."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    assert depth == 8
    c = {2: 3, 6: 4}[ctype]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    assert (rows[:, 0] == 0).all()  # filter type None
    return rows[:, 1:].reshape(h, w, c)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_roundtrip_without_pil(tmp_path, channels):
    img = np.random.default_rng(0).integers(0, 256, (5, 7, channels),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(_decode_png(encode_png(img)), img)
    # save_png: float image in [0, 1], flipped (row 0 is the bottom)
    f = img.astype(np.float32) / 255.0
    save_png(tmp_path / "x.png", f)
    np.testing.assert_array_equal(
        _decode_png((tmp_path / "x.png").read_bytes()), img[::-1])
