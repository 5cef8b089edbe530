"""Image export (PNG) — parity with the reference's stb_image_write path
(`DustRayTracer/src/Editor/EditorLayer.cpp:23-31,85-96`): RGB(A)8 PNG of
the current framebuffer, vertically flipped because pixel row 0 is the
bottom scanline (GL convention). Encoded with zlib + struct alone."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(image) -> np.ndarray:
    arr = np.asarray(image)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 -> PNG bytes (8-bit RGB or RGBA, no filter)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w, c = arr.shape
    if c not in (3, 4):
        raise ValueError(f"need 3 or 4 channels, got {c}")

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, w * c)], axis=1)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_png(path, image, flip: bool = True) -> None:
    arr = to_uint8(image)
    if flip:
        arr = arr[::-1]
    with open(path, "wb") as f:
        f.write(encode_png(arr))
