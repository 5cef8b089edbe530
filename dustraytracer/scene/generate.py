"""Seeded procedural scenes: glTF documents built in memory.

Every scene the tests, the benchmark and `chip_smoke.py` render comes
from here, so nothing depends on files outside the repository. Each
builder returns a `GltfDocument` with its textures as uint8 arrays;
`build_scene` then takes it through the same path a loaded file takes.

- `cornell_box_doc`: a box open on one side (36 triangles, 2 textures,
  an emissive ceiling panel), the small interior scene.
- `courtyard_doc`: an outdoor scene of about 100k triangles at
  `detail=1` (a textured height-field ground, tessellated spheres, a
  torus knot, boxes, alpha-cutout foliage, a glass slab and an emissive
  panel) with 16 RGBA textures; one of them carries an alpha cutout.
  `detail` scales the tessellation for small test scenes and leaves the
  material and texture counts as they are.
"""

from __future__ import annotations

import numpy as np

from dustraytracer.scene.gltf import (GltfDocument, GltfMaterial,
                                      GltfPrimitive)

N_TEXTURES = 16
ALPHA_TEXTURE = N_TEXTURES - 1   # the foliage cutout
EMISSIVE_MATERIAL = N_TEXTURES   # material ids after the textured ones
GLASS_MATERIAL = N_TEXTURES + 1


def make_quad(center, size, axis, mat=0, flip=False) -> GltfPrimitive:
    """Two triangles forming a square perpendicular to `axis`."""
    c = np.asarray(center, np.float32)
    h = size / 2.0
    if axis == 2:  # XY plane
        corners = np.array([[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0]])
        n = np.array([0, 0, 1.0])
    elif axis == 1:  # XZ plane
        corners = np.array([[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]])
        n = np.array([0, 1.0, 0])
    else:  # YZ plane
        corners = np.array([[0, -h, -h], [0, h, -h], [0, h, h], [0, -h, h]])
        n = np.array([1.0, 0, 0])
    if flip:
        n = -n
        corners = corners[::-1]
    corners = (corners + c).astype(np.float32)
    tris = np.stack([corners[[0, 1, 2]], corners[[0, 2, 3]]])
    normals = np.broadcast_to(n, (2, 3, 3)).astype(np.float32)
    uvs = np.array([[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]],
                   np.float32)
    return GltfPrimitive(positions=tris, normals=normals.copy(),
                         uvs=uvs, material=mat)


def _grid_tris(pts, uvs, nrm):
    """(R, S, ...) vertex grids -> (2*(R-1)*(S-1), 3, ...) triangles."""
    def quads(a):
        p00, p01 = a[:-1, :-1], a[:-1, 1:]
        p10, p11 = a[1:, :-1], a[1:, 1:]
        t0 = np.stack([p00, p10, p11], axis=2)
        t1 = np.stack([p00, p11, p01], axis=2)
        both = np.stack([t0, t1], axis=2)  # (R-1, S-1, 2, 3, C)
        return both.reshape((-1, 3) + a.shape[2:])
    return (quads(pts).astype(np.float32), quads(nrm).astype(np.float32),
            quads(uvs).astype(np.float32))


def _prim(pts, uvs, nrm, mat) -> GltfPrimitive:
    p, n, u = _grid_tris(pts, uvs, nrm)
    return GltfPrimitive(positions=p, normals=n, uvs=u, material=mat)


def _box(lo, hi, mat) -> GltfPrimitive:
    """Axis-aligned box, 12 triangles, outward normals, per-face uvs."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    c = (lo + hi) / 2
    ext = (hi - lo) / 2
    tris, nrms, uvs = [], [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            n = np.zeros(3, np.float32)
            n[axis] = sign
            a, b = [i for i in range(3) if i != axis]
            corners = []
            for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = c.copy()
                p[axis] += sign * ext[axis]
                p[a] += du * ext[a]
                p[b] += dv * ext[b]
                corners.append(p)
            corners = np.stack(corners)
            if sign < 0:
                corners = corners[::-1]
            tris += [corners[[0, 1, 2]], corners[[0, 2, 3]]]
            nrms += [np.broadcast_to(n, (3, 3))] * 2
            uvs += [np.array([[0, 0], [1, 0], [1, 1]], np.float32),
                    np.array([[0, 0], [1, 1], [0, 1]], np.float32)]
    return GltfPrimitive(positions=np.stack(tris).astype(np.float32),
                         normals=np.stack(nrms).astype(np.float32),
                         uvs=np.stack(uvs), material=mat)


def _sphere(center, radius, seg, mat) -> GltfPrimitive:
    rings = max(seg // 2, 3)
    th = np.linspace(0.0, np.pi, rings + 1)[:, None]
    ph = np.linspace(0.0, 2 * np.pi, seg + 1)[None, :]
    n = np.stack([np.sin(th) * np.cos(ph),
                  np.cos(th) * np.ones_like(ph),
                  np.sin(th) * np.sin(ph)], axis=-1)
    uv = np.stack([np.broadcast_to(ph / (2 * np.pi), n.shape[:2]),
                   np.broadcast_to(th / np.pi, n.shape[:2])], axis=-1)
    prim = _prim(np.asarray(center) + radius * n, uv * 4.0, n, mat)
    # drop the zero-area triangles at the poles
    e = np.cross(prim.positions[:, 1] - prim.positions[:, 0],
                 prim.positions[:, 2] - prim.positions[:, 0])
    keep = np.linalg.norm(e, axis=-1) > 1e-12
    return GltfPrimitive(prim.positions[keep], prim.normals[keep],
                         prim.uvs[keep], mat)


def _torus_knot(center, scale, nu, nv, mat, p=2, q=3, tube=0.25):
    u = np.linspace(0.0, 2 * np.pi, nu + 1)

    def curve(t):
        r = 2.0 + np.cos(q * t)
        return np.stack([r * np.cos(p * t), np.sin(q * t), r * np.sin(p * t)],
                        axis=-1)

    c = curve(u)
    tan = curve(u + 1e-3) - curve(u - 1e-3)
    tan /= np.linalg.norm(tan, axis=-1, keepdims=True)
    side = np.cross(tan, np.array([0.0, 1.0, 0.0]))
    side /= np.maximum(np.linalg.norm(side, axis=-1, keepdims=True), 1e-9)
    up = np.cross(side, tan)
    v = np.linspace(0.0, 2 * np.pi, nv + 1)
    n = (np.cos(v)[None, :, None] * side[:, None, :]
         + np.sin(v)[None, :, None] * up[:, None, :])
    pts = c[:, None, :] + tube * n
    uv = np.stack(np.meshgrid(u / (2 * np.pi) * 8.0, v / (2 * np.pi),
                              indexing="ij"), axis=-1)
    return _prim(np.asarray(center) + scale * pts, uv, n, mat)


def _texture(rng, kind: int, size: int) -> np.ndarray:
    """One procedural RGBA texture (opaque)."""
    y, x = np.mgrid[0:size, 0:size] / size
    c0 = rng.uniform(0.1, 0.9, 3)
    c1 = rng.uniform(0.1, 0.9, 3)
    freq = int(rng.integers(2, 9))
    if kind % 4 == 0:    # checker
        w = ((np.floor(x * freq) + np.floor(y * freq)) % 2)[..., None]
    elif kind % 4 == 1:  # stripes
        w = (0.5 + 0.5 * np.sin(2 * np.pi * freq * (x + 0.3 * y)))[..., None]
    elif kind % 4 == 2:  # bricks
        row = np.floor(y * freq)
        bx = (x * freq + 0.5 * (row % 2)) % 1.0
        by = (y * freq) % 1.0
        w = ((bx > 0.06) & (by > 0.1)).astype(np.float64)[..., None]
    else:                # value noise
        g = rng.uniform(0, 1, (freq + 1, freq + 1))
        gx, gy = x * freq, y * freq
        ix, iy = np.floor(gx).astype(int), np.floor(gy).astype(int)
        fx, fy = gx - ix, gy - iy
        w = (g[iy, ix] * (1 - fx) * (1 - fy) + g[iy, ix + 1] * fx * (1 - fy)
             + g[iy + 1, ix] * (1 - fx) * fy + g[iy + 1, ix + 1] * fx * fy)
        w = w[..., None]
    rgb = c0 * (1 - w) + c1 * w
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = np.clip(rgb * 255 + 0.5, 0, 255).astype(np.uint8)
    img[..., 3] = 255
    return img


def _leaf_texture(rng, size: int) -> np.ndarray:
    """Green leaf on a transparent background (alpha 0 or 255)."""
    y, x = np.mgrid[0:size, 0:size] / size
    inside = ((x - 0.5) / 0.42) ** 2 + ((y - 0.5) / 0.3) ** 2 < 1.0
    holes = rng.uniform(0, 1, (size // 16 + 1, size // 16 + 1)) < 0.15
    inside &= ~holes[(y * (size // 16)).astype(int),
                     (x * (size // 16)).astype(int)]
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 0] = 40
    img[..., 1] = (120 + 80 * y).astype(np.uint8)
    img[..., 2] = 30
    img[..., 3] = np.where(inside, 255, 0)
    return img


def courtyard_doc(seed: int = 0, detail: float = 1.0,
                  tex_size: int = 256) -> GltfDocument:
    """The seeded outdoor scene (see the module docstring): about 100k
    triangles at detail=1, 16 textures of tex_size^2 RGBA, 16 textured
    materials plus one emissive and one glass material."""
    rng = np.random.default_rng(seed)
    images = [_texture(rng, i, tex_size) for i in range(N_TEXTURES - 1)]
    images.append(_leaf_texture(rng, tex_size))
    materials = [
        GltfMaterial(name=f"tex{i}", base_color=np.ones(3, np.float32),
                     base_color_texture=i,
                     roughness=float(rng.uniform(0.2, 1.0)),
                     metallic=0.6 if i == 5 else 0.0)
        for i in range(N_TEXTURES)]
    materials.append(GltfMaterial(
        name="emitter", base_color=np.zeros(3, np.float32),
        emissive=np.array([9.0, 7.5, 5.0], np.float32)))
    materials.append(GltfMaterial(
        name="glass", base_color=np.array([0.92, 0.97, 1.0], np.float32),
        roughness=0.0, transmission=0.9, ior=1.5))

    g = max(2, round(128 * detail))
    seg = max(6, round(64 * detail))
    knot_u, knot_v = max(16, round(256 * detail)), max(4, round(32 * detail))
    n_leaves = max(8, round(5000 * detail * detail))
    half = 12.0

    meshes = []
    # ground: gentle seeded height field, tiled texture
    gx, gz = np.meshgrid(np.linspace(-half, half, g + 1),
                         np.linspace(-half, half, g + 1), indexing="ij")
    amp = rng.uniform(0.1, 0.3, 3)
    ph = rng.uniform(0, 2 * np.pi, 3)
    gy = (amp[0] * np.sin(0.4 * gx + ph[0]) * np.cos(0.3 * gz + ph[1])
          + amp[1] * np.sin(0.9 * gx + 0.7 * gz + ph[2]) - 0.3)
    dydx = np.gradient(gy, gx[:, 0], axis=0)
    dydz = np.gradient(gy, gz[0], axis=1)
    gn = np.stack([-dydx, np.ones_like(gy), -dydz], axis=-1)
    gn /= np.linalg.norm(gn, axis=-1, keepdims=True)
    guv = np.stack([gx, gz], axis=-1) / 3.0
    meshes.append(("ground", [_prim(np.stack([gx, gy, gz], -1), guv, gn,
                                    0)]))

    # ten spheres on a ring
    prims = []
    for i in range(10):
        a = 2 * np.pi * i / 10 + rng.uniform(-0.2, 0.2)
        r = rng.uniform(0.6, 1.3)
        center = (7.0 * np.cos(a), r, 7.0 * np.sin(a))
        prims.append(_sphere(center, r, seg, 1 + i % 9))
    meshes.append(("spheres", prims))

    meshes.append(("knot", [_torus_knot((0.0, 2.2, 0.0), 0.8, knot_u, knot_v,
                                        10)]))

    prims = []
    for i in range(48):
        a = rng.uniform(0, 2 * np.pi)
        d = rng.uniform(9.0, 11.5)
        x, z = d * np.cos(a), d * np.sin(a)
        w = rng.uniform(0.3, 0.9, 3) * np.array([1.0, 3.0, 1.0])
        prims.append(_box((x - w[0], -0.3, z - w[2]),
                          (x + w[0], w[1], z + w[2]), 11 + i % 4))
    meshes.append(("boxes", prims))

    # foliage: cutout quads in twelve clumps
    clumps = rng.uniform(-6.0, 6.0, (12, 3)) * np.array([1.0, 0.0, 1.0])
    clumps[:, 1] = rng.uniform(1.5, 3.5, 12)
    ctr = (clumps[rng.integers(0, 12, n_leaves)]
           + rng.normal(0, 1.1, (n_leaves, 3)))
    ax = rng.normal(size=(n_leaves, 3))
    ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
    bx = np.cross(ax, rng.normal(size=(n_leaves, 3)))
    bx /= np.linalg.norm(bx, axis=-1, keepdims=True)
    s = 0.3
    corners = np.stack([ctr - s * ax - s * bx, ctr + s * ax - s * bx,
                        ctr + s * ax + s * bx, ctr - s * ax + s * bx], 1)
    leaf_pos = np.concatenate([corners[:, [0, 1, 2]], corners[:, [0, 2, 3]]])
    ln = np.cross(ax, bx)
    leaf_n = np.repeat(np.concatenate([ln, ln])[:, None, :], 3, axis=1)
    quv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    leaf_uv = np.concatenate(
        [np.broadcast_to(quv[[0, 1, 2]], (n_leaves, 3, 2)),
         np.broadcast_to(quv[[0, 2, 3]], (n_leaves, 3, 2))])
    meshes.append(("foliage", [GltfPrimitive(
        leaf_pos.astype(np.float32), leaf_n.astype(np.float32),
        leaf_uv.astype(np.float32), ALPHA_TEXTURE)]))

    meshes.append(("glass", [_box((-3.0, -0.2, 3.0), (3.0, 2.5, 3.3),
                                  GLASS_MATERIAL)]))
    meshes.append(("emitter", [make_quad((0.0, 6.5, -6.0), 3.0, axis=2,
                                         mat=EMISSIVE_MATERIAL)]))
    return GltfDocument(meshes=meshes, materials=materials, images=images,
                        cameras=[])


# camera that frames courtyard_doc: make_camera(**COURTYARD_VIEW)
COURTYARD_VIEW = dict(position=(4.0, 7.0, 17.0), look_at=(0.0, 1.2, 0.0),
                      vfov_deg=50.0)


def cornell_box_doc(tex_size: int = 64) -> GltfDocument:
    """A box open toward +z, x in [-1, 1], y in [0, 2.5], z in
    [-1.25, 1.25]: red left wall, green back wall at z = -1.25, blue
    right wall, a textured floor and ceiling, an emissive ceiling panel
    and two textured blocks (36 triangles, 2 textures). Camera inside:
    CORNELL_VIEW."""
    rng = np.random.default_rng(1)
    images = [_texture(rng, 0, tex_size), _texture(rng, 2, tex_size)]
    mats = [
        GltfMaterial(name="red", base_color=np.array([0.8, 0.1, 0.1],
                                                     np.float32)),
        GltfMaterial(name="floor", base_color_texture=0),
        GltfMaterial(name="green", base_color=np.array([0.1, 0.7, 0.1],
                                                       np.float32)),
        GltfMaterial(name="blue", base_color=np.array([0.1, 0.2, 0.8],
                                                      np.float32)),
        GltfMaterial(name="light", base_color=np.zeros(3, np.float32),
                     emissive=np.array([12.0, 11.0, 9.0], np.float32)),
        GltfMaterial(name="block", base_color_texture=1),
    ]

    def wall(center, axis, flip, mat, sx, sy):
        q = make_quad(center, 1.0, axis, mat=mat, flip=flip)
        c = np.asarray(center, np.float32)
        scale = np.ones(3, np.float32)
        a, b = [i for i in range(3) if i != axis]
        scale[a], scale[b] = sx, sy
        return GltfPrimitive((q.positions - c) * scale + c, q.normals,
                             q.uvs * 2.0, mat)

    meshes = [
        ("left", [wall((-1.0, 1.25, 0.0), 0, False, 0, 2.5, 2.5)]),
        ("right", [wall((1.0, 1.25, 0.0), 0, True, 3, 2.5, 2.5)]),
        ("back", [wall((0.0, 1.25, -1.25), 2, False, 2, 2.0, 2.5)]),
        ("floor", [wall((0.0, 0.0, 0.0), 1, False, 1, 2.0, 2.5)]),
        ("ceiling", [wall((0.0, 2.5, 0.0), 1, True, 1, 2.0, 2.5)]),
        ("light", [wall((0.0, 2.49, 0.0), 1, True, 4, 0.6, 0.6)]),
        ("blocks", [_box((-0.7, 0.0, -0.8), (-0.1, 1.0, -0.2), 5),
                    _box((0.2, 0.0, 0.0), (0.7, 0.5, 0.5), 5)]),
    ]
    return GltfDocument(meshes=meshes, materials=mats, images=images,
                        cameras=[])


CORNELL_VIEW = dict(position=(0.0, 1.25, 1.18), look_at=(0.0, 1.1, -1.25),
                    vfov_deg=75.0)
