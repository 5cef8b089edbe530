"""Texture sampling: point or bilinear, wrapped UVs, gamma-2 decode.

Behavioral parity with `Texture::getPixel`
(`DustRayTracer/src/Core/Scene/Texture.cu:33-58`): repeat
wrapping via u - floor(u), nearest texel, RGB in [0,1] squared as the
approximate sRGB->linear decode. The texture *stack* (T, H, W, 4) u8 with
per-texture true dims replaces the reference's per-texture managed
buffers so one gather shape serves every material under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# u8 -> [0, 1] as a multiply: XLA on the GPU divides inexactly when the
# divisor is not a compile-time constant (255 / 255 = 0.99999994 there),
# and the alpha test needs 255 to decode to exactly 1.0 on every backend
INV_255 = 1.0 / 255.0


def _wrap(x):
    return x - jnp.floor(x)


def packed_texels(scene):
    """(T*H*W,) u32 view of the u8 RGBA stack — one 32-bit word per
    texel, so a texel lookup is ONE 1-D gather plus a byte unpack
    instead of a 4-D gather of byte slices."""
    return jax.lax.bitcast_convert_type(
        scene.tex_stack, jnp.uint32).reshape(-1)


def sample_texture(scene, tex_idx, uv, bilinear: bool = False):
    """Sample albedo RGB (linearized). tex_idx: (...,) i32 (>= 0); uv (..., 2).

    Out-of-stack rows from padded textures never get sampled because
    `tex_idx` is clamped by callers to valid entries.
    """
    safe = jnp.maximum(tex_idx, 0)
    hw = scene.tex_hw[safe]
    h = hw[..., 0].astype(jnp.float32)
    w = hw[..., 1].astype(jnp.float32)
    fu = _wrap(uv[..., 0]) * w
    fv = _wrap(uv[..., 1]) * h

    is_u8 = scene.tex_stack.dtype == jnp.uint8
    if is_u8:
        flat = packed_texels(scene)
        hs, ws = scene.tex_stack.shape[1], scene.tex_stack.shape[2]

    def fetch(xi, yi):
        xi = jnp.clip(xi, 0, hw[..., 1] - 1)
        yi = jnp.clip(yi, 0, hw[..., 0] - 1)
        if is_u8:
            word = flat[(safe * hs + yi) * ws + xi]
            rgb = jnp.stack(
                [(word & 0xFF).astype(jnp.float32),
                 ((word >> 8) & 0xFF).astype(jnp.float32),
                 ((word >> 16) & 0xFF).astype(jnp.float32)],
                axis=-1) * INV_255
            return rgb * rgb  # gamma-2 decode (Texture.cu:56)
        # float stacks store LINEAR texel values (the learnable-texture
        # path for inverse rendering) — no decode; the gather's VJP is
        # an atomic scatter-add into the stack
        return scene.tex_stack[safe, yi, xi, :3]

    if not bilinear:
        return fetch(fu.astype(jnp.int32), fv.astype(jnp.int32))

    x0 = jnp.floor(fu - 0.5)
    y0 = jnp.floor(fv - 0.5)
    tx = (fu - 0.5 - x0)[..., None]
    ty = (fv - 0.5 - y0)[..., None]
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    c00 = fetch(x0i, y0i)
    c10 = fetch(x0i + 1, y0i)
    c01 = fetch(x0i, y0i + 1)
    c11 = fetch(x0i + 1, y0i + 1)
    top = c00 * (1 - tx) + c10 * tx
    bot = c01 * (1 - tx) + c11 * tx
    return top * (1 - ty) + bot * ty


def sample_alpha(scene, tex_idx, uv):
    """Point-sampled, wrapped alpha fetch (`Texture.cu:60-75`), batched.
    tex_idx: (...,) i32 (may be -1); uv: (..., 2). Returns alpha (...,)."""
    safe_tex = jnp.maximum(tex_idx, 0)
    hw = scene.tex_hw[safe_tex]  # (..., 2)
    h = hw[..., 0]
    w = hw[..., 1]
    fu = uv[..., 0] - jnp.floor(uv[..., 0])
    fv = uv[..., 1] - jnp.floor(uv[..., 1])
    x = jnp.clip((fu * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((fv * h).astype(jnp.int32), 0, h - 1)
    if scene.tex_stack.dtype == jnp.uint8:
        # flat u32 texel gather + byte unpack (packed_texels)
        hs, ws = scene.tex_stack.shape[1], scene.tex_stack.shape[2]
        word = packed_texels(scene)[(safe_tex * hs + y) * ws + x]
        a = ((word >> 24) & 0xFF).astype(jnp.float32) * INV_255
    else:
        a = scene.tex_stack[safe_tex, y, x, 3].astype(jnp.float32)
    opaque = (tex_idx < 0) | ~scene.tex_has_alpha[safe_tex]
    return jnp.where(opaque, 1.0, a)


def cutout_opaque(scene, tri, u, v):
    """The alpha-cutout AnyHit test (`AnyHit.cuh:8-28`) of candidate hits:
    True where triangle `tri` (any shape, ids >= 0) is opaque at its
    barycentrics (u, v), i.e. its albedo texture's alpha is 1 there."""
    uv = scene.tri_uv[tri]  # (..., 3, 2)
    w = 1.0 - u - v
    uv_i = (w[..., None] * uv[..., 0, :] + u[..., None] * uv[..., 1, :]
            + v[..., None] * uv[..., 2, :])
    tex = scene.mat_albedo_tex[scene.tri_mat[tri]]
    return sample_alpha(scene, tex, uv_i) >= 1.0


def decode_textures(scene):
    """Convert the uint8 texture stack to a LINEAR float32 stack.

    Float stacks are sampled without the gamma-2 decode, making every
    texel a differentiable parameter — the learnable-texture path for
    inverse rendering (BASELINE config 5: texture gradients). The render
    is value-identical to the uint8 path."""
    import jax.numpy as jnp

    u8 = scene.tex_stack
    if u8.dtype != jnp.uint8:
        return scene
    f = u8.astype(jnp.float32) * INV_255
    rgb = f[..., :3] ** 2  # match the u8 path's gamma-2 decode
    alpha = f[..., 3:4]
    return scene.replace(tex_stack=jnp.concatenate([rgb, alpha], axis=-1))
