"""Thin-lens fly camera, batched differentiable ray generation.

Capability mirror of the reference `Camera`
(`/root/reference/DustRayTracer/src/Core/Scene/Camera.{cuh,cu}`): position/
forward basis, vertical FOV, focus distance + defocus angle (DoF),
exposure, per-sample AA jitter, plus host-side fly-cam move/rotate
helpers. Differences by design:

- The reference computes `fov_factor = tan((vfov/2)/2)` — half the
  intended FOV (`Camera.cu:84-85`). We use the correct `tan(vfov/2)`.
- `GetRay` is vectorized over all pixels at once and is differentiable
  w.r.t. every camera parameter (camera optimization in inverse
  rendering), instead of a scalar per-thread function.
- AA jitter uses a half-pixel box filter instead of the reference's
  fixed 0.0035 NDC offset (`Camera.cu:98-99`), so anti-aliasing is
  resolution-independent.

The camera is a registered-dataclass pytree: all parameters are traced
arrays, so `jax.grad` flows through them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import numpy as np
import jax.numpy as jnp

from dustraytracer.ops.rng import random_float, random_in_disk

WORLD_UP = (0.0, 1.0, 0.0)


@jax.tree_util.register_dataclass
@dataclass
class Camera:
    position: jax.Array      # (3,)
    forward: jax.Array       # (3,) need not be normalized
    vfov_deg: jax.Array      # ()
    focus_dist: jax.Array    # ()
    defocus_angle: jax.Array  # () degrees; <= 0 disables DoF
    exposure: jax.Array      # () tonemap exposure bias

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    def basis(self):
        """Orthonormal (forward, right, up) with world-up Y
        (`Camera.cu:91-94`), falling back to world-up Z when looking
        straight up/down (the reference's basis degenerates there)."""
        fwd = self.forward / jnp.linalg.norm(self.forward)
        up_w = jnp.asarray(WORLD_UP)
        degenerate = jnp.abs(fwd[1]) > 0.999
        up_w = jnp.where(degenerate, jnp.asarray([0.0, 0.0, 1.0]), up_w)
        right = jnp.cross(fwd, up_w)
        right = right / jnp.maximum(jnp.linalg.norm(right), 1e-8)
        up = jnp.cross(right, fwd)
        return fwd, right, up


def make_camera(position=(0.0, 1.0, 3.0), look_at=None, forward=None,
                vfov_deg=60.0, focus_dist=10.0, defocus_angle=0.0,
                exposure=2.0) -> Camera:
    position = np.asarray(position, np.float32)
    if forward is None:
        target = np.asarray(look_at if look_at is not None else (0, 1, 0),
                            np.float32)
        forward = target - position
        if np.linalg.norm(forward) < 1e-8:
            forward = np.array([0, 0, -1], np.float32)
    return Camera(
        position=jnp.asarray(position),
        forward=jnp.asarray(forward, jnp.float32),
        vfov_deg=jnp.float32(vfov_deg),
        focus_dist=jnp.float32(focus_dist),
        defocus_angle=jnp.float32(defocus_angle),
        exposure=jnp.float32(exposure),
    )


def generate_rays(camera: Camera, width: int, height: int, rng_state,
                  jitter: bool = True, pixel_ids=None):
    """Primary rays for a batch of pixels: (N, 3) origins + directions.

    `pixel_ids` (flat y*width + x, default all H*W pixels) selects the
    pixels — the unit of tile sharding across a device mesh. Pixel (0, 0)
    is the *bottom-left* (GL convention, like the reference's render
    target; the PNG writer flips, `EditorLayer.cpp:69`). Rays go through a
    world-space image plane at `focus_dist` with thin-lens defocus
    (`Camera.cu:82-123`, FOV bug fixed).

    Returns (rng_state, origins, directions).
    """
    fwd, right, up = camera.basis()

    if pixel_ids is None:
        pixel_ids = jnp.arange(width * height, dtype=jnp.int32)
    idx = pixel_ids
    px = (idx % width).astype(jnp.float32)
    py = (idx // width).astype(jnp.float32)

    if jitter:
        rng_state, ju = random_float(rng_state)
        rng_state, jv = random_float(rng_state)
    else:
        ju = jv = 0.5

    # NDC in [-1, 1] with half-pixel centering (+ jitter inside the pixel)
    u = ((px + ju) / width) * 2.0 - 1.0
    v = ((py + jv) / height) * 2.0 - 1.0

    theta = jnp.deg2rad(camera.vfov_deg) * 0.5
    half_h = jnp.tan(theta) * camera.focus_dist
    half_w = half_h * (width / height)

    plane_point = (fwd * camera.focus_dist
                   + u[:, None] * (half_w * right)
                   + v[:, None] * (half_h * up))  # relative to camera pos

    defocus_radius = camera.focus_dist * jnp.tan(
        jnp.deg2rad(jnp.maximum(camera.defocus_angle, 0.0)) * 0.5)
    rng_state, disk = random_in_disk(rng_state)
    lens_offset = defocus_radius * (disk[:, 0:1] * right + disk[:, 1:2] * up)
    use_dof = camera.defocus_angle > 0.0
    lens_offset = jnp.where(use_dof, lens_offset, 0.0)

    origins = camera.position + lens_offset
    directions = plane_point - lens_offset
    directions = directions / jnp.linalg.norm(directions, axis=-1,
                                              keepdims=True)
    return rng_state, origins, directions


# --- host-side fly-cam controls (EditorLayer.cpp:324-417, Camera.cu:44-80) ---

def move_camera(camera: Camera, local_delta) -> Camera:
    """Translate in camera space (WASD/QE fly movement)."""
    fwd, right, up = camera.basis()
    d = jnp.asarray(local_delta, jnp.float32)
    world = d[0] * right + d[1] * up + d[2] * fwd
    return camera.replace(position=camera.position + world)


def rotate_camera(camera: Camera, yaw_rad: float, pitch_rad: float) -> Camera:
    """Yaw about world up, pitch about camera right (Rodrigues rotations,
    `Camera.cu:44-80` semantics)."""
    fwd, right, _ = camera.basis()

    def rodrigues(v, axis, angle):
        axis = axis / jnp.maximum(jnp.linalg.norm(axis), 1e-8)
        c, s = jnp.cos(angle), jnp.sin(angle)
        return (v * c + jnp.cross(axis, v) * s
                + axis * jnp.sum(axis * v) * (1.0 - c))

    f = rodrigues(fwd, jnp.asarray(WORLD_UP), jnp.float32(yaw_rad))
    f = rodrigues(f, right, jnp.float32(pitch_rad))
    return camera.replace(forward=f)
