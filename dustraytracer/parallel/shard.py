"""Tile-sharded rendering + inverse-rendering train step over a mesh.

Data layout: the flat pixel-id array is split along the `tiles` mesh axis
(`shard_map`); scene, camera, lights are replicated. Forward rendering
needs *zero* communication — rays are embarrassingly parallel (SURVEY
§5.7) — so scaling is limited only by launch overhead. The inverse-
rendering step computes per-shard parameter gradients and all-reduces
them with one `psum` over ICI, the only collective in the system
(BASELINE.json north star: 'parameter gradients all-reduced').
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

# Full vma checking stays ON: every loop carry in the render path derives
# its initial constants from the (sharded) rays (ops/intersect.py::
# varying_zero), so the varying-manual-axes checker accepts the scans and
# while_loops and will catch real sharding bugs.
shard_map = jax.shard_map

from dustraytracer.parallel.mesh import TILE_AXIS
from dustraytracer.render.integrator import render_pixels
from dustraytracer.scene.settings import LightParams, RenderSettings


def apply_params(scene, camera, lights, params: dict):
    """Overlay optimizable parameters onto scene/camera/lights.

    Recognized keys: any Scene material/vertex field (`mat_albedo`,
    `mat_emissive`, `mat_metallic`, `mat_roughness`, `tri_pos`),
    `camera` (full Camera pytree), `lights` (full LightParams pytree).
    """
    scene_keys = {k: v for k, v in params.items()
                  if k not in ("camera", "lights")}
    if scene_keys:
        # Scene.replace re-bakes the cluster tables when tri_pos changes
        # (jit-safe refit) so vertex optimization runs on the fast
        # sweep/cluster kernels instead of the gather walk — and a
        # vertex-perturbed scene can never silently render stale
        # geometry (scene/scene.py::Scene.replace).
        scene = scene.replace(**scene_keys)
    camera = params.get("camera", camera)
    lights = params.get("lights", lights)
    return scene, camera, lights


@partial(jax.jit, static_argnames=("mesh", "width", "height", "settings"))
def sharded_render_sample(scene, camera, lights, frame_idx, *, mesh,
                          width: int, height: int,
                          settings: RenderSettings):
    """One progressive sample with pixels sharded over the mesh.

    Returns (H, W, 3) laid out tile-sharded on device; converting to a
    host numpy array performs the implicit all-gather.
    """
    n = width * height
    n_dev = mesh.devices.size
    if n % n_dev:
        raise ValueError(f"pixels ({n}) must divide mesh size ({n_dev})")
    pixel_ids = jnp.arange(n, dtype=jnp.int32)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P(), P(), P(TILE_AXIS)),
             out_specs=P(TILE_AXIS))
    def _tile(scene, camera, lights, frame, ids):
        return render_pixels(scene, camera, lights, frame, ids,
                             width=width, height=height, settings=settings)

    color = _tile(scene, camera, lights, frame_idx, pixel_ids)
    return color.reshape(height, width, 3)


@partial(jax.jit, static_argnames=("mesh", "width", "height", "settings"))
def sharded_train_step(params: dict, scene, camera, lights, target,
                       frame_idx, lr, *, mesh, width: int, height: int,
                       settings: RenderSettings):
    """One SGD step of inverse rendering, tile-sharded with psum'd grads.

    Args:
      params: optimizable overlay (see `apply_params`), replicated.
      target: (H, W, 3) target image, host-order rows.
      lr: learning rate scalar.

    Returns (new_params, loss). Loss/gradients are exact (psum over every
    shard) — equivalent to the single-device computation.
    """
    n = width * height
    n_dev = mesh.devices.size
    if n % n_dev:
        raise ValueError(f"pixels ({n}) must divide mesh size ({n_dev})")
    pixel_ids = jnp.arange(n, dtype=jnp.int32)
    target_flat = target.reshape(n, 3)

    def local_loss(params, ids, tgt):
        sc, cam, li = apply_params(scene, camera, lights, params)
        color = render_pixels(sc, cam, li, frame_idx, ids,
                              width=width, height=height, settings=settings)
        # mean over the FULL image: sum locally, normalize by global n
        return jnp.sum((color - tgt) ** 2) / n

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(TILE_AXIS), P(TILE_AXIS)),
             out_specs=(P(), P()))
    def _grad_tile(params, ids, tgt):
        loss, grads = jax.value_and_grad(local_loss)(params, ids, tgt)
        loss = jax.lax.psum(loss, TILE_AXIS)
        # grads need NO explicit psum: with vma checking on, params enter
        # unvarying (replicated) and AD transposes the unvarying->varying
        # broadcast into the all-reduce automatically — an explicit psum
        # here would 8x-count gradients (verified empirically).
        return loss, grads

    loss, grads = _grad_tile(params, pixel_ids, target_flat)
    new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
    return new_params, loss
