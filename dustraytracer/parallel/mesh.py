"""Device mesh construction + scene replication for multi-chip rendering.

The reference is single-GPU with zero distributed machinery (SURVEY §2.4);
this module is the capability layered on top: a flat 1-D
`jax.sharding.Mesh` over which framebuffer *tiles* are data-parallel
while the scene/BVH is replicated. The GPUs of one host reach each other
all to all over NVLink, so the mesh follows the algorithm alone.
Collectives are a psum for gradients in inverse rendering, and an
all_gather only implicitly when the host assembles the framebuffer.

Works identically on several GPUs and on the CPU-simulated mesh used in
tests (`--xla_force_host_platform_device_count`).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tiles"


def make_render_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over all (or the first n) local devices, axis `tiles`."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), axis_names=(TILE_AXIS,))


def multihost_mesh(axis: str = TILE_AXIS) -> Mesh:
    """Mesh spanning every GPU in a multi-host job.

    Call `jax.distributed.initialize()` first on each host; devices here
    include the other hosts' GPUs, in process order, so each host's
    tiles are contiguous.
    """
    return Mesh(np.array(jax.devices()), axis_names=(axis,))


def replicate_scene(scene, mesh: Mesh):
    """Place every scene array replicated across the mesh (the reference's
    one-GPU scene upload, generalized: every GPU holds the full BVH +
    triangles, matching BASELINE.json's 'scene/BVH replicated' design)."""
    spec = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, spec), scene)


def tile_sharding(mesh: Mesh):
    """Sharding for a flat per-pixel array: dim 0 split across tiles."""
    return NamedSharding(mesh, P(TILE_AXIS))
