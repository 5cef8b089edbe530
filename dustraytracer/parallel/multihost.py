"""Multi-host rendering runtime.

The reference is strictly single-process/single-GPU (SURVEY §2.4, §5.8);
this is the scale-out path. One process per host, all GPUs in one global
mesh, tiles data-parallel, scene replicated:

    # on every host (same command; the launcher provides the env):
    python -m dustraytracer.parallel.multihost --scene s.glb ...

Collective layout: the forward render is communication-free (rays are
embarrassingly parallel); inverse rendering all-reduces parameter
gradients with a single psum that XLA hands to NCCL (NVLink within a
host, the network across hosts). Framebuffer assembly happens only on
host 0 via `jax.experimental.multihost_utils.process_allgather`.

Without a cluster this module still works single-host (initialize()
no-ops), and the sharding semantics are covered by the CPU-simulated
mesh tests (tests/test_sharding.py).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None,
               initialization_timeout: int | None = None) -> int:
    """Bring up the jax distributed runtime; returns this process' index.

    With no arguments, JAX detects the cluster from its environment
    (SLURM, Open MPI, Kubernetes). Only when no such environment is
    present does the job run as one process; a cluster that is present
    but fails to initialize raises.
    """
    import jax

    kw = {}
    if initialization_timeout is not None:
        kw["initialization_timeout"] = initialization_timeout
    if coordinator:
        # explicit cluster parameters: failure here means the job the
        # user asked for cannot run — fail LOUDLY, never fall back to a
        # silent single-process render of 1/N of the work
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id, **kw)
    elif _cluster_env_present():
        jax.distributed.initialize(**kw)
    return jax.process_index()


def _cluster_env_present() -> bool:
    """Whether any cluster environment JAX auto-detects is set (the same
    test jax.distributed.initialize applies without arguments)."""
    from jax._src.clusters import ClusterEnv

    return any(env.is_env_present() for env in ClusterEnv._cluster_types
               if not env.opt_in_only_method)


def render_distributed(scene_path: str, *, width: int, height: int,
                       spp: int, settings=None, camera=None):
    """Render across every chip of every host; returns the full image on
    process 0 (None elsewhere)."""
    import jax
    import numpy as np
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    from dustraytracer.parallel.mesh import multihost_mesh, replicate_scene
    from dustraytracer.parallel.shard import sharded_render_sample
    from dustraytracer.render.film import film_image
    from dustraytracer.scene import load_scene, make_camera
    from dustraytracer.scene.settings import LightParams, RenderSettings

    settings = settings or RenderSettings()
    camera = camera or make_camera()
    lights = LightParams.from_settings(settings)

    scene = load_scene(scene_path)
    mesh = multihost_mesh()
    scene = replicate_scene(scene, mesh)

    accum = jnp.zeros((height, width, 3))
    for f in range(min(spp, settings.max_samples)):
        accum = accum + sharded_render_sample(
            scene, camera, lights, jnp.uint32(f), mesh=mesh,
            width=width, height=height, settings=settings)
    image = accum / max(spp, 1)

    # tiled=True: `image` is a GLOBAL tile-sharded array (not fully
    # addressable per process); tiled assembly stitches the shards back
    # into the full framebuffer instead of stacking per-process copies
    gathered = multihost_utils.process_allgather(image, tiled=True)
    if jax.process_index() == 0:
        return np.asarray(gathered)
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dustraytracer.multihost")
    p.add_argument("--scene", required=True)
    p.add_argument("--size", default="512x512")
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--out", default="render_multihost.png")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)

    pid = initialize(args.coordinator, args.num_processes, args.process_id)
    import jax

    w, h = (int(x) for x in args.size.split("x"))
    t0 = time.perf_counter()
    img = render_distributed(args.scene, width=w, height=h, spp=args.spp)
    dt = time.perf_counter() - t0
    if pid == 0 and img is not None:
        from dustraytracer.utils.image import save_png

        save_png(args.out, img)
        print(json.dumps({
            "hosts": jax.process_count(),
            "devices": len(jax.devices()),
            "seconds": round(dt, 3),
            "out": args.out,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
