"""Benchmark: forward+backward rays/s of one GPU on the generated scene.

Prints ONE JSON line:
  {"metric": "rays_per_sec_fwd_bwd", "value": N, "unit": "rays/s",
   "device": {...}, "card": "<name>, <power limit>", ...}

Workload: the seeded generated courtyard (scene/generate.py, about 100k
triangles, 16 textures, alpha cutout foliage, glass, an emissive panel),
512x512, 4-bounce paths with sun NEE (8 traced rays per pixel sample:
4 path segments + 4 shadow rays, alpha cutout tested inside the walk),
forward render + backward gradients w.r.t. material albedo,
emissive and the light parameters.

Timing: host clock around `block_until_ready` over REPS steps after one
warm-up step; compilation is reported apart as set-up. The benchmark
needs a GPU and fails on any other platform. The full benchmark (cells,
per-layer trace spans) is not defined yet.
"""

from __future__ import annotations

import json
import subprocess
import time

WIDTH = HEIGHT = 512
BOUNCES = 4
REPS = 10


def main():
    import jax
    import jax.numpy as jnp

    from dustraytracer.platform import require_gpu, use_compile_cache
    from dustraytracer.render.integrator import render_sample
    from dustraytracer.scene import make_camera
    from dustraytracer.scene.generate import COURTYARD_VIEW, courtyard_doc
    from dustraytracer.scene.scene import build_scene
    from dustraytracer.scene.settings import LightParams, RenderSettings

    devices = require_gpu()
    use_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    scene = build_scene(courtyard_doc(0))
    camera = make_camera(**COURTYARD_VIEW)
    settings = RenderSettings(bounces=BOUNCES, shading="pbr",
                              alpha_test=True, sky_intensity=1.5,
                              sun_intensity=4.0)
    lights = LightParams.from_settings(settings)

    def loss_fn(albedo, emissive, lights, frame):
        sc = scene.replace(mat_albedo=albedo, mat_emissive=emissive)
        img = render_sample(sc, camera, lights, frame,
                            width=WIDTH, height=HEIGHT, settings=settings)
        return jnp.mean(img)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 2)))

    def step(frame):
        return grad_fn(scene.mat_albedo, scene.mat_emissive, lights,
                       jnp.uint32(frame))

    t0 = time.perf_counter()
    jax.block_until_ready(step(0))
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for frame in range(1, REPS + 1):
        out = step(frame)
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / REPS * 1e3

    rays = WIDTH * HEIGHT * 2 * BOUNCES
    dev = devices[0]
    print(json.dumps({
        "metric": "rays_per_sec_fwd_bwd",
        "value": rays / (ms / 1e3),
        "unit": "rays/s",
        "ms_per_sample_fwd_bwd": ms,
        "compile_s": compile_s,
        "triangles": scene.n_tris,
        "size": [WIDTH, HEIGHT],
        "bounces": BOUNCES,
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devices)},
    }))


if __name__ == "__main__":
    main()
