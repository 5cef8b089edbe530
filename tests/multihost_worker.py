"""Worker process for tests/test_multihost.py.

Each of the 2 processes owns 4 virtual CPU devices; together they form an
8-device global mesh via jax.distributed. Process 0 writes the gathered
image to --out as .npy.

Run (by the test, once per process):
  python tests/multihost_worker.py --coordinator 127.0.0.1:PORT \
      --num-processes 2 --process-id I --scene S --out OUT.npy
"""

import argparse
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--scene", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from dustraytracer.parallel.multihost import (initialize,
                                                  render_distributed)

    pid = initialize(args.coordinator, args.num_processes, args.process_id)
    assert jax.process_count() == args.num_processes, jax.process_count()
    assert len(jax.devices()) == 4 * args.num_processes, len(jax.devices())

    import numpy as np

    from dustraytracer.scene import make_camera
    from dustraytracer.scene.settings import RenderSettings

    settings = RenderSettings(bounces=2, enable_tonemap=False,
                              enable_gamma=False)
    camera = make_camera(position=(0, 1.25, 1.18), look_at=(0, 1.1, -1.25),
                         vfov_deg=75.0)
    img = render_distributed(args.scene, width=32, height=32, spp=2,
                             settings=settings, camera=camera)
    if pid == 0:
        np.save(args.out, img)
        print("worker0 wrote", args.out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
