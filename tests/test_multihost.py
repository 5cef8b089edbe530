"""Real multi-process jax.distributed test.

Spawns 2 local processes, each owning 4 virtual CPU devices, joined into
one 8-device global mesh via a local coordinator. Process 0's gathered
framebuffer must match the single-process render of the same workload.
This executes the actual multi-host code path (jax.distributed.initialize
with explicit cluster args, global mesh over non-addressable devices,
cross-process framebuffer assembly) that single-process 8-device tests
cannot reach.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_render_matches_single(tmp_path):
    pytest.importorskip("PIL")  # the loader decodes the embedded PNGs
    from tests.util_scenes import cornell_glb

    scene_file = cornell_glb(tmp_path)
    port = _free_port()
    out = str(tmp_path / "img.npy")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own 4-device flag

    procs = []
    logs = []
    for pid in range(2):
        log = open(tmp_path / f"worker{pid}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER,
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(pid),
             "--scene", scene_file, "--out", out],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT))
    rcs = [p.wait(timeout=600) for p in procs]
    for log in logs:
        log.close()
    if any(rcs):
        tails = [(tmp_path / f"worker{i}.log").read_text()[-2000:]
                 for i in range(2)]
        raise AssertionError(f"worker rcs={rcs}\n" + "\n---\n".join(tails))

    got = np.load(out)

    # single-process reference of the identical workload on the local
    # 8-device mesh (same tile split -> same math)
    import jax
    import jax.numpy as jnp

    from dustraytracer.parallel.mesh import (make_render_mesh,
                                             replicate_scene)
    from dustraytracer.parallel.shard import sharded_render_sample
    from dustraytracer.scene import load_scene, make_camera
    from dustraytracer.scene.settings import LightParams, RenderSettings

    settings = RenderSettings(bounces=2, enable_tonemap=False,
                              enable_gamma=False)
    camera = make_camera(position=(0, 1.25, 1.18), look_at=(0, 1.1, -1.25),
                         vfov_deg=75.0)
    lights = LightParams.from_settings(settings)
    scene = load_scene(scene_file)
    mesh = make_render_mesh(8)
    scene = replicate_scene(scene, mesh)
    accum = jnp.zeros((32, 32, 3))
    for f in range(2):
        accum = accum + sharded_render_sample(
            scene, camera, lights, jnp.uint32(f), mesh=mesh,
            width=32, height=32, settings=settings)
    want = np.asarray(accum / 2)

    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_initialize_fails_loudly_on_bad_coordinator():
    """Explicit cluster args must never silently fall back to one
    process. Run in a subprocess: a failed
    jax.distributed handshake must not poison this process."""
    code = (
        "import os; os.environ['JAX_PLATFORMS']='cpu'\n"
        "import jax; jax.config.update('jax_platforms','cpu')\n"
        "from dustraytracer.parallel.multihost import initialize\n"
        "try:\n"
        "    initialize('127.0.0.1:1', num_processes=2, process_id=1,\n"
        "               initialization_timeout=5)\n"
        "except Exception:\n"
        "    raise SystemExit(42)\n"
        "raise SystemExit(0)\n"  # silent fallback would exit 0 -> caught
    )
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       timeout=300, capture_output=True)
    # "loud" = the process dies: either our re-raised Python exception
    # (42) or jax's own fatal coordination abort (abseil exits 1 before
    # Python sees it). rc 0 would mean a silent fallback.
    assert r.returncode != 0, r.stdout[-500:]
