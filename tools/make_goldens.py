"""Generate the committed reference-parity goldens (tests/goldens/).

Two tiers (see docs/REFERENCE_PARITY.md for the full contract):

- *exact* goldens: small, few-sample renders at the reference's default
  settings, regenerated and compared PER-PIXEL by
  tests/test_reference_parity.py on every run. Generated on CPU so the
  test (which runs on CPU) is bit-for-bit reproducible modulo XLA
  numerics drift (tolerance 2e-3).
- *converged* goldens: 512-sample progressive accumulations at the
  reference's default 500-sample-cap-class workload
  (`RendererSettings.h:22-34`: tonemap+gamma on, sunlight on,
  bounce_limit=2 == 3 path segments). Tests render a few fresh samples
  and gate on PSNR against these, tying the current integrator to the
  converged image the reference's progressive renderer would settle on.

Usage:
  python tools/make_goldens.py [--tier exact|converged|all] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # allow running as `python tools/make_goldens.py`
    sys.path.insert(0, ROOT)
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")

# Every golden scene is generated (tests/util_scenes.py builders over
# dustraytracer/scene/generate.py), so the goldens need no files
# from outside the repository.
SCENES = {
    "cornell_box": dict(
        file="synthetic:cornell",
        camera=dict(position=(0, 1.25, 1.18), look_at=(0, 1.1, -1.25),
                    vfov_deg=75.0),
        exact=dict(size=96, spp=2),
        converged=dict(size=128, spp=512),
    ),
    "cornell_dof": dict(
        file="synthetic:cornell",
        # thin-lens depth of field (Camera.cu:101-115 parity): focus on
        # the back wall, wide 6-degree defocus cone
        camera=dict(position=(0, 1.25, 1.18), look_at=(0, 1.1, -1.25),
                    vfov_deg=75.0, focus_dist=2.4, defocus_angle=6.0),
        exact=dict(size=64, spp=4),
    ),
    "courtyard": dict(
        file="synthetic:courtyard_small",  # alpha-cutout foliage
        # (AnyHit.cuh:8-28), glass, emitter, 16 textures
        camera=dict(position=(4.0, 7.0, 17.0), look_at=(0.0, 1.2, 0.0),
                    vfov_deg=50.0),
        overrides=dict(alpha_test=True, shading="pbr"),
        exact=dict(size=64, spp=2),
    ),
    "courtyard_smooth": dict(
        file="synthetic:courtyard_small",
        camera=dict(position=(4.0, 7.0, 17.0), look_at=(0.0, 1.2, 0.0),
                    vfov_deg=50.0),
        overrides=dict(smooth_shading=True),
        exact=dict(size=64, spp=2),
    ),
    "glass_panes": dict(
        file="synthetic:glass_panes",  # tests/util_scenes.py builder
        camera=dict(position=(0.0, 1.2, 2.2), look_at=(0.0, 1.2, -0.8),
                    vfov_deg=50.0),
        overrides=dict(shading="pbr"),
        exact=dict(size=64, spp=4),
    ),
}


def load_golden_scene(file: str):
    """Build a golden scene from its "synthetic:<name>" builder."""
    import tests.util_scenes as us

    return getattr(us, f"make_{file.split(':', 1)[1]}_scene")()


def reference_default_settings():
    """The reference's RendererSettings defaults (`RendererSettings.h:
    22-34`): tonemap + gamma + sunlight on, sky on, bounce_limit=2.
    The reference's loop runs `i <= ray_bounce_limit` (`RayGen.cuh:88`)
    = 3 path segments, which is bounces=3 here."""
    from dustraytracer.scene.settings import RenderSettings

    return RenderSettings(bounces=3)


def render_accum(scene, cam, lights, settings, size, spp, start_frame=0):
    import jax
    import jax.numpy as jnp

    from dustraytracer.render.integrator import render_sample

    accum = None
    for i in range(spp):
        img = render_sample(scene, cam, lights,
                            jnp.uint32(start_frame + i),
                            width=size, height=size, settings=settings)
        accum = img if accum is None else accum + img
        if (i + 1) % 64 == 0:
            jax.block_until_ready(accum)
            print(f"  {i + 1}/{spp} samples", file=sys.stderr)
    return np.asarray(accum) / spp


def save_golden(name, image, meta):
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    np.savez_compressed(path, image=image.astype(np.float16),
                        meta=json.dumps(meta))
    # 8-bit preview for humans (the test compares the npz)
    from dustraytracer.utils.image import save_png

    save_png(os.path.join(GOLDEN_DIR, f"{name}.png"),
             np.clip(image, 0.0, 1.0))
    print(f"wrote {path}  mean={image.mean():.4f}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tier", default="all",
                   choices=["exact", "converged", "all"])
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--scenes", default="",
                   help="comma-separated subset of scene names to regen")
    args = p.parse_args(argv)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from dustraytracer.scene import make_camera
    from dustraytracer.scene.settings import LightParams

    settings = reference_default_settings()
    from dustraytracer.platform import platform

    backend = platform()

    only = {s for s in args.scenes.split(",") if s}
    for name, cfg in SCENES.items():
        if only and name not in only:
            continue
        scene = load_golden_scene(cfg["file"])
        cam = make_camera(**cfg["camera"])
        over = cfg.get("overrides", {})
        st = settings.replace(**over) if over else settings
        lights = LightParams.from_settings(st)
        for tier in ("exact", "converged"):
            if args.tier not in (tier, "all") or tier not in cfg:
                continue
            size, spp = cfg[tier]["size"], cfg[tier]["spp"]
            print(f"{name} [{tier}] {size}x{size} @ {spp}spp "
                  f"on {backend}...", file=sys.stderr)
            img = render_accum(scene, cam, lights, st, size, spp)
            meta = {"scene": cfg["file"], "camera": cfg["camera"],
                    "size": size, "spp": spp, "bounces": st.bounces,
                    "overrides": over,
                    "tier": tier, "backend": backend,
                    "settings": "reference defaults (RendererSettings.h:22-34)"
                                + (f" + {over}" if over else "")}
            save_golden(f"{name}_{tier}", img, meta)


if __name__ == "__main__":
    main()
