"""Headless CLI — the renderer's front door.

Replaces the reference's ImGui editor shell (`src/Editor/EditorLayer.cpp`)
for the headless workflow: render a glTF scene progressively to PNG with
full control over the reference's settings surface
(`RendererSettings.h:4-35`), debug views, camera, and device mesh, plus a
metrics report (the editor's "Developer Metrics" panel,
`EditorLayer.cpp:100-231`, as structured JSON).

Usage:
  python -m dustraytracer.apps.cli render --scene cornell_box.glb \\
      --spp 64 --bounces 2 --size 512x512 --out img.png
  python -m dustraytracer.apps.cli render --debug-view bvh ...
  python -m dustraytracer.apps.cli stats --scene scene.glb
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _parse_size(s: str):
    w, h = s.lower().split("x")
    return int(w), int(h)


def _parse_vec3(s: str):
    return tuple(float(x) for x in s.split(","))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dustraytracer")
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("render", help="render a scene to PNG")
    r.add_argument("--scene", required=True, help="path to .glb/.gltf")
    r.add_argument("--out", default="render.png")
    r.add_argument("--size", type=_parse_size, default=(640, 360),
                   help="WxH (reference default viewport ~640x360)")
    r.add_argument("--spp", type=int, default=64)
    r.add_argument("--bounces", type=int, default=3)
    r.add_argument("--max-samples", type=int, default=500,
                   help="sample cap (RendererSettings.h:25)")
    r.add_argument("--camera-pos", type=_parse_vec3, default=(0, 1, 4))
    r.add_argument("--look-at", type=_parse_vec3, default=(0, 1, 0))
    r.add_argument("--vfov", type=float, default=60.0)
    r.add_argument("--focus-dist", type=float, default=10.0)
    r.add_argument("--defocus-angle", type=float, default=0.0)
    r.add_argument("--exposure", type=float, default=2.0)
    r.add_argument("--no-tonemap", action="store_true")
    r.add_argument("--no-gamma", action="store_true")
    r.add_argument("--no-sun", action="store_true")
    r.add_argument("--sun-intensity", type=float, default=30.0)
    r.add_argument("--sky-intensity", type=float, default=20.0)
    r.add_argument("--sky-color", type=_parse_vec3, default=(0.2, 0.4, 1.0))
    r.add_argument("--alpha-test", action="store_true",
                   help="alpha-cutout any-hit (AnyHit.cuh)")
    r.add_argument("--russian-roulette", action="store_true")
    r.add_argument("--smooth-shading", action="store_true",
                   help="interpolate glTF vertex normals (the reference "
                   "shades with flat face normals)")
    r.add_argument("--tex-filter", choices=["point", "bilinear"],
                   default="point")
    r.add_argument("--shading", choices=["reference", "pbr"],
                   default="reference",
                   help="pbr adds emissive + metallic/roughness lobes")
    r.add_argument("--debug-view",
                   choices=["albedo", "normal", "barycentric", "uvs", "bvh"],
                   help="render a debug head instead of the beauty pass")
    r.add_argument("--devices", type=int, default=0,
                   help="shard over N devices (0 = single device)")
    r.add_argument("--cpu", action="store_true", help="force CPU backend")
    r.add_argument("--metrics-out", help="write render metrics JSON here")
    r.add_argument("--checkpoint", help="film checkpoint path (.npz); "
                   "resumes if it exists, saves on completion")

    s = sub.add_parser("stats", help="print scene statistics JSON")
    s.add_argument("--scene", required=True)
    s.add_argument("--cpu", action="store_true")
    return p


def cmd_stats(args) -> int:
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    from dustraytracer.scene import load_scene

    t0 = time.perf_counter()
    scene = load_scene(args.scene)
    out = dict(scene.stats)
    out["ingest_seconds"] = round(time.perf_counter() - t0, 3)
    print(json.dumps(out, indent=2))
    return 0


def cmd_render(args) -> int:
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from dustraytracer.render.film import (Film, film_image, film_init)
    from dustraytracer.scene import load_scene, make_camera
    from dustraytracer.scene.settings import (DebugMode, LightParams,
                                              RenderMode, RenderSettings)
    from dustraytracer.utils.image import save_png

    width, height = args.size
    t0 = time.perf_counter()
    scene = load_scene(args.scene)
    ingest_s = time.perf_counter() - t0

    camera = make_camera(position=args.camera_pos, look_at=args.look_at,
                         vfov_deg=args.vfov, focus_dist=args.focus_dist,
                         defocus_angle=args.defocus_angle,
                         exposure=args.exposure)

    settings = RenderSettings(
        bounces=args.bounces, max_samples=args.max_samples,
        enable_tonemap=not args.no_tonemap, enable_gamma=not args.no_gamma,
        enable_sunlight=not args.no_sun, sun_intensity=args.sun_intensity,
        sky_intensity=args.sky_intensity, sky_color=tuple(args.sky_color),
        alpha_test=args.alpha_test, russian_roulette=args.russian_roulette,
        smooth_shading=args.smooth_shading, tex_filter=args.tex_filter,
        shading=args.shading)
    if args.debug_view:
        settings = settings.replace(
            render_mode=RenderMode.DEBUG,
            debug_mode=DebugMode[args.debug_view.upper()])
    lights = LightParams.from_settings(settings)

    film = film_init(width, height)
    if args.checkpoint:
        from dustraytracer.utils.checkpoint import load_film
        resumed = load_film(args.checkpoint, width, height)
        if resumed is not None:
            film = resumed
            print(f"resumed from {args.checkpoint} at sample "
                  f"{int(film.frame)}", file=sys.stderr)

    spp = min(args.spp, settings.max_samples)

    if args.devices > 0:
        from dustraytracer.parallel.mesh import (make_render_mesh,
                                                 replicate_scene)
        from dustraytracer.parallel.shard import sharded_render_sample

        mesh = make_render_mesh(args.devices)
        scene = replicate_scene(scene, mesh)

        def one_sample(f):
            return sharded_render_sample(scene, camera, lights,
                                         jnp.uint32(f), mesh=mesh,
                                         width=width, height=height,
                                         settings=settings)
    else:
        from dustraytracer.render.integrator import render_sample

        def one_sample(f):
            return render_sample(scene, camera, lights, jnp.uint32(f),
                                 width=width, height=height,
                                 settings=settings)

    # compile (excluded from throughput, like the reference's first-frame
    # cudaEvent warm-up). The non-sharded path warms the batched
    # accumulate executable with a count=0 call (compiles, adds nothing).
    t0 = time.perf_counter()
    start = int(film.frame)
    if start < spp:
        if args.devices > 0:
            jax.block_until_ready(one_sample(start))
        else:
            from dustraytracer.render.film import film_accumulate
            film = film_accumulate(scene, camera, lights, film,
                                   jnp.int32(0), width=width,
                                   height=height, settings=settings)
            jax.block_until_ready(film.accum)
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    if args.devices > 0:
        from dustraytracer.render.film import film_add
        for f in range(start, spp):
            film = film_add(film, one_sample(f))
    else:
        # batched accumulation: k samples per device dispatch, so the
        # per-dispatch host cost does not dominate small frames
        # (render/film.py film_accumulate)
        from dustraytracer.render.film import film_accumulate
        todo = spp - start
        while todo > 0:
            chunk = min(todo, 8)
            film = film_accumulate(scene, camera, lights, film,
                                   jnp.int32(chunk), width=width,
                                   height=height, settings=settings)
            todo -= chunk
    jax.block_until_ready(film.accum)
    render_s = time.perf_counter() - t0

    img = np.asarray(film_image(film))
    save_png(args.out, img)
    if args.checkpoint:
        from dustraytracer.utils.checkpoint import save_film
        save_film(args.checkpoint, film)

    n_samples = spp - start
    metrics = {
        "scene": args.scene,
        "triangles": scene.n_tris if hasattr(scene, "n_tris") else None,
        "size": [width, height],
        "spp": n_samples,
        "bounces": args.bounces,
        "ingest_seconds": round(ingest_s, 3),
        "compile_seconds": round(compile_s, 3),
        "render_seconds": round(render_s, 4),
        "samples_per_second": round(n_samples / render_s, 2) if render_s > 0
        and n_samples else None,
        "mrays_per_second": round(
            width * height * n_samples * 2 * args.bounces / render_s / 1e6, 2)
        if render_s > 0 and n_samples else None,
        "devices": args.devices or 1,
        "out": args.out,
    }
    print(json.dumps(metrics, indent=2))
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            json.dump(metrics, fh)
    return 0


def main(argv=None) -> int:
    from dustraytracer.platform import use_compile_cache

    use_compile_cache()
    args = build_parser().parse_args(argv)
    if args.command == "stats":
        return cmd_stats(args)
    return cmd_render(args)


if __name__ == "__main__":
    sys.exit(main())
