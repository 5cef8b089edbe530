"""Inverse rendering CLI: gradient descent on scene parameters.

The capability this renderer layers on reference parity (BASELINE.json
config 4: "gradient descent on material params"): render a target,
perturb parameters, recover them by differentiating through the
renderer. Uses optax (adam) over the tile-sharded train step
(`parallel/shard.py`) so the same command runs on one GPU or several.

Usage:
  python -m dustraytracer.apps.optimize --scene cornell_box.glb \\
      --target target.png --optimize albedo --steps 200 --out recovered/
  # self-test mode: render the target from the true scene, scramble the
  # params, recover them:
  python -m dustraytracer.apps.optimize --scene x.glb --self-test ...
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="dustraytracer.optimize")
    p.add_argument("--scene", required=True)
    p.add_argument("--target", help="target PNG (linear fit happens in "
                   "tonemapped space); omit with --self-test")
    p.add_argument("--self-test", action="store_true",
                   help="render target from true params, scramble, recover")
    p.add_argument("--optimize", nargs="+", default=["albedo"],
                   choices=["albedo", "emissive", "roughness", "metallic",
                            "transmission", "ior",
                            "lights", "camera", "vertices", "textures"])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--size", default="128x128")
    p.add_argument("--spp-per-step", type=int, default=1)
    p.add_argument("--bounces", type=int, default=2)
    p.add_argument("--camera-pos", default="0,1,4")
    p.add_argument("--look-at", default="0,1,0")
    p.add_argument("--vfov", type=float, default=60.0)
    p.add_argument("--devices", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", default="optimize_out")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--resume", action="store_true",
                   help="continue from {out}/ckpt if present (params + "
                   "optimizer state + step)")
    p.add_argument("--stochastic", action="store_true",
                   help="vary the RNG frame per step (noisy loss); default "
                   "keeps the sample deterministic, which converges faster "
                   "on self-tests")
    p.add_argument("--perturb-vertices", type=float, default=0.0,
                   help="self-test vertex init: true + U(-s, s) offset "
                   "instead of the default 0.5*true + 0.25*U scramble "
                   "(a full scramble destroys a mesh beyond any local "
                   "silhouette gradient's basin)")
    p.add_argument("--soft-edges", type=float, default=None,
                   help="differentiable silhouettes (settings.soft_edges); "
                   "default: 0.05 when optimizing vertices, else 0")
    p.add_argument("--nee-cosine", action="store_true",
                   help="N*L on sun NEE — gives vertex gradients a "
                   "continuous shading term at low bounce counts")
    return p


PARAM_KEYS = {
    "albedo": "mat_albedo",
    "emissive": "mat_emissive",
    "roughness": "mat_roughness",
    "metallic": "mat_metallic",
    "transmission": "mat_transmission",
    "ior": "mat_ior",
    "vertices": "tri_pos",
    "textures": "tex_stack",
}

# physical ranges, projected after every update (adam can otherwise walk
# weakly-observed parameters — e.g. roughness while metallic -> 0 — far
# out of their domain and strand them there)
PARAM_BOUNDS = {
    "mat_albedo": (0.0, 1.0),
    "mat_emissive": (0.0, None),
    "mat_roughness": (0.0, 1.0),
    "mat_metallic": (0.0, 1.0),
    "mat_transmission": (0.0, 1.0),
    # lower bound sits ABOVE the integrator's maximum(ior, 1+1e-4) clamp:
    # at exactly 1.0 the clamp's gradient is zero and a clipped ior could
    # never recover
    "mat_ior": (1.01, 3.0),
    "tex_stack": (0.0, 1.0),
}


def project_params(params):
    import jax.numpy as jnp

    out = dict(params)
    for k, (lo, hi) in PARAM_BOUNDS.items():
        if k in out:
            out[k] = jnp.clip(out[k], lo, hi)
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    from dustraytracer.platform import use_compile_cache
    from dustraytracer.scene import load_scene

    use_compile_cache()
    result = optimize(args, load_scene(args.scene))
    print(json.dumps(result, indent=2))
    return 0


def optimize(args, scene) -> dict:
    """The descent loop of `main` on an already built Scene; returns the
    report (loss history, and parameter errors in self-test mode)."""
    import os

    import jax
    import jax.numpy as jnp
    import optax

    from dustraytracer.parallel.mesh import make_render_mesh
    from dustraytracer.parallel.shard import apply_params
    from dustraytracer.render.integrator import render_pixels, render_sample
    from dustraytracer.scene import make_camera
    from dustraytracer.scene.settings import LightParams, RenderSettings
    from dustraytracer.utils.image import save_png

    os.makedirs(args.out, exist_ok=True)
    w, h = (int(x) for x in args.size.split("x"))
    if "textures" in args.optimize:
        # texel values become differentiable parameters on a linear
        # float32 stack (render-identical to the uint8 path)
        from dustraytracer.render.texture import decode_textures
        scene = decode_textures(scene)
    cam = make_camera(position=tuple(float(x) for x in args.camera_pos.split(",")),
                      look_at=tuple(float(x) for x in args.look_at.split(",")),
                      vfov_deg=args.vfov)
    settings = RenderSettings(bounces=args.bounces, enable_tonemap=False,
                              enable_gamma=False)
    # vertex updates keep the fast traversal: apply_params re-bakes the
    # cluster tables from live tri_pos each step (accel/cluster.py
    # refit_cluster_bvh)
    soft = args.soft_edges
    if soft is None:
        soft = 0.05 if "vertices" in args.optimize else 0.0
    if soft > 0.0:
        settings = settings.replace(soft_edges=float(soft))
    if args.nee_cosine:
        settings = settings.replace(nee_cosine=True)
    if {"emissive", "metallic", "roughness", "transmission",
            "ior"} & set(args.optimize):
        # these parameters only shade in the PBR model
        settings = settings.replace(shading="pbr")
    lights = LightParams.from_settings(settings)

    # --- target ---
    if args.self_test or not args.target:
        # deterministic mode: target uses the same RNG frame the training
        # step renders with, so loss -> 0 at the true parameters
        tgt_frame = 9999 if args.stochastic else 0
        target = render_sample(scene, cam, lights, jnp.uint32(tgt_frame),
                               width=w, height=h, settings=settings)
        save_png(f"{args.out}/target.png", np.clip(np.asarray(target), 0, 1))
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("reading a --target image needs the Pillow "
                              "package (pip install Pillow)") from e

        img = np.asarray(Image.open(args.target).convert("RGB"),
                         np.float32)[::-1] / 255.0
        target = jnp.asarray(img)

    # --- initial (scrambled) params ---
    key = jax.random.PRNGKey(0)
    params = {}
    for name in args.optimize:
        if name == "lights":
            params["lights"] = lights
        elif name == "camera":
            params["camera"] = cam
        else:
            k = PARAM_KEYS[name]
            true = getattr(scene, k)
            if args.self_test:
                key, sub = jax.random.split(key)
                if name == "vertices" and args.perturb_vertices > 0:
                    s_p = args.perturb_vertices
                    init = true + jax.random.uniform(
                        sub, true.shape, minval=-s_p, maxval=s_p)
                else:
                    init = true * 0.5 + 0.25 * jax.random.uniform(
                        sub, true.shape)
            else:
                init = true
            params[k] = init

    # --- optimizer ---
    tx = optax.adam(args.lr)
    opt_state = tx.init(params)

    # --- resume (params + optimizer state + step) ---
    start_step = 0
    if args.resume:
        from dustraytracer.utils.checkpoint import load_train_state

        restored = load_train_state(f"{args.out}/ckpt", params, opt_state)
        if restored is not None:
            params, r_opt, start_step = restored
            if r_opt is not None:
                opt_state = r_opt
            print(f"resumed from step {start_step}", file=sys.stderr)

    n = w * h
    pixel_ids_full = jnp.arange(n, dtype=jnp.int32)
    target_flat = target.reshape(n, 3)

    def local_loss(params, ids, tgt, frame):
        sc, c, li = apply_params(scene, cam, lights, params)
        color = render_pixels(sc, c, li, frame, ids,
                              width=w, height=h, settings=settings)
        # sum locally, normalize by the GLOBAL pixel count so the sharded
        # loss equals the single-device mean
        return jnp.sum((color - tgt) ** 2) / (n * 3)

    if args.devices > 0:
        # tile-sharded training: pixels split over the mesh, params
        # replicated; gradients all-reduce automatically (vma transpose
        # of the replicated->varying broadcast, parallel/shard.py)
        from functools import partial

        from jax.sharding import PartitionSpec as P

        from dustraytracer.parallel.mesh import (TILE_AXIS,
                                                 replicate_scene)
        from dustraytracer.parallel.shard import shard_map

        if n % args.devices:
            raise SystemExit(f"pixels ({n}) must divide --devices")
        mesh = make_render_mesh(args.devices)
        scene = replicate_scene(scene, mesh)

        def loss_fn(params, frame):
            @partial(shard_map, mesh=mesh,
                     in_specs=(P(), P(TILE_AXIS), P(TILE_AXIS)),
                     out_specs=P())
            def _tile(p, ids, tgt):
                loss = local_loss(p, ids, tgt, frame)
                return jax.lax.psum(loss, TILE_AXIS)

            return _tile(params, pixel_ids_full, jnp.asarray(target_flat))
    else:
        def loss_fn(params, frame):
            return local_loss(params, pixel_ids_full, target_flat, frame)

    @jax.jit
    def train_step(params, opt_state, frame):
        loss, grads = jax.value_and_grad(loss_fn)(params, frame)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = project_params(optax.apply_updates(params, updates))
        return params, opt_state, loss

    history = []
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        frame = step % 64 if args.stochastic else 0
        params, opt_state, loss = train_step(params, opt_state,
                                             jnp.uint32(frame))
        if step % 10 == 0 or step == args.steps - 1:
            l = float(loss)
            history.append({"step": step, "loss": l,
                            "t": round(time.perf_counter() - t0, 2)})
            print(f"step {step:5d}  loss {l:.6f}", file=sys.stderr)
        if args.checkpoint_every and step and step % args.checkpoint_every == 0:
            from dustraytracer.utils.checkpoint import save_train_state
            save_train_state(f"{args.out}/ckpt", params, opt_state,
                             step=step)

    # --- report ---
    sc, c, li = apply_params(scene, cam, lights, params)
    final = render_sample(sc, c, li, jnp.uint32(9999),
                          width=w, height=h, settings=settings)
    save_png(f"{args.out}/final.png", np.clip(np.asarray(final), 0, 1))
    result = {"history": history,
              "final_loss": history[-1]["loss"] if history else None}
    if args.self_test:
        errs = {}
        for name in args.optimize:
            if name in ("lights", "camera"):
                continue
            k = PARAM_KEYS[name]
            true = np.asarray(getattr(scene, k))
            got = np.asarray(params[k])
            errs[k] = float(np.abs(true - got).mean())
        result["param_mae"] = errs
    return result


if __name__ == "__main__":
    sys.exit(main())
