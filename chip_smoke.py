#!/usr/bin/env python3
"""Smoke test of the path tracer on one NVIDIA GPU.

Drives the main path once through the library's own entry points on a
seeded generated scene of about 100k triangles (scene/generate.py
courtyard: 16 RGBA textures of 256^2, one alpha cutout, one emissive
and one glass material, sun NEE on), and checks every result:

  1 device     the platform is "gpu"; the card's name and power limit
  2 scene      generate, build the BVH on the host, upload
  3 traversal  the compiled traversal kernel against brute force (65,536
               rays) and the plain XLA walk (all rays), primary and
               bounce waves at 1024^2, closest and any-hit, without and
               with the alpha-cutout test
  4 forward    render_progressive 1024^2, 4 bounces, 4 spp, against the
               same frame on the plain traversal
  5 gradients  value_and_grad of render_sample 512^2, 4 bounces, w.r.t.
               albedo, emissive and LightParams, against the plain path
  6 reference  a 128^2 frame on the CPU (brute force, matmul precision
               "highest") against the GPU frame
  7 inverse    5 steps of the apps/optimize.py albedo self-test on a
               one-device mesh; the loss must not rise
  8 timings    ms per forward and per forward+backward sample (host
               clock around block_until_ready), informational

Any failed phase exits non-zero. The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

  python3 chip_smoke.py             # one GPU, all phases
  python3 chip_smoke.py --cards 4   # only the tile-sharded render and
                                    # train step over four GPUs
  python3 chip_smoke.py --rehearse  # tiny sizes on whatever JAX has
                                    # (the CPU runs the kernel in the
                                    # Pallas interpreter); never prints
                                    # the result line, exits 3
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np

CHECKOUT = os.path.dirname(os.path.abspath(__file__))
REHEARSAL_EXIT = 3


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


@contextmanager
def phase(n, name):
    t0 = time.perf_counter()
    info = {}
    yield info
    extra = "  ".join(f"{k}={v}" for k, v in info.items())
    print(f"phase {n} {name}: ok  ({time.perf_counter() - t0:.1f} s)  "
          f"{extra}", flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip()


def sizes(rehearse: bool) -> dict:
    if rehearse:
        return dict(detail=0.1, tex=32, trace=64, sub=1024, fwd=32, spp=2,
                    grad=32, ref=16, inv=16, shard=32)
    return dict(detail=1.0, tex=256, trace=1024, sub=65536, fwd=1024,
                spp=4, grad=512, ref=128, inv=128, shard=1024)


def compare_hits(ki, kt, ri, rt, live):
    """hit ids equal on >= 99.99% of live rays; a differing id only where
    both hits' t agree within 1e-6 relative (ties, shared edges); equal
    ids with t within 1e-6 relative."""
    same = ki == ri
    rel = np.abs(kt - rt) / np.maximum(np.abs(rt), 1e-30)
    frac = float(same[live].mean())
    unexplained = int((live & ~same & (rel > 1e-6)).sum())
    both = live & same & (ri >= 0)
    max_rel = float(rel[both].max()) if both.any() else 0.0
    check(frac >= 0.9999, f"hit ids agree on {frac:.6f} < 0.9999 of rays")
    check(unexplained == 0, f"{unexplained} rays differ in hit id with t "
          "differing by more than 1e-6 relative")
    check(max_rel <= 1e-6, f"equal hit ids with t differing by {max_rel:.3g}"
          " relative > 1e-6")
    return {"agree": f"{frac:.6f}", "ties": int((live & ~same).sum()),
            "max_rel_t": f"{max_rel:.2e}"}


def make_waves(scene, cam, res, interpret):
    """Primary rays of a res^2 frame and one diffuse bounce wave from the
    kernel's primary hits (misses parked far outside, as the integrator
    does)."""
    import jax.numpy as jnp

    from dustraytracer.ops.rng import random_in_ball, seed_pixels
    from dustraytracer.ops.traverse_kernel import traverse_kernel
    from dustraytracer.render.integrator import shade_hits
    from dustraytracer.scene.camera import generate_rays

    ids = jnp.arange(res * res, dtype=jnp.int32)
    rng = seed_pixels(ids.astype(jnp.uint32), jnp.uint32(0))
    rng, o, d = generate_rays(cam, res, res, rng, pixel_ids=ids)
    r = traverse_kernel(scene.cluster, o, d, interpret=interpret)
    sh = shade_hits(scene, o, d, r["hit_idx"])
    _, ball = random_in_ball(rng)
    hit = r["hit_idx"] >= 0
    o2 = jnp.where(hit[:, None], sh["world_position"] + sh["normal"] * 1e-3,
                   3.0e37)
    d2 = jnp.where(hit[:, None], sh["normal"] + ball, 1.0)
    return {"primary": (o, d, np.ones(res * res, bool)),
            "bounce": (o2, d2, np.asarray(hit))}


def phase_traversal(scene, cam, sz, interpret):
    import jax

    from dustraytracer.ops.traverse import (traverse_anyhit,
                                            traverse_closest)
    from dustraytracer.ops.traverse_brute import traverse_brute
    from dustraytracer.ops.traverse_kernel import traverse_kernel

    cb = scene.cluster
    waves = make_waves(scene, cam, sz["trace"], interpret)
    info = {}
    # opaque geometry, then with the alpha-cutout test inside each walk
    for cut in (None, scene):
        alpha = cut is not None
        for name, (o, d, live) in waves.items():
            k = traverse_kernel(cb, o, d, cutout=cut, interpret=interpret)
            ki, kt = np.asarray(k["hit_idx"]), np.asarray(k["t"])
            p = jax.jit(traverse_closest, static_argnames="alpha_test")(
                scene, o, d, alpha_test=alpha)
            pi = np.asarray(p["hit_idx"])
            vs_plain = compare_hits(ki, kt, pi, np.asarray(p["t"]), live)
            sub = slice(0, sz["sub"])
            b = traverse_brute(cb, o[sub], d[sub], cutout=cut)
            vs_brute = compare_hits(ki[sub], kt[sub],
                                    np.asarray(b["hit_idx"]),
                                    np.asarray(b["t"]), live[sub])
            ka = np.asarray(traverse_kernel(cb, o, d, anyhit=True,
                                            cutout=cut, interpret=interpret)
                            ["hit_idx"] >= 0)
            pa = np.asarray(jax.jit(traverse_anyhit,
                                    static_argnames="alpha_test")(
                scene, o, d, alpha_test=alpha))
            tie = ki != pi
            check(not (live & (ka != (ki >= 0))).any(),
                  f"{name}: kernel any-hit disagrees with its closest hit")
            bad = int((live & ~tie & (ka != pa)).sum())
            check(bad == 0, f"{name}: {bad} any-hit occlusion bits differ "
                  "from the plain walk outside ties")
            key = name + ("_alpha" if alpha else "")
            info[key] = (f"rays={int(live.sum())} "
                         f"hit={float((ki >= 0)[live].mean()):.3f} "
                         f"plain={vs_plain} brute{sz['sub']}={vs_brute}")
    info["precision"] = "no matmul on this path, TF32 does not apply"
    return info


def smoke_settings():
    from dustraytracer.scene.settings import RenderSettings

    # sky and sun dimmer than the reference's defaults (20 and 30), so
    # the tonemapped image is not saturated and its gradients are not
    # flattened by the tonemap's shoulder
    return RenderSettings(bounces=4, shading="pbr", alpha_test=True,
                          sky_intensity=1.5, sun_intensity=4.0)


def run_one_card(args, sz, interpret):
    import jax
    import jax.numpy as jnp

    from dustraytracer.platform import platform, use_compile_cache
    from dustraytracer.render.film import film_image, render_progressive
    from dustraytracer.render.integrator import render_sample
    from dustraytracer.scene import make_camera
    from dustraytracer.scene.generate import COURTYARD_VIEW, courtyard_doc
    from dustraytracer.scene.scene import build_scene
    from dustraytracer.scene.settings import LightParams

    use_compile_cache()
    with phase(2, "scene") as info:
        t0 = time.perf_counter()
        doc = courtyard_doc(args.seed, detail=sz["detail"],
                            tex_size=sz["tex"])
        scene = build_scene(doc)
        jax.block_until_ready(scene)
        from dustraytracer.accel.native import build as native

        info["triangles"] = scene.n_tris
        info["bvh_nodes"] = scene.n_nodes
        info["cluster_nodes"] = scene.cluster.n_nodes
        info["textures"] = scene.n_textures
        info["device_bytes"] = sum(x.nbytes for x in jax.tree.leaves(scene))
        info["host_build_s"] = f"{time.perf_counter() - t0:.2f}"
        info["bvh_builder"] = ("native" if native.load_error() is None
                               else f"numpy ({native.load_error()})")
        check(bool(np.asarray(scene.tex_has_alpha).any()),
              "the scene has no alpha texture")
    cam = make_camera(**COURTYARD_VIEW)

    with phase(3, "traversal parity") as info:
        info.update(phase_traversal(scene, cam, sz, interpret))

    s = smoke_settings()
    plain = s.replace(traversal="gather")
    lights = LightParams.from_settings(s)
    with phase(4, "forward") as info:
        res = sz["fwd"]
        a = np.asarray(film_image(render_progressive(
            scene, cam, s, width=res, height=res, spp=sz["spp"])))
        b = np.asarray(film_image(render_progressive(
            scene, cam, plain, width=res, height=res, spp=sz["spp"])))
        check(a.shape == (res, res, 3), f"image shape {a.shape}")
        check(bool(np.isfinite(a).all()), "non-finite pixels")
        check(float(a.std()) > 1e-3, "constant image")
        frac = float((np.abs(a - b).max(-1) <= 1e-4).mean())
        check(frac >= 0.999, f"only {frac:.5f} of pixels within 1e-4 of "
              "the plain traversal's frame")
        info.update(size=f"{res}x{res}", spp=sz["spp"], mean=f"{a.mean():.5f}",
                    within_1e4_of_plain=f"{frac:.6f}")
        from dustraytracer.utils.image import save_png

        os.makedirs(os.path.join(CHECKOUT, "chiprun_out"), exist_ok=True)
        save_png(os.path.join(CHECKOUT, "chiprun_out", "smoke_forward.png"), a)

    def grad_fn(settings, res):
        def loss(albedo, emissive, li):
            sc = scene.replace(mat_albedo=albedo, mat_emissive=emissive)
            return jnp.mean(render_sample(sc, cam, li, jnp.uint32(0),
                                          width=res, height=res,
                                          settings=settings))
        return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))

    gres = sz["grad"]
    g_kernel = grad_fn(s, gres)
    params = (scene.mat_albedo, scene.mat_emissive, lights)
    with phase(5, "forward+backward") as info:
        lk, gk = g_kernel(*params)
        lp, gp = grad_fn(plain, gres)(*params)
        leaves_k = [np.asarray(x) for x in jax.tree.leaves(gk)]
        leaves_p = [np.asarray(x) for x in jax.tree.leaves(gp)]
        check(all(np.isfinite(x).all() for x in leaves_k),
              "non-finite gradient")
        for name, g in zip(("albedo", "emissive", "lights"), gk):
            mag = max(float(np.abs(np.asarray(x)).max())
                      for x in jax.tree.leaves(g))
            check(mag > 0.0, f"zero {name} gradient")
        worst = 0.0  # largest |diff| / (atol + rtol * |plain|)
        for x, y in zip(leaves_k, leaves_p):
            ratio = float((np.abs(x - y) / (1e-6 + 1e-4 * np.abs(y))).max())
            check(ratio <= 1.0, "kernel and plain-path gradients differ "
                  f"beyond rtol=1e-4, atol=1e-6 (max |diff| "
                  f"{float(np.abs(x - y).max()):.3g})")
            worst = max(worst, ratio)
        info.update(size=f"{gres}x{gres}", loss=f"{float(lk):.6f}",
                    plain_loss=f"{float(lp):.6f}",
                    worst_diff_over_tol=f"{worst:.3g}")

    with phase(6, "plain reference on the CPU") as info:
        cpu = jax.devices("cpu")[0]
        rres = sz["ref"]
        ref_s = s.replace(traversal="brute")
        with jax.default_device(cpu), jax.default_matmul_precision("highest"):
            on_cpu = jax.device_put((scene, cam, lights), cpu)
            ref = np.asarray(render_sample(*on_cpu, jnp.uint32(0), width=rres,
                                           height=rres, settings=ref_s))
        got = np.asarray(render_sample(scene, cam, lights, jnp.uint32(0),
                                       width=rres, height=rres, settings=s))
        rel_mean = abs(float(got.mean()) - float(ref.mean())) / max(
            abs(float(ref.mean())), 1e-12)
        frac = float((np.abs(got - ref).max(-1) <= 1e-3).mean())
        check(rel_mean <= 1e-3, f"mean differs by {rel_mean:.3g} relative")
        check(frac >= 0.99, f"only {frac:.4f} of pixels within 1e-3")
        info.update(size=f"{rres}x{rres}", mean_rel_diff=f"{rel_mean:.2e}",
                    within_1e3=f"{frac:.5f}")

    with phase(7, "inverse rendering") as info:
        from dustraytracer.apps.optimize import build_parser, optimize

        ires = sz["inv"]
        pos = ",".join(str(v) for v in COURTYARD_VIEW["position"])
        at = ",".join(str(v) for v in COURTYARD_VIEW["look_at"])
        opt_args = build_parser().parse_args([
            "--scene", "generated:courtyard", "--self-test",
            "--optimize", "albedo", "--steps", "6", "--devices", "1",
            "--size", f"{ires}x{ires}", "--bounces", "2",
            "--camera-pos", pos, "--look-at", at,
            "--vfov", str(COURTYARD_VIEW["vfov_deg"]),
            "--checkpoint-every", "0",
            "--out", os.path.join(CHECKOUT, "chiprun_out", "smoke_optimize")])
        result = optimize(opt_args, scene)
        hist = {h["step"]: h["loss"] for h in result["history"]}
        check(set(hist) >= {0, 5}, f"loss history {hist}")
        check(all(np.isfinite(v) for v in hist.values()), "non-finite loss")
        check(hist[5] <= hist[0], f"loss rose: {hist[0]} -> {hist[5]}")
        info.update(loss_step0=f"{hist[0]:.6f}", loss_step5=f"{hist[5]:.6f}")

    with phase(8, "timings") as info:
        def per_call_ms(f, *a, reps=10):
            jax.block_until_ready(f(*a))
            t0 = time.perf_counter()
            for _ in range(reps):
                jax.block_until_ready(f(*a))
            return (time.perf_counter() - t0) / reps * 1e3

        fwd = jax.jit(lambda sc, li: render_sample(
            sc, cam, li, jnp.uint32(0), width=gres, height=gres, settings=s))
        info["fwd_ms_per_sample"] = f"{per_call_ms(fwd, scene, lights):.2f}"
        info["fwdbwd_ms_per_sample"] = f"{per_call_ms(g_kernel, *params):.2f}"
        info["size"] = f"{gres}x{gres} bounces=4"
        info["card"] = (card_line().replace("\n", " | ")
                        if platform() == "gpu" else "cpu")


def run_four_cards(args, sz, interpret):
    """Tile-sharded render and one sharded train step over four devices,
    each against the same computation on one device."""
    import jax
    import jax.numpy as jnp

    from functools import partial

    from jax.sharding import PartitionSpec as P

    from dustraytracer.parallel.mesh import (TILE_AXIS, make_render_mesh,
                                             replicate_scene)
    from dustraytracer.parallel.shard import (apply_params,
                                              sharded_render_sample,
                                              sharded_train_step)
    from dustraytracer.platform import use_compile_cache
    from dustraytracer.render.integrator import (render_pixels,
                                                 render_sample)
    from dustraytracer.scene import make_camera
    from dustraytracer.scene.generate import COURTYARD_VIEW, courtyard_doc
    from dustraytracer.scene.scene import build_scene
    from dustraytracer.scene.settings import LightParams

    use_compile_cache()
    check(len(jax.devices()) >= 4, f"--cards 4 needs 4 devices, JAX has "
          f"{len(jax.devices())}")
    with phase(2, "scene") as info:
        scene = build_scene(courtyard_doc(args.seed, detail=sz["detail"],
                                          tex_size=sz["tex"]))
        info["triangles"] = scene.n_tris
    cam = make_camera(**COURTYARD_VIEW)
    s = smoke_settings()
    lights = LightParams.from_settings(s)
    mesh = make_render_mesh(4)
    rep = replicate_scene(scene, mesh)

    with phase("4c", "sharded render") as info:
        res = sz["shard"]
        out = sharded_render_sample(rep, cam, lights, jnp.uint32(0),
                                    mesh=mesh, width=res, height=res,
                                    settings=s)
        devs = {sh.device for sh in out.addressable_shards}
        check(len(devs) == 4, f"shards landed on {len(devs)} devices")
        one = render_sample(scene, cam, lights, jnp.uint32(0), width=res,
                            height=res, settings=s)
        diff = float(np.abs(np.asarray(out) - np.asarray(one)).max())
        check(diff <= 1e-5, f"sharded vs one device: max |diff| {diff:.3g}")
        info.update(size=f"{res}x{res}", devices=sorted(d.id for d in devs),
                    max_abs_diff=f"{diff:.2e}")

    with phase("4c", "sharded train step") as info:
        res = sz["grad"]
        target = render_sample(scene, cam, lights, jnp.uint32(0), width=res,
                               height=res, settings=s)
        params = {"mat_albedo": scene.mat_albedo * 0.5, "lights": lights}
        # lr = 1 so the gradient read back as p - p' carries only an ulp
        # of p (about 6e-8), well inside atol=1e-6
        lr = 1.0
        new, loss = sharded_train_step(
            params, rep, cam, lights, target, jnp.uint32(1), jnp.float32(lr),
            mesh=mesh, width=res, height=res, settings=s)
        g_sharded = jax.tree.map(lambda p, q: (p - q) / lr, params, new)
        n = res * res
        ids = jnp.arange(n, dtype=jnp.int32)

        def loss_and_colors(p, sc, c, li, tgt, frame, pix):
            sc, c, li = apply_params(sc, c, li, p)
            color = render_pixels(sc, c, li, frame, pix, width=res,
                                  height=res, settings=s)
            return jnp.sum((color - tgt) ** 2) / n, color

        # The train step's program with each shard's colours returned
        # beside its loss. Scene, camera, lights, target and frame enter
        # as arguments, as they enter sharded_train_step: closed over,
        # XLA would fold divisions by camera values into constants, and
        # f32 division on the GPU is not correctly rounded (PERF.md).
        @jax.jit
        def sharded_colors(p, sc, c, li, tgt, frame):
            @partial(jax.shard_map, mesh=mesh, out_specs=(P(), P(TILE_AXIS)),
                     in_specs=(P(), P(TILE_AXIS), P(TILE_AXIS)))
            def tile(p, pix, t):
                (l, color), _ = jax.value_and_grad(
                    loss_and_colors, has_aux=True)(p, sc, c, li, t, frame,
                                                   pix)
                return jax.lax.psum(l, TILE_AXIS), color
            return tile(p, ids, tgt.reshape(n, 3))

        @jax.jit
        def one_device(p, sc, c, li, tgt, frame):
            return jax.value_and_grad(loss_and_colors, has_aux=True)(
                p, sc, c, li, tgt.reshape(n, 3), frame, ids)

        args = (cam, lights, target, jnp.uint32(1))
        loss_m, col4 = sharded_colors(params, rep, *args)
        (l1, col1), g1 = one_device(params, scene, *args)
        # the same reference with everything but the parameters closed
        # over as constants, printed for contrast (no check)
        (l1c, _), _ = jax.jit(lambda p: jax.value_and_grad(
            loss_and_colors, has_aux=True)(p, scene, *args[:2],
                                           target.reshape(n, 3), args[3],
                                           ids))(params)
        px = np.abs(np.asarray(col4) - np.asarray(col1)).max(-1)

        def rel(x, y):
            return abs(float(x) - float(y)) / abs(float(y))

        print(f"  loss: train step {float(loss):.9g}, its program with "
              f"colours {float(loss_m):.9g}, one device {float(l1):.9g} "
              f"(relative {rel(loss, l1):.3g}), one device with inputs "
              f"closed over {float(l1c):.9g} (relative "
              f"{rel(loss, l1c):.3g}); pixels differing from one device: "
              f"{int((px > 0).sum())} of {n}, > 1e-6: "
              f"{int((px > 1e-6).sum())}, max {float(px.max()):.3g}",
              flush=True)
        # One card rendering these pixels as four 65,536-ray chunks under
        # value_and_grad gives bit-identical colours and a loss 1.1e-7
        # apart (summation order; PERF.md), so the sharded step is held
        # to the same: every pixel within 1e-6, the losses within 1e-6
        check(rel(loss_m, loss) <= 1e-6,
              "the colour-returning program's loss is not the train step's")
        check(float(px.max()) <= 1e-6, "sharded vs one-device colours: "
              f"{int((px > 1e-6).sum())} pixels differ by more than 1e-6")
        check(rel(loss, l1) <= 1e-6,
              f"loss {float(loss)} vs one device {float(l1)}")
        for x, y in zip(jax.tree.leaves(g_sharded), jax.tree.leaves(g1)):
            x, y = np.asarray(x), np.asarray(y)
            ok = np.abs(x - y) <= 1e-4 * np.abs(y) + 1e-6
            check(bool(ok.all()), "sharded vs one-device gradients differ: "
                  f"max |diff| {float(np.abs(x - y).max()):.3g}")
        info.update(size=f"{res}x{res}", loss=f"{float(loss):.9g}",
                    one_device_loss=f"{float(l1):.9g}",
                    loss_rel_diff=f"{rel(loss, l1):.3g}",
                    max_pixel_diff=f"{float(px.max()):.3g}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="tiny sizes on any platform; never reports ok")
    args = p.parse_args(argv)

    import jax

    from dustraytracer.platform import platform, require_gpu

    with phase(1, "device") as info:
        if args.rehearse:
            plat = platform()
        else:
            require_gpu()
            plat = "gpu"
            info["card"] = card_line().replace("\n", " | ")
        dev = jax.devices()[0]
        info.update(platform=dev.platform, kind=dev.device_kind,
                    count=len(jax.devices()))
    sz = sizes(args.rehearse)
    interpret = plat == "cpu"
    if args.cards == 4:
        run_four_cards(args, sz, interpret)
    else:
        run_one_card(args, sz, interpret)
    if args.rehearse:
        print("rehearsal finished: no result is reported", flush=True)
        return REHEARSAL_EXIT
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
