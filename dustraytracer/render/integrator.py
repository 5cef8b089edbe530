"""The path integrator: a pure function over ray batches.

A wavefront re-design of the reference's per-thread megakernel `RayGen`
(`DustRayTracer/src/Core/Kernel/Shaders/RayGen.cuh:63-172`). Instead of
one divergent loop per pixel, the whole frame is a wavefront: (N = H*W)
rays advance together through a bounce scan with a live mask; each
stage is a fused batch of elementwise XLA ops around one traversal.

Semantics preserved from the reference (defaults) — each is a flag when
we deviate:
- gradient sky squared, scaled by sky_intensity (`RayGen.cuh:54-61`),
- throughput *= albedo / texture sample per bounce (`:110-118`),
- sun NEE: jittered un-normalized shadow direction toward a 2-angle sun
  position, *no* cosine term, contribution suncol * throughput (`:120-128`),
- diffuse bounce dir = surface normal + uniform-in-ball sample (`:133-134`),
- geometric (face) normals flipped toward the viewer (`ClosestHit.cuh:17-25`),
- debug view heads (`:136-161`),
- Uncharted2 + gamma applied per sample *before* accumulation
  (`RenderKernel.cu:29-31` averages post-processed colors; quirk kept for
  parity — the progressive average matches the reference's).

Differentiability: traversal returns discrete hit ids (stop-gradient);
every continuous quantity (hit point, barycentrics, normals, radiance) is
recomputed from those ids with differentiable math, so `jax.grad` flows
to materials, lights, camera, and vertex positions. The traversal
backends run INLINE in the bounce scan as opaque selectors on
stop-gradient inputs — reverse-mode AD saves their outputs as residuals
and transposes only the shading math (one traversal + one shading pass
per sample, fwd or fwd+bwd).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from dustraytracer.ops.intersect import moller_trumbore, varying_zero
from dustraytracer.ops.rng import (random_float, random_in_ball,
                                   random_unit_vec3, seed_pixels)
from dustraytracer.ops.tonemap import gamma_correct, uncharted2_filmic
from dustraytracer.ops.traverse import traverse_anyhit, traverse_closest
from dustraytracer.platform import platform
from dustraytracer.render.texture import sample_texture
from dustraytracer.scene.camera import Camera, generate_rays
from dustraytracer.scene.settings import (DebugMode, LightParams,
                                          RenderMode, RenderSettings)


def _fetch_material(scene, mats):
    """Per-ray material attributes (albedo, tex id, emissive, metallic,
    roughness, transmission, ior) as ONE packed row gather."""
    tab = jnp.concatenate(
        [scene.mat_albedo, scene.mat_emissive,
         scene.mat_metallic[:, None], scene.mat_roughness[:, None],
         scene.mat_albedo_tex.astype(jnp.float32)[:, None],
         scene.mat_transmission[:, None], scene.mat_ior[:, None]],
        axis=1)
    rows = tab[mats]
    return {"albedo": rows[:, 0:3], "emissive": rows[:, 3:6],
            "metallic": rows[:, 6], "roughness": rows[:, 7],
            "tex": rows[:, 8].astype(jnp.int32),
            "transmission": rows[:, 9], "ior": rows[:, 10]}


def shade_hits(scene, origin, direction, hit_idx, smooth: bool = False):
    """Differentiable hit attributes from discrete hit ids.

    Recomputes the Möller–Trumbore solution for the *selected* triangle so
    t/u/v (and everything downstream) differentiate w.r.t. vertices and
    rays, while the selection itself stays discrete. Returns a dict with
    world_position, normal (geometric viewer-facing per `ClosestHit.cuh:
    17-25`, or barycentric-interpolated vertex normals with smooth=True),
    shading uv, barycentrics, material id, front_face.
    """
    safe = jnp.maximum(hit_idx, 0)
    corner_nrm = None
    # ONE packed row gather (19 or 28 f32) of the whole per-triangle
    # record; gradients flow back through the concat's split (a
    # scatter-add into each source table)
    t_n = scene.tri_pos.shape[0]
    cols = [scene.tri_pos.reshape(t_n, 9), scene.tri_face_nrm,
            scene.tri_uv.reshape(t_n, 6),
            scene.tri_mat.astype(jnp.float32)[:, None]]
    if smooth:
        cols.append(scene.tri_nrm.reshape(t_n, 9))
    rows = jnp.concatenate(cols, axis=1)[safe]
    v0, v1, v2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    face_nrm = rows[:, 9:12]
    uv0, uv1, uv2 = rows[:, 12:14], rows[:, 14:16], rows[:, 16:18]
    mat = rows[:, 18].astype(jnp.int32)
    if smooth:
        corner_nrm = rows[:, 19:28].reshape(-1, 3, 3)
    _valid, t, u, v = moller_trumbore(origin, direction, v0, v1, v2)
    # Sanitize miss lanes: their MT solution is garbage (possibly ±inf),
    # and infinities poison gradients even through masked-out branches
    # (transpose rule: 0 cotangent * inf = NaN). Callers still mask by
    # hit_idx >= 0 for correctness; this only makes the dead lanes finite.
    ok = hit_idx >= 0
    t = jnp.where(ok, t, 1.0)
    u = jnp.where(ok, u, 0.3)
    v = jnp.where(ok, v, 0.3)
    w = 1.0 - u - v

    world_pos = origin + direction * t[:, None]
    # Geometric normal recomputed from the (differentiable) vertex
    # positions so vertex gradients flow through shading; the ingest-time
    # orientation rule (Scene.cu:270-302) is applied as a stop-gradiented
    # sign against the precomputed face normal.
    raw_n = jnp.cross(v1 - v0, v2 - v0)
    raw_n = raw_n / jnp.maximum(
        jnp.linalg.norm(raw_n, axis=-1, keepdims=True), 1e-20)
    orient = jnp.sum(jax.lax.stop_gradient(raw_n) * face_nrm, axis=-1)
    face_n = raw_n * jax.lax.stop_gradient(jnp.sign(orient))[:, None]
    d_norm = direction / jnp.linalg.norm(direction, axis=-1, keepdims=True)
    front = jnp.sum(face_n * d_norm, axis=-1) <= 0.0
    normal = jnp.where(front[:, None], face_n, -face_n)
    if smooth:
        # barycentric-interpolated vertex normals (smooth shading), still
        # flipped toward the viewer; falls back to the geometric normal
        # where the interpolated one degenerates
        sm = (w[:, None] * corner_nrm[:, 0] + u[:, None] * corner_nrm[:, 1]
              + v[:, None] * corner_nrm[:, 2])
        ln = jnp.linalg.norm(sm, axis=-1, keepdims=True)
        sm = jnp.where(ln > 1e-8, sm / jnp.maximum(ln, 1e-20), normal)
        flip = jnp.sum(sm * d_norm, axis=-1) > 0.0
        normal = jnp.where(flip[:, None], -sm, sm)

    uv = w[:, None] * uv0 + u[:, None] * uv1 + v[:, None] * uv2
    return {
        "t": t, "bary": jnp.stack([w, u, v], axis=-1),
        "world_position": world_pos, "normal": normal, "uv": uv,
        "material": mat, "front_face": front,
    }


def _bary_min(bary):
    """min over the last axis as a pairwise `minimum` chain.

    NOT jnp.min: the reduce-min JVP divides by the count of elements
    equal to the reduced answer, and inside lax.scan XLA's fusion can
    rematerialize w = 1-u-v with different rounding between the reduce
    and the equality match — zero matches -> 0/0 -> NaN tangents
    (observed on CPU XLA, jax 0.9). Pairwise minimum JVP selects per
    pair and has no count division.
    """
    return jnp.minimum(jnp.minimum(bary[..., 0], bary[..., 1]),
                       bary[..., 2])


def _sky(direction, lights: LightParams):
    """Gradient sky (`RayGen.cuh:54-61`): lerp(white, sky_color) by
    0.5*(1+dir.y), squared."""
    d = direction / jnp.linalg.norm(direction, axis=-1, keepdims=True)
    g = 0.5 * (1.0 + d[:, 1])
    col = (1.0 - g)[:, None] * jnp.ones(3) + g[:, None] * lights.sky_color
    return col * col


def _albedo(scene, mat_attrs, uv, bilinear=False):
    tex = mat_attrs["tex"]
    flat = mat_attrs["albedo"]
    sampled = sample_texture(scene, tex, uv, bilinear=bilinear)
    return jnp.where((tex >= 0)[:, None], sampled, flat)


def traversal_backend(scene, settings: RenderSettings) -> str:
    """The traversal `settings.traversal` resolves to on this platform:
    "kernel" (ops/traverse_kernel.py), "cluster", "gather" or "brute".

    auto: brute force for tiny scenes, else the Hopper kernel on the GPU
    and the XLA cluster walk on the CPU; the threaded gather walk when
    the scene has no cluster tables. An explicit "kernel" on the CPU
    runs the kernel in the Pallas interpreter (how tests reach it).
    """
    mode = settings.traversal
    if mode not in ("auto", "kernel", "cluster", "gather", "brute"):
        raise ValueError(f"unknown settings.traversal={mode!r}")
    if mode in ("kernel", "cluster", "brute") and scene.cluster is None:
        raise ValueError(f"settings.traversal={mode!r} but the scene was "
                         "built without cluster tables (cluster_k=None)")
    if mode != "auto":
        return mode
    if scene.cluster is None:
        return "gather"
    # n_clusters*k upper-bounds the real triangle count and is static
    if scene.cluster.n_clusters * scene.cluster.k <= settings.brute_max_tris:
        return "brute"
    return "kernel" if platform() == "gpu" else "cluster"


def _make_tracers(scene, settings: RenderSettings):
    """Build the (closest, anyhit) tracers (static decision, traced once).

    With alpha_test every backend applies the alpha-cutout AnyHit filter
    (`AnyHit.cuh:8-28`) inside its walk: a candidate hit whose albedo
    texture alpha is below 1 is rejected and the walk goes on, so all
    backends share the reference's exact cutout semantics. Vertex
    optimization stays on the fast path too: Scene.replace re-bakes the
    cluster tables from live tri_pos (accel/cluster.py
    refit_cluster_bvh).
    """
    from dustraytracer.ops.traverse_brute import traverse_brute
    from dustraytracer.ops.traverse_cluster import traverse_cluster
    from dustraytracer.ops.traverse_kernel import traverse_kernel

    backend = traversal_backend(scene, settings)
    cutout = scene if settings.alpha_test else None
    if backend == "brute":
        def closest(o, d):
            return traverse_brute(scene.cluster, o, d, cutout=cutout)

        def anyhit(o, d):
            return traverse_brute(scene.cluster, o, d, anyhit=True,
                                  cutout=cutout)["hit_idx"] >= 0
    elif backend == "kernel":
        interpret = platform() == "cpu"

        def closest(o, d):
            return traverse_kernel(scene.cluster, o, d, cutout=cutout,
                                   interpret=interpret)

        def anyhit(o, d):
            r = traverse_kernel(scene.cluster, o, d, anyhit=True,
                                cutout=cutout, interpret=interpret)
            return r["hit_idx"] >= 0
    elif backend == "cluster":
        def closest(o, d):
            return traverse_cluster(scene.cluster, o, d, cutout=cutout)

        def anyhit(o, d):
            r = traverse_cluster(scene.cluster, o, d, anyhit=True,
                                 cutout=cutout)
            return r["hit_idx"] >= 0
    else:
        def closest(o, d):
            return traverse_closest(scene, o, d,
                                    alpha_test=settings.alpha_test)

        def anyhit(o, d):
            return traverse_anyhit(scene, o, d,
                                   alpha_test=settings.alpha_test)

    # Tracers run INSIDE the differentiable bounce scan (see
    # render_pixels), so cut input tangents at this boundary: every
    # backend is a stop-gradient discrete selector, but the walks use
    # lax.while_loop, which has no JVP — a live tangent on origin would
    # make linearization throw.
    def _sg_in(f):
        def g(o, d):
            return f(jax.lax.stop_gradient(o), jax.lax.stop_gradient(d))
        return g

    return _sg_in(closest), _sg_in(anyhit)


def _segment(scene, lights, settings: RenderSettings, tracers, carry,
             bounce_idx):
    """One path segment for all rays (the bounce-scan body).

    The traversals run inline. They are opaque discrete selectors fed
    stop-gradient inputs (_make_tracers), so under reverse-mode AD their
    outputs become scan residuals — the transpose covers only the
    differentiable shading math around them, and traversal+shading each
    run exactly once per sample.
    """
    origin, direction, throughput, light, alive, rng = carry
    sun_pos = lights.sun_position()
    sun_col = lights.sun_color * lights.sun_intensity

    trace_closest, trace_anyhit = tracers
    # park DEAD lanes far outside the scene so their walks terminate
    # at the root test (~1 node step). Their results are ignored
    # downstream (masked by `alive`) — without this, terminated paths
    # keep paying full traversal every bounce.
    o_live = jnp.where(alive[:, None], origin, 3.0e37)
    res = trace_closest(o_live, direction)
    hit_idx = jnp.where(alive, res["hit_idx"], -1)

    # --- soft-edge visibility (boundary-term gradients) ---
    # Near a triangle edge the hard hit/miss decision hides the visibility
    # derivative from AD. One extra closest-hit trace from just past each
    # hit finds what is BEHIND it, then the edge becomes differentiable
    # with the estimator matched to the backing:
    #  * environment-backed (continuation misses): DETERMINISTIC blend —
    #    light += (1-sigma) * sky, throughput *= sigma. Zero variance; the
    #    round-1 behavior, which sky-backed recovery tests showed converges
    #    exactly.
    #  * geometry-backed (continuation hits): stochastic keep/pass-through
    #    branch with probability sigma, reweighted by
    #    w/stop_grad(w) — value unchanged, gradient the exact single-sample
    #    estimator of d(sigma*L_hit + (1-sigma)*L_behind). This is the
    #    term the round-1 version lacked (it blended only toward the sky).
    edge_idx = hit_idx
    kept = jnp.ones_like(alive)
    cont_miss = jnp.zeros_like(alive)
    if settings.soft_edges > 0.0:
        rng, u_edge = random_float(rng)
        edge_idx = hit_idx
        sh0 = shade_hits(scene, origin, direction, edge_idx)
        b0 = _bary_min(sh0["bary"])
        sigma_sg = jax.lax.stop_gradient(
            1.0 - jnp.exp(-jnp.clip(b0, 0.0, 1.0)
                          / settings.soft_edges))
        hit0 = edge_idx >= 0
        # continuation just past the hit for ALL hit lanes. Too small an
        # epsilon re-hits the same triangle, too large skips geometry
        # nearly coincident with it
        adv = jnp.where(alive & hit0,
                        res["t"] * (1.0 + 1e-4) + 1e-4, 0.0)
        # lanes with no hit need no continuation: park them far out
        # so the continuation costs ~1 node step
        o2 = jnp.where((alive & hit0)[:, None],
                       o_live + direction * adv[:, None], 3.0e37)
        res2 = trace_closest(o2, direction)
        cont_miss = alive & hit0 & (res2["hit_idx"] < 0)
        pass_th = (alive & hit0 & ~cont_miss
                   & (u_edge >= sigma_sg))
        hit_idx = jnp.where(pass_th, res2["hit_idx"], edge_idx)
        kept = ~pass_th
    miss = hit_idx < 0
    live_hit = alive & ~miss

    if settings.soft_edges > 0.0:
        # differentiable weight from the ORIGINAL edge triangle
        apply_edge = alive & (edge_idx >= 0)
        sh_e = shade_hits(scene, origin, direction, edge_idx)
        b_min = _bary_min(sh_e["bary"])
        # double-where: dead lanes' barycentrics are garbage whose
        # tangents would NaN-poison the gradient through jnp.where
        b_min = jnp.where(apply_edge, b_min, 0.5)
        sigma = 1.0 - jnp.exp(-jnp.clip(b_min, 0.0, 1.0)
                              / settings.soft_edges)
        # environment-backed: deterministic blend toward the sky
        sky_e = _sky(direction, lights)
        light = light + jnp.where(
            cont_miss[:, None],
            throughput * (1.0 - sigma)[:, None] * sky_e
            * lights.sky_intensity, 0.0)
        det_scale = jnp.where(cont_miss, sigma, 1.0)
        # geometry-backed: reweight the recorded stochastic branch
        w = jnp.where(kept, sigma, 1.0 - sigma)
        w = jnp.clip(w, 1e-4, 1.0)
        ratio = jnp.where(apply_edge & ~cont_miss,
                          w / jax.lax.stop_gradient(w), 1.0)
        # scales EVERYTHING downstream of the branch choice, including
        # the sky added below when a pass-through escapes
        throughput = throughput * (ratio * det_scale)[:, None]

    # --- sky on miss (RayGen.cuh:99-108) ---
    sky = _sky(direction, lights)
    add_sky = alive & miss
    light = light + jnp.where(add_sky[:, None],
                              throughput * sky * lights.sky_intensity, 0.0)

    sh = shade_hits(scene, origin, direction, hit_idx,
                    smooth=settings.smooth_shading)
    matd = _fetch_material(scene, sh["material"])

    # --- emission (PBR mode; the reference parses EmissiveFactor but
    #     never shades it, Material.cuh:10-22) ---
    if settings.shading == "pbr":
        emis = matd["emissive"]
        light = light + jnp.where(live_hit[:, None], throughput * emis, 0.0)

    # --- surface throughput (RayGen.cuh:110-118) ---
    alb = _albedo(scene, matd, sh["uv"],
                  bilinear=settings.tex_filter == "bilinear")
    throughput = jnp.where(live_hit[:, None], throughput * alb, throughput)

    new_origin = sh["world_position"] + sh["normal"] * 1e-3

    # --- sun NEE shadow ray (RayGen.cuh:120-128) ---
    n = origin.shape[0]
    occluded = jnp.zeros((n,), bool)
    if settings.enable_sunlight:
        rng, jit_vec = random_unit_vec3(rng)
        shadow_dir = sun_pos[None, :] + jit_vec * 1.5
        # shadow rays only matter for live hits; park the rest
        nee_o = jnp.where(live_hit[:, None], new_origin, 3.0e37)
        occluded = trace_anyhit(nee_o, shadow_dir)
        contrib = sun_col[None, :] * throughput
        if settings.shading == "pbr":
            # A dielectric lane transmits with P = transmission, so only
            # the (1-transmission) reflected fraction sees the diffuse-
            # style sun term — without this, clear glass collected the
            # full sun contribution as if it were diffuse. Remaining
            # known bias (documented): the shadow ray's anyhit treats
            # transmissive panes as opaque occluders (hard shadows
            # behind glass) — matching the reference's own limitation
            # (`TraceRay.cu:34` "does not support glass material").
            diffuse_frac = 1.0 - (1.0 - matd["metallic"]) \
                * matd["transmission"]
            contrib = contrib * diffuse_frac[:, None]
        if settings.nee_cosine:  # opt-in physical N·L (off = reference)
            d_n = shadow_dir / jnp.linalg.norm(shadow_dir, axis=-1,
                                               keepdims=True)
            contrib = contrib * jnp.maximum(
                jnp.sum(sh["normal"] * d_n, axis=-1), 0.0)[:, None]
        light = light + jnp.where((live_hit & ~occluded)[:, None],
                                  contrib, 0.0)

    # --- russian roulette (new capability; north-star item) ---
    survive = jnp.ones((n,), bool)
    if settings.russian_roulette:
        rng, u_rr = random_float(rng)
        p = jnp.clip(jnp.max(throughput, axis=-1), 0.05, 1.0)
        do_rr = bounce_idx >= settings.rr_start_bounce
        survive = ~do_rr | (u_rr < jax.lax.stop_gradient(p))
        scale = jnp.where(do_rr & survive, 1.0 / p, 1.0)
        throughput = throughput * scale[:, None]
        alive = live_hit & survive
    else:
        alive = live_hit

    # --- bounce: diffuse (RayGen.cuh:133-134) or PBR metal lobe ---
    rng, ball = random_in_ball(rng)
    bounce_dir = sh["normal"] + ball
    if settings.cosine_weighted:
        rng, sph = random_unit_vec3(rng)
        bounce_dir = sh["normal"] + sph
        bounce_dir = bounce_dir / jnp.maximum(
            jnp.linalg.norm(bounce_dir, axis=-1, keepdims=True), 1e-8)
    if settings.shading == "pbr":
        # stochastic lobe choice: P(metal) = metallic; specular direction
        # is the mirror reflection fuzzed by roughness (differentiable in
        # roughness and geometry; the lobe CHOICE is discrete and
        # reweighted below so AD sees its probability)
        rng, u_lobe = random_float(rng)
        metallic = matd["metallic"]
        roughness = matd["roughness"]
        d_n = direction / jnp.linalg.norm(direction, axis=-1, keepdims=True)
        refl = d_n - 2.0 * jnp.sum(d_n * sh["normal"], axis=-1,
                                   keepdims=True) * sh["normal"]
        spec_dir = refl + roughness[:, None] * ball
        is_metal = u_lobe < jax.lax.stop_gradient(metallic)
        bounce_dir = jnp.where(is_metal[:, None], spec_dir, bounce_dir)
        # w/stop_grad(w) reweight (same estimator as soft edges): value 1,
        # gradient = the lobe-choice probability derivative — without it
        # `metallic` is invisible to AD (its only effect is this discrete
        # branch). Applied to throughput AFTER this segment's light adds,
        # so it scales exactly the radiance downstream of the choice.
        w_lobe = jnp.where(is_metal, metallic, 1.0 - metallic)
        w_lobe = jnp.clip(w_lobe, 1e-3, 1.0)
        lobe_ratio = jnp.where(live_hit,
                               w_lobe / jax.lax.stop_gradient(w_lobe), 1.0)
        throughput = throughput * lobe_ratio[:, None]

        # --- glass (transmission) lobe ---
        # The reference's Material carries Transmission + refractive_index
        # and Random.cu declares refract()/reflectance() "for future
        # glass", but its integrator never implemented it (TraceRay.cu:34
        # "does not support glass material"). We do: a dielectric lane
        # (not metal) transmits with P = transmission; a transmitting lane
        # refracts by Snell or mirror-reflects on total internal
        # reflection / a Schlick-Fresnel coin. Both discrete choices
        # are reweighted by w/stop_grad(w), so gradients flow to
        # `transmission` (choice probability) and to `ior` (through the
        # refracted direction and Fresnel weight). Tint = albedo (already
        # multiplied into throughput above): colored glass.
        rng, u_glass = random_float(rng)
        rng, u_fresnel = random_float(rng)
        transm = matd["transmission"]
        ior = jnp.maximum(matd["ior"], 1.0 + 1e-4)
        is_glass = (~is_metal) & (
            u_glass < jax.lax.stop_gradient(transm))
        nrm = sh["normal"]  # viewer-flipped: cos_in >= 0 below
        eta = jnp.where(sh["front_face"], 1.0 / ior, ior)
        cos_in = jnp.clip(-jnp.sum(d_n * nrm, axis=-1), 0.0, 1.0)
        k = 1.0 - eta * eta * (1.0 - cos_in * cos_in)
        tir = k < 0.0
        # double-where: sqrt'(0) = inf would NaN-poison d/d(ior) through
        # the refl/refr select on TIR lanes (0 cotangent * inf = NaN)
        k_safe = jnp.where(tir, 1.0, jnp.maximum(k, 0.0))
        refr = (eta[:, None] * (d_n + cos_in[:, None] * nrm)
                - jnp.sqrt(k_safe)[:, None] * nrm)
        # Schlick reflectance (the reference's declared
        # `reflectance(cosine, ref_idx)`, Random.cu)
        r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
        fres = r0 + (1.0 - r0) * (1.0 - cos_in) ** 5
        fres = jnp.clip(fres, 0.0, 1.0)
        reflect = tir | (u_fresnel < jax.lax.stop_gradient(fres))
        glass_dir = jnp.where(reflect[:, None], refl, refr) \
            + roughness[:, None] * ball  # frosted-glass fuzz
        bounce_dir = jnp.where(is_glass[:, None], glass_dir, bounce_dir)
        # transmitted rays continue THROUGH the surface: offset along
        # -normal instead of +normal
        transmitted = is_glass & ~reflect
        new_origin = jnp.where(transmitted[:, None],
                               sh["world_position"] - nrm * 1e-3,
                               new_origin)
        # reweights: glass-vs-diffuse choice, then reflect-vs-refract.
        # Metal lanes never flipped the glass coin (is_glass requires
        # ~is_metal), so their branch weight is 1 — gating by is_metal
        # keeps d(image)/d(transmission) unbiased when metallic > 0
        # (ungated, metal lanes picked up a spurious (1-transm) factor).
        w_g = jnp.where(is_glass, transm,
                        jnp.where(is_metal, 1.0, 1.0 - transm))
        w_f = jnp.where(reflect, fres, 1.0 - fres)
        w_f = jnp.where(is_glass & ~tir, w_f, 1.0)  # TIR is deterministic
        w = jnp.clip(w_g * w_f, 1e-3, 1.0)
        glass_ratio = jnp.where(live_hit,
                                w / jax.lax.stop_gradient(w), 1.0)
        throughput = throughput * glass_ratio[:, None]

    return (new_origin, bounce_dir, throughput, light, alive, rng), None


def render_pixels(scene, camera: Camera, lights: LightParams, frame_idx,
                  pixel_ids, *, width: int, height: int,
                  settings: RenderSettings):
    """Render one sample for a flat batch of pixel ids -> (N, 3) color.

    This is the shardable unit: a device mesh splits `pixel_ids` into
    tiles and each device runs this same function on its shard (see
    parallel/). `render_sample` below is the full-frame convenience.

    Non-debug rendering is ONE differentiable bounce scan with the
    traversal kernels inline (see _segment).
    """
    n = pixel_ids.shape[0]
    debug = settings.render_mode == RenderMode.DEBUG

    def start_rays(cam):
        rng = seed_pixels(pixel_ids.astype(jnp.uint32), frame_idx)
        rng, origin, direction = generate_rays(cam, width, height, rng,
                                               pixel_ids=pixel_ids)
        # carry constants derive from the (possibly sharded) rays so the
        # scan carry is vma-consistent under shard_map (ops/intersect.py::
        # varying_zero)
        vz = varying_zero(origin)
        light = jnp.zeros((n, 3)) + vz[:, None]
        throughput = jnp.ones((n, 3)) + vz[:, None]
        alive = vz == 0.0
        return (origin, direction, throughput, light, alive, rng)

    if debug:
        # single traced iteration feeding the debug view heads
        # (RayGen.cuh:136-161)
        trace_closest, _ = _make_tracers(scene, settings)
        origin, direction, throughput, light, alive, _rng = start_rays(camera)
        res = trace_closest(origin, direction)
        hit_idx = res["hit_idx"]
        live_hit = alive & (hit_idx >= 0)
        sh = shade_hits(scene, origin, direction, hit_idx,
                        smooth=settings.smooth_shading)
        alb = _albedo(scene, _fetch_material(scene, sh["material"]),
                      sh["uv"], bilinear=settings.tex_filter == "bilinear")
        throughput = jnp.where(live_hit[:, None], throughput * alb, throughput)
        sky = _sky(direction, lights)
        light = light + jnp.where((~live_hit)[:, None],
                                  throughput * sky * lights.sky_intensity, 0.0)

        dm = settings.debug_mode
        if dm == DebugMode.ALBEDO:
            debug_out = jnp.where(live_hit[:, None], throughput, light)
        elif dm == DebugMode.NORMAL:
            debug_out = jnp.where(live_hit[:, None], sh["normal"], 0.0)
        elif dm == DebugMode.BARYCENTRIC:
            debug_out = jnp.where(live_hit[:, None], sh["bary"], 0.0)
        elif dm == DebugMode.UVS:
            uvs = jnp.concatenate([sh["uv"], jnp.zeros((n, 1))], axis=-1)
            debug_out = jnp.where(live_hit[:, None], uvs, 0.0)
        elif dm in (DebugMode.BVH, DebugMode.WORLD_BVH):
            # heat = visits * 0.05 (BVHTraversal.cuh:43), hit base color
            # (0, 0.1, 0.1) (RayGen.cuh:156-158)
            heat = res["visits"].astype(jnp.float32) * 0.05
            base = jnp.where(live_hit[:, None],
                             jnp.asarray([0.0, 0.1, 0.1]), 0.0)
            debug_out = base + heat[:, None]
        color = debug_out
        post = settings.debug_mode == DebugMode.ALBEDO
    else:
        bounce_ids = jnp.arange(settings.bounces, dtype=jnp.int32)

        # --- single differentiable scan. The traversals sit INLINE:
        # every backend is an opaque discrete selector with
        # stop-gradient inputs (_make_tracers), so reverse-mode AD saves
        # their outputs as scan residuals and transposes only the
        # shading math around them; fwd+bwd pays traversal once and
        # shading's linearization once.
        tracers = _make_tracers(jax.lax.stop_gradient(scene), settings)

        def body(carry, bounce_idx):
            return _segment(scene, lights, settings, tracers, carry,
                            bounce_idx)

        carry, _ = jax.lax.scan(body, start_rays(camera), bounce_ids)
        color = carry[3]
        post = True

    # post (RayGen.cuh:164-169): tonemap + gamma in NORMAL mode and the
    # albedo debug view only
    if post and settings.enable_tonemap:
        color = uncharted2_filmic(color, camera.exposure)
    if post and settings.enable_gamma:
        color = gamma_correct(color)

    # Zero-valued anchor over EVERY input leaf: different settings
    # variants would otherwise prune different unused arguments from
    # their executables, and jax's C++ jit fastpath has a bug pairing one
    # variant's argument-pruning metadata with another variant's
    # executable ("Execution supplied N buffers but compiled program
    # expected M"). Making pruning identical across variants defuses it.
    return color + _use_all_inputs(scene, camera, lights)


def _use_all_inputs(*pytrees):
    z = jnp.float32(0.0)
    for t in pytrees:
        for leaf in jax.tree.leaves(t):
            z = z + 0.0 * jnp.ravel(leaf)[0].astype(jnp.float32)
    return z


@partial(jax.jit, static_argnames=("width", "height", "settings"),
         inline=True)
def render_sample(scene, camera: Camera, lights: LightParams, frame_idx,
                  *, width: int, height: int, settings: RenderSettings):
    """Render one sample per pixel; returns (H, W, 3) post-processed color.

    The reference's per-frame kernel launch (`RenderKernel.cu:20-35`)
    minus accumulation — see render/film.py for the progressive average.
    `frame_idx` decorrelates the RNG across progressive samples.
    """
    pixel_ids = jnp.arange(width * height, dtype=jnp.int32)
    color = render_pixels(scene, camera, lights, frame_idx, pixel_ids,
                          width=width, height=height, settings=settings)
    return color.reshape(height, width, 3)
