"""Render settings — static (hashable) configuration.

Capability mirror of the reference's `RendererSettings` POD
(`DustRayTracer/src/Core/Scene/RendererSettings.h:4-35`),
re-designed as a frozen dataclass: under `jax.jit` these are trace-time
constants, so every mode combination compiles to a specialized executable
with dead branches eliminated (the reference instead branches dynamically
per CUDA thread).

Scalar *lighting parameters* (sun direction/color/intensity, sky
color/intensity) live here too but are lifted into a small `LightParams`
pytree at trace time so they remain differentiable for inverse rendering.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass

import jax
import jax.numpy as jnp


class RenderMode(enum.Enum):
    # Reference: RendererSettings::RenderModes (RendererSettings.h:12-14).
    NORMAL = 0
    DEBUG = 1


class DebugMode(enum.Enum):
    # Reference: RendererSettings::DebugModes (RendererSettings.h:15-20).
    ALBEDO = 0
    NORMAL = 1
    BARYCENTRIC = 2
    UVS = 3
    BVH = 4  # traversal heatmap
    WORLD_BVH = 5  # enum existed in the reference but was unimplemented


@dataclass(frozen=True)
class RenderSettings:
    """Static render configuration (hashable; safe as a jit static arg)."""

    # Modes (RendererSettings.h:12-20)
    render_mode: RenderMode = RenderMode.NORMAL
    debug_mode: DebugMode = DebugMode.ALBEDO

    # Integrator (RendererSettings.h:25-26). The reference's loop runs
    # `i <= ray_bounce_limit` giving limit+1 segments — we define `bounces`
    # as the actual number of path segments (documented fix).
    max_samples: int = 500
    bounces: int = 3

    # Post (RendererSettings.h:23-24)
    enable_tonemap: bool = True
    enable_gamma: bool = True

    # Lights (RendererSettings.h:27-34)
    enable_sunlight: bool = True
    sun_azimuth: float = 0.7    # radians (sunlight_dir.x)
    sun_elevation: float = 1.0  # radians (sunlight_dir.y)
    sun_color: tuple = (1.0, 1.0, 1.0)
    sun_intensity: float = 30.0
    sky_color: tuple = (0.2, 0.4, 1.0)
    sky_intensity: float = 20.0

    # New knobs (not in the reference)
    shading: str = "reference"      # "reference" | "pbr":
    #   reference = the upstream integrator exactly (albedo-only diffuse;
    #   metallic/roughness/emissive parsed but unused, Material.cuh:10-22)
    #   pbr = emissive emission + metallic specular lobe with roughness
    #   fuzz (north-star "full PBR materials" / EmissiveTest.glb)
    traversal: str = "auto"         # "auto" | "kernel" | "cluster" |
    #   "gather" | "brute":
    #   kernel = the fused Pallas traversal kernel for the GPU
    #   (ops/traverse_kernel.py; on the CPU it runs in the Pallas
    #   interpreter, which is how tests reach it),
    #   cluster = the XLA walk over the cluster tables
    #   (ops/traverse_cluster.py),
    #   gather = the threaded gather walk (ops/traverse.py),
    #   brute = all-pairs, no BVH (ops/traverse_brute.py).
    #   auto picks brute for tiny scenes (<= brute_max_tris), else the
    #   kernel on the GPU and the cluster walk on the CPU
    #   (integrator.traversal_backend).
    brute_max_tris: int = 512       # "auto" crossover: scenes at or below
    #   this many (padded) triangles skip the BVH
    alpha_test: bool = False        # alpha-cutout any-hit (AnyHit.cuh:8-28),
    #   applied inside every traversal's walk
    russian_roulette: bool = False  # RR path termination (north-star item)
    rr_start_bounce: int = 2
    soft_edges: float = 0.0         # differentiable silhouettes: hits
    #   within ~soft_edges (barycentric units) of a triangle edge blend
    #   toward whatever is BEHIND them (one continuation trace per
    #   segment): deterministically into the sky when nothing is behind,
    #   or via a stochastic keep/pass-through branch reweighted by
    #   w/stop_grad(w) when other geometry backs the edge — an unbiased
    #   single-sample estimator of the boundary gradient in both cases.
    #   0 = hard visibility (reference). Typical: 0.02-0.1 for vertex
    #   optimization. Silhouettes are antialiased in the edge zone
    #   (documented softening); costs one extra closest-hit trace per
    #   segment.
    tex_filter: str = "point"       # "point" | "bilinear" albedo texture
    #   filtering. The reference point-samples (`Texture.cu:33-58`);
    #   bilinear is a quality extension and makes texel gradients vary
    #   smoothly in uv (useful for texture optimization).
    smooth_shading: bool = False    # interpolate per-corner shading
    #   normals (glTF NORMAL attribute) across each triangle instead of
    #   the flat geometric normal. The reference parses vertex normals
    #   but shades with the face normal only (`ClosestHit.cuh:17-25`);
    #   default False keeps that look.
    cosine_weighted: bool = False   # true-Lambertian bounce (normalized);
    #   default False reproduces the reference's normal + in-ball sample
    #   (`RayGen.cuh:133-134`)
    nee_cosine: bool = False        # apply N·L to sun NEE (the reference
    #   omits it, `RayGen.cuh:124-128`); opt-in physical correction

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)


@jax.tree_util.register_pytree_node_class
class LightParams:
    """Differentiable lighting parameters, lifted out of RenderSettings.

    sun position model matches the reference exactly
    (`RayGen.cuh:67-72`): a 2-angle direction scaled by 100, with the
    (1 - sin(elevation)) horizontal attenuation quirk preserved because
    renders depend on it.
    """

    def __init__(self, sun_azimuth, sun_elevation, sun_color, sun_intensity,
                 sky_color, sky_intensity):
        self.sun_azimuth = jnp.asarray(sun_azimuth, jnp.float32)
        self.sun_elevation = jnp.asarray(sun_elevation, jnp.float32)
        self.sun_color = jnp.asarray(sun_color, jnp.float32)
        self.sun_intensity = jnp.asarray(sun_intensity, jnp.float32)
        self.sky_color = jnp.asarray(sky_color, jnp.float32)
        self.sky_intensity = jnp.asarray(sky_intensity, jnp.float32)

    @classmethod
    def from_settings(cls, s: RenderSettings) -> "LightParams":
        return cls(s.sun_azimuth, s.sun_elevation, s.sun_color,
                   s.sun_intensity, s.sky_color, s.sky_intensity)

    def sun_position(self):
        az, el = self.sun_azimuth, self.sun_elevation
        horiz = 1.0 - jnp.sin(el)
        return 100.0 * jnp.stack(
            [jnp.sin(az) * horiz, jnp.sin(el), jnp.cos(az) * horiz])

    def tree_flatten(self):
        leaves = (self.sun_azimuth, self.sun_elevation, self.sun_color,
                  self.sun_intensity, self.sky_color, self.sky_intensity)
        return leaves, None

    @classmethod
    def tree_unflatten(cls, _aux, leaves):
        obj = cls.__new__(cls)
        (obj.sun_azimuth, obj.sun_elevation, obj.sun_color,
         obj.sun_intensity, obj.sky_color, obj.sky_intensity) = leaves
        return obj
