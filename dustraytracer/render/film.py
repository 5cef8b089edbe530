"""Progressive accumulation film — explicit, resumable render state.

The reference keeps a device float3 accumulation buffer plus a frame
index, computing a running mean each frame and resetting on any camera or
setting change (`/root/reference/DustRayTracer/src/Core/Renderer.cu:
80-136`, `RenderKernel.cu:29-31`). Here that state is an explicit pytree
threaded through a pure update — trivially checkpointable (orbax/numpy),
shardable over pixel tiles, and donate-able under jit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from dustraytracer.render.integrator import render_sample
from dustraytracer.scene.settings import LightParams, RenderSettings


@jax.tree_util.register_dataclass
@dataclass
class Film:
    accum: jax.Array  # (H, W, 3) f32 running sum of post-processed samples
    frame: jax.Array  # () i32 number of accumulated samples

    def replace(self, **kw) -> "Film":
        return dataclasses.replace(self, **kw)


def film_init(width: int, height: int) -> Film:
    """Fresh accumulation state (`Renderer::resetAccumulationBuffer`,
    `Renderer.cu:132-136`)."""
    return Film(accum=jnp.zeros((height, width, 3), jnp.float32),
                frame=jnp.int32(0))


def film_add(film: Film, sample: jax.Array) -> Film:
    return Film(accum=film.accum + sample, frame=film.frame + 1)


def film_image(film: Film) -> jax.Array:
    """Running mean (`RenderKernel.cu:29-31`)."""
    return film.accum / jnp.maximum(film.frame, 1).astype(jnp.float32)


@partial(jax.jit, static_argnames=("width", "height", "settings"),
         donate_argnames=("film",))
def film_accumulate(scene, camera, lights, film: Film, count,
                    *, width: int, height: int,
                    settings: RenderSettings) -> Film:
    """Accumulate `count` samples in ONE device dispatch.

    `count` is a traced scalar (the fori_loop lowers to a while_loop), so
    one executable serves every chunk size, and the host dispatches once
    per chunk instead of once per sample. The film buffer is donated:
    accumulation is in-place on device.
    """
    start = film.frame.astype(jnp.uint32)

    def body(j, f):
        sample = render_sample(scene, camera, lights,
                               start + jnp.uint32(j), width=width,
                               height=height, settings=settings)
        return film_add(f, sample)

    return jax.lax.fori_loop(0, count, body, film)


def render_progressive(scene, camera, settings: RenderSettings, *,
                       width: int, height: int, spp: int,
                       lights: LightParams | None = None,
                       film: Film | None = None,
                       samples_per_dispatch: int = 8) -> Film:
    """Accumulate `spp` samples (respecting `settings.max_samples`, the
    reference's sample-cap gate `Renderer.cu:82`). Host loop over a jitted
    multi-sample step so progress is observable and interruptible; chunk
    size trades interactivity (viewer passes spp=1 per tick, unchanged)
    against dispatch-latency amortization (film_accumulate)."""
    lights = lights or LightParams.from_settings(settings)
    film = film or film_init(width, height)
    todo = min(int(film.frame) + spp, settings.max_samples) - int(film.frame)
    while todo > 0:
        chunk = min(todo, max(samples_per_dispatch, 1))
        film = film_accumulate(scene, camera, lights, film,
                               jnp.int32(chunk), width=width,
                               height=height, settings=settings)
        todo -= chunk
    return film
