"""Post-processing: Uncharted2 filmic tonemap + gamma.

Behavioral parity with `DustRayTracer/src/Core/Kernel/Shaders/
RayGen.cuh:23-52`: Hable's Uncharted2 curve with exposure bias and white
point 11.2, then sqrt "gamma 2.0" correction. Pure elementwise math;
fuses into the surrounding render under jit.
"""

from __future__ import annotations

import jax.numpy as jnp


def _uncharted2_partial(x):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def uncharted2_filmic(color, exposure=2.0):
    curr = _uncharted2_partial(color * exposure)
    white_scale = 1.0 / _uncharted2_partial(jnp.float32(11.2))
    return curr * white_scale


def gamma_correct(color):
    """sqrt gamma (gamma 2.0), `RayGen.cuh:49-52`.

    Double-where: black pixels (a ray that ends on an unlit, non-emitting
    surface) would otherwise send sqrt'(0) = inf into the backward pass,
    and inf times their zero tangent is NaN."""
    pos = color > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, color, 1.0)), 0.0)
