"""The one place that decides the platform, and where compiled code is
cached.

The program runs on an NVIDIA GPU, where the traversal kernel runs
compiled, or on the CPU, where the plain XLA paths run (tests and the
multi-device rehearsal on virtual CPU devices). Every path choice reads
`platform()`; nothing else asks JAX which backend it has.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

_CHECKOUT = Path(__file__).resolve().parent.parent


def platform() -> str:
    """"gpu" or "cpu"; any other JAX backend raises."""
    backend = jax.default_backend()
    if backend in ("gpu", "cuda"):
        return "gpu"
    if backend == "cpu":
        return "cpu"
    raise RuntimeError(f"unsupported JAX backend {backend!r}: this program "
                       "runs on an NVIDIA GPU, or on the CPU for tests")


def require_gpu():
    """The GPU devices, or an error: measurement and the chip smoke test
    never fall back to the CPU."""
    if platform() != "gpu":
        raise RuntimeError("no GPU found: JAX runs on "
                           f"{jax.default_backend()!r}")
    return jax.devices()


def use_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and this
    sets nothing. Otherwise the cache lives at `<checkout>/.jax_cache`,
    a fixed path (the path is part of the cache key) that git ignores.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(_CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
