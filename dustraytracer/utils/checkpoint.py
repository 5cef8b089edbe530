"""Checkpoint/resume for progressive renders and inverse-rendering runs.

The reference has no persistence at all — its resumable state is the
in-memory accumulation buffer + frame index, lost on exit (SURVEY §5.4).
Here that state is an explicit pytree, so checkpointing is trivial:
npz for the film (fast, dependency-free) and orbax for full optimizer
state in inverse rendering.
"""

from __future__ import annotations

import numpy as np


def save_film(path, film) -> None:
    """Persist film accumulation state (resumable progressive render)."""
    np.savez_compressed(path, accum=np.asarray(film.accum),
                        frame=np.asarray(film.frame))


def load_film(path, width: int, height: int):
    """Load a film checkpoint; None if absent or shape-mismatched."""
    import os

    import jax.numpy as jnp

    from dustraytracer.render.film import Film

    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        accum = z["accum"]
        frame = int(z["frame"])
    if accum.shape != (height, width, 3):
        return None
    return Film(accum=jnp.asarray(accum), frame=jnp.int32(frame))


def save_train_state(path, params, opt_state=None, step: int = 0) -> None:
    """Persist inverse-rendering state (params + optax optimizer state)
    with orbax; falls back to npz-of-leaves when orbax is unavailable.
    The round-trip partner is `load_train_state`; `optimize.py --resume`
    uses the pair to survive kills mid-run."""
    import jax

    try:
        import orbax.checkpoint as ocp

        ckptr = ocp.StandardCheckpointer()
        state = {"params": params, "step": step}
        if opt_state is not None:
            state["opt_state"] = opt_state
        ckptr.save(path, state, force=True)
        ckptr.wait_until_finished()
    except Exception:
        arrays = {"step": step}
        p_leaves = jax.tree.flatten(params)[0]
        arrays.update({f"p{i}": np.asarray(l)
                       for i, l in enumerate(p_leaves)})
        if opt_state is not None:
            o_leaves = jax.tree.flatten(opt_state)[0]
            arrays.update({f"o{i}": np.asarray(l)
                           for i, l in enumerate(o_leaves)})
        np.savez_compressed(str(path) + ".npz", **arrays)


def load_train_state(path, example_params, example_opt_state=None):
    """Restore (params, opt_state, step) saved by save_train_state.

    `example_*` provide the pytree structure (orbax and the npz fallback
    both store flat leaves). Returns None when no checkpoint exists;
    opt_state in the result is None when it was not saved or no example
    structure was given.
    """
    import os

    import jax
    import jax.numpy as jnp

    try:
        import orbax.checkpoint as ocp

        if os.path.exists(path):
            ckptr = ocp.StandardCheckpointer()
            example = {"params": example_params, "step": 0}
            if example_opt_state is not None:
                example["opt_state"] = example_opt_state
            restored = ckptr.restore(path, example)
            return (restored["params"], restored.get("opt_state"),
                    int(restored["step"]))
    except Exception:
        pass
    npz = str(path) + ".npz"
    if os.path.exists(npz):
        with np.load(npz) as z:
            p_leaves, p_def = jax.tree.flatten(example_params)
            new_p = [jnp.asarray(z[f"p{i}"]) for i in range(len(p_leaves))]
            params = jax.tree.unflatten(p_def, new_p)
            opt_state = None
            if example_opt_state is not None and "o0" in z:
                o_leaves, o_def = jax.tree.flatten(example_opt_state)
                new_o = [jnp.asarray(z[f"o{i}"])
                         for i in range(len(o_leaves))]
                opt_state = jax.tree.unflatten(o_def, new_o)
            step = int(z["step"])
        return params, opt_state, step
    return None
