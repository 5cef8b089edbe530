"""Checkpoint/resume round trips: film state, train state (params +
optimizer state), and the optimize CLI's --resume path (save -> stop ->
resume continues from the recorded step with the recorded state).

The reference has no persistence (SURVEY §5.4); these tests pin the new
capability so inverse-rendering runs can actually recover after a kill.
"""

import json
import os

import numpy as np
import pytest


def test_film_roundtrip(tmp_path):
    import jax.numpy as jnp

    from dustraytracer.render.film import Film
    from dustraytracer.utils.checkpoint import load_film, save_film

    film = Film(accum=jnp.arange(48.0).reshape(4, 4, 3), frame=jnp.int32(7))
    p = tmp_path / "film.npz"
    save_film(p, film)
    back = load_film(p, 4, 4)
    assert back is not None
    np.testing.assert_array_equal(np.asarray(back.accum),
                                  np.asarray(film.accum))
    assert int(back.frame) == 7
    # shape mismatch -> None (caller starts fresh)
    assert load_film(p, 8, 8) is None


def test_train_state_roundtrip_with_opt_state(tmp_path):
    import jax.numpy as jnp
    import optax

    from dustraytracer.utils.checkpoint import (load_train_state,
                                                save_train_state)

    params = {"mat_albedo": jnp.full((3, 3), 0.25),
              "mat_roughness": jnp.ones((3,)) * 0.5}
    tx = optax.adam(1e-2)
    opt_state = tx.init(params)
    # advance the optimizer so its state is non-trivial
    grads = {"mat_albedo": jnp.ones((3, 3)), "mat_roughness": jnp.ones((3,))}
    updates, opt_state = tx.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)

    path = str(tmp_path / "ckpt")
    save_train_state(path, params, opt_state, step=11)

    example_p = {k: jnp.zeros_like(v) for k, v in params.items()}
    example_o = tx.init(example_p)
    restored = load_train_state(path, example_p, example_o)
    assert restored is not None
    r_params, r_opt, step = restored
    assert step == 11
    for k in params:
        np.testing.assert_allclose(np.asarray(r_params[k]),
                                   np.asarray(params[k]))
    assert r_opt is not None
    got = [np.asarray(x) for x in __import__("jax").tree.leaves(r_opt)]
    want = [np.asarray(x) for x in __import__("jax").tree.leaves(opt_state)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w)

    assert load_train_state(str(tmp_path / "missing"), example_p) is None


@pytest.mark.slow
def test_optimize_resume_roundtrip(tmp_path, capsys):
    """save -> stop -> --resume continues from the checkpointed step."""
    pytest.importorskip("PIL")  # the loader decodes the embedded PNGs
    from dustraytracer.apps import optimize
    from tests.util_scenes import cornell_glb

    scene = cornell_glb(tmp_path)

    out = str(tmp_path / "run")
    base = ["--scene", scene, "--self-test", "--optimize", "albedo",
            "--size", "32x32", "--bounces", "1", "--lr", "5e-2",
            "--out", out, "--checkpoint-every", "3"]
    # first run: 7 steps, checkpoints at steps 3 and 6
    assert optimize.main(base + ["--steps", "7"]) == 0
    first = json.loads(capsys.readouterr().out)
    assert os.path.exists(os.path.join(out, "ckpt")) or \
        os.path.exists(os.path.join(out, "ckpt.npz"))

    # resume: should pick up at step 6 and run 6..9
    assert optimize.main(base + ["--steps", "10", "--resume"]) == 0
    captured = capsys.readouterr()
    second = json.loads(captured.out)
    assert "resumed from step 6" in captured.err
    steps = [h["step"] for h in second["history"]]
    assert min(steps) >= 6
    # optimization keeps making progress across the resume
    assert second["final_loss"] <= first["final_loss"] + 1e-6
