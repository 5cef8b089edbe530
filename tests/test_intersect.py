"""Analytic oracles for the intersection primitives (SURVEY §4: the tests
the reference never had)."""

import numpy as np
import jax.numpy as jnp

from dustraytracer.ops.intersect import moller_trumbore, ray_aabb_entry


def _mt(o, d, v0, v1, v2):
    out = moller_trumbore(jnp.asarray(o, jnp.float32)[None],
                          jnp.asarray(d, jnp.float32)[None],
                          jnp.asarray(v0, jnp.float32)[None],
                          jnp.asarray(v1, jnp.float32)[None],
                          jnp.asarray(v2, jnp.float32)[None])
    return [np.asarray(x)[0] for x in out]


V0, V1, V2 = [0, 0, 0], [1, 0, 0], [0, 1, 0]


def test_mt_center_hit():
    valid, t, u, v = _mt([0.25, 0.25, -2], [0, 0, 1], V0, V1, V2)
    assert valid
    np.testing.assert_allclose(t, 2.0, rtol=1e-6)
    np.testing.assert_allclose([u, v], [0.25, 0.25], rtol=1e-5)


def test_mt_backface_accepted():
    # the reference accepts both faces (no culling, Intersection.cu:12-14)
    valid, t, _, _ = _mt([0.25, 0.25, 2], [0, 0, -1], V0, V1, V2)
    assert valid and abs(t - 2.0) < 1e-5


def test_mt_miss_outside():
    valid, *_ = _mt([2.0, 2.0, -1], [0, 0, 1], V0, V1, V2)
    assert not valid


def test_mt_parallel_ray():
    valid, *_ = _mt([0.25, 0.25, -1], [1, 0, 0], V0, V1, V2)
    assert not valid


def test_mt_behind_origin():
    # t > eps requirement (Intersection.cu:29)
    valid, *_ = _mt([0.25, 0.25, 1], [0, 0, 1], V0, V1, V2)
    assert not valid


def test_mt_differentiable():
    import jax

    def f(v0):
        _, t, _, _ = moller_trumbore(
            jnp.array([[0.25, 0.25, -2.0]]), jnp.array([[0.0, 0.0, 1.0]]),
            v0[None], jnp.array([[1.0, 0, 0]]), jnp.array([[0.0, 1, 0]]))
        return t[0]

    g = jax.grad(f)(jnp.zeros(3))
    # moving v0 along +z by dz moves the plane: dt/dz at center ~ 0.5
    assert np.isfinite(np.asarray(g)).all()
    assert abs(float(g[2]) - 0.5) < 1e-4


def _aabb(o, d, bmin, bmax):
    inv = 1.0 / np.asarray(d, np.float32)
    hit, t = ray_aabb_entry(jnp.asarray(o, jnp.float32),
                            jnp.asarray(inv), jnp.asarray(bmin, jnp.float32),
                            jnp.asarray(bmax, jnp.float32))
    return bool(hit), float(t)


def test_aabb_front_hit():
    hit, t = _aabb([0, 0, -5], [0, 0, 1], [-1, -1, -1], [1, 1, 1])
    assert hit and abs(t - 4.0) < 1e-6


def test_aabb_inside_clamps_to_zero():
    # Bounds.cu:31-34
    hit, t = _aabb([0, 0, 0], [0, 0, 1], [-1, -1, -1], [1, 1, 1])
    assert hit and t == 0.0


def test_aabb_behind_misses():
    hit, _ = _aabb([0, 0, 5], [0, 0, 1], [-1, -1, -1], [1, 1, 1])
    assert not hit


def test_aabb_axis_parallel_nan_guard():
    # direction 0 in two axes -> inv = inf; NaN-safe ordering (Bounds.cu:23-24)
    hit, t = _aabb([0.5, 0.5, -3], [0, 0, 1], [0, 0, 0], [1, 1, 1])
    assert hit and abs(t - 3.0) < 1e-6
    hit, _ = _aabb([2.5, 0.5, -3], [0, 0, 1], [0, 0, 0], [1, 1, 1])
    assert not hit


def test_aabb_on_boundary_ray_grazing_misses():
    # A ray sliding exactly in a face plane produces 0 * inf = NaN in the
    # slab products; NaN-suppressing fmin/fmax turn that slab into
    # [inf, inf] -> miss. This matches CUDA fminf/fmaxf semantics
    # (Bounds.cu:23-24): the reference also reports a miss here.
    hit, _ = _aabb([0, 0.5, -3], [0, 0, 1], [0, 0, 0], [1, 1, 1])
    assert not hit
    # ...but strictly inside the slab still hits
    hit, t = _aabb([0.001, 0.5, -3], [0, 0, 1], [0, 0, 0], [1, 1, 1])
    assert hit and abs(t - 3.0) < 1e-6
