from dustraytracer.ops.intersect import ray_aabb_entry, moller_trumbore
from dustraytracer.ops.rng import pcg_hash, random_float, random_unit_vec3, random_in_ball
from dustraytracer.ops.tonemap import uncharted2_filmic, gamma_correct
from dustraytracer.ops.traverse import traverse_closest, traverse_anyhit

__all__ = [
    "ray_aabb_entry", "moller_trumbore",
    "pcg_hash", "random_float", "random_unit_vec3", "random_in_ball",
    "uncharted2_filmic", "gamma_correct",
    "traverse_closest", "traverse_anyhit",
]
