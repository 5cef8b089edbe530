from dustraytracer.accel.bvh import build_bvh, BvhArrays

__all__ = ["build_bvh", "BvhArrays"]
