"""dustraytracer — a differentiable, progressive path tracer for GPUs.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
DustRayTracer reference (a CUDA megakernel path tracer), re-designed as
a wavefront of XLA ops around one fused traversal kernel:

- Scene ingest: glTF 2.0 (.glb/.gltf) -> flat SoA arrays (scene/).
- Acceleration: binned-SAH BVH built on host (numpy + native C++), flat
  SoA node arrays laid out for batched, masked traversal (accel/).
- Compute path: pure-functional wavefront rendering. Rays are (N, ...)
  arrays, the bounce loop is a `lax.scan` with live-ray masking, and the
  BVH walk is a Pallas (Triton) kernel on the GPU with plain XLA walks
  beside it (ops/); `platform.py` decides which runs.
- Rendering: progressive accumulation carried as explicit state,
  sun NEE, gradient sky, alpha cutout, Uncharted2 filmic + gamma,
  debug view heads (render/).
- Differentiability: pixel gradients w.r.t. materials / camera / vertices
  with traversal decisions stop-gradiented (diff/).
- Scale: tile-sharded data parallelism over a `jax.sharding.Mesh`,
  scene/BVH replicated, one gradient psum (parallel/).
"""

__version__ = "0.1.0"

from dustraytracer.scene.settings import RenderSettings, RenderMode, DebugMode

__all__ = ["RenderSettings", "RenderMode", "DebugMode", "__version__"]
