from dustraytracer.parallel.mesh import make_render_mesh, replicate_scene
from dustraytracer.parallel.shard import (sharded_render_sample,
                                          sharded_train_step)

__all__ = ["make_render_mesh", "replicate_scene",
           "sharded_render_sample", "sharded_train_step"]
