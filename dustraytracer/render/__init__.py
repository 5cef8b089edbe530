from dustraytracer.render.integrator import (render_pixels, render_sample,
                                             shade_hits)
from dustraytracer.render.film import Film, film_init, film_add, film_image
from dustraytracer.render.texture import sample_texture

__all__ = [
    "render_sample", "shade_hits",
    "Film", "film_init", "film_add", "film_image",
    "sample_texture",
]
