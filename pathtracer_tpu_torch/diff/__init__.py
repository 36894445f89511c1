"""Differentiable rendering: gradients of an image loss with respect to
object colors, emission, triangle colors and texels, through the differentiable
megakernel (render/grad.py)."""
from .grad import (SceneParams, from_jax_params, make_megakernel_step,
                   make_megakernel_step_tex, make_megakernel_step_tri)

__all__ = ["SceneParams", "from_jax_params", "make_megakernel_step",
           "make_megakernel_step_tex", "make_megakernel_step_tri"]
