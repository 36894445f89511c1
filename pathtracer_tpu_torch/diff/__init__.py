"""Differentiable rendering: gradients of an image loss with respect to
object colors, emission and triangle colors, through the differentiable
megakernel (render/grad.py)."""
from .grad import (SceneParams, from_jax_params, make_megakernel_step,
                   make_megakernel_step_tri)

__all__ = ["SceneParams", "from_jax_params", "make_megakernel_step",
           "make_megakernel_step_tri"]
