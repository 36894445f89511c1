"""Differentiable rendering: gradients of an image loss with respect to
object colors, emission, triangle colors and textures, through the
wavefront integrator's autograd (render_image_diff, image_loss,
train_step) or the differentiable megakernel (render/grad.py, the step
factories), and the training state's checkpoints (checkpoint.py)."""
from .checkpoint import restore_train_state, save_train_state
from .grad import (SceneParams, apply_params, extract_params,
                   from_jax_params, image_loss, loss_and_grads,
                   make_megakernel_step, make_megakernel_step_tex,
                   make_megakernel_step_tri, make_sharded_megakernel_step,
                   make_sharded_train_step, render_image_diff, train_step)

__all__ = ["SceneParams", "apply_params", "extract_params",
           "from_jax_params", "image_loss", "loss_and_grads",
           "make_megakernel_step", "make_megakernel_step_tex",
           "make_megakernel_step_tri", "make_sharded_megakernel_step",
           "make_sharded_train_step", "render_image_diff", "train_step",
           "save_train_state", "restore_train_state"]
