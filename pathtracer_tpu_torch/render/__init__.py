"""Rendering: the camera, the forward megakernel with its gradient and
intersect kernels, and the wavefront integrator."""
