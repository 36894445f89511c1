"""Multi-GPU rendering and training over torch.distributed.

Counterpart of pathtracer_tpu.parallel: a 2-D (pixels, spp) mesh of ranks,
one process and one device a rank. Scene tables are replicated on every
rank; the pixels axis splits the image, the spp axis splits the sample
budget, whose partial sums are reduced with all_reduce(SUM); an all-gather
over the pixels axis leaves the whole frame on every rank.
"""
from .mesh import RenderMesh, make_mesh, mesh_shape_for
from .multihost import global_render_mesh, initialize_multihost
from .render_dist import render_sharded, render_sharded_megakernel

__all__ = ["RenderMesh", "make_mesh", "mesh_shape_for", "render_sharded",
           "render_sharded_megakernel", "initialize_multihost",
           "global_render_mesh"]
