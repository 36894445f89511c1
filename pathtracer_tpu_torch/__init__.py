"""pathtracer_tpu_torch: the Monte-Carlo path tracer of pathtracer_tpu, ported
to PyTorch and CUDA for an NVIDIA H100 (Hopper, sm_90a).

The JAX package beside it stays the reference. This package imports torch
and never jax. Ported so far: the untextured forward path, for scenes of
primitives and of triangle meshes (the BVH walk).

- ``geometry``  numpy tuples, 4x4 matrices and transforms (host)
- ``scene``     shapes, materials, .obj parsing, the BVH builder and
                packing to device tensors
- ``render``    the camera, the tile layout and tables, and the forward
                megakernel (``csrc/megakernel.cu``) with its plain PyTorch
                version; the wavefront integrator (torch ops, its nearest
                hits from the intersect kernel on the card)
- ``driver``    segmented rendering, checkpoint/resume, metrics, profiling
- ``parallel``  multi-GPU rendering over torch.distributed: a (pixels,
                spp) mesh of ranks, the sharded renders and the driver's
                sharded segments
- ``diff``      the differentiable renders' training steps (sharded too)
- ``bench``     the benchmark record (``python -m pathtracer_tpu_torch.bench``)
- ``io``        PNG (standard library) and big-endian .raw writers
- ``scenes``    the registered scenes this package can render
- ``assets``    model lookup and procedural stand-ins for missing .obj files
"""

__version__ = "0.1.0"
