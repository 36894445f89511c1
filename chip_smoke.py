#!/usr/bin/env python3
"""Smoke test of pathtracer_tpu_torch on one CUDA card.

Run from the root of the checkout: `python3 chip_smoke.py`. It builds the
CUDA megakernel from the sources in the checkout and prints the ptxas
register and spill counts of both its instantiations (primitive scenes,
and scenes with meshes, which add the BVH walk). It holds the kernel
against its plain PyTorch version on the card at 160x120 (primitive scenes
by the per-slot rule, mesh scenes bit for bit), renders the `reference`
scene and then the `teapot` scene at 1280x960x2048 spp through the CLI
(the reference renderer's two benchmarks) and checks each image, requires
the kernel to be bit-equal to the plain version on each driver's last
segment at that size, and times the kernel against the plain version.
The textured instantiations (K1-tex, kTex) are held bit for bit against
the plain version on `textures`, `envmap`, `cubemap` and `textures-file`
(the first 64 tiles of 1280x960, phase 3); `textures` renders at
1280x960x2048 spp through the CLI (phase 4); phase 5 times K1-tex on
`textures`, `cubemap` and `envmap-file`, runs the texel-fetch probe (the
kernel's own fetch function at random UVs over a 2048x1024 texture, the
counterpart of the JAX package's tools/tex_vmem_probe.py) and measures
what the JAX package's 128x128-area mip costs `envmap-file` (per-pixel
mean abs difference of two renders, full pool against the mip). Phase 5
also splits K1-mesh's time on `teapot` and the size-check mesh (the node
walk alone, the leaf tests, K1 on `reference` as the bounce without a
walk, the node and leaf-slot tests a sample, the object loop's operations
a bounce) and times K1-mesh at the BVH leaf sizes of LEAF_SWEEP
(PT_BVH_LEAF); phase 4 counts the slots of the last `teapot` segment that
differ when the mesh is packed at the JAX package's leaf size instead of
the port's. With `--ab-parent DIR` (DIR holding another checkout's
pathtracer_tpu_torch, or a copy with one edit; the option may be given
more than once, each tree in turn), phase 5 also runs the K1 family of
AB_CASES (K1, K1-mesh and its walks, K1-tex, K1-nee, K5, K6) on that
tree's own code and tables (its package imported under another name, its
kernels built from its own csrc) against this one, in turns, and requires
bit-equal outputs (the gradient rule for K6) at the leaf sizes both trees'
JAX-package rule picks; the kernels outside the K1 family must keep their
ptxas register, stack and spill counts (the K1 family's are printed
before and after).
Then the gradient kernel (K6, the same source's kGrad instantiations):
phase 6 holds it against its plain version at 1280x960x4 spp in object mode
on `reference` and in triangle mode on `teapot` and the size-check mesh,
and times both; phase 7 drives training through the training steps at
1280x960, object colors on `reference` (32 spp a step, the fwd+bwd rate as
bench.py measures it) and triangle colors on `teapot` (8 spp a step),
each loss falling over 5 steps, and a short `train_demo --tri` run.
Phase 8 is the texel path on `textures-train` (K6-tex and the f32-texel
forward, the kF32 instantiations): the f32-texel forward bit-equal to rgb8
K1-tex at 1280x960x8 spp, K6-tex against its plain version at 1280x960x4
spp, then the main path: texels perturbed and recovered toward a
common-random-number target at 1280x960 (32 spp a step, Adam through
make_diff_render_tex, the loss falling over 5 steps), the fwd+bwd rate of
make_megakernel_step_tex as bench.py measures `fwd_bwd_textures-train`,
and a short `train_demo --tex`. Next-event estimation (K1-nee, the kNee
instantiations): phase 3 holds it bit for bit against its plain version on
`reference`, `transparency_quad_lights`, `transparency_f_light`, `teapot`,
`textures`, `cubemap`, with depth of field, with PT_COHERENT=0 and on the
tie scenes (each light with a copy of itself after and before it, on the
primitive and the mesh instantiation) at 160x120, and the light point's
sincosf against torch.sin and torch.cos on every f32 angle of its ranges
(bit for bit); phase 4 renders
`reference --nee` and `teapot --nee` at 1280x960x2048 spp through the
CLI, checks the launch counts and each image, requires the last segment
bit-equal to the plain version (whose counts hold the kernel's shadow
query, light_visible, to the nearest-hit rule on every cast shadow ray)
and prints the shares of the shadow rays that miss their light, stop at
an occluder and are lit; phase 5 times K1-nee at 1280x960x8 spp beside
K1 and K1-mesh on the same samples, with the bound of the query's own
work and, beside it, that of the JAX kernel's nearest-hit work, prints the ptxas counts of the per-thread NEE
instantiations, and measures what a runtime branch in place of the kNee
flag would cost the renders without NEE (the NEE instantiation with no
light against the one without NEE code, and their ptxas counts). Phase 9
runs the intersect-only kernel (K5) on 9,830,400 rays a batch (1280x960x8
jittered camera rays, then one bounce of random rays from their hits, on
the incoming side) on `reference`, `teapot` and the size-check mesh, bit
for bit against its plain version, and times it. The mesh walks of the JAX package's knobs (Kernel A, the warp-packet
walk: PT_SUBPACKET 1/2/3; Kernel B, its tensor-core leaves:
PT_TRAVERSAL=mxu; the node walk alone: PT_ABLATE_LEAF=1) and the probes
(P2, probes/op_rate.py; P3, probes/leaf_bench.py): phase 2 builds the
probes' library beside the megakernel's (two nvcc at once) and runs P2,
whose fastest non-FMA rate replaces the spec rate in every bound if it is
higher; phase 3 holds Kernel A bit for bit (modes 2 and 3) and Kernel B by
the per-slot rule on `teapot`, the size-check mesh, `cubemap` and `teapot
--nee` at 160x120, and Kernel B's leaf test per ray x triangle pair;
phase 4 renders `teapot` at 1280x960x2048 through the CLI three more times
(PT_SUBPACKET=2 with the subblock order, PT_SUBPACKET=3, PT_TRAVERSAL=mxu
with the rowblock order: this slice's main path), checks the launch
counts and each image's mean against the default render's, and holds the
last segment against the plain version; phase 5 times every walk on
`teapot` and the size-check mesh at 1280x960x8 with K1-mesh's bound and
each walk's node and leaf tests a sample; phase 9 runs K5 on teapot's two
batches under modes 2, 3 and mxu; phase 10 runs P3 (each leaf-body
variant's marginal cost) and the cross-check of the leaf rate against
K1-mesh's. For K1-tex's redesign (R3: the fetch's wrap without a
division) phase 3 also holds the fetches' wrap to the JAX formula on the
card over every integer in [-2^25, 2^25] for each texture side of the
repository's scenes; phase 5
splits the texture path (each textured scene on its textured and its
untextured instantiation, on this tree and on the trees of `--tex-split
DIR`, e.g. a copy whose four loads are pinned to one address, made by
tools/tex_variants.py), times the fetch probe with and without the wrap,
and gives K1-tex the bound of its own work beside the JAX kernel's; the
A/B covers every textured instantiation. For the gradient kernel's
redesign (K6, K6-tex: the adds merged per warp) phase 6 holds each
gradient row (K6 `reference`, `teapot` triangles and the size-check mesh,
K6-tex `textures-train`) against its plain version at 4 spp and at the
training steps' 32, with bounds, prints the spp-per-launch curve (4, 8,
16, 32 of GRAD_ROWS) and, with `--grad-split DIR`, times other trees'
gradient kernels beside this one's (tools/grad_variants.py's copies: the
split of a kernel into its replay, tape, reverse walk and adds; the tape
in shared memory; no merge; the launch shape); `--grad-only` runs these
and the A/B alone. The A/B also compares the forward instantiations'
SASS (cuobjdump) and measures bench.py's three fwd+bwd rates on both
trees in turns; phase 4 counts the slots that differ at the JAX
package's leaf size on `gopher` and the size-check mesh as well, with
and without NEE. For K1's object loop (R4: 16-byte object rows) phase 3
holds the object loop's filter (plane_skip, round_skip: exact, but not
taken by the loop) to the exact tests on 2^28 cases a type, phase 5
times the forward rows of K1_ROWS on this tree and on the trees of
`--k1-split DIR` (tools/k1_variants.py's copies: the divisions made
approximate, the filter, the draws taken where read, one sincosf, the
16-byte rows, the launch shape), and the A/B adds K1 at 128 spp and K5
on the size-check mesh; `--k1-only` runs the filter check, the split and
the A/B alone. Phase 11 runs the wavefront forward on K5; phase 12
(`--ad-only` alone) its autograd path: diff.train_step at 1280x960x1 on
`reference`, `teapot` and `textures` through K5 on every bounce of the
fixed trip (K5 bit-equal to its plain version, triangle slot included, on
a step's own rays; the launch and re-attach counts, peak memory, live
rays a bounce, the fwd+bwd rate as bench.py measures it, the loss falling
under Adam; no bounce rematerialized, as the batch fits), the bounces of
`textures` rematerialized (every bounce: K5 once a bounce in the forward
and once in the backward's recompute, each recomputed launch bit-equal to
the forward's, the gradients within the rule of the loop without it at a
third of its peak memory or less; the SGD step at 8 spp, which the plain
loop cannot hold, with the bounces the memory asks for rematerialized, its
peak memory and rate; with `--ad-only` the steps at 1, 2 and 4 spp and the
1-spp step's traced split too, and with `--ad-only --ab-parent DIR` the AD
step of `reference`, `teapot` and `textures` at 1 and 4 spp on DIR's tree
and this one in turns), the kernel's route against the torch
walk, the wavefront's gradient against the megakernel step's over 8
seeds, train_demo's default mode and a resumed run of it. Every K5 time
is given three ways (k5_times): the wrapper's call, the kernel alone (its
C entry, arguments built once) and the launcher's host time a call; the
A/B runs K5 on the
AD step's 1,228,800-ray batches too. `--k5-only` runs K5's split on the
main paths' bounce-1 rays (this tree and the trees of `--k5-split DIR`,
e.g. tools/k5_variants.py's copies), the launcher's host time step by
step, and the A/B of `--ab-parent` and `--ab-chain` on K5_AB_CASES.
Phase 13 (`--dist-only` alone) runs the multi-GPU paths (parallel/) at
W x H: (a) one rank over NCCL through the CLI's --distributed on
`reference` at 2048 spp, bit-equal to the single-device driver; then two
ranks that share the one card over gloo (NCCL takes one rank a device),
this script started twice (`--dist-rank`) through PT_COORDINATOR,
PT_NUM_PROCESSES and PT_PROCESS_ID: (b) the CLI under --mesh 2x1 and 1x2
on `reference`, 1x2 on `teapot`, 2x1 on `textures` at 2048 spp, both
ranks' frames identical and bit-equal to one process playing both ranks
(parallel.mesh.LogicalMesh) on the card, with walls, all-reduce and
all-gather times and Msamples/s; (c) make_sharded_megakernel_step on
`reference` at 32 spp a step over 1x2 (ranks identical, the gradient
within the rule of one process, the loss falling over 5 steps); (d)
make_sharded_train_step at 1280x960x1 over 2x1 (ranks identical,
bit-equal to one process under torch's deterministic kernels, the
averaged gradients the step hands its optimizer within the rule of one
process's, peak memory a rank); (e) the driver under --mesh 1x2 with a
checkpoint, stopped halfway and resumed bit-equal, a resume under 2x1
refused. One card measures no multi-card speed-up. The JAX walk knobs
in the gradient path (render/megakernel.py grad_walk): phase 6 holds K6
on the block-packet walk (PT_SUBPACKET=2; =1 once), without leaf tests
(PT_ABLATE_LEAF=1) and on both, against its plain version at W x H at 4
and 32 spp on `teapot` and the size-check mesh in triangle mode and on
the textured teapot (tests/_torch_scenes.textured_teapot) in texel mode,
each beside the per-thread walk's time, and prints the gradient
instantiations' ptxas counts (at most 64 registers); it also holds the
megakernel step's default row-shared draws against the wavefront's
gradient at 32 seeds (printed, not raised). Phase 7 drives training
under the knobs (the triangle step, `train_demo --tri` at W x H and the
texel recovery on the textured teapot under PT_SUBPACKET=2; one step
under the ablation, alone and with mode 2, whose triangle gradient is
exactly zero; a texel step under PT_SUBPACKET=3), each run's launch
counts set to 0 just before it; phase 8 holds the f32-texel forward on
each walk bit for bit against its plain version. With `--ab-parent` the
forward instantiations that the parent has must keep their ptxas
counts. Phase 14 runs first after the build and P2: every mesh scene
loads through the host scene core (native.py, csrc/scenecore.cpp, built
with the host's C++ compiler); it packs `teapot`, `gopher`, `glass` and
the size-check mesh once through the core and once under PT_NATIVE=0 and
requires every SceneArrays tensor and SceneMeta field equal, holds one
K1-mesh launch on the natively built size-check mesh bit for bit against
its plain version on its first 64 tiles, and prints the set-up split
(parse, normals, BVH build, octant copies, tables, first launch) of the
size-check mesh (natively and in Python) and of a 66,040-triangle UV
sphere (natively); `--scene-core-only` runs it alone. It
prints one JSON line of kernel results, each with its bound (the least
time the card could take for the same work, from the work the plain
version counts in this run), and, last, one JSON line naming the device.
Every failure raises; without a card it exits non-zero before printing any
result. It imports nothing of JAX.

`teapot` and the mesh scenes load procedural stand-ins (a 1472-triangle UV
sphere, a 576-triangle goblet) because the repository ships no .obj files;
the size-check mesh is a 16640-triangle UV sphere, as many triangles as
the reference's gopher model.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import importlib
import importlib.util
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

from pathtracer_tpu_torch import bench, cli, native, train_demo
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.driver import render_driver
from pathtracer_tpu_torch.diff import (extract_params, loss_and_grads,
                                       make_megakernel_step,
                                       make_megakernel_step_tri,
                                       make_sharded_megakernel_step,
                                       make_sharded_train_step,
                                       image_loss, render_image_diff,
                                       restore_train_state)
from pathtracer_tpu_torch.geometry import transforms as gx
from pathtracer_tpu_torch.io.raw import read_raw
from pathtracer_tpu_torch.parallel import mesh as dist_mesh
from pathtracer_tpu_torch.parallel.mesh import LogicalMesh
from pathtracer_tpu_torch.probes import leaf_bench, op_rate
from pathtracer_tpu_torch.render import _build
from pathtracer_tpu_torch.render import grad as tg
from pathtracer_tpu_torch.render import integrator, proctex, threefry
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.render.intersect import reattach_hit
from pathtracer_tpu_torch.render.vec3 import Vec3
from pathtracer_tpu_torch.assets import uv_sphere_obj
from pathtracer_tpu_torch.scene import bvh, material, objfile, pack, shapes
from pathtracer_tpu_torch.scene.pack import texel_params, trainable_texels
from pathtracer_tpu_torch.scene.shapes import (BOX, CYLINDER, GROUP, PLANE,
                                               SPHERE)
from pathtracer_tpu_torch.scenes import _models, cornell, get_scene

# the test suite's synthetic scenes and per-slot rule (jax-free helpers)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from _torch_scenes import (ATOL, GRAD_REL, MEAN_REL, RTOL,  # noqa: E402
                           SLOT_FRAC, ablated_grad_rule,
                           bounce_rays, camera_rays, cylinder_scene,
                           filter_cases, grad_inputs, grad_rule,
                           one_warp_live, port_inputs,
                           SIZE_CHECK_LAT_LON, sincos_mismatches,
                           size_check_scene,
                           tex_grad_rule, textured_teapot, tie_scene)

MAIN_MEAN_REL = 0.02         # 2048-spp image vs an 8-spp plain render
TILE = (64, 256)             # the driver's tile for primitive scenes
MESH_TILE = (8, 512)         # the driver's tile for mesh scenes
W, H, SPP = 1280, 960, 2048  # the reference renderer's benchmark size
PLAIN_BUDGET_S = 150.0       # a full-size plain run beyond this is skipped
GRAD_TILE = (8, 512)         # the training steps' tile (no sample packing)
GRAD_SPP = 4                 # phase 6: K6 against its plain version
STEP_SPP = 32                # bench.py's fwd+bwd samples a step
TRI_STEP_SPP = 8
LOSS_FALL = 0.9              # 5 steps must bring the loss below this share
TEX_SCENES = ("textures", "envmap", "cubemap", "textures-file")
TEX_TIMED = ("textures", "cubemap", "envmap-file")
FETCHES = 1 << 24            # texel-fetch probe: UVs per launch
WRAP_RANGE = 1 << 25         # phase 3: the wrap checked on [-2^25, 2^25]
FILTER_CHUNK = 1 << 24       # phase 3: the object loop's filter, cases a call
FILTER_CASES = 1 << 28       # and a type (plane, sphere, cylinder)
EPS = RenderConfig().epsilon
FILTER_Y = (0.0, 0.4)        # the filter cases' cylinder: `default`'s range
MIP_AREA = 128 * 128         # the JAX package's PT_TEX_MIP_AREA default
MIP_SPP = 16
TEX_TRAIN = "textures-train"  # phase 8: bench.py's fwd_bwd_textures-train
TEX_LR = 0.05                # phase 8: Adam's step on the texels
# the gradient kernel's rows (tree_case specs): object mode, triangle mode
# and texels, with the samples a launch of their training steps takes
# (phases 7, 8: one launch a step), and the spp-per-launch curve
GRAD_ROWS = {
    "K6 reference": dict(kind="grad", scene="reference"),
    "K6 teapot triangles": dict(kind="tri", scene="teapot"),
    "K6-tex textures-train": dict(kind="texgrad", scene=TEX_TRAIN),
}
GRAD_MAIN_SPP = {"grad": STEP_SPP, "tri": TRI_STEP_SPP, "texgrad": STEP_SPP}
# phase 6: the gradient kernel's walks (render/megakernel.py grad_walk):
# each walk's knobs, the walk whose plain version's counts bound it (the
# per-thread walk of the same function; None: its own) and whether it is
# held at its training step's launch size (WALK_SPP) besides GRAD_SPP
# (PT_SUBPACKET=1 takes mode 2's instantiation and is held once, at
# GRAD_SPP on `teapot`)
GRAD_WALKS = {
    "packet mode 2": ({"PT_SUBPACKET": "2"}, "per-thread", True),
    "ablated": ({"PT_ABLATE_LEAF": "1"}, None, True),
    "packet ablated": ({"PT_SUBPACKET": "2", "PT_ABLATE_LEAF": "1"},
                       "ablated", False),
}
# a gradient launch's samples in phase 7's training steps (walk_training):
# the triangle step's and the textured teapot's
WALK_SPP = {"triangle": TRI_STEP_SPP, "texel": STEP_SPP}
# phase 8: the f32-texel forward's walks (mesh_walk's but the tensor-core
# leaves, which the differentiable render refuses)
F32_WALKS = {
    "per-thread": {},
    "packet mode 2": {"PT_SUBPACKET": "2"},
    "packet mode 3": {"PT_SUBPACKET": "3"},
    "ablated": {"PT_ABLATE_LEAF": "1"},
    "packet ablated": {"PT_SUBPACKET": "2", "PT_ABLATE_LEAF": "1"},
    "warp ablated": {"PT_SUBPACKET": "3", "PT_ABLATE_LEAF": "1"},
}
# the per-thread walk of the same function, whose work bounds each walk
F32_BOUND_BY = {"per-thread": "per-thread", "packet mode 2": "per-thread",
                "packet mode 3": "per-thread", "ablated": "ablated",
                "packet ablated": "ablated", "warp ablated": "ablated"}
ROW_SHARED_SEEDS = 32        # phase 6: the row-shared draws' seeds
GRAD_CURVE = (4, 8, 16, 32)
SEG_SPP = 128                # the render driver's samples a `reference` launch
# the forward kernel's rows (tree_case specs) of its split (--k1-split): K1
# at the launch the `reference` main path makes and at 8 spp, and the 8-spp
# rows of K1-mesh, K1-tex and K1-nee, each at the port's own leaf size
K1_ROWS = {
    f"K1 reference {SEG_SPP} spp": dict(kind="fwd", scene="reference",
                                        tile=TILE, spp=SEG_SPP),
    "K1 reference 8 spp": dict(kind="fwd", scene="reference", tile=TILE),
    "K1-mesh teapot 8 spp": dict(kind="fwd", scene="teapot", tile=MESH_TILE),
    "K1-tex textures 8 spp": dict(kind="fwd", scene="textures"),
    "K1-nee reference 8 spp": dict(kind="fwd", scene="reference", tile=TILE,
                                   cfg={"nee": True}),
    "K1-nee teapot 8 spp": dict(kind="fwd", scene="teapot", tile=MESH_TILE,
                                cfg={"nee": True}),
}

# The bound: the least time the card could take for a kernel's work, the
# larger of its f32 operations over the rate the card can issue them and its
# bytes (each input read once, each output written once) over 3.35 TB/s (the
# H100 SXM's published rate; the card may be set below 700 W, whose limit is
# printed beside every number). The H100 SXM has 132 SMs of 128 FP32 lanes,
# 16896 lanes at a 1.98 GHz boost clock; its published 67 TFLOP/s counts a
# fused multiply-add as two operations. The kernels are built with
# -fmad=false, so that no multiply and add fuse (each rounds as in the plain
# version): every counted operation issues alone, at most 16896 x 1.98e9 =
# 33.45e12 a second, and IEEE division, square root and sin/cos take
# several instructions each, so this bound is still low. Operations per
# unit of work, counted from csrc/megakernel.cu: adds, subtracts,
# multiplies, divides, square roots, min/max/abs/floor/trunc, cos/sin and
# int-to-float conversions count one each; the integer hash, comparisons
# and selects are not counted. The units are what the plain version counts
# in the same run (trace_tiles_reference's and intersect_batch_reference's
# `counts`).
F32_OPS_PER_S = 16896 * 1.98e9
PEAK_BYTES = 3.35e12
# the rate every bound divides by: F32_OPS_PER_S, unless the op-rate probe
# (P2, phase 2) measures a faster non-FMA rate (mul_par8, add_par8) in
# this run, which then shows the spec rate wrong
bound_rate = {"ops_per_s": F32_OPS_PER_S, "from": "spec"}
OPS_SAMPLE = 44          # jittered camera ray, normalize, the sums' adds
OPS_OBJECT = {           # one object's transform and test, per live ray
    PLANE: 33 + 3, SPHERE: 33 + 29, CYLINDER: 33 + 26, BOX: 33 + 26,
    GROUP: 33 + 25,      # the group's box pretest; the walk counts below
}
# the narrowed object loop (nearest_hit, object_t): a plane transforms its
# y row alone (toy: 3 multiplies, 3 adds; tdy: 3 multiplies, 2 adds) before
# its test; the winner's full transform runs once a hit, after the loop
OPS_OBJECT_NARROW = {**OPS_OBJECT, PLANE: 11 + 3}
OPS_WINNER = 33
OPS_HIT = 125            # a diffuse hit: normal, roulette, bounce, resolve
OPS_NODE = 22            # one node's slab test
OPS_LEAF_SLOT = 34       # one triangle's test
# a bilinear fetch: the JAX kernel's four wraps (an IEEE division each), 4
# taps decoded, the blend; this kernel's two division-free wraps (wrap_fast,
# 6 each) and |x0|, |y0| count the same 80 (fx, fy and the weights 8, five
# conversions, the decode 24, the blend 29): the count does not see that a
# division costs 16.8 multiply slots (P2)
OPS_FETCH = 80
OPS_DECODE = 24          # of which the rgb8 decode (4 taps x 3 x 2)
OPS_UV = {"plane": 2, "sphere": 60, "cube": 21}
OPS_GRAD_HIT = 21        # K6: one tape entry's reverse step
OPS_SCATTER = 56         # K6-tex: taps, 4 weights, 12 products, 12 adds
# K1-nee, per light point: two draws (4), 2u-1 (2), the acos polynomial
# (25), the latitude offset and longitude (2), four sin/cos, the point (9),
# its direction normalized (13), ldn (5), the shadow origin (6). A cast
# shadow ray adds one OPS_OBJECT per object (and its walk's nodes and
# slots); a lit one the attenuation (6), its weight (1) and the three
# channels' products and adds (12)
OPS_SHADOW = 70
OPS_SHADOW_LIT = 19
# K5, per ray: t at most t_max (1), and a winning triangle's smooth normal
# (12); the objects' tests as OPS_OBJECT, the walk as OPS_NODE/LEAF_SLOT
OPS_ISECT_RAY = 1
OPS_ISECT_TRI = 12
ISECT_SCENES = ("reference", "teapot", "size-check mesh")
K5_REPS = 20             # K5's timings: calls or launches a timing
# the mesh walks of the JAX package's knobs (render/megakernel.py
# mesh_walk): Kernel A (the warp-packet walk on the block's or the warp's
# majority octant), Kernel B (its tensor-core leaves), the node walk alone
WALKS = {
    "per-thread": {},
    "packet mode 2": {"PT_SUBPACKET": "2"},
    "packet mode 3": {"PT_SUBPACKET": "3"},
    "tensor core": {"PT_TRAVERSAL": "mxu"},
    "leaf-ablated": {"PT_ABLATE_LEAF": "1"},
    "packet leaf-ablated": {"PT_SUBPACKET": "2", "PT_ABLATE_LEAF": "1"},
    "packet mode 3 leaf-ablated": {"PT_SUBPACKET": "3", "PT_ABLATE_LEAF": "1"},
}
WALK_KNOBS = ("PT_SUBPACKET", "PT_TRAVERSAL", "PT_ABLATE_LEAF",
              "PT_TILE_ORDER")
# phase 5: the BVH leaf sizes K1-mesh is timed at (PT_BVH_LEAF)
LEAF_SWEEP = (4, 8, 16, 32)
# phase 4: the slice's main path, `teapot` through the CLI under the knobs
MAIN_WALKS = (
    ("packet mode 2, subblock", {"PT_SUBPACKET": "2",
                                 "PT_TILE_ORDER": "subblock"}),
    ("packet mode 3", {"PT_SUBPACKET": "3"}),
    ("tensor core, rowblock", {"PT_TRAVERSAL": "mxu",
                               "PT_TILE_ORDER": "rowblock"}),
)


# the packet walks' split (--walk-split): `teapot` and the size-check mesh
# at W x H x 8 spp under packet modes 2 and 3, the tensor-core leaves and
# the packet node walks alone, packed at the port's leaf size (4) and at 32
WALK_SPLIT = ("packet mode 2", "packet mode 3", "tensor core",
              "packet leaf-ablated", "packet mode 3 leaf-ablated")
WALK_ROWS = {f"{walk} {scene} leaf {leaf} {W}x{H}x8 spp": dict(
    kind="fwd", scene=scene, tile=MESH_TILE, leaf=leaf, env=WALKS[walk])
    for scene in ("teapot", "size-check mesh") for leaf in (4, 32)
    for walk in WALK_SPLIT}
# the packet walks' A/B rows (the redesign's rule): Kernel A (modes 2 and
# 3) and Kernel B (tensor core) on `teapot` at the port's leaf size; the
# size-check mesh under each walk; `teapot` at leaf 32 under each; the
# textured packet walk; K5 under the three walks; the per-thread walk
WALK_AB_CASES = {
    **{f"{walk} teapot leaf 4 {W}x{H}x8 spp": dict(
        kind="fwd", scene="teapot", tile=MESH_TILE, leaf=4, env=WALKS[walk])
       for walk in ("packet mode 2", "packet mode 3", "tensor core",
                    "per-thread")},
    **{f"{walk} size-check mesh leaf 4 {W}x{H}x8 spp": dict(
        kind="fwd", scene="size-check mesh", tile=MESH_TILE, leaf=4,
        env=WALKS[walk])
       for walk in ("packet mode 2", "packet mode 3", "tensor core")},
    **{f"{walk} teapot {W}x{H}x8 spp": dict(
        kind="fwd", scene="teapot", tile=MESH_TILE, leaf=32, env=WALKS[walk])
       for walk in ("packet mode 2", "packet mode 3", "tensor core")},
    f"K1-tex packet mode 2 cubemap {W}x{H}x8 spp": dict(
        kind="fwd", scene="cubemap", env=WALKS["packet mode 2"]),
    **{f"K5 {walk} teapot {W * H * 8} rays": dict(
        kind="isect", scene="teapot", leaf=4, env=WALKS[walk])
       for walk in ("packet mode 2", "packet mode 3", "tensor core")},
    # outside the rule's rows: the packet walks' NEE instantiations
    **{f"K1-nee {walk} teapot leaf 4 {W}x{H}x8 spp": dict(
        kind="fwd", scene="teapot", tile=MESH_TILE, leaf=4, env=WALKS[walk],
        cfg={"nee": True})
       for walk in ("packet mode 2", "tensor core")},
}


# phase 5 A/B (--ab-parent): the K1 family on the main paths' scenes at
# W x H, each tree on its own code (tree_case); the meshes at the leaf size
# both trees' JAX-package rule picks (32 for `teapot`, 16 for the
# size-check mesh), so that the outputs must be bit-equal
AB_CASES = {
    f"K1 reference {W}x{H}x{SEG_SPP} spp": dict(kind="fwd", scene="reference",
                                                tile=TILE, spp=SEG_SPP),
    f"K1 reference {W}x{H}x8 spp": dict(kind="fwd", scene="reference",
                                        tile=TILE),
    f"K1-mesh teapot {W}x{H}x8 spp": dict(kind="fwd", scene="teapot",
                                          tile=MESH_TILE, leaf=32),
    f"K1-mesh size-check mesh {W}x{H}x8 spp": dict(
        kind="fwd", scene="size-check mesh", tile=MESH_TILE, leaf=16),
    **{f"{walk} teapot {W}x{H}x8 spp": dict(
        kind="fwd", scene="teapot", tile=MESH_TILE, leaf=32, env=WALKS[walk])
       for walk in ("packet mode 2", "packet mode 3", "tensor core",
                    "leaf-ablated")},
    # every textured instantiation (K1-tex R3): the primitive and the
    # mesh one (`cubemap`), NEE, a packet walk, the f32 texels, K6-tex
    **{f"K1-tex {name} {W}x{H}x8 spp": dict(kind="fwd", scene=name)
       for name in ("textures", "cubemap", "envmap-file", "textures-file")},
    f"K1-tex packet mode 2 cubemap {W}x{H}x8 spp": dict(
        kind="fwd", scene="cubemap", env=WALKS["packet mode 2"]),
    f"K1-nee textures {W}x{H}x8 spp": dict(kind="fwd", scene="textures",
                                           cfg={"nee": True}),
    f"K1-nee cubemap {W}x{H}x8 spp": dict(kind="fwd", scene="cubemap",
                                          cfg={"nee": True}),
    f"K1-tex f32 texels textures-train {W}x{H}x8 spp": dict(
        kind="texel", scene="textures-train"),
    f"K6-tex textures-train {W}x{H}x{GRAD_SPP} spp": dict(
        kind="texgrad", scene="textures-train", spp=GRAD_SPP),
    f"K1-nee reference {W}x{H}x8 spp": dict(kind="fwd", scene="reference",
                                            tile=TILE, cfg={"nee": True}),
    f"K1-nee teapot {W}x{H}x8 spp": dict(kind="fwd", scene="teapot",
                                         tile=MESH_TILE, leaf=32,
                                         cfg={"nee": True}),
    f"K5 reference {W * H * 8} rays": dict(kind="isect", scene="reference"),
    f"K5 teapot {W * H * 8} rays": dict(kind="isect", scene="teapot",
                                        leaf=32),
    f"K5 size-check mesh {W * H * 8} rays": dict(
        kind="isect", scene="size-check mesh", leaf=16),
    # the AD step's batch size (W x H x 1 rays a bounce), at the port's
    # leaf size
    **{f"K5 {name} {W * H} rays": dict(kind="isect", scene=name, spp=1,
                                       leaf=4)
       for name in ("reference", "teapot", "textures")},
    f"K6 reference {W}x{H}x{GRAD_SPP} spp": dict(kind="grad",
                                                 scene="reference",
                                                 spp=GRAD_SPP),
    f"K6 teapot triangles {W}x{H}x{GRAD_SPP} spp": dict(
        kind="tri", scene="teapot", spp=GRAD_SPP, leaf=32),
    # the gradient rows at their main paths' launch sizes, and the
    # size-check mesh in triangle mode
    f"K6 reference {W}x{H}x{STEP_SPP} spp": dict(kind="grad",
                                                 scene="reference",
                                                 spp=STEP_SPP),
    f"K6-tex textures-train {W}x{H}x{STEP_SPP} spp": dict(
        kind="texgrad", scene="textures-train", spp=STEP_SPP),
    f"K6 size-check mesh triangles {W}x{H}x{GRAD_SPP} spp": dict(
        kind="tri", scene="size-check mesh", spp=GRAD_SPP, leaf=16),
}


def phase(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def env_var(name: str, value: str):
    """Set environment variable `name` to `value` for a block."""
    with env_vars({name: value}):
        yield


@contextlib.contextmanager
def env_vars(env: dict, unset=()):
    """Set the variables of `env` and unset those of `unset` for a block."""
    old = {k: os.environ.get(k) for k in (*env, *unset)}
    for k in unset:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def walk_env(env: dict):
    """The knobs of one mesh walk (WALKS, MAIN_WALKS), the others unset."""
    return env_vars(env, unset=WALK_KNOBS)


def n_triangles(sc) -> int:
    return sum(o.n_triangles() for o in sc.objects
               if isinstance(o, shapes.Group))


def work_bound(counts, meta, in_bytes, out_bytes, grad=False, f32=False,
               query=False, jax=False):
    """(bound ms, "operations" or "bytes", ops) of a kernel run whose work
    the plain version counted in `counts` (see OPS_*); `f32`: the fetches
    load f32 texels, with no decode. The object loop counts the kernel's
    own work (a plane's y row, the winner's transform once a hit:
    OPS_OBJECT_NARROW, OPS_WINNER), or with `jax` the JAX kernel's (every
    object's full transform). The cast shadow rays count a nearest hit
    over every object and the walks it makes (the JAX kernel's work);
    with `query` the occlusion query's own (K1-nee's light_visible: the
    object tests, nodes and leaf slots of _light_visible's counts)."""
    c = lambda k: counts.get(k, 0)  # noqa: E731
    plain_uv = (counts["texel_fetches"] - counts["uv_sphere"]
                - counts["uv_cube"])
    fetch = OPS_FETCH - (OPS_DECODE if f32 else 0)
    objects = OPS_OBJECT if jax else OPS_OBJECT_NARROW
    per_ray = sum(objects[t] for t in meta.obj_types)
    ops = (OPS_SAMPLE * counts["samples"]
           + counts["bounces"] * per_ray
           + (0 if jax else OPS_WINNER * counts["hits"])
           + (OPS_HIT + (OPS_GRAD_HIT if grad else 0)) * counts["hits"]
           + OPS_NODE * (counts["node_visits"] - c("shadow_nodes"))
           + OPS_LEAF_SLOT * (counts["leaf_slots"] - c("shadow_slots"))
           + fetch * counts["texel_fetches"]
           + OPS_SCATTER * c("texel_scatters")
           + OPS_UV["plane"] * plain_uv + OPS_UV["sphere"] * counts["uv_sphere"]
           + OPS_UV["cube"] * counts["uv_cube"]
           + OPS_SHADOW * c("shadow_rays")
           + OPS_SHADOW_LIT * c("shadow_lit"))
    if query:
        ops += (sum(objects[code] * c(f"query_{name}")
                    for code, name in mk.TYPE_NAMES.items())
                + OPS_NODE * c("query_nodes")
                + OPS_LEAF_SLOT * c("query_slots"))
    else:
        ops += (per_ray * c("shadow_tests") + OPS_NODE * c("shadow_nodes")
                + OPS_LEAF_SLOT * c("shadow_slots"))
    return bound_of(ops, in_bytes + out_bytes)


def bound_of(ops, n_bytes):
    """(bound ms, "operations" or "bytes", ops) of `ops` f32 operations
    and `n_bytes` bytes moved."""
    t_ops = ops / bound_rate["ops_per_s"] * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", ops)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def fwd_bound(counts, tabs, kw, query=False, jax=False):
    """work_bound of a forward launch on `tabs` with trace_tiles keywords
    `kw`: its tables, texel pool (or f32 texels, read as [T, 4]) and pixel
    maps in, three f32 sums out."""
    texels = kw.get("tex_texels")
    ins = nbytes(*tabs, kw.get("tex_pool"), kw.get("tex_table")) + (
        0 if texels is None else texels.shape[0] * 16)
    return work_bound(counts, kw["meta"], ins, 3 * nbytes(tabs[-2]),
                      f32=texels is not None, query=query, jax=jax)


def shadow_shares(counts) -> dict:
    """The shares of the cast shadow rays that miss their light, stop at an
    occluder and are lit (_light_visible's counts)."""
    n = max(counts["shadow_tests"], 1)
    return {k: counts[c] / n for k, c in (
        ("missed", "shadow_light_missed"), ("occluded", "shadow_occluded"),
        ("lit", "shadow_lit"))}


def shadow_text(counts) -> str:
    """The shadow rays' counts and the query's, for a phase line."""
    sh = shadow_shares(counts)
    return (f"{counts['shadow_rays']} light points, {counts['shadow_tests']} "
            f"shadow rays cast: {sh['missed']:.4f} miss the light, "
            f"{sh['occluded']:.4f} stop at an occluder, {sh['lit']:.4f} lit; "
            f"nearest-hit walks {counts['shadow_nodes']} nodes "
            f"{counts['shadow_slots']} slots, the query's "
            f"{counts['query_nodes']} nodes {counts['query_slots']} slots; "
            f"query object tests " + ", ".join(
                f"{n} {counts['query_' + n]}" for n in mk.TYPE_NAMES.values()))


def spread_tiles(tabs, tile, n):
    """The inputs of n tiles spread evenly over the image (every
    (T // n)-th tile; renumbered 0..n-1, so their random streams are those
    of the first n): a sample of the whole frame's work."""
    S = tile[0]
    px, py = tabs[-2:]
    step = max(1, px.shape[0] // S // n)
    rows = (torch.arange(n, device=px.device)[:, None] * step * S
            + torch.arange(S, device=px.device)).reshape(-1)
    return tabs[:-2] + [px[rows].contiguous(), py[rows].contiguous()]


def first_tiles(tabs, tile, n):
    """The inputs of the first `n` tiles (their slots keep their tile
    numbers, so their random streams)."""
    rows = n * tile[0]
    return tabs[:-2] + [tabs[-2][:rows].contiguous(),
                        tabs[-1][:rows].contiguous()]


def compare(name, sc, cfg, tile, sample_base, dev, exact=False,
            tiles=None):
    """Kernel vs plain version on the card, same inputs: the per-slot rule,
    or bit-equality when `exact`; on the first `tiles` tiles only when
    given. Returns (max abs err, bit-equal fraction)."""
    tabs, meta, _, layout = port_inputs(sc, cfg, tile, dev)
    tile = tile or mk.default_tile(meta)
    if tiles is not None:
        tabs = first_tiles(tabs, tile, tiles)
    seed = (cfg.seed * 7919 + 1, sample_base)
    kw = dict(meta=meta, cfg=cfg, spp=cfg.samples,
              total_samples=cfg.samples + sample_base, tile=tile, **layout)
    k = torch.stack(mk.trace_tiles(seed, *tabs, **kw))
    p = torch.stack(mk.trace_tiles_reference(seed, *tabs, **kw))
    torch.cuda.synchronize()
    k, p = k.cpu().numpy(), p.cpu().numpy()
    if not np.isfinite(k).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    frac = float(np.isclose(k, p, atol=ATOL, rtol=RTOL).mean())
    bit_eq = float((k == p).mean())
    km, pm = k.mean(axis=(1, 2)), p.mean(axis=(1, 2))
    mean_rel = float(np.max(np.abs(km - pm) / np.abs(pm)))
    max_err = float(np.abs(k - p).max())
    tris = f", {n_triangles(sc)} triangles" if meta.has_groups else ""
    if tiles is not None:
        tris += (f", {cfg.width}x{cfg.height}x{cfg.samples} spp, first "
                 f"{tiles} tiles of {tile}")
    phase(f"phase 3: {name}{tris}: bit-equal on {bit_eq:.6f} of {k.size} "
          f"slot values; {frac:.6f} within atol={ATOL} rtol={RTOL} "
          f"(need {SLOT_FRAC}); mean rel diff {mean_rel:.2e} "
          f"(need <{MEAN_REL}); max abs err {max_err:.3e}")
    if exact and bit_eq != 1.0:
        raise AssertionError(f"{name}: kernel differs from plain version")
    if frac < SLOT_FRAC or mean_rel >= MEAN_REL:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return max_err, bit_eq


def timed(fn, stack=True):
    """(torch.stack(fn()), ms) of one call, by CUDA events (fn()'s result
    itself when not `stack`)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    if stack:
        out = torch.stack(out)
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of `fn` on the card, by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


WALK_WORDS = {"0": "", "1": "block-packet ", "2": "warp-packet "}
LEAF_WORDS = {"0": "", "1": "mma ", "2": "ablated "}
BENCH_WORDS = ("prod", "mma", "base", "hitpoint", "tree", "synth")
OP_RATE_WORDS = ("fma_dep", "fma_par8", "mul_par8", "add_par8", "cmp_sel",
                 "leafmix", "div_par8", "sqrt_par8", "sincos")


def _walk_words(ints: str) -> str:
    """The walk and leaf words of the kWalk, kLeaf arguments (Li..E), none
    for the per-thread walk with SIMT leaves (the names of older builds)."""
    w, lf = (re.findall(r"Li(\d+)E", ints) + ["0", "0"])[:2]
    return WALK_WORDS[w] + LEAF_WORDS[lf]


def kernel_name(mangled: str) -> str:
    """The instantiation of megakernel<kMesh, kGrad, kTex, kF32, kNee,
    kWalk, kLeaf> (fewer arguments in older builds), of
    packet_megakernel<kTex, kNee, kWalk, kLeaf> (named as the megakernel
    instantiation it runs), of
    grad_megakernel<kMesh, kTex, kF32, kWalk, kLeaf> (named as the kGrad
    megakernel of older builds), of intersect<kMesh, kWalk, kLeaf>, or
    the probe, by
    name."""
    m = re.search(r"tex_fetchILb([01])E", mangled)
    if m:
        return "fetch probe" + ("" if m.group(1) == "1" else " jax wrap")
    if "tex_fetch" in mangled:
        return "fetch probe"
    if "wrap_check" in mangled:
        return "wrap check"
    if "mma_pairs" in mangled:
        return "mma pairs probe"
    if "sincos_check" in mangled:
        return "sincos check"
    if "filter_check" in mangled:
        return "filter check"
    m = re.search(r"leaf_benchILi(\d+)E", mangled)
    if m:
        return f"leaf bench {BENCH_WORDS[int(m.group(1))]}"
    m = re.search(r"op_rateILi(\d+)E", mangled)
    if m:
        return f"op rate {OP_RATE_WORDS[int(m.group(1))]}"
    m = re.search(r"intersectILb([01])E((?:Li\d+E)*)E", mangled)
    if m:
        return ("intersect " + _walk_words(m.group(2))
                + ("mesh" if m.group(1) == "1" else "primitive"))
    m = re.search(r"packet_megakernelI((?:Lb[01]E)+)((?:Li\d+E)*)E", mangled)
    if m:     # packet_megakernel<kTex, kNee, kWalk, kLeaf>: a mesh forward
        tex, nee = re.findall(r"Lb([01])E", m.group(1))
        return " ".join(["textured"] * (tex == "1") + ["nee"] * (nee == "1")
                        + [_walk_words(m.group(2)) + "mesh"])
    m = re.search(r"grad_megakernelI((?:Lb[01]E)+)((?:Li\d+E)*)E", mangled)
    if m:     # grad_megakernel<kMesh, kTex, kF32[, kWalk, kLeaf]>
        mesh, tex, f32 = re.findall(r"Lb([01])E", m.group(1))
        return " ".join(["grad"] + ["textured"] * (tex == "1")
                        + ["f32-texel"] * (f32 == "1")
                        + [_walk_words(m.group(2))
                           + ("mesh" if mesh == "1" else "primitive")])
    m = re.search(r"megakernelI((?:Lb[01]E)+)((?:Li\d+E)*)E", mangled)
    if not m:
        return mangled
    mesh, grad, tex, f32, nee = (re.findall(r"Lb([01])E", m.group(1))
                                 + ["0", "0"])[:5]
    words = (["grad"] * (grad == "1") + ["textured"] * (tex == "1")
             + ["f32-texel"] * (f32 == "1") + ["nee"] * (nee == "1"))
    return (" ".join(words + [_walk_words(m.group(2))
                              + ("mesh" if mesh == "1" else "primitive")]))


def ptxas_lines(log_text: str):
    """ptxas register/spill lines of each kernel instantiation, named."""
    out, current = [], "?"
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = kernel_name(m.group(1))
        elif "registers" in line or "spill" in line:
            out.append(f"{current}: {line.strip()}")
    return out


def ptxas_counts(lines):
    """{instantiation: (registers, stack frame, spill stores, spill loads)}
    from ptxas_lines (the constant-bank size, which grows with the launch
    parameters, is left out)."""
    out = {}
    for line in lines:
        name, text = line.split(": ", 1)
        nums = out.setdefault(name, [None] * 4)
        for i, pat in enumerate((r"Used (\d+) registers",
                                 r"(\d+) bytes stack frame",
                                 r"(\d+) bytes spill stores",
                                 r"(\d+) bytes spill loads")):
            m = re.search(pat, text)
            if m:
                nums[i] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def cli_render(scene: str, tmp: str, nee: bool = False):
    """Render `scene` at W x H x SPP through cli.main (with --nee when
    `nee`) with the launch counts set to 0 just before. Returns (image,
    metrics, {"launches", "mesh", "tex", "nee"}: the launches of the kernel
    and of its mesh, textured and NEE instantiations)."""
    raw = os.path.join(tmp, f"{scene}.raw")
    metrics = os.path.join(tmp, f"{scene}.json")
    mk.trace_tiles.launches = 0
    mk.trace_tiles.mesh_launches = 0
    mk.trace_tiles.tex_launches = 0
    mk.trace_tiles.nee_launches = 0
    mk.trace_tiles.packet_launches = 0
    mk.trace_tiles.mma_launches = 0
    mk.trace_tiles.ablate_launches = 0
    rc = cli.main([
        "--scene", scene, "--width", str(W), "--height", str(H),
        "--samples", str(SPP), "--raw-output", raw,
        "--output", os.path.join(tmp, f"{scene}.png"),
        "--metrics-json", metrics] + ["--nee"] * nee)
    n = dict(launches=mk.trace_tiles.launches,
             mesh=mk.trace_tiles.mesh_launches,
             tex=mk.trace_tiles.tex_launches, nee=mk.trace_tiles.nee_launches,
             packet=mk.trace_tiles.packet_launches,
             mma=mk.trace_tiles.mma_launches)
    if rc != 0:
        raise AssertionError(f"cli.main --scene {scene} returned {rc}")
    with open(metrics) as f:
        m = json.load(f)
    return read_raw(raw), m, n


def check_image(tag: str, img) -> None:
    if img.shape != (H, W, 3) or not np.isfinite(img).all():
        raise AssertionError(f"{tag}: image is not finite [H, W, 3]")
    left, right = img[H // 2, 5], img[H // 2, W - 6]
    if not (left[0] > left[2] and right[2] > right[0]):
        raise AssertionError(f"{tag}: Cornell walls wrong: {left} {right}")


def last_segment(scene: str, metrics: dict, tile, dev, nee: bool = False):
    """The driver's last segment of a W x H x SPP render of `scene` (with
    NEE when `nee`): its inputs and trace_tiles keywords, and its seed
    vector."""
    cfg = RenderConfig(width=W, height=H, samples=SPP, nee=nee)
    chunk = cfg.samples_per_pass
    seg_spp = metrics["samples"] // (W * H) // metrics["segments"]
    c0 = (SPP - seg_spp) // chunk
    seed = (cfg.seed * 7919 + c0 + 1, c0 * chunk)
    tabs, meta, pid, layout = port_inputs(get_scene(scene, cfg), cfg, tile,
                                          dev)
    kw = dict(meta=meta, cfg=cfg, spp=seg_spp, total_samples=SPP, tile=tile,
              **layout)
    return tabs, kw, seed, pid


def plain_affordable(tag, seed, tabs, kw, n_tiles: int, probe_tiles: int,
                     counts=None):
    """Time the plain version on the first `probe_tiles` tiles (the tile
    numbering, so the random stream, is that of the full run) and decide
    whether the full run fits PLAIN_BUDGET_S; `counts` gains the probe's
    work. Returns (probe output, probe ms, whether the full run fits)."""
    sub = first_tiles(tabs, kw["tile"], probe_tiles)
    out, ms = timed(lambda: mk.trace_tiles_reference(seed, *sub, **kw,
                                                     counts=counts))
    est_s = ms / 1e3 * n_tiles / probe_tiles
    phase(f"{tag}: plain version on the first {probe_tiles} of {n_tiles} "
          f"tiles: {ms:.1f} ms; full run estimated at {est_s:.1f} s "
          f"(budget {PLAIN_BUDGET_S:.0f} s)")
    return out, ms, est_s < PLAIN_BUDGET_S


def reference_main_path(tmp, dev, card, nee=False):
    """Phase 4: `reference` at W x H x SPP through cli.main (with --nee: the
    NEE instantiation), its launch counts set to 0 just before; the image
    checked (Cornell walls, the mean against a plain 8-spp render), and the
    driver's last segment through the kernel and the plain version, bit
    for bit. Returns the numbers and the inputs phase 5 times."""
    tag = "phase 4 nee" if nee else "phase 4"
    img, m, n = cli_render("reference", tmp, nee)
    want = m["segments"]
    phase(f"{tag}: reference{' --nee' if nee else ''} {W}x{H}x{SPP}: "
          f"{m['msamples_per_sec']} Msamples/s, render wall {m['wall_s']} s "
          f"(driver), {m['total_wall_s']} s incl. scene setup; "
          f"{n['launches']} kernel launches ({n['nee']} of the NEE "
          f"instantiation) for {want} segments; card {card}")
    if (n["launches"] != want or want != 16
            or n["nee"] != (want if nee else 0)):
        raise AssertionError(f"{tag}: the main path did not launch the "
                             "kernel once per segment (16 expected)")
    check_image(tag, img)
    cfg8 = RenderConfig(width=W, height=H, samples=8, samples_per_pass=8,
                        nee=nee)
    tabs8, meta8, pid, lay8 = port_inputs(get_scene("reference", cfg8), cfg8,
                                          TILE, dev)
    kw8 = dict(meta=meta8, cfg=cfg8, spp=8, total_samples=8, tile=TILE,
               **lay8)
    c8 = {}
    ref, p8_ms = timed(lambda: mk.trace_tiles_reference(
        (1, 0), *tabs8, **kw8, counts=c8))
    ref = mk.untile_image(ref.permute(1, 2, 0).reshape(-1, 3).cpu().numpy(),
                          pid, W, H) / 8.0
    rel = np.abs(img.reshape(-1, 3).mean(0) - ref.mean(0)) / ref.mean(0)
    phase(f"{tag}: image mean {img.reshape(-1, 3).mean(0)} vs plain "
          f"8-spp {ref.mean(0)}: rel diff {rel.max():.4f} "
          f"(need <{MAIN_MEAN_REL})")
    if rel.max() >= MAIN_MEAN_REL:
        raise AssertionError(f"{tag}: image mean off the plain render")

    # the driver's last segment again, kernel vs plain version slot by
    # slot: the shapes, seed vector and sample base the main path used
    tabs, kw, seed, _ = last_segment("reference", m, TILE, dev, nee)
    k = torch.stack(mk.trace_tiles(seed, *tabs, **kw)).cpu().numpy()
    counts = {}
    p, p_ms = timed(lambda: mk.trace_tiles_reference(seed, *tabs, **kw,
                                                     counts=counts))
    p = p.cpu().numpy()
    frac = float(np.isclose(k, p, atol=ATOL, rtol=RTOL).mean())
    bit_eq = float((k == p).mean())
    err = float(np.abs(k - p).max())
    phase(f"{tag}: segment seed {seed} x {kw['spp']} spp of {SPP} at "
          f"{W}x{H}: kernel vs plain bit-equal on {bit_eq:.6f} of "
          f"{k.size} slot values, {frac:.6f} within atol={ATOL} "
          f"rtol={RTOL}; max abs err {err:.3e}")
    if not np.isfinite(k).all() or bit_eq != 1.0:
        raise AssertionError(f"{tag}: kernel differs from the plain version "
                             "on the main path's segment")
    if nee:
        phase(f"{tag}: the segment's shadow rays (the query held to the "
              f"nearest-hit rule on each): {shadow_text(counts)}")
    return dict(launches=n["launches"], nee=n["nee"], seed=seed, tabs=tabs,
                kw=kw, p_ms=p_ms, counts=counts, bit_eq=bit_eq, frac=frac,
                err=err, tabs8=tabs8, kw8=kw8, p8_ms=p8_ms, c8=c8,
                metrics=m)


def teapot_main_path(tmp, dev, card, mesh_tris, nee=False):
    """Phase 4 (mesh): `teapot` at W x H x SPP through cli.main (with
    --nee: the NEE instantiation, whose shadow rays walk the mesh), its
    launch counts set to 0 just before; the image checked, and the
    driver's last segment through the kernel and the plain version, bit for
    bit: the first 64 tiles, or every slot when the plain version fits its
    time budget. Returns the numbers and the inputs phase 5 times."""
    tag = "phase 4 mesh nee" if nee else "phase 4 mesh"
    timg, tm, n = cli_render("teapot", tmp, nee)
    t_want = tm["segments"]
    phase(f"{tag}: teapot{' --nee' if nee else ''} ({mesh_tris['teapot']} "
          f"triangles) {W}x{H}x{SPP}: {tm['msamples_per_sec']} Msamples/s, "
          f"render wall {tm['wall_s']} s (driver), {tm['total_wall_s']} s "
          f"incl. scene setup; {n['launches']} kernel launches ({n['mesh']} "
          f"of the mesh instantiation, {n['nee']} of the NEE one) for "
          f"{t_want} segments; card {card}")
    if not (n["launches"] == n["mesh"] == t_want == SPP // 8
            and n["nee"] == (t_want if nee else 0)):
        raise AssertionError(f"{tag}: the main path did not launch the mesh "
                             f"kernel once per segment ({SPP // 8} expected)")
    check_image(tag, timg)

    mtabs, mkw, mseed, _ = last_segment("teapot", tm, MESH_TILE, dev, nee)
    n_tiles = mtabs[-2].shape[0] // MESH_TILE[0]
    k = torch.stack(mk.trace_tiles(mseed, *mtabs, **mkw))
    torch.cuda.synchronize()
    c64 = {}
    p64, p64_ms, full = plain_affordable(tag, mseed, mtabs, mkw, n_tiles, 64,
                                         c64)
    rows64 = 64 * MESH_TILE[0]
    if full:
        counts = {}
        p, tp_ms = timed(lambda: mk.trace_tiles_reference(
            mseed, *mtabs, **mkw, counts=counts))
        checked = "every slot"
    else:
        p, tp_ms = p64, None
        k = k[:, :rows64]
        checked = "the slots of the first 64 tiles"
        # the full run's work, estimated from the first 64 tiles'
        counts = {key: v * n_tiles // 64 for key, v in c64.items()}
    k, p = k.cpu().numpy(), p.cpu().numpy()
    if not np.array_equal(k[:, :rows64], p64.cpu().numpy()):
        raise AssertionError(f"{tag}: plain version on the first 64 tiles "
                             "differs from its full run")
    bit_eq = float((k == p).mean())
    err = float(np.abs(k - p).max())
    phase(f"{tag}: segment seed {mseed} x {mkw['spp']} spp of {SPP} at "
          f"{W}x{H}: checked {checked} ({k.size} slot values): bit-equal on "
          f"{bit_eq:.6f}; max abs err {err:.3e}")
    if not np.isfinite(k).all() or bit_eq != 1.0:
        raise AssertionError(f"{tag}: kernel differs from the plain version "
                             "on the main path's segment")
    if nee:
        phase(f"{tag}: the segment's shadow rays (the query held to the "
              f"nearest-hit rule on each; "
              f"{'all tiles' if full else 'the first 64 tiles, scaled'}): "
              f"{shadow_text(counts)}")
    # the same segment packed at the JAX package's leaf size: the slots
    # whose sums differ (another leaf size renumbers the slots, so the walk
    # may pick another triangle at an exact-t tie, or where a box's tmin
    # and a triangle's t round apart)
    leaf_diff = None
    jax_leaf = 32 if mesh_tris["teapot"] <= 8000 else 16
    if mkw["meta"].leaf_size != jax_leaf:
        with env_var("PT_BVH_LEAF", str(jax_leaf)):
            jtabs, jkw, _, _ = last_segment("teapot", tm, MESH_TILE, dev,
                                            nee)
        kj = torch.stack(mk.trace_tiles(mseed, *jtabs, **jkw)).cpu().numpy()
        full_k = torch.stack(mk.trace_tiles(mseed, *mtabs, **mkw)).cpu()
        leaf_diff = int((full_k.numpy() != kj).any(axis=0).sum())
        phase(f"{tag}: the segment at leaf {jax_leaf} (the JAX package's "
              f"rule) against leaf {mkw['meta'].leaf_size}: {leaf_diff} of "
              f"{kj[0].size} slots differ (image-mean rel diff "
              f"{np.abs(kj.mean((1, 2)) - full_k.numpy().mean((1, 2))).max() / kj.mean():.2e})")
    # the mean check's plain render: 8 spp with per-slot draws
    # (PT_COHERENT=0, the same estimator). The coherent draws of a mesh
    # tile are shared by a whole 32x32-pixel block, so the mean of one
    # coherent 8-spp render carries several percent of noise. At a quarter
    # of the size when the full-size plain run does not fit its budget (the
    # mean over the image plane does not depend on the resolution).
    qw, qh = (W, H) if full else (W // 4, H // 4)
    qcfg = RenderConfig(width=qw, height=qh, samples=8, samples_per_pass=8,
                        nee=nee)
    with env_var("PT_COHERENT", "0"):
        qtabs, qmeta, qpid, qlay = port_inputs(get_scene("teapot", qcfg),
                                               qcfg, MESH_TILE, dev)
        q = torch.stack(mk.trace_tiles_reference(
            (1, 0), *qtabs, meta=qmeta, cfg=qcfg, spp=8, total_samples=8,
            tile=MESH_TILE, **qlay), -1).reshape(-1, 3).cpu().numpy()
    plain_img = mk.untile_image(q.astype(np.float64), qpid, qw, qh) / 8.0
    pmean = plain_img.reshape(-1, 3).mean(0)
    trel = np.abs(timg.reshape(-1, 3).mean(0) - pmean) / pmean
    phase(f"{tag}: image mean {timg.reshape(-1, 3).mean(0)} vs plain 8-spp "
          f"per-slot-draw {qw}x{qh} {pmean}: rel diff {trel.max():.4f} "
          f"(need <{MAIN_MEAN_REL})")
    if trel.max() >= MAIN_MEAN_REL:
        raise AssertionError(f"{tag}: image mean off the plain render")
    return dict(launches=n["launches"], mesh=n["mesh"], nee=n["nee"],
                seed=mseed, tabs=mtabs, kw=mkw, full=full, p_ms=tp_ms,
                p64_ms=p64_ms, counts=counts, bit_eq=bit_eq, err=err,
                checked=checked, metrics=tm, img=timg, leaf_diff=leaf_diff)


def tex_main_path(tmp, dev, card):
    """Phase 4 (textures): `textures` at W x H x SPP through cli.main, with
    the launch counts set to 0 just before; then the first 8 samples of the
    driver's last segment through the kernel and the plain version, bit
    for bit, and the image mean against that plain render's. Returns the
    numbers, with the 8-spp inputs for phase 5."""
    img, m, n = cli_render("textures", tmp)
    launches, tex_launches = n["launches"], n["tex"]
    segs = m["segments"]
    phase(f"phase 4 textures: textures {W}x{H}x{SPP}: "
          f"{m['msamples_per_sec']} Msamples/s, render wall {m['wall_s']} s "
          f"(driver), {m['total_wall_s']} s incl. scene setup; {launches} "
          f"kernel launches ({tex_launches} of the textured instantiation) "
          f"for {segs} segments; card {card}")
    if not launches == tex_launches == segs == 16:
        raise AssertionError("phase 4 textures: the main path did not launch "
                             "the textured kernel once per segment (16 "
                             "expected)")
    if img.shape != (H, W, 3) or not np.isfinite(img).all() \
            or img.min() < 0.0 or not img.mean() > 0.0:
        raise AssertionError("phase 4 textures: image is not a finite, "
                             "non-negative [H, W, 3] render")
    tabs, kw, seed, pid = last_segment("textures", m, TILE, dev)
    kw["spp"] = 8
    k = torch.stack(mk.trace_tiles(seed, *tabs, **kw))
    counts = {}
    p, p_ms = timed(lambda: mk.trace_tiles_reference(seed, *tabs, **kw,
                                                     counts=counts))
    k, pn = k.cpu().numpy(), p.cpu().numpy()
    bit_eq = float((k == pn).mean())
    err = float(np.abs(k - pn).max())
    plain = mk.untile_image(np.moveaxis(pn, 0, -1).reshape(-1, 3)
                            .astype(np.float64), pid, W, H) / 8.0
    pm, im = plain.reshape(-1, 3).mean(0), img.reshape(-1, 3).mean(0)
    rel = np.abs(im - pm) / pm
    phase(f"phase 4 textures: segment seed {seed}, its first 8 spp at "
          f"{W}x{H}: kernel vs plain bit-equal on {bit_eq:.6f} of {k.size} "
          f"slot values, max abs err {err:.3e}; image mean {im} vs plain "
          f"{pm}: rel diff {rel.max():.4f} (need <{MAIN_MEAN_REL})")
    if bit_eq != 1.0:
        raise AssertionError("phase 4 textures: kernel differs from the "
                             "plain version on the main path's segment")
    if rel.max() >= MAIN_MEAN_REL:
        raise AssertionError("phase 4 textures: image mean off the plain "
                             "render")
    return dict(launches=tex_launches, err=err, bit_eq=bit_eq, p_ms=p_ms,
                counts=counts, seed=seed, tabs=tabs, kw=kw)


def tex_timing(main, dev, card):
    """Phase 5 (textures): K1-tex against its plain version at W x H x 8
    spp on TEX_TIMED (`textures` on phase 4's inputs), each with its bound
    from the plain run's work. Returns {scene: numbers}."""
    out = {}
    for name in TEX_TIMED:
        if name == "textures":
            seed, tabs, kw = main["seed"], main["tabs"], main["kw"]
            p_ms, counts = main["p_ms"], main["counts"]
        else:
            cfg = RenderConfig(width=W, height=H, samples=8,
                               samples_per_pass=8)
            tabs, meta, _, lay = port_inputs(get_scene(name, cfg), cfg, None,
                                             dev)
            seed = (1, 0)
            kw = dict(meta=meta, cfg=cfg, spp=8, total_samples=8,
                      tile=mk.default_tile(meta), **lay)
            counts = {}
            p, p_ms = timed(lambda: mk.trace_tiles_reference(
                seed, *tabs, **kw, counts=counts))
            k = torch.stack(mk.trace_tiles(seed, *tabs, **kw))
            if not torch.equal(k, p):
                raise AssertionError(f"phase 5: {name}: kernel differs from "
                                     "the plain version")
        k_ms = cuda_ms(lambda: mk.trace_tiles(seed, *tabs, **kw), 10)
        b_ms, b_by, ops = fwd_bound(counts, tabs, kw)
        j_ms, j_by, j_ops = fwd_bound(counts, tabs, kw, jax=True)
        pool = kw["tex_pool"].shape[0]
        phase(f"phase 5: {name} {W}x{H}x8 spp (tile {kw['tile']}, texel pool "
              f"{pool} texels, {counts['texel_fetches']} fetches): kernel "
              f"{k_ms:.4f} ms ({W * H * 8 / k_ms / 1e3:.1f} Msamples/s), "
              f"plain {p_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}; {ops:.4g} "
              f"f32 ops: the kernel's own work), the JAX kernel's work "
              f"{j_ms:.4f} ms ({j_by}; {j_ops:.4g} f32 ops); card {card}")
        out[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         jax_work_bound_ms=j_ms, jax_work_bound_by=j_by,
                         fetches=counts["texel_fetches"])
    return out


def fetch_probe(dev, card):
    """The texel-fetch probe (the Hopper counterpart of the JAX package's
    tools/tex_vmem_probe.py): the kernels' own bilinear fetch at FETCHES
    random UVs in [-2, 3] over the 2048x1024 sky of `envmap`, and the same
    fetch with the JAX kernel's wrap alone (the kernels' before R3), each
    bit for bit against sample_pool and timed in turns (this, JAX wrap,
    JAX wrap, this; 10 launches a timing), with the bound of the fetch's
    work (OPS_FETCH: the JAX kernel's and this one's count the same).
    Returns the numbers."""
    arrays, _ = get_scene("envmap", RenderConfig(width=8, height=6)).pack(
        device=dev)
    pool = arrays.tex_pool_u32.view(torch.int32)
    w, h = 2048, 1024
    if pool.numel() != w * h:
        raise AssertionError("phase 5: envmap's pool is not one 2048x1024 "
                             "texture")
    rng = np.random.default_rng(0)
    u, v = (torch.from_numpy(rng.uniform(-2.0, 3.0, FETCHES).astype(
        np.float32)).to(dev) for _ in range(2))
    f = lambda x: torch.full_like(u, float(x))  # noqa: E731
    p, p_ms = timed(lambda: mk.sample_pool(pool, f(0), f(w), f(h), u, v))
    runs = {True: [], False: []}
    for fast in (True, False, False, True):
        if not torch.equal(torch.stack(mk.fetch_texels(pool, 0, w, h, u, v,
                                                       fast)), p):
            raise AssertionError("phase 5: the fetch probe differs from "
                                 "sample_pool")
        runs[fast].append(cuda_ms(lambda: mk.fetch_texels(pool, 0, w, h, u,
                                                          v, fast), 10))
    k_ms, j_ms = min(runs[True]), min(runs[False])
    bound, by, _ = bound_of(FETCHES * OPS_FETCH,
                            nbytes(pool, u, v) + 3 * nbytes(u))
    phase(f"phase 5: texel-fetch probe, {FETCHES} random bilinear fetches "
          f"over a {w}x{h} rgb8 texture: kernel {k_ms:.4f} ms = "
          f"{FETCHES / k_ms / 1e6:.2f} Gfetch/s, with the JAX kernel's wrap "
          f"{j_ms:.4f} ms = {FETCHES / j_ms / 1e6:.2f} Gfetch/s, plain "
          f"(sample_pool) {p_ms:.2f} ms, all bit-equal; bound {bound:.4f} ms "
          f"({by}); timings {runs[True]}, {runs[False]}; card {card}")
    return dict(ms=k_ms, jax_wrap_ms=j_ms, plain_ms=p_ms,
                gfetch_s=FETCHES / k_ms / 1e6,
                jax_wrap_gfetch_s=FETCHES / j_ms / 1e6, bound_ms=bound,
                bound_by=by)


def filter_phase(dev, card):
    """Phase 3: the object loop's filter (plane_skip, round_skip) held to
    the exact tests on the card (megakernel.filter_check) over FILTER_CASES
    seeded random and adversarial cases a type (_torch_scenes.filter_cases,
    FILTER_CHUNK a call): the cases it skips where the exact t is below the
    threshold must be 0. Returns {type: numbers}."""
    out = {}
    t0 = time.perf_counter()
    for name, code in (("plane", PLANE), ("sphere", SPHERE),
                       ("cylinder", CYLINDER)):
        n = skipped = bad = 0
        for seed in range(FILTER_CASES // FILTER_CHUNK):
            ray, thr = filter_cases(code, FILTER_CHUNK, seed, dev, EPS,
                                    FILTER_Y[0], FILTER_Y[1])
            s, b = mk.filter_check(code, ray, thr, EPS, *FILTER_Y)
            n, skipped, bad = n + thr.numel(), skipped + s, bad + b
        out[name] = dict(cases=n, skipped=skipped, skipped_winners=bad)
        phase(f"phase 3: the object loop's filter, {name}: {n} cases, "
              f"{skipped} skipped, {bad} of them with an exact t below the "
              f"threshold (a winner the loop would miss; must be 0); card "
              f"{card}")
        if bad or n < FILTER_CASES:
            raise AssertionError(f"phase 3: the filter skipped {bad} "
                                 f"winners of {name}s")
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = mk.filter_check.launches
    return out


def texture_sides(dev):
    """The widths and heights of the textures of the repository's scenes
    (every scene that samples one)."""
    sides = set()
    cfg = RenderConfig(width=8, height=6)
    for name in sorted({*TEX_SCENES, *TEX_TIMED, TEX_TRAIN}):
        arrays, meta = get_scene(name, cfg).pack(device=dev)
        table = mk.build_tex_table(arrays, meta)
        for col in (0, 6):
            rows = table[table[:, col] > 0.5]
            sides.update(int(x) for x in rows[:, col + 2:col + 4].ravel())
    return sorted(sides)


def wrap_phase(dev, card):
    """Phase 3 (the fetches' wrap): wrap_fast and its neighbour against the
    JAX formula on the card, for each texture side of the repository's
    scenes, on every integer in [-WRAP_RANGE, WRAP_RANGE] (as f32: every
    integer-valued float floorf can give there); the fast branch must take
    exactly the 2^23 - 1 integers below 2^22 in magnitude, and no pair may
    differ (the cold branch is the formula itself). Returns the numbers."""
    t0 = time.perf_counter()
    want = 2 ** 23 - 1
    out = {}
    for m in texture_sides(dev):
        fast, bad = mk.wrap_check(m, -WRAP_RANGE, WRAP_RANGE, dev)
        out[m] = dict(fast=fast, differing=bad)
        if bad or fast != want:
            raise AssertionError(f"phase 3: the fetches' wrap by {m}: {bad} "
                                 f"of {fast} fast-wrapped integers differ "
                                 f"from the JAX formula ({want} expected "
                                 "fast)")
    secs = time.perf_counter() - t0
    phase(f"phase 3 tex: the fetches' wrap (wrap_fast, no division) against "
          f"the JAX formula a - m floor(a / m) on every integer in "
          f"[-{WRAP_RANGE}, {WRAP_RANGE}] for the sides {sorted(out)}: "
          f"{want} a side wrapped fast, 0 differ, the rest by the formula "
          f"itself; {secs:.2f} s; card {card}")
    return dict(sides=sorted(out), range=WRAP_RANGE, fast_per_side=want,
                differing=0, seconds=secs)


def tex_split(trees, tex_times, probe, ptxas_of, dev, card):
    """Phase 5 (the texture path's split): on TEX_TIMED at W x H x 8 spp,
    each tree's K1-tex and the same scene on its untextured instantiation
    (the same tables, the texture records cleared): their difference is
    the texture path's whole cost. `trees` is [(tag, tree)], this tree
    first; a copy of a tree whose fetch loads one address for all four
    taps (tools/tex_variants.py pinned) gives, against that tree, the
    loads' cost. Timed in turns (20 launches, through the trees and back,
    twice). Beside each: the plain run's fetches a launch (tex_times) and
    the rate the texture path fetches at, beside the fetch probe's; the
    ptxas counts of each tree's textured instantiations (`ptxas_of`: tag ->
    counts). Returns {scene: {tag: numbers}}."""
    out = {}
    order = [tag for tag, _ in trees]
    for name in TEX_TIMED:
        fns = {tag: (tree_case(T, dict(kind="fwd", scene=name), dev),
                     tree_case(T, dict(kind="fwd", scene=name, bare=True),
                               dev))
               for tag, T in trees}
        runs = {tag: ([], []) for tag in order}
        for tag in (order + order[::-1]) * 2:
            for i in (0, 1):
                runs[tag][i].append(cuda_ms(fns[tag][i], 20))
        fetches = tex_times[name]["fetches"]
        res = {}
        for tag in order:
            tex_ms, bare_ms = (float(np.median(r)) for r in runs[tag])
            path = tex_ms - bare_ms
            res[tag] = dict(ms=tex_ms, untextured_ms=bare_ms, path_ms=path,
                            gfetch_s=(fetches / path / 1e6 if path > 0
                                      else None))
            phase(f"phase 5 tex split: {name} {W}x{H}x8 spp, {tag}: K1-tex "
                  f"{tex_ms:.4f} ms, untextured instantiation {bare_ms:.4f} "
                  f"ms, texture path {path:.4f} ms ({fetches} fetches: "
                  f"{fetches / max(path, 1e-9) / 1e6:.2f} Gfetch/s of the "
                  f"path, the fetch probe {probe['gfetch_s']:.2f}); timings "
                  f"{runs[tag]}; card {card}")
        out[name] = res
    for tag in order:
        tex_ptxas = {k: v for k, v in ptxas_of[tag].items()
                     if "textured" in k.split()}
        phase(f"phase 5 tex split: ptxas (registers, stack, spill stores, "
              f"spill loads) of {tag}'s textured instantiations: {tex_ptxas}")
        out.setdefault("ptxas", {})[tag] = {k: list(v) for k, v in
                                            tex_ptxas.items()}
    return out


def _mip2(im: np.ndarray) -> np.ndarray:
    """One box-filtered mip level, as the JAX package stages a large file
    texture (its scene/pack.py `_mip2`): 2x2 average, an odd tail row or
    column edge-replicated first."""
    if im.shape[0] % 2:
        im = np.concatenate([im, im[-1:]], axis=0)
    if im.shape[1] % 2:
        im = np.concatenate([im, im[:, -1:]], axis=1)
    h2, w2 = im.shape[0] // 2, im.shape[1] // 2
    return im.reshape(h2, 2, w2, 2, *im.shape[2:]).mean(axis=(1, 3))


def mip_blur(dev, card):
    """What the JAX package's staged mip costs `envmap-file`: the scene at
    W x H x MIP_SPP through the kernel, once from its full-resolution sky
    and once from the mip the JAX package stages (area <= MIP_AREA), with
    the same seed and so the same paths. Returns the numbers."""
    cfg = RenderConfig(width=W, height=H, samples=MIP_SPP,
                       samples_per_pass=MIP_SPP)
    sc = get_scene("envmap-file", cfg)
    full = np.asarray(sc.sphere_textures[0])
    mip = np.asarray(full, np.float64)
    while mip.shape[0] * mip.shape[1] > MIP_AREA and min(mip.shape[:2]) > 1:
        mip = _mip2(mip)
    imgs = []
    for tex in (full, mip):
        sc.sphere_textures = [tex]
        arrays, meta = sc.pack(device=dev)
        imgs.append(mk.render_megakernel(arrays, meta, sc.camera, cfg))
    d = np.abs(imgs[0] - imgs[1])
    mad, mean = float(d.mean()), float(imgs[0].mean())
    phase(f"phase 5: envmap-file {W}x{H}x{MIP_SPP} spp, full {full.shape[1]}x"
          f"{full.shape[0]} sky vs the JAX package's {mip.shape[1]}x"
          f"{mip.shape[0]} mip, same seed: per-pixel mean abs diff {mad:.6f} "
          f"(image mean {mean:.6f}; {mad / mean:.4%}), max {d.max():.4f}, "
          f"{(d.max(axis=-1) > 0.05).mean():.4%} of pixels off by > 0.05; "
          f"card {card}")
    return dict(mad=mad, image_mean=mean, max=float(d.max()),
                mip=f"{mip.shape[1]}x{mip.shape[0]}")


_TREES = {}


def load_tree(root: str, tag: str):
    """The pathtracer_tpu_torch under `root` (another checkout, or a copy
    with one edit) imported as a package of its own named `tag` (once a
    directory: a later call returns the first import): its megakernel
    module builds the kernels from its own csrc into its own build
    directory and makes its own tables, so a tree with another table
    layout runs as that tree runs. Returns its modules."""
    pkg = Path(root).resolve() / "pathtracer_tpu_torch"
    if pkg in _TREES:
        return _TREES[pkg]
    tag = f"{tag}_{len(_TREES)}"  # a name of its own for each directory
    spec = importlib.util.spec_from_file_location(
        tag, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[tag] = module
    spec.loader.exec_module(module)

    def sub(name):
        return importlib.import_module(f"{tag}.{name}")

    _TREES[pkg] = types.SimpleNamespace(
        mk=sub("render.megakernel"), tg=sub("render.grad"),
        build=sub("render._build"), get_scene=sub("scenes").get_scene,
        RenderConfig=sub("config").RenderConfig, pack=sub("scene.pack"),
        diff=sub("diff"), integrator=sub("render.integrator"),
        threefry=sub("render.threefry"), vec3=sub("render.vec3"), root=root)
    return _TREES[pkg]


def host_key(T) -> str:
    """A digest of tree T's Python sources: trees with the same key pack
    the same scenes into the same tables."""
    import hashlib
    h = hashlib.sha256()
    for f in sorted((Path(T.root) / "pathtracer_tpu_torch").rglob("*.py")):
        h.update(f.read_bytes())
    return h.hexdigest()


def prebuild(dirs):
    """Build the kernels of the trees under `dirs` all at once, one nvcc
    each: a tree's library lands in its own build directory, named by its
    source, so the phases that load the tree later find it built."""
    trees = [load_tree(d, f"prebuild_{i}") for i, d in enumerate(dirs)]
    with concurrent.futures.ThreadPoolExecutor(max(len(trees), 1)) as ex:
        list(ex.map(lambda T: T.build.build_all(["megakernel"]), trees))


THIS_TREE = types.SimpleNamespace(mk=mk, tg=tg, build=_build,
                                  get_scene=get_scene,
                                  RenderConfig=RenderConfig, pack=pack,
                                  diff=sys.modules["pathtracer_tpu_torch.diff"],
                                  integrator=integrator, threefry=threefry,
                                  vec3=sys.modules[
                                      "pathtracer_tpu_torch.render.vec3"],
                                  root=".")


_CASE_INPUTS = {}


def tree_case(T, spec: dict, dev):
    """The launch of one A/B case on tree T's own code: spec's scene
    ("size-check mesh" for the 16640-triangle sphere) at W x H with spec's
    config keywords, packed at spec's leaf size (PT_BVH_LEAF) and walked
    under spec's walk knobs, as the forward kernel ("fwd": trace_tiles on
    the render driver's layout and tile; with spec's "bare", the same
    tables on the untextured instantiation, the texture records cleared;
    "texel": the f32-texel forward on the decoded pool), the gradient
    kernel ("grad": grad_tiles on the steps' layout, random cotangents;
    "tri": in triangle mode; "texgrad": K6-tex, the texel gradients of the
    decoded pool) or the intersect-only kernel ("isect": camera rays,
    spec's spp a pixel, on intersect_tables; with spec's "bounce", one
    bounce of random rays from their hits). Returns a function that
    launches it and returns its outputs, flat; for "isect" its `kernel`
    launches the kernel alone (k5_prebuilt)."""
    env = dict(spec.get("env", {}))
    if "leaf" in spec:
        env["PT_BVH_LEAF"] = str(spec["leaf"])
    kind, spp = spec["kind"], spec.get("spp", 8)
    with walk_env(env):
        cfg = T.RenderConfig(width=W, height=H, samples=spp,
                             samples_per_pass=spp, **spec.get("cfg", {}))
        key = (host_key(T), repr(sorted(spec.items())))
        if key not in _CASE_INPUTS:
            # packed once for the trees of the same host code (the walk
            # split's copies differ in csrc alone)
            sc = (size_check_scene(cfg, T.get_scene)
                  if spec["scene"] == "size-check mesh"
                  else T.get_scene(spec["scene"], cfg))
            arrays, meta = sc.pack(device=dev)
            _CASE_INPUTS[key] = (sc, arrays, meta, [
                torch.from_numpy(t).to(dev) for t in (
                    T.mk.build_scene_table(arrays, meta),
                    *T.mk.build_mesh_tables(arrays, meta))])
        sc, arrays, meta, tables = _CASE_INPUTS[key]
        cam = torch.from_numpy(T.mk.build_camera_vec(sc.camera)).to(dev)
        if kind == "isect":
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            o, d = camera_rays(sc.camera, W, H, spp, gen)
            itables = T.mk.intersect_tables(arrays, meta, dev)
            if spec.get("bounce"):
                # one bounce of random rays from the camera rays' hits (the
                # plain version's t, bit-equal on every tree)
                o, d = bounce_rays(o, d, T.mk.intersect_batch_reference(
                    arrays, meta, cfg, o, d, itables)[0], cfg.t_max, gen)

            def launch():
                return flat_outputs(T.mk.intersect_batch(
                    arrays, meta, cfg, o, d, tables=itables))
        elif kind in ("grad", "tri", "texgrad"):
            xs, ys, _ = T.mk.tile_pixel_layout(
                W, H, *GRAD_TILE, order=T.mk.default_order(meta))
            px, py = (torch.from_numpy(v).to(dev) for v in (xs, ys))
            rng = np.random.default_rng(0)
            cots = [torch.from_numpy(rng.random(xs.shape, dtype=np.float32))
                    .to(dev) for _ in range(3)]
            gkw = {}
            if kind == "texgrad":
                gkw = dict(tex_grads=True, tex=T.pack.texel_params(arrays),
                           tex_table=torch.from_numpy(
                               T.mk.build_tex_table(arrays, meta)).to(dev))

            def launch():
                return T.tg.grad_tiles(
                    (3, 0), cam, *tables, px, py, *cots, meta=meta, cfg=cfg,
                    spp=spp, total_samples=spp, tile=GRAD_TILE,
                    tri_grads=kind == "tri", **gkw)
        else:
            tile = spec.get("tile") or T.mk.default_tile(meta)
            axis = T.mk.default_pack_axis(meta)
            pack = T.mk.clamp_pack(T.mk.default_pack(meta, spp), *tile, axis)
            xs, ys, _ = T.mk.tile_pixel_layout(
                W, H, *tile, order=T.mk.default_order(meta), spp_pack=pack,
                pack_axis=axis)
            px, py = (torch.from_numpy(v).to(dev) for v in (xs, ys))
            kw = dict(meta=meta, cfg=cfg, spp=spp, total_samples=spp,
                      tile=tile, spp_pack=pack, pack_axis=axis,
                      **T.mk.texture_inputs(arrays, meta, dev))
            if kind == "texel":
                kw["tex_texels"] = T.pack.texel_params(arrays)
                del kw["tex_pool"]
            if spec.get("bare"):
                kw = {k: v for k, v in kw.items() if not k.startswith("tex")}
                kw["meta"] = dataclasses.replace(meta, obj_tex=(),
                                                 obj_tex_nm=())

            def launch():
                return T.mk.trace_tiles((1, 0), cam, *tables, px, py, **kw)

    def run():
        with walk_env(env):
            return list(launch())

    if kind == "isect":
        with walk_env(env):
            kernel = k5_prebuilt(T, meta, cfg, o, d, itables)

        def run_kernel():
            with walk_env(env):
                kernel()
        run.kernel = run_kernel   # the kernel alone (k5_prebuilt)
    return run


def sass_of(lib: Path) -> dict:
    """{instantiation: its SASS lines, addresses and encodings left out and
    its branch labels numbered within it (cuobjdump numbers them across the
    module, so one changed kernel renumbers the others')} of a kernel
    library, by cuobjdump (None when the toolkit has none)."""
    try:
        tool = Path(_build._nvcc()).with_name("cuobjdump")
    except RuntimeError:
        return None
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = block.split("\n", 1)
        body = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]{16} \*/", "", body)
        labels = {}
        body = re.sub(r"\.L_x_\d+", lambda m: labels.setdefault(
            m.group(0), f".L{len(labels)}"), body)
        out[kernel_name(name.strip())] = [x.strip() for x in body.splitlines()
                                          if x.strip()]
    return out


def same_sass(T, parent: str, this=None) -> dict:
    """Phase 5 A/B: whether each forward instantiation (the K1 family
    without the gradient kernels) of this build (or of tree `this`'s) is
    the parent tree T's instruction for instruction, and so each of those
    without a packet walk (kWalk). Returns {"same": [...], "differ":
    [...]}, empty without cuobjdump."""
    theirs = sass_of(T.build._target("megakernel"))
    ours = sass_of((this or THIS_TREE).build._target("megakernel"))
    if theirs is None or ours is None:
        phase("phase 5 A/B: no cuobjdump; the SASS is not compared")
        return {}
    fwd = sorted(k for k in theirs if not k.startswith((
        "grad", "wrap", "sincos", "filter", "mma")))
    out = {"same": [k for k in fwd if ours.get(k) == theirs[k]],
           "differ": [k for k in fwd if ours.get(k) != theirs[k]]}
    first = ""
    if out["differ"]:
        k = out["differ"][0]
        a, b = theirs[k], ours.get(k) or []
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        first = (f"; {k}: {len(a)} against {len(b)} lines, the first "
                 f"difference at line {i}: {a[i:i + 1]} against "
                 f"{b[i:i + 1]}")
    plain = [k for k in fwd if "packet" not in k]
    moved = [k for k in plain if k in out["differ"]]
    phase(f"phase 5 A/B: SASS of the forward instantiations, {parent} and "
          f"this: {len(out['same'])} of {len(fwd)} identical; differ: "
          f"{out['differ']}{first}; without a packet walk (kWalk): "
          f"{len(plain) - len(moved)} of {len(plain)} identical"
          f"{'' if not moved else f', differ: {moved}'}")
    return out


# bench.py's fwd+bwd training steps (phases 7, 8 and the A/B): scene and
# samples a step, one launch a step
STEP_CASES = {"reference": ("reference", STEP_SPP),
              "teapot triangles": ("teapot", TRI_STEP_SPP),
              TEX_TRAIN: (TEX_TRAIN, STEP_SPP)}


def step_cases(T, dev, names=tuple(STEP_CASES)):
    """The training steps of STEP_CASES named in `names` on tree T's own
    code at W x H, with bench.py's step size and a zero target: {name:
    (step, params, target, spp)}."""
    out = {}
    for name in names:
        scene, spp = STEP_CASES[name]
        cfg = T.RenderConfig(width=W, height=H, samples=spp,
                             samples_per_pass=spp)
        sc = T.get_scene(scene, cfg)
        arrays, meta = sc.pack(device=dev)
        if scene == "teapot":
            step, target_of = T.diff.make_megakernel_step_tri(
                arrays, meta, cfg, sc.camera, n_passes=1, tile=GRAD_TILE,
                spp=spp)
            params = (arrays.color, arrays.emission, arrays.tri_color)
        elif scene == TEX_TRAIN:
            step, target_of = T.diff.make_megakernel_step_tex(
                arrays, meta, cfg, sc.camera, spp=spp)
            params = (arrays.color, arrays.emission,
                      T.pack.texel_params(arrays))
        else:
            step, target_of = T.diff.make_megakernel_step(
                arrays, meta, cfg, sc.camera, spp=spp)
            params = (arrays.color, arrays.emission)
        out[name] = (step, params,
                     target_of(np.zeros((H, W, 3), np.float32)), spp)
    return out


def rates_ab(T, parent: str, dev, card) -> dict:
    """Phase 5 A/B: the fwd+bwd Msamples/s of bench.py's three training
    steps (step_rate) on the parent tree T and on this one, in the order
    parent, this, this, parent, twice. Returns {step: (parent median,
    this median)}."""
    cases = {"parent": step_cases(T, dev), "this": step_cases(THIS_TREE,
                                                              dev)}
    out = {}
    for name in cases["this"]:
        runs = {"parent": [], "this": []}
        for who in ["parent", "this", "this", "parent"] * 2:
            step, params, target, spp = cases[who][name]
            runs[who].append(step_rate(step, params, target, spp)[0])
        pm, tm = (float(np.median(runs[w])) for w in ("parent", "this"))
        phase(f"phase 5 A/B: fwd+bwd {name} {W}x{H}: {parent} {pm:.1f} "
              f"Msamples/s, this {tm:.1f} ({(tm - pm) / pm:+.2%}); rates "
              f"{parent} {[round(x, 1) for x in runs['parent']]}, this "
              f"{[round(x, 1) for x in runs['this']]}; card {card}")
        out[name] = (pm, tm)
    return out


def tree_ptxas(T):
    """The ptxas lines of tree T's megakernel build."""
    log = T.build._target("megakernel").with_suffix(".log")
    return ptxas_lines(log.read_text())


def ab_parent(parent: str, tag: str, specs: dict, dev, card, ptxas,
              this=None, strict=True, rates=True):
    """Phase 5 A/B: another tree (`parent`: a checkout, or a copy of the
    package with one edit) against this one (or against tree `this`,
    load_tree's, with its ptxas lines `ptxas`), each on its own code
    (load_tree, tree_case) and the same inputs: 20 launches a timing in the
    order parent, this, this, parent, three times over. Each case of
    `specs` must give bit-equal outputs (the gradient rule for "grad",
    "tri" and "texgrad" cases); unless `strict`, a case whose outputs
    differ is reported and the A/B goes on. The ptxas counts of the kernels
    outside the K1 family (the sincos check) must not move; those of the
    K1 family (the megakernel, intersect and leaf microbenchmark
    instantiations, the tensor-core pairs probe, which runs Kernel B's
    dots, and the fetch probe, which runs K1-tex's fetch) are printed
    before and after. With `rates`, bench.py's fwd+bwd rates too (rates_ab).
    An "isect" case times the kernel alone in the same turns too.
    Returns ({case: (parent median ms, this median ms[, the kernel alone's
    two])}, {K1-family
    instantiation: (parent counts, this build's)}, same_sass's result,
    {step: rates}, [cases whose outputs differ])."""
    T = load_tree(parent, tag)
    T.mk.library()                       # its build, from its own csrc
    this = this or THIS_TREE
    this.mk.library()
    parent_lines = tree_ptxas(T)
    for line in parent_lines:
        phase(f"phase 5 A/B: {parent} ptxas: {line}")
    theirs, ours = ptxas_counts(parent_lines), ptxas_counts(ptxas)

    def k1_family(name):
        return ("primitive" in name.split() or "mesh" in name.split()
                or name.startswith(("leaf bench", "fetch probe",
                                    "mma pairs")))

    family = {k: (v, ours.get(k)) for k, v in theirs.items() if k1_family(k)}
    moved = {k: (v, ours.get(k)) for k, v in theirs.items()
             if not k1_family(k) and ours.get(k) != v}
    phase(f"phase 5 A/B: ptxas (registers, stack, spill stores, spill "
          f"loads) of the {len(theirs) - len(family)} kernels outside the "
          f"K1 family: {'unchanged' if not moved else moved}")
    phase(f"phase 5 A/B: ptxas of the K1 family, {parent} then this: "
          f"{family}")
    if moved:
        raise AssertionError(f"phase 5 A/B: ptxas counts moved: {moved}")
    fwd_moved = {k: v for k, v in family.items()
                 if not k.startswith("grad") and v[0] != v[1]}
    phase(f"phase 5 A/B: ptxas of the forward instantiations (the K1 family "
          f"without the gradient kernels), {parent} then this: "
          f"{'unchanged' if not fwd_moved else fwd_moved}")
    sass = same_sass(T, parent, this)
    out, differ = {}, []
    for name, spec in specs.items():
        fns = {"parent": tree_case(T, spec, dev),
               "this": tree_case(this, spec, dev)}
        runs = {"parent": [], "this": []}
        alone = {"parent": [], "this": []}
        res = {}
        for who in ["parent", "this", "this", "parent"] * 3:
            res[who] = fns[who]()
            runs[who].append(cuda_ms(fns[who], 20))
            if hasattr(fns[who], "kernel"):
                alone[who].append(cuda_ms(fns[who].kernel, 20))
        exact = spec["kind"] not in ("grad", "tri", "texgrad")
        if exact and not all(torch.equal(a, b) for a, b in
                             zip(res["parent"], res["this"])):
            if strict:
                raise AssertionError(f"phase 5 A/B: {name}: outputs differ "
                                     f"from {parent}'s")
            same = float(np.mean([float((a == b).float().mean()) for a, b
                                  in zip(res["parent"], res["this"])]))
            phase(f"phase 5 A/B: {name}: outputs DIFFER from {parent}'s "
                  f"(bit-equal on {same:.6f} of the values)")
            differ.append(name)
        if spec["kind"] == "texgrad":
            tex_grad_rule(res["this"], res["parent"])
        elif not exact:
            grad_rule(res["this"], res["parent"], spec["kind"] == "tri")
        pm, tm = (float(np.median(runs[w])) for w in ("parent", "this"))
        phase(f"phase 5 A/B: {name}: {parent} {pm:.4f} ms, this {tm:.4f} ms "
              f"({(tm - pm) / pm:+.2%}; within 1%: {abs(tm - pm) < 0.01 * pm}"
              f"), outputs {'bit-equal' if exact else 'by the gradient rule'}"
              f"; timings {parent} "
              f"{[round(x, 4) for x in runs['parent']]}, this "
              f"{[round(x, 4) for x in runs['this']]}; card {card}")
        out[name] = (pm, tm)
        if alone["this"]:
            pk, tk = (float(np.median(alone[w])) for w in ("parent", "this"))
            phase(f"phase 5 A/B: {name}, the kernel alone: {parent} "
                  f"{pk:.4f} ms, this {tk:.4f} ms ({(tk - pk) / pk:+.2%}); "
                  f"timings {parent} {[round(x, 4) for x in alone['parent']]}"
                  f", this {[round(x, 4) for x in alone['this']]}; card "
                  f"{card}")
            out[name] = (pm, tm, pk, tk)
    rates = rates_ab(T, parent, dev, card) if rates else {}
    return out, family, sass, rates, differ


def nee_timing(ref_nee, tea_nee, card):
    """Phase 5 (NEE): K1-nee at W x H x 8 spp on `reference` (phase 4's
    8-spp inputs) and on teapot's last 8-spp segment, each timed in turns
    with K1 on the same samples (cfg.nee off: K1, NEE, NEE, K1, 10 launches
    a timing), with the plain time and the bound from the plain run's
    work. Returns {scene: numbers}."""
    out = {}
    for name, d, seed, tabs, kw, p_ms, counts in (
            ("reference", ref_nee, (1, 0), ref_nee["tabs8"], ref_nee["kw8"],
             ref_nee["p8_ms"], ref_nee["c8"]),
            ("teapot", tea_nee, tea_nee["seed"], tea_nee["tabs"],
             tea_nee["kw"], tea_nee["p_ms"] or tea_nee["p64_ms"],
             tea_nee["counts"])):
        k1kw = dict(kw, cfg=kw["cfg"].replace(nee=False))
        runs = {"k1": [], "nee": []}
        for who in ("k1", "nee", "nee", "k1"):
            runs[who].append(cuda_ms(lambda: mk.trace_tiles(
                seed, *tabs, **(kw if who == "nee" else k1kw)), 10))
        n_ms, k_ms = min(runs["nee"]), min(runs["k1"])
        b_ms, b_by, ops = fwd_bound(counts, tabs, kw, query=True)
        j_ms, j_by, j_ops = fwd_bound(counts, tabs, kw, jax=True)
        plain = ("plain" if name == "reference" or d["full"] else
                 "plain on the first 64 tiles")
        k1_name = "K1-mesh" if kw["meta"].has_groups else "K1"
        phase(f"phase 5 nee: {name} {W}x{H}x{kw['spp']} spp: K1-nee "
              f"{n_ms:.4f} ms, {k1_name} on the same samples {k_ms:.4f} ms "
              f"({n_ms / k_ms:.2f}x); {plain} {p_ms:.1f} ms; bound "
              f"{b_ms:.4f} ms ({b_by}; {ops:.4g} f32 ops: the query's own "
              f"work), the JAX kernel's work (a nearest hit a shadow ray) "
              f"{j_ms:.4f} ms ({j_by}; {j_ops:.4g} f32 ops); "
              f"{shadow_text(counts)}; "
              f"timings K1-nee {runs['nee']}, {k1_name} {runs['k1']}; card "
              f"{card}")
        out[name] = dict(ms=n_ms, k1_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                         bound_by=b_by, jax_work_bound_ms=j_ms,
                         jax_work_bound_by=j_by,
                         shadow_rays=counts["shadow_rays"],
                         shadow_tests=counts["shadow_tests"],
                         shares=shadow_shares(counts))
    return out


def branch_cost(cases, ptxas, card):
    """Phase 5 (NEE): what a runtime branch in place of the kNee template
    flag would cost the renders without NEE. Each case (seed, inputs,
    keywords of a render without NEE) runs on the instantiation without
    NEE (the flag's) and on the NEE instantiation with no light (the code a
    runtime branch would run for it: cfg.nee with the lights taken away),
    bit for bit, 20 launches a timing in the order flag, branch, branch,
    flag, three times over; and each NEE instantiation's ptxas counts
    stand beside its twin's. Returns {case: (flag ms, branch ms)} and
    {instantiation: (NEE counts, twin counts)}."""
    counts = ptxas_counts(ptxas)
    pairs = {k: (v, counts.get(k.replace("nee ", "")))
             for k, v in counts.items() if "nee " in k}
    phase(f"phase 5 nee: ptxas (registers, stack, spill stores, spill "
          f"loads) of the NEE instantiations beside their twins: {pairs}")
    out = {}
    for tag, (seed, tabs, kw) in cases.items():
        bkw = dict(kw, cfg=kw["cfg"].replace(nee=True),
                   meta=dataclasses.replace(kw["meta"], light_indices=()))
        res, runs = {}, {"flag": [], "branch": []}
        for who in ["flag", "branch", "branch", "flag"] * 3:
            fkw = bkw if who == "branch" else kw
            res[who] = torch.stack(mk.trace_tiles(seed, *tabs, **fkw))
            runs[who].append(cuda_ms(lambda: mk.trace_tiles(seed, *tabs,
                                                            **fkw), 20))
        if not torch.equal(res["flag"], res["branch"]):
            raise AssertionError(f"phase 5 nee: {tag}: the NEE instantiation "
                                 "without a light differs from the render "
                                 "without NEE")
        fm, bm = (float(np.median(runs[w])) for w in ("flag", "branch"))
        phase(f"phase 5 nee: runtime branch, {tag}: flag (no NEE code) "
              f"{fm:.4f} ms, branch (NEE code, no light) {bm:.4f} ms "
              f"({(bm - fm) / fm:+.2%}; within 1%: {abs(bm - fm) < 0.01 * fm}"
              f"), bit-equal; timings flag "
              f"{[round(x, 4) for x in runs['flag']]}, branch "
              f"{[round(x, 4) for x in runs['branch']]}; card {card}")
        out[tag] = (fm, bm)
    return out, pairs


def flat_outputs(res):
    """intersect_batch's result as a list of its [R] tensors (16: the
    triangle slot last; a tree before the slot, 15)."""
    return [x for r in res for x in (r if isinstance(r, tuple) else (r,))]


def intersect_phase(dev, card):
    """Phase 9: the intersect-only kernel (K5) on W x H x 8 = 9,830,400
    rays a batch: jittered camera rays, then one bounce of random rays from
    their hits (_torch_scenes.bounce_rays), on ISECT_SCENES. Its launch count is set to 0 before the
    six batches' first calls (the wavefront's calls) and read after; then
    each batch is held bit for bit against intersect_batch_reference and
    timed (k5_times: the kernel alone, the call, the launcher's host time;
    tables built once), with its bound: the bytes in and out against the
    operations the plain run counts. Returns the numbers."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfg = RenderConfig(width=W, height=H, samples=8)
    mk.intersect_batch.launches = 0
    batches = []
    for name in ISECT_SCENES:
        sc = (size_check_scene(cfg, get_scene) if name == "size-check mesh"
              else get_scene(name, cfg))
        arrays, meta = sc.pack(device=dev)
        tables = mk.intersect_tables(arrays, meta, dev)
        o, d = camera_rays(sc.camera, W, H, 8, gen)
        first = mk.intersect_batch(arrays, meta, cfg, o, d, tables=tables)
        o2, d2 = bounce_rays(o, d, first[0], cfg.t_max, gen)
        second = mk.intersect_batch(arrays, meta, cfg, o2, d2, tables=tables)
        batches += [(f"{name} primary", arrays, meta, tables, o, d, first),
                    (f"{name} bounce", arrays, meta, tables, o2, d2, second)]
    launches = mk.intersect_batch.launches
    if launches != len(batches):
        raise AssertionError(f"phase 9: {launches} intersect launches for "
                             f"{len(batches)} batches")
    out = {}
    for tag, arrays, meta, tables, o, d, got in batches:
        counts = {}
        want, p_ms = timed(lambda: mk.intersect_batch_reference(
            arrays, meta, cfg, o, d, tables, counts), stack=False)
        got, want = flat_outputs(got), flat_outputs(want)
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(got, want))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            bad = [i for i, (a, b) in enumerate(zip(got, want))
                   if not torch.equal(a, b)]
            raise AssertionError(f"phase 9: {tag}: the kernel differs from "
                                 f"the plain version in outputs {bad}")
        k = k5_times(THIS_TREE, arrays, meta, cfg, o, d, tables)
        R = counts["rays"]
        misses = int((got[0] == cfg.t_max).sum())
        b_ms, b_by, ops = k5_bound(meta, cfg, counts, got, o, d, tables)
        phase(f"phase 9: {tag}: {R} rays ({misses} misses, "
              f"{counts['tri_hits']} triangle hits, {counts['node_visits']} "
              f"node visits): {k5_text(k)} "
              f"({R / k['kernel_ms'] / 1e6:.2f} Grays/s alone), bit-equal "
              f"to the plain version ({p_ms:.1f} ms); bound {b_ms:.4f} ms "
              f"({b_by}; {ops:.4g} f32 ops); card {card}")
        out[tag] = dict(ms=k["call_ms"], kernel_ms=k["kernel_ms"],
                        host_ms=k["host_ms"], plain_ms=p_ms, bound_ms=b_ms,
                        bound_by=b_by, rays=R, misses=misses, err=err)
    return launches, out


def op_rate_phase(dev, card):
    """P2, the op-rate probe (probes/op_rate.py): every variant's marginal
    rate at its default size, each kernel first held against its plain
    version at 4096 threads x 2 iterations by op_rate.compare (bit-equal
    but for sincos and leafmix, relative 1e-5). Sets bound_rate to the
    fastest non-FMA rate when that beats F32_OPS_PER_S. The JSON row is
    mul_par8 at THREADS x 100 iterations; it and add_par8, the two rates
    that can replace the spec's, are held bit for bit at that shape too.
    Returns {variant: rate dict} and the JSON row's numbers."""
    def check(v, xs, iters, plain=None):
        k = op_rate.run(v, xs, iters)
        if plain is None:
            plain = op_rate.run_plain(v, xs, iters)
        c = op_rate.compare(v, k, plain)
        if not c["ok"]:
            raise AssertionError(
                f"P2: {v} at {xs.numel()} threads x {iters} iterations "
                f"differs from its plain version (max rel {c['max_rel']:.2e}"
                f", need {c['rule']})")
        return c

    x = torch.from_numpy(np.random.default_rng(1).uniform(
        1.0, 2.0, 4096).astype(np.float32)).to(dev)
    op_rate.run.launches = 0
    rates = {}
    for v in op_rate.VARIANTS:
        c = check(v, x, 2)
        r = op_rate.measure(v, dev)
        rates[v] = dict(r, max_rel_err=c["max_rel"], max_abs_err=c["max_abs"])
        phase(f"phase 2 P2: {v}: {r['ops_per_s']:.4e} ops/s ({r['threads']} "
              f"threads x {r['iters']} iterations x "
              f"{op_rate.OPS_PER_ITER[v]} ops: {r['ms']:.4f} ms, 2x "
              f"{r['ms_2x']:.4f} ms); vs its plain version ({c['rule']}) "
              f"max rel {c['max_rel']:.1e}; card {card}")
    fastest = max(rates["mul_par8"]["ops_per_s"],
                  rates["add_par8"]["ops_per_s"])
    if fastest > F32_OPS_PER_S:
        bound_rate.update(ops_per_s=fastest, **{"from": "P2"})
    phase(f"phase 2 P2: fastest non-FMA rate {fastest:.4e} ops/s against "
          f"the spec's {F32_OPS_PER_S:.4e} (16896 lanes x 1.98 GHz): every "
          f"bound divides by {bound_rate['ops_per_s']:.4e} "
          f"({bound_rate['from']})")
    # the JSON row: mul_par8 at the default threads x 100 iterations,
    # kernel and plain version on the card, bit-equal, with its bound
    n, iters = op_rate.THREADS, 100
    xs = torch.from_numpy(np.random.default_rng(2).uniform(
        1.0, 2.0, n).astype(np.float32)).to(dev)
    k_ms = cuda_ms(lambda: op_rate.run("mul_par8", xs, iters), 5)
    p, p_ms = timed(lambda: op_rate.run_plain("mul_par8", xs, iters),
                    stack=False)
    c = check("mul_par8", xs, iters, p)
    check("add_par8", xs, iters)
    phase(f"phase 2 P2: mul_par8 and add_par8 at {n} threads x {iters} "
          f"iterations bit-equal to their plain versions")
    bound = bound_of(n * iters * op_rate.OPS_PER_ITER["mul_par8"],
                     2 * nbytes(xs))
    return rates, dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound[0],
                       bound_by=bound[1], launches=op_rate.run.launches,
                       fastest=fastest, max_abs_err=c["max_abs"])


def walk_compare(dev, msmall, nmesh):
    """Phase 3 (the mesh walks): Kernel A (packet modes 2 and 3) bit for
    bit against its plain version on `teapot`, the size-check mesh,
    `cubemap` and `teapot --nee` at 160x120; the node walk alone (thread
    and packet) on `teapot`; Kernel B (tensor-core leaves) on the same
    scenes by the per-slot rule, with its bit-equal share, and its leaf
    test per ray x triangle pair at each leaf size of LEAF_SWEEP
    (leaf_bench.check: t within one ulp, winners differing only at ties).
    Returns (max abs errs, {leaf: Kernel B's leaf check})."""
    scenes = [("teapot", get_scene("teapot", msmall), msmall, MESH_TILE),
              ("size-check mesh", size_check_scene(msmall, get_scene),
               msmall, MESH_TILE),
              ("cubemap", get_scene("cubemap", msmall), msmall, None),
              ("teapot --nee", get_scene("teapot", nmesh), nmesh, MESH_TILE)]
    errs = {"A": [], "B": []}
    for walk in ("packet mode 2", "packet mode 3", "tensor core"):
        exact = walk != "tensor core"
        with walk_env(WALKS[walk]):
            for name, sc, cfg, tile in scenes:
                err, bit = compare(f"{walk}: {name}", sc, cfg, tile, 0, dev,
                                   exact=exact)
                errs["A" if exact else "B"].append(err)
    for walk in ("leaf-ablated", "packet leaf-ablated"):
        with walk_env(WALKS[walk]):
            compare(f"{walk}: teapot", get_scene("teapot", msmall), msmall,
                    MESH_TILE, 0, dev, exact=True)
    # a block in which one warp stays live: the others' slots on a pixel
    # that sees the light, so their paths end at the first hit (Kernel A
    # under WALK_BLOCK lets such warps leave the bounce)
    for walk in ("packet mode 2", "packet mode 3", "tensor core"):
        with walk_env(WALKS[walk]):
            tabs, meta, _, lay = port_inputs(get_scene("teapot", msmall),
                                             msmall, MESH_TILE, dev)
            kw = dict(meta=meta, cfg=msmall, spp=msmall.samples,
                      total_samples=msmall.samples, tile=MESH_TILE, **lay)
            tabs, pixel = one_warp_live(tabs, kw)
            k = torch.stack(mk.trace_tiles((5, 0), *tabs, **kw))
            p = torch.stack(mk.trace_tiles_reference((5, 0), *tabs, **kw))
            bit = float((k == p).float().mean())
            phase(f"phase 3: {walk}: teapot, one warp a block live (the "
                  f"others on pixel {pixel}): bit-equal on {bit:.6f} of "
                  f"{k.numel()} slot values")
            if walk != "tensor core" and bit != 1.0:
                raise AssertionError(f"phase 3: {walk} differs from its "
                                     "plain version with one warp live")
            errs["A" if walk != "tensor core" else "B"].append(
                float((k - p).abs().max()))
    checks = {}
    for leaf in LEAF_SWEEP:
        tris, meta, arrays = leaf_bench.teapot_leaves(dev, leaf)
        check = checks[leaf] = leaf_bench.check(
            leaf_bench.mesh_rays(arrays, 1 << 16, dev), tris, meta)
        pr, mm = check["pairs"], check["mma"]
        phase(f"phase 3: Kernel B's leaf test on teapot's leaves of {leaf}: "
              f"{pr['within_1ulp']} of {pr['pairs']} ray x triangle pairs "
              f"with t within 1 ulp of the plain version "
              f"({pr['hit_within_1ulp']} of {pr['hit_pairs']} hit pairs; "
              f"bit-equal {pr['bit_equal']}); over 3 leaf visits of "
              f"{mm['rays']} rays: t within 1 ulp on {mm['t_within_1ulp']}, "
              f"winner equal on {mm['winner_equal']}, ties where it differs "
              f"{mm['winner_differs_at_tie']}")
        if (pr["within_1ulp"] < 0.999 * pr["pairs"]
                or mm["winner_equal"] + mm["winner_differs_at_tie"]
                != mm["rays"]):
            raise AssertionError(f"phase 3: Kernel B's leaf test at leaf "
                                 f"{leaf} is off its plain version")
    return errs, checks


def variant_main_path(tmp, dev, card, tag, env, tea):
    """Phase 4 (this slice's main path): `teapot` at W x H x SPP through
    cli.main under one of MAIN_WALKS, its launch counts set to 0 just
    before (every launch the mesh instantiation's and the packet walk's,
    the tensor-core one's under mxu); the image checked and its mean within
    MAIN_MEAN_REL of the default `teapot` render (`tea`, phase 4); the
    driver's last segment through the kernel and the plain version on
    every slot: bit-equal (Kernel A) or by the per-slot rule (Kernel B).
    Returns the numbers."""
    with walk_env(env):
        walk = mk.mesh_walk()
        img, m, n = cli_render("teapot", tmp)
        segs = m["segments"]
        phase(f"phase 4 walks: teapot {tag} {W}x{H}x{SPP}: "
              f"{m['msamples_per_sec']} Msamples/s, render wall {m['wall_s']} "
              f"s (driver), {m['total_wall_s']} s incl. scene setup; "
              f"{n['launches']} kernel launches ({n['packet']} of the packet "
              f"walk, {n['mma']} with tensor-core leaves) for {segs} "
              f"segments; card {card}")
        want_mma = segs if walk.leaf == "mma" else 0
        if not (n["launches"] == n["mesh"] == n["packet"] == segs
                == SPP // 8 and n["mma"] == want_mma):
            raise AssertionError(f"phase 4 walks: {tag}: the main path did "
                                 "not launch the packet walk once per "
                                 "segment")
        check_image(f"phase 4 walks {tag}", img)
        im, dm = img.reshape(-1, 3).mean(0), tea["img"].reshape(-1, 3).mean(0)
        rel = np.abs(im - dm) / dm
        tabs, kw, seed, _ = last_segment("teapot", m, MESH_TILE, dev)
        k = torch.stack(mk.trace_tiles(seed, *tabs, **kw))
        counts = {}
        p, p_ms = timed(lambda: mk.trace_tiles_reference(
            seed, *tabs, **kw, counts=counts))
    k, p = k.cpu().numpy(), p.cpu().numpy()
    bit_eq = float((k == p).mean())
    frac = float(np.isclose(k, p, atol=ATOL, rtol=RTOL).mean())
    prel = float(np.max(np.abs(k.mean((1, 2)) - p.mean((1, 2)))
                        / np.abs(p.mean((1, 2)))))
    err = float(np.abs(k - p).max())
    phase(f"phase 4 walks: {tag}: image mean {im} vs the default teapot "
          f"render {dm}: rel diff {rel.max():.4f} (need <{MAIN_MEAN_REL}); "
          f"segment seed {seed} x {kw['spp']} spp: kernel vs plain "
          f"({p_ms:.1f} ms) bit-equal on {bit_eq:.6f} of {k.size} slot "
          f"values, {frac:.6f} within atol={ATOL} rtol={RTOL}, mean rel "
          f"{prel:.2e}; max abs err {err:.3e}")
    if rel.max() >= MAIN_MEAN_REL:
        raise AssertionError(f"phase 4 walks: {tag}: image mean off the "
                             "default render")
    if not np.isfinite(k).all() or (walk.leaf != "mma" and bit_eq != 1.0):
        raise AssertionError(f"phase 4 walks: {tag}: the kernel differs "
                             "from the plain version")
    if frac < SLOT_FRAC or prel >= MEAN_REL:
        raise AssertionError(f"phase 4 walks: {tag}: kernel off the plain "
                             "version by the per-slot rule")
    return dict(launches=n["launches"], packet=n["packet"], mma=n["mma"],
                bit_eq=bit_eq, frac=frac, err=err, p_ms=p_ms, counts=counts,
                msamples=m["msamples_per_sec"], wall=m["wall_s"],
                mean_rel=float(rel.max()))


def walk_timing(dev, card):
    """Phase 5 (the mesh walks): each walk of WALKS on `teapot` and the
    size-check mesh at W x H x 8 spp (seed (1, 0)), timed in turns (two
    rounds, 5 launches a timing, the best), with K1-mesh's bound (the same
    function on the same inputs, from the per-thread plain run's work) and
    each walk's work from its plain version on 64 tiles spread over the
    frame (spread_tiles): node tests and leaf-slot tests a sample (a packet
    walk counts what its warps issue, 32 lanes a node and 32 x leaf a
    leaf). Returns {scene: {walk: numbers}}."""
    cfg = RenderConfig(width=W, height=H, samples=8, samples_per_pass=8)
    out = {}
    for scene in ("teapot", "size-check mesh"):
        sc = (size_check_scene(cfg, get_scene) if scene != "teapot"
              else get_scene("teapot", cfg))
        ins = {}
        for walk, env in WALKS.items():
            with walk_env(env):
                tabs, meta, _, lay = port_inputs(sc, cfg, MESH_TILE, dev)
                kw = dict(meta=meta, cfg=cfg, spp=8, total_samples=8,
                          tile=MESH_TILE, **lay)
                counts = {}
                sub = spread_tiles(tabs, MESH_TILE, 64)
                _, p64 = timed(lambda: mk.trace_tiles_reference(
                    (1, 0), *sub, **kw, counts=counts))
            ins[walk] = (tabs, kw, counts, p64)
        runs = {w: [] for w in WALKS}
        for _ in range(2):
            for walk, env in WALKS.items():
                tabs, kw = ins[walk][:2]
                with walk_env(env):
                    runs[walk].append(cuda_ms(
                        lambda: mk.trace_tiles((1, 0), *tabs, **kw), 5))
        n_tiles = ins["per-thread"][0][-2].shape[0] // MESH_TILE[0]
        full = {k: v * n_tiles // 64
                for k, v in ins["per-thread"][2].items()}
        b_ms, b_by, ops = fwd_bound(full, ins["per-thread"][0],
                                    ins["per-thread"][1])
        base = ins["per-thread"][2]
        res = {}
        for walk in WALKS:
            c = ins[walk][2]
            ms = min(runs[walk])
            res[walk] = dict(ms=ms, runs=runs[walk], bound_ms=b_ms,
                             bound_by=b_by, plain_ms_64_tiles=ins[walk][3],
                             node_tests_per_sample=c["node_visits"]
                             / c["samples"],
                             leaf_tests_per_sample=c["leaf_slots"]
                             / c["samples"])
            phase(f"phase 5 walks: {scene} {W}x{H}x8 spp, {walk}: "
                  f"{ms:.4f} ms (timings {[round(x, 4) for x in runs[walk]]}"
                  f"; {W * H * 8 / ms / 1e3:.1f} Msamples/s), K1-mesh's bound "
                  f"{b_ms:.4f} ms ({b_by}; {ops:.4g} f32 ops; {ms / b_ms:.2f}x)"
                  f"; a sample: {res[walk]['node_tests_per_sample']:.2f} node "
                  f"tests, {res[walk]['leaf_tests_per_sample']:.2f} leaf-slot "
                  f"tests ({c['leaf_slots'] / max(base['leaf_slots'], 1):.2f}x "
                  f"the per-thread walk's); plain on 64 spread tiles "
                  f"{ins[walk][3]:.1f} ms; card {card}")
        out[scene] = res
    return out


def object_ops(meta) -> dict:
    """The object loop's f32 operations a bounce of a scene: every object's
    full transform and test (OPS_OBJECT), and the narrowed loop (a plane's
    y row only, then the winner's full transform once: OPS_OBJECT_NARROW,
    OPS_WINNER)."""
    return {"full": sum(OPS_OBJECT[t] for t in meta.obj_types),
            "narrowed": sum(OPS_OBJECT_NARROW[t] for t in meta.obj_types)
            + OPS_WINNER}


def split_phase(walk_times, k1_ms, metas, card):
    """Phase 5 (the split): on `teapot` and the size-check mesh at W x H x 8
    spp, K1-mesh (the per-thread walk), the node walk alone
    (PT_ABLATE_LEAF=1) and what the leaf tests add (the difference), beside
    K1 on `reference` at the same size (the bounce without any walk), the
    node and leaf-slot tests a sample (phase 5's walk timings), and the
    object loop's operations a bounce of `reference` and `teapot`
    (object_ops). Returns the numbers."""
    out = {"k1_reference_ms": k1_ms,
           "object_ops": {n: object_ops(m) for n, m in metas.items()}}
    for scene, res in walk_times.items():
        pt, nw = res["per-thread"], res["leaf-ablated"]
        out[scene] = dict(
            k1_mesh_ms=pt["ms"], node_walk_ms=nw["ms"],
            leaf_ms=pt["ms"] - nw["ms"],
            node_tests_per_sample=pt["node_tests_per_sample"],
            leaf_tests_per_sample=pt["leaf_tests_per_sample"])
        phase(f"phase 5 split: {scene} {W}x{H}x8 spp: K1-mesh {pt['ms']:.4f} "
              f"ms, the node walk alone {nw['ms']:.4f} ms, the leaf tests "
              f"{pt['ms'] - nw['ms']:.4f} ms; K1 on reference (no walk) "
              f"{k1_ms:.4f} ms; a sample: {pt['node_tests_per_sample']:.2f} "
              f"node tests, {pt['leaf_tests_per_sample']:.2f} leaf-slot tests;"
              f" card {card}")
    phase(f"phase 5 split: object-loop f32 operations a bounce (every "
          f"object's full transform, or a plane's y row and the winner's "
          f"transform after the loop): {out['object_ops']}")
    return out


def leaf_sweep(dev, card):
    """Phase 5 (the leaf size): K1-mesh at W x H x 8 spp on `teapot` and the
    size-check mesh packed at each PT_BVH_LEAF of LEAF_SWEEP, each held bit
    for bit against its plain version on 64 tiles spread over the frame
    (whose counts give the node and leaf-slot tests a sample), and on
    `teapot` the other kernels of its main paths at each leaf size (K1-nee
    at 8 spp, K6 in triangle mode at GRAD_SPP: tree_case); then each kernel
    timed in turns: the sizes in order and reversed, three times over, 10
    launches a timing. Returns {scene: {kernel: {leaf: numbers}}}: the
    median and every timing."""
    cfg = RenderConfig(width=W, height=H, samples=8, samples_per_pass=8)
    out = {}
    for scene in ("teapot", "size-check mesh"):
        ins, fns = {}, {"K1-mesh": {}}
        if scene == "teapot":
            fns.update({"K1-nee": {}, "K6 triangles": {}})
        for leaf in LEAF_SWEEP:
            with env_var("PT_BVH_LEAF", str(leaf)):
                sc = (size_check_scene(cfg, get_scene) if scene != "teapot"
                      else get_scene("teapot", cfg))
                tabs, meta, _, lay = port_inputs(sc, cfg, MESH_TILE, dev)
            kw = dict(meta=meta, cfg=cfg, spp=8, total_samples=8,
                      tile=MESH_TILE, **lay)
            sub = spread_tiles(tabs, MESH_TILE, 64)
            counts = {}
            p = torch.stack(mk.trace_tiles_reference((1, 0), *sub, **kw,
                                                     counts=counts))
            if not torch.equal(torch.stack(mk.trace_tiles((1, 0), *sub,
                                                          **kw)), p):
                raise AssertionError(f"phase 5 leaf: {scene} leaf {leaf}: "
                                     "kernel differs from the plain version")
            ins[leaf] = (counts, meta.n_nodes)
            fns["K1-mesh"][leaf] = (
                lambda tabs=tabs, kw=kw: mk.trace_tiles((1, 0), *tabs, **kw))
            if scene == "teapot":
                fns["K1-nee"][leaf] = tree_case(THIS_TREE, dict(
                    kind="fwd", scene="teapot", tile=MESH_TILE, leaf=leaf,
                    cfg={"nee": True}), dev)
                fns["K6 triangles"][leaf] = tree_case(THIS_TREE, dict(
                    kind="tri", scene="teapot", spp=GRAD_SPP, leaf=leaf), dev)
        res = {}
        for kernel, by_leaf in fns.items():
            runs = {leaf: [] for leaf in LEAF_SWEEP}
            for order in (LEAF_SWEEP, LEAF_SWEEP[::-1]) * 3:
                for leaf in order:
                    runs[leaf].append(cuda_ms(by_leaf[leaf], 10))
            res[kernel] = {}
            for leaf in LEAF_SWEEP:
                c = ins[leaf][0]
                r = res[kernel][leaf] = dict(
                    ms=float(np.median(runs[leaf])), runs=runs[leaf],
                    nodes=ins[leaf][1],
                    node_tests_per_sample=c["node_visits"] / c["samples"],
                    leaf_tests_per_sample=c["leaf_slots"] / c["samples"])
                phase(f"phase 5 leaf: {scene} {W}x{H}, {kernel}, "
                      f"PT_BVH_LEAF={leaf} ({r['nodes']} nodes): median "
                      f"{r['ms']:.4f} ms (timings "
                      f"{[round(x, 4) for x in runs[leaf]]}); K1-mesh's "
                      f"sample: {r['node_tests_per_sample']:.2f} node "
                      f"tests, {r['leaf_tests_per_sample']:.2f} leaf-slot "
                      f"tests, bit-equal to the plain version on 64 spread "
                      f"tiles; card {card}")
        out[scene] = res
    return out


def intersect_walks(dev, card):
    """Phase 9 (the mesh walks): K5 on `teapot`'s two 9,830,400-ray batches
    (phase 9's rays) under packet modes 2 and 3 and tensor-core leaves, the
    launch counts set to 0 before the batches' first calls and read after;
    then each batch against intersect_batch_reference: bit for bit (Kernel
    A), t within one ulp and the winner equal except at ties (Kernel B);
    and timed (10 launches). Returns the numbers and the counts."""
    cfg = RenderConfig(width=W, height=H, samples=8)
    sc = get_scene("teapot", cfg)
    mk.intersect_batch.launches = 0
    mk.intersect_batch.packet_launches = 0
    mk.intersect_batch.mma_launches = 0
    batches = []
    for walk in ("packet mode 2", "packet mode 3", "tensor core"):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        with walk_env(WALKS[walk]):
            arrays, meta = sc.pack(device=dev)
            tables = mk.intersect_tables(arrays, meta, dev)
            o, d = camera_rays(sc.camera, W, H, 8, gen)
            first = mk.intersect_batch(arrays, meta, cfg, o, d, tables=tables)
            o2, d2 = bounce_rays(o, d, first[0], cfg.t_max, gen)
            second = mk.intersect_batch(arrays, meta, cfg, o2, d2,
                                        tables=tables)
        batches += [(walk, "primary", arrays, meta, tables, o, d, first),
                    (walk, "bounce", arrays, meta, tables, o2, d2, second)]
    n = (mk.intersect_batch.launches, mk.intersect_batch.packet_launches,
         mk.intersect_batch.mma_launches)
    phase(f"phase 9 walks: {n[0]} intersect launches, {n[1]} on the packet "
          f"walk, {n[2]} with tensor-core leaves")
    if n != (6, 6, 2):
        raise AssertionError("phase 9 walks: the walks were not launched")
    out = {}
    for walk, tag, arrays, meta, tables, o, d, got in batches:
        with walk_env(WALKS[walk]):
            counts = {}
            want, p_ms = timed(lambda: mk.intersect_batch_reference(
                arrays, meta, cfg, o, d, tables, counts), stack=False)
            k_ms = cuda_ms(lambda: mk.intersect_batch(
                arrays, meta, cfg, o, d, tables=tables), 10)
        got, want = flat_outputs(got), flat_outputs(want)
        t_ulp = (got[0].view(torch.int32).long()
                 - want[0].view(torch.int32).long()).abs()
        same_w = got[1] == want[1]
        ties = int((~same_w & (t_ulp == 0)).sum())
        bit = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(got, want))
        phase(f"phase 9 walks: teapot {tag}, {walk}: {counts['rays']} rays: "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.1f} ms, bit-equal {bit} "
              f"(t within 1 ulp on {int((t_ulp <= 1).sum())}, winners "
              f"differing at ties {ties}); {counts['node_visits']} node tests "
              f"issued; card {card}")
        if walk != "tensor core" and not bit:
            raise AssertionError(f"phase 9 walks: {walk} {tag}: the kernel "
                                 "differs from its plain version")
        if walk == "tensor core" and not (
                int((t_ulp <= 1).sum()) == t_ulp.numel()
                and int(same_w.sum()) + ties == same_w.numel()):
            raise AssertionError(f"phase 9 walks: {walk} {tag}: off the rule")
        out[f"teapot {tag}, {walk}"] = dict(ms=k_ms, plain_ms=p_ms,
                                            bit_equal=bit, err=err, ties=ties)
    return out, n


def leaf_phase(dev, card, teapot_walks):
    """Phase 10: P3, the leaf microbenchmark (probes/leaf_bench.py) on
    teapot's leaves: each variant's marginal ns a visit and G triangle
    tests a second, `prod` and `mma` held against their plain versions
    first; then the JAX harness's cross-check on the port: the per-thread
    K1-mesh rate (phase 5) against the leaf rate over the leaf-slot tests a
    sample. Returns the numbers."""
    leaf_bench.run.launches = 0
    tris, meta, arrays = leaf_bench.teapot_leaves(dev)
    rays = leaf_bench.mesh_rays(arrays, leaf_bench.RAYS, dev)
    res = {}
    for v in leaf_bench.VARIANTS:
        r = leaf_bench.measure(v, rays, tris, meta)
        res[v] = r
        phase(f"phase 10 P3: {v}: {r['ns_per_visit']:.1f} ns a visit of "
              f"{r['rays']} rays (leaf {r['leaf']}; {r['visits']} and "
              f"{5 * r['visits']} visits: {r['ms']:.4f} / {r['ms_5x']:.4f} "
              f"ms) = {r['gtests_per_s']:.1f} G triangle tests/s; card {card}")
    pw = teapot_walks["per-thread"]
    k1_rate = W * H * 8 / (pw["ms"] / 1e3)
    tests = pw["leaf_tests_per_sample"]
    predicted = res["prod"]["gtests_per_s"] * 1e9 / tests
    phase(f"phase 10 P3: cross-check: teapot K1-mesh {k1_rate / 1e6:.1f} "
          f"Msamples/s (phase 5, per-thread) against the leaf rate / leaf "
          f"tests a sample = {res['prod']['gtests_per_s']:.1f}e9 / "
          f"{tests:.2f} = {predicted / 1e6:.1f} Msamples/s "
          f"({k1_rate / predicted:.3f} of it)")
    # the JSON row: `prod` at RAYS x VISITS, kernel and plain version
    visits = leaf_bench.VISITS
    k_ms = cuda_ms(lambda: leaf_bench.run("prod", rays, tris, meta, visits), 5)
    k = leaf_bench.run("prod", rays, tris, meta, visits)
    p, p_ms = timed(lambda: leaf_bench.plain("prod", rays, tris, meta,
                                             visits), stack=False)
    if not (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])):
        raise AssertionError("phase 10 P3: prod differs from its plain "
                             "version")
    n = rays[0].numel()
    bound = bound_of(n * meta.leaf_size * visits * OPS_LEAF_SLOT,
                     nbytes(*rays) + 8 * n)
    return res, dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound[0],
                     bound_by=bound[1], launches=leaf_bench.run.launches,
                     k1_msamples=k1_rate / 1e6,
                     predicted_msamples=predicted / 1e6,
                     max_abs_err=float((k[0] - p[0]).abs().max()))


def grad_setup(sc, cfg, dev):
    """The gradient kernel's inputs for `sc` on the steps' layout and random
    per-slot cotangents: (tabs, meta, arrays, cots)."""
    tabs, meta, arrays, _ = grad_inputs(sc, cfg, GRAD_TILE, dev)
    rng = np.random.default_rng(0)
    cots = [torch.from_numpy(rng.random(tuple(tabs[-2].shape),
                                        dtype=np.float32)).to(dev)
            for _ in range(3)]
    return tabs, meta, arrays, cots


def grad_case(tag, sc, cfg, mode, dev, card, work=None):
    """K6 in `mode` ("object", "triangle" or "texel": K6-tex, the texels the
    decoded pool) against its plain version on the card, the same inputs
    and per-slot cotangents, on the walk of the knobs (grad_walk): the
    gradient rule (the texel rule in texel mode; without leaf tests the
    triangle gradients exactly zero, ablated_grad_rule), both times by
    CUDA events, and whether two launches give the same bits. The bound
    counts the work of `work` (the plain version's counts of another walk
    of the same function on the same inputs: a packet walk is bounded by
    the per-thread walk's work, not by the lanes that ride along), else
    this walk's own. Returns the numbers, with this walk's counts."""
    tabs, meta, arrays, cots = grad_setup(sc, cfg, dev)
    kw = dict(meta=meta, cfg=cfg, spp=cfg.samples,
              total_samples=cfg.samples, tile=GRAD_TILE,
              tri_grads=mode == "triangle")
    tex_bytes = 0
    if mode == "texel":
        tex = texel_params(arrays)
        kw.update(tex_grads=True, tex=tex, tex_table=torch.from_numpy(
            mk.build_tex_table(arrays, meta)).to(dev))
        tex_bytes = tex.shape[0] * 16 + nbytes(kw["tex_table"])

    def run():
        return tg.grad_tiles((3, 0), *tabs, *cots, **kw)

    k, k2 = run(), run()
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(k, k2))
    counts = {}
    p, p_ms = timed(lambda: tg.grad_tiles_reference(
        (3, 0), *tabs, *cots, counts=counts, **kw), stack=False)
    if mode == "texel":
        err = tex_grad_rule(k, p)
    elif mode == "triangle" and mk.grad_scene_walk(meta).leaf == "none":
        err = ablated_grad_rule(k, p)
    else:
        err = grad_rule(k, p, meta.has_groups)
    k_ms = cuda_ms(run, 5)
    # in: the tables, pixel maps, cotangents (and texels, texture table);
    # out: the gradient sums
    io_bytes = (nbytes(*tabs, *cots) + tex_bytes, nbytes(*k))
    bound = work_bound(work or counts, meta, *io_bytes, grad=True,
                       f32=mode == "texel")
    own = work_bound(counts, meta, *io_bytes, grad=True, f32=mode == "texel")
    extra = ""
    if mode == "triangle" and "gtri_frac" not in err:
        extra = "; gtri exactly zero on both sides (no leaf tests)"
    elif mode == "triangle":
        extra = (f"; gtri {err['gtri_frac']:.6f} of {meta.n_tri_slots} slots "
                 f"within the rule ({err['gtri_slots_hit']} hit)")
    elif mode == "texel":
        extra = (f"; gtex {err['gtex_frac']:.6f} of {err['gtex_touched']} "
                 f"touched texels within the rule, channel sums within "
                 f"{err['gtex_sum_rel']:.2e}; {counts['texel_scatters']} "
                 f"texel scatters")
    whose = ("" if work is None else f", the per-thread walk's work; this "
             f"walk's plain version counts {own[2]:.4g}, {own[0]:.4f} ms")
    phase(f"phase {8 if mode == 'texel' else 6}: {tag}, {mode} mode, "
          f"{cfg.width}x{cfg.height}x{cfg.samples} spp: kernel {k_ms:.4f} "
          f"ms, plain {p_ms:.1f} ms; max rel err gcol {err['gcol']:.2e} "
          f"gemi {err['gemi']:.2e}{extra}; two launches bit-identical: "
          f"{same_bits}; bound {bound[0]:.4f} ms ({bound[1]}; "
          f"{bound[2]:.4g} f32 ops{whose}); card {card}")
    return dict(err, ms=k_ms, plain_ms=p_ms, same_bits=same_bits,
                bound_ms=bound[0], bound_by=bound[1],
                own_work_bound_ms=own[0],
                scatters=counts.get("texel_scatters", 0), counts=counts)


def crn_target(tabs, meta, cfg, pid, seed, spp):
    """The true-color image the training steps render with `seed` (common
    random numbers: the loss then sees no Monte-Carlo noise at the truth),
    through the forward kernel on the steps' layout."""
    rgb = mk.trace_tiles(seed, *tabs, meta=meta, cfg=cfg, spp=spp,
                         total_samples=cfg.samples, tile=GRAD_TILE)
    flat = torch.stack(rgb, -1).reshape(-1, 3).cpu().numpy() / spp
    return mk.untile_image(flat, pid, cfg.width, cfg.height).reshape(
        cfg.height, cfg.width, 3)


def check_falls(tag, losses):
    phase(f"{tag}: losses {[float(f'{x:.6g}') for x in losses]}")
    if not (np.isfinite(losses).all() and losses[-1] < LOSS_FALL
            * losses[0]):
        raise AssertionError(f"{tag}: the loss did not fall below "
                             f"{LOSS_FALL} of its first value")


def step_rate(step, params, target, spp, n=3):
    """fwd+bwd Msamples/s of a training step as bench.py:160-173 measures
    it: one warm-up step, then n steps with new seeds, the loss read once
    at the end."""
    *params, loss = step(*params, (1, 0), target)
    float(loss)
    t0 = time.perf_counter()
    for i in range(n):
        *params, loss = step(*params, (i + 2, 0), target)
    float(loss)
    dt = time.perf_counter() - t0
    return W * H * spp * n / dt / 1e6, dt


def grad_phase(dev, card, mesh_tris):
    """Phase 6 (and phase 8's K6-tex): the gradient kernel against its plain
    version at W x H, GRAD_SPP and STEP_SPP samples a launch: object mode
    on `reference`, triangle mode on `teapot` and the size-check mesh, and
    texel mode on TEX_TRAIN. Returns {spp: (reference, teapot, size-check,
    texels)}."""
    out = {}
    for spp in (GRAD_SPP, STEP_SPP):
        gcfg = RenderConfig(width=W, height=H, samples=spp,
                            samples_per_pass=spp)
        out[spp] = (
            grad_case("reference", get_scene("reference", gcfg), gcfg,
                      "object", dev, card),
            grad_case(f"teapot ({mesh_tris['teapot']} triangles)",
                      get_scene("teapot", gcfg), gcfg, "triangle", dev,
                      card),
            grad_case(f"size-check mesh ({mesh_tris['size-check mesh']} "
                      "triangles)", size_check_scene(gcfg, get_scene), gcfg,
                      "triangle", dev, card),
            grad_case(TEX_TRAIN, get_scene(TEX_TRAIN, gcfg), gcfg, "texel",
                      dev, card))
    return out


def grad_walk_phase(dev, card, mesh_tris, per_thread, ptxas):
    """Phase 6 (the walks): K6 and K6-tex on each walk of GRAD_WALKS
    against its plain version on the whole W x H image, at GRAD_SPP and
    (as GRAD_WALKS says) at its training step's launch size (WALK_SPP), on
    `teapot` and the size-check mesh in triangle mode and on the textured
    teapot (textured_teapot) in texel mode, beside the per-thread walk's
    rows at the same sizes (`per_thread`: grad_phase's, which give the
    triangle meshes' at GRAD_SPP), whose counts bound the packet walks;
    PT_SUBPACKET=1 once, at GRAD_SPP on `teapot`; the ptxas counts of the
    walks' gradient instantiations, each at most 64 registers. Returns
    ({walk: {case: {spp: row}}}, the per-thread walk's under "per-thread",
    mode 1's row, {instantiation: ptxas counts})."""
    scenes = {
        "teapot": (f"teapot ({mesh_tris['teapot']} triangles)", "triangle",
                   lambda c: get_scene("teapot", c)),
        "size-check": (f"size-check mesh ({mesh_tris['size-check mesh']} "
                       "triangles)", "triangle",
                       lambda c: size_check_scene(c, get_scene)),
        "textured teapot": ("textured teapot", "texel",
                            lambda c: textured_teapot(get_scene("teapot", c),
                                                      proctex.make)),
    }

    def row(walk, case, spp, base=None):
        tag, mode, make = scenes[case]
        cfg = RenderConfig(width=W, height=H, samples=spp,
                           samples_per_pass=spp)
        work = out[base][case][spp]["counts"] if base else None
        return grad_case(f"{tag}, {walk}", make(cfg), cfg, mode, dev, card,
                         work)

    def sizes(case, training=True):
        return (GRAD_SPP,) + ((WALK_SPP[scenes[case][1]],) if training
                              else ())

    out = {"per-thread": {"teapot": {GRAD_SPP: per_thread[GRAD_SPP][1]},
                          "size-check": {GRAD_SPP: per_thread[GRAD_SPP][2]},
                          "textured teapot": {}}}
    with walk_env({}):
        for case in scenes:
            for spp in sizes(case):
                if spp not in out["per-thread"][case]:
                    out["per-thread"][case][spp] = row("per-thread", case, spp)
    for walk, (env, base, training) in GRAD_WALKS.items():
        with walk_env(env):
            out[walk] = {case: {spp: row(walk, case, spp, base)
                                for spp in sizes(case, training)}
                         for case in scenes}
        phase(f"phase 6 walks: {walk} against the per-thread walk: "
              + ", ".join(f"{case} {scenes[case][1]}s {W}x{H}x{spp} "
                          f"{r['ms']:.4f} ms / {b['ms']:.4f} ms "
                          f"({r['ms'] / b['ms']:.3f}x)"
                          for case, rows in out[walk].items()
                          for spp, r in rows.items()
                          for b in [out["per-thread"][case][spp]])
              + f"; card {card}")
    with walk_env({"PT_SUBPACKET": "1"}):
        if mk.grad_walk() != mk.Walk("block", "simt"):
            raise AssertionError("phase 6 walks: PT_SUBPACKET=1 does not "
                                 "take mode 2's walk")
        mode1 = row("packet mode 1", "teapot", GRAD_SPP, "per-thread")
    counts = {k: v for k, v in ptxas_counts(ptxas).items()
              if k.startswith("grad") and "mesh" in k.split()}
    phase(f"phase 6 walks: ptxas (registers, stack, spill stores, spill "
          f"loads) of the mesh gradient instantiations: {counts}")
    over = {k: v for k, v in counts.items() if v[0] is None or v[0] > 64}
    if len(counts) != 8 or over:
        raise AssertionError(f"phase 6 walks: {len(counts)} mesh gradient "
                             f"instantiations (need 8), over 64 registers: "
                             f"{over}")
    return out, mode1, counts


def row_shared_check(dev, card):
    """Phase 6 (the megakernel step's default draws): the gradient of
    make_megakernel_step with its default row-shared roulette and
    hemisphere draws against the wavefront's (image_loss) on `reference`
    at AD_EST over ROW_SHARED_SEEDS seeds each, by the rule that phase 12
    applies to per-slot draws (every entry within AD_SIGMAS standard
    errors; a noiseless entry equal). The result is printed and returned,
    not raised: the row sharing skews one seed's gradient (a sum over a
    few hundred directions), and whether ROW_SHARED_SEEDS seeds take its
    tail in is what this records."""
    z, live, still = estimator_z(dev, "1", ROW_SHARED_SEEDS)
    zmax = float(np.abs(z).max())
    ok = zmax <= AD_SIGMAS and not still
    phase(f"phase 6: the megakernel step's default row-shared draws against "
          f"the wavefront, reference {AD_EST[0]}x{AD_EST[1]}x{AD_EST[2]}, "
          f"{ROW_SHARED_SEEDS} seeds each: {live} entries with noise, |z| "
          f"max {zmax:.3f} (rule {AD_SIGMAS}), {still} noiseless entries "
          f"that differ: {'within' if ok else 'OUTSIDE'} the rule; card "
          f"{card}")
    return dict(seeds=ROW_SHARED_SEEDS, entries=live, z_max=zmax,
                noiseless_differ=still, within_rule=ok)


def tex_forward_walks(dev, card):
    """Phase 8 (the f32-texel forward's walks): the textured teapot at
    W x H x 8 spp on the training steps' layout through the f32-texel
    forward on each walk of F32_WALKS, bit-equal to its plain version,
    timed, with its bound: the per-thread walk's work on the same inputs
    (F32_BOUND_BY: a packet walk's plain version counts the lanes that
    ride along), this walk's own beside it. Returns {walk: numbers}."""
    cfg = RenderConfig(width=W, height=H, samples=8, samples_per_pass=8)
    sc = textured_teapot(get_scene("teapot", cfg), proctex.make)
    tabs, meta, arrays, _ = grad_inputs(sc, cfg, GRAD_TILE, dev)
    kw = dict(meta=meta, cfg=cfg, spp=8, total_samples=8, tile=GRAD_TILE,
              tex_table=torch.from_numpy(mk.build_tex_table(arrays, meta))
              .to(dev), tex_texels=texel_params(arrays))
    out, work = {}, {}
    for walk, env in F32_WALKS.items():
        with walk_env(env):
            def run():
                return mk.trace_tiles((1, 0), *tabs, **kw)
            k = torch.stack(run())
            counts = {}
            p, p_ms = timed(lambda: mk.trace_tiles_reference(
                (1, 0), *tabs, counts=counts, **kw))
            if not torch.equal(k, p):
                raise AssertionError(f"phase 8 walks: the f32-texel forward "
                                     f"on the {walk} walk differs from its "
                                     f"plain version")
            ms = cuda_ms(run, 10)
            work[walk] = counts
            b_ms, b_by, ops = fwd_bound(work[F32_BOUND_BY[walk]], tabs, kw)
            own = fwd_bound(counts, tabs, kw)
            name = mk.scene_walk(meta)
        out[walk] = dict(ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         own_work_bound_ms=own[0],
                         err=float((k - p).abs().max()),
                         walk=list(name))
        phase(f"phase 8 walks: textured teapot {W}x{H}x8 spp, f32-texel "
              f"forward on the {walk} walk {tuple(name)}: kernel {ms:.4f} ms "
              f"({ms / out['per-thread']['ms']:.3f}x the per-thread walk), "
              f"bit-equal to the plain version ({p_ms:.1f} ms); bound "
              f"{b_ms:.4f} ms ({b_by}; {ops:.4g} f32 ops, the "
              f"{F32_BOUND_BY[walk]} walk's work; this walk's plain version "
              f"counts {own[2]:.4g}, {own[0]:.4f} ms); card {card}")
    return out


def grad_split(trees, ptxas_of, dev, card):
    """Phase 6 (the gradient kernel's split): each row of GRAD_ROWS at
    W x H x GRAD_SPP and at its main path's launch size, on this tree and
    on the trees of `--grad-split DIR` (e.g. tools/grad_variants.py's
    timing copies: the replay alone, the tape written, the reverse walk
    with its adds to a register; their gradients are not checked), timed
    in turns (10 launches, through the trees and back, twice). `trees` is
    [(tag, tree)], this tree first; `ptxas_of`: tag -> ptxas counts, whose
    gradient instantiations are printed. Returns ({row: {spp: {tag: median
    ms}}}, {tag: gradient ptxas})."""
    order = [tag for tag, _ in trees]
    out = {}
    for row, spec in GRAD_ROWS.items():
        for spp in sorted({GRAD_SPP, GRAD_MAIN_SPP[spec["kind"]]}):
            fns = {tag: tree_case(T, dict(spec, spp=spp), dev)
                   for tag, T in trees}
            runs = {tag: [] for tag in order}
            for tag in (order + order[::-1]) * 2:
                runs[tag].append(cuda_ms(fns[tag], 10))
            res = {tag: float(np.median(runs[tag])) for tag in order}
            phase(f"phase 6 grad split: {row} {W}x{H}x{spp} spp: " + ", ".join(
                f"{tag} {ms:.4f} ms ({ms / res[order[0]]:.3f}x)"
                for tag, ms in res.items()) + f"; timings "
                f"{ {t: [round(x, 4) for x in r] for t, r in runs.items()} }"
                f"; card {card}")
            out.setdefault(row, {})[spp] = res
    ptx = {}
    for tag in order:
        ptx[tag] = {k: list(v) for k, v in ptxas_of[tag].items()
                    if k.startswith("grad")}
        phase(f"phase 6 grad split: ptxas (registers, stack, spill stores, "
              f"spill loads) of {tag}'s gradient instantiations: {ptx[tag]}")
    return out, ptx


def k1_split(trees, ptxas_of, dev, card):
    """Phase 5 (the forward kernel's split): each row of K1_ROWS at W x H on
    this tree and on the trees of `--k1-split DIR` (e.g.
    tools/k1_variants.py's timing copies: the object tests' divisions made
    approximate, the roulette's draws taken where read, one sincosf for the
    hemisphere, 16-byte object rows, the launch shape; their outputs are not
    checked), timed in turns (10 launches a timing, through the trees and
    back, twice: the median of 4). `trees` is [(tag, tree)], this tree
    first; `ptxas_of`: tag -> ptxas counts, whose forward instantiations
    are printed. Returns ({row: {tag: median ms}}, {tag: forward ptxas})."""
    order = [tag for tag, _ in trees]
    out = {}
    for row, spec in K1_ROWS.items():
        fns = {tag: tree_case(T, spec, dev) for tag, T in trees}
        runs = {tag: [] for tag in order}
        for tag in (order + order[::-1]) * 2:
            runs[tag].append(cuda_ms(fns[tag], 10))
        res = {tag: float(np.median(runs[tag])) for tag in order}
        phase(f"phase 5 k1 split: {row} {W}x{H}: " + ", ".join(
            f"{tag} {ms:.4f} ms ({ms / res[order[0]]:.3f}x)"
            for tag, ms in res.items()) + f"; timings "
            f"{ {t: [round(x, 4) for x in r] for t, r in runs.items()} }"
            f"; card {card}")
        out[row] = res
    ptx = {}
    for tag in order:
        ptx[tag] = {k: list(v) for k, v in ptxas_of[tag].items()
                    if ("primitive" in k.split() or "mesh" in k.split())
                    and not k.startswith("grad")}
        phase(f"phase 5 k1 split: ptxas (registers, stack, spill stores, "
              f"spill loads) of {tag}'s forward instantiations: {ptx[tag]}")
    return out, ptx


def walk_split(trees, ptxas_of, dev, card):
    """Phase 5 (the packet walks' split): each row of WALK_ROWS at W x H on
    this tree and on the trees of `--walk-split DIR` (e.g.
    tools/walk_variants.py's timing copies: the octant vote without
    barriers, group_any a warp vote, dead warps skipped, one column tile,
    no reduction, the dots on the SIMT cores; their outputs are not
    checked), timed in turns (10 launches a timing, through the trees and
    back, twice: the median of 4). `trees` is [(tag, tree)], this tree
    first; `ptxas_of`: tag -> ptxas counts, whose packet instantiations
    (and Kernel B's probes) are printed. Returns ({row: {tag: median
    ms}}, {tag: those ptxas counts})."""
    order = [tag for tag, _ in trees]
    out = {}
    for row, spec in WALK_ROWS.items():
        fns = {tag: tree_case(T, spec, dev) for tag, T in trees}
        runs = {tag: [] for tag in order}
        for tag in (order + order[::-1]) * 2:
            runs[tag].append(cuda_ms(fns[tag], 10))
        res = {tag: float(np.median(runs[tag])) for tag in order}
        phase(f"phase 5 walk split: {row}: " + ", ".join(
            f"{tag} {ms:.4f} ms ({ms / res[order[0]]:.3f}x)"
            for tag, ms in res.items()) + f"; timings "
            f"{ {t: [round(x, 4) for x in r] for t, r in runs.items()} }"
            f"; card {card}")
        out[row] = res
    ptx = {}
    for tag in order:
        ptx[tag] = {k: list(v) for k, v in ptxas_of[tag].items()
                    if "packet" in k or k.startswith(("mma", "leaf bench mma"))}
        phase(f"phase 5 walk split: ptxas (registers, stack, spill stores, "
              f"spill loads) of {tag}'s packet instantiations and Kernel B's "
              f"probes: {ptx[tag]}")
    return out, ptx


def walk_phases(args, dev, card, ptxas):
    """Phase 5: the packet walks' split over this tree and the trees of
    `--walk-split` (none: this tree alone). Returns walk_split's results."""
    trees, ptxas_of = [("this", THIS_TREE)], {"this": ptxas_counts(ptxas)}
    for i, d in enumerate(args.walk_split):
        T = load_tree(d, f"walk_tree_{i}")
        T.mk.library()
        trees.append((d, T))
        ptxas_of[d] = ptxas_counts(tree_ptxas(T))
    return walk_split(trees, ptxas_of, dev, card)


def ab_chain(dirs, specs, dev, card):
    """Phase 5 A/B along a chain of trees (one --ab-chain, in order): each tree
    against the one before it, on its own code (ab_parent with `this` the
    later tree), outputs reported where they differ, no fwd+bwd rates.
    Returns {(parent, this): ab_parent's results}."""
    out = {}
    for i in range(1, len(dirs)):
        parent, this = dirs[i - 1], dirs[i]
        phase(f"phase 5 A/B: {this} (this) against {parent}")
        T = load_tree(this, f"chain_tree_{i}")
        T.mk.library()
        out[(parent, this)] = ab_parent(
            parent, f"chain_tree_{i - 1}", specs, dev, card, tree_ptxas(T),
            this=T, strict=False, rates=False)
    return out


def k1_phases(args, dev, card, ptxas):
    """Phase 5: the forward kernel's split over this tree and the trees of
    `--k1-split` (none: this tree alone). Returns k1_split's results."""
    trees, ptxas_of = [("this", THIS_TREE)], {"this": ptxas_counts(ptxas)}
    for i, d in enumerate(args.k1_split):
        T = load_tree(d, f"k1_tree_{i}")
        T.mk.library()
        trees.append((d, T))
        ptxas_of[d] = ptxas_counts(ptxas_lines(
            T.build._target("megakernel").with_suffix(".log").read_text()))
    return k1_split(trees, ptxas_of, dev, card)


def grad_curve(dev, card):
    """Phase 6 (the spp-per-launch curve): each row of GRAD_ROWS at W x H
    and GRAD_CURVE samples a launch (10 launches a timing, the sizes in
    turns, twice), with its time a sample and a 32-spp launch against
    eight 4-spp ones. Returns {row: {spp: median ms}}."""
    out = {}
    for row, spec in GRAD_ROWS.items():
        fns = {spp: tree_case(THIS_TREE, dict(spec, spp=spp), dev)
               for spp in GRAD_CURVE}
        runs = {spp: [] for spp in GRAD_CURVE}
        for spp in (GRAD_CURVE + GRAD_CURVE[::-1]) * 2:
            runs[spp].append(cuda_ms(fns[spp], 10))
        ms = {spp: float(np.median(r)) for spp, r in runs.items()}
        lo, hi = GRAD_CURVE[0], GRAD_CURVE[-1]
        phase(f"phase 6 curve: {row} {W}x{H}: " + ", ".join(
            f"{spp} spp {m:.4f} ms ({m * 1e6 / (W * H * spp):.4f} ns a "
            f"sample)" for spp, m in ms.items()) + f"; a {hi}-spp launch "
            f"{ms[hi] / (ms[lo] * hi / lo):.3f}x {hi // lo} {lo}-spp ones; "
            f"card {card}")
        out[row] = ms
    return out


def leaf_counts(dev, card):
    """Phase 4 (leaf sizes): on `gopher` and the size-check mesh, with and
    without NEE, one W x H x 8 segment on the driver's mesh layout packed at
    the port's leaf size and at the JAX package's (32 up to 8000
    triangles, else 16): the slots whose sums differ (another leaf size
    renumbers the slots, so the walk may pick another triangle at an
    exact-t tie). Returns {"scene[ --nee]": differing slots}."""
    out = {}
    for name in ("gopher", "size-check mesh"):
        for nee in (False, True):
            cfg = RenderConfig(width=W, height=H, samples=8,
                               samples_per_pass=8, nee=nee)
            sums = {}
            for leaf in (None, "jax"):
                sc = (size_check_scene(cfg, get_scene)
                      if name == "size-check mesh" else get_scene(name, cfg))
                env = {}
                if leaf == "jax":
                    env["PT_BVH_LEAF"] = str(32 if n_triangles(sc) <= 8000
                                             else 16)
                with env_vars(env):
                    tabs, meta, _, lay = port_inputs(sc, cfg, MESH_TILE,
                                                     dev)
                sums[leaf] = (meta.leaf_size, torch.stack(mk.trace_tiles(
                    (1, 0), *tabs, meta=meta, cfg=cfg, spp=8,
                    total_samples=8, tile=MESH_TILE, **lay)).cpu().numpy())
            (pl, a), (jl, b) = sums[None], sums["jax"]
            tag = f"{name}{' --nee' if nee else ''}"
            out[tag] = int((a != b).any(axis=0).sum())
            phase(f"phase 4 leaf: {tag} {W}x{H}x8 spp: the segment at leaf "
                  f"{jl} (the JAX package's rule) against leaf {pl}: "
                  f"{out[tag]} of {a[0].size} slots differ (image-mean rel "
                  f"diff {np.abs(a.mean((1, 2)) - b.mean((1, 2))).max() / b.mean():.2e}"
                  f"); card {card}")
    return out


def training_phase(dev, card, mesh_tris):
    """Phase 7, the main path of training, with every launch count set to 0
    just before: make_megakernel_step on `reference` and
    make_megakernel_step_tri on `teapot` at W x H (each loss must fall over
    5 steps, and the fwd+bwd rate is measured as bench.py measures it),
    then a short `train_demo --tri`. Returns (reference rate, teapot rate,
    object-mode launches, triangle-mode launches)."""
    tg.grad_tiles.launches = 0
    tg.grad_tiles.tri_launches = 0
    mk.trace_tiles.launches = 0
    mk.trace_tiles.mesh_launches = 0
    crn = (1, 0)
    # object colors on `reference`: two sphere colors perturbed
    rcfg = RenderConfig(width=W, height=H, samples=SPP)
    rsc = get_scene("reference", rcfg)
    rtabs, rmeta, rarr, rpid = grad_inputs(rsc, rcfg, GRAD_TILE, dev)
    step, target_of = make_megakernel_step(rarr, rmeta, rcfg, rsc.camera,
                                           spp=STEP_SPP, lr=3.0)
    target = target_of(crn_target(rtabs, rmeta, rcfg, rpid, crn, STEP_SPP))
    spheres = [j for j, code in enumerate(rmeta.obj_types) if code == 1
               and not rarr.emission[j].any()]
    c = rarr.color.clone()
    c[spheres[0], 0] += 0.3
    c[spheres[1], 2] -= 0.2
    e, losses = rarr.emission, []
    for _ in range(5):
        c, e, loss = step(c, e, crn, target)
        losses.append(float(loss))
    check_falls(f"phase 7: reference {W}x{H}, {STEP_SPP} spp a step, "
                f"sphere colors {spheres[:2]} perturbed", losses)
    # the rates: bench.py's steps (the default step size, a zero target)
    rate, dt = step_rate(*step_cases(THIS_TREE, dev, ["reference"])[
        "reference"])
    phase(f"phase 7: reference fwd+bwd {rate:.1f} Msamples/s ({W}x{H}x"
          f"{STEP_SPP} spp x 3 steps in {dt:.4f} s, bench.py's "
          f"measurement); card {card}")

    # triangle colors on `teapot`: every triangle's red lowered by 0.3
    tcfg = RenderConfig(width=W, height=H, samples=TRI_STEP_SPP,
                        samples_per_pass=TRI_STEP_SPP)
    tsc = get_scene("teapot", tcfg)
    ttabs, tmeta, tarr, tpid = grad_inputs(tsc, tcfg, GRAD_TILE, dev)
    tstep, ttarget_of = make_megakernel_step_tri(
        tarr, tmeta, tcfg, tsc.camera, n_passes=1, tile=GRAD_TILE, lr=1000.0,
        spp=TRI_STEP_SPP)
    ttarget = ttarget_of(crn_target(ttabs, tmeta, tcfg, tpid, crn,
                                    TRI_STEP_SPP))
    # the object colors stay at their true values: the triangles' step
    # size would throw the walls' colors off
    tri = tarr.tri_color.clone()
    tri[:, 0] -= 0.3
    losses = []
    for _ in range(5):
        _, _, tri, loss = tstep(tarr.color, tarr.emission, tri, crn, ttarget)
        losses.append(float(loss))
    check_falls(f"phase 7: teapot ({mesh_tris['teapot']} triangles) "
                f"{W}x{H}, {TRI_STEP_SPP} spp a step, triangle colors",
                losses)
    trate, tdt = step_rate(*step_cases(THIS_TREE, dev, [
        "teapot triangles"])["teapot triangles"])
    phase(f"phase 7: teapot triangle-mode fwd+bwd {trate:.1f} Msamples/s "
          f"({W}x{H}x{TRI_STEP_SPP} spp x 3 steps in {tdt:.4f} s); card "
          f"{card}")

    # the inverse-rendering demo, short
    with tempfile.TemporaryDirectory() as tmp:
        strip = os.path.join(tmp, "demo.png")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train_demo.main(["--tri", "--scene", "teapot", "--width",
                                  "160", "--height", "120", "--spp", "8",
                                  "--steps", "5", "--out", strip])
        out = buf.getvalue()
        m = re.search(r"loss ([0-9.]+) -> ([0-9.]+); tri-color MAD "
                      r"([0-9.]+) -> ([0-9.]+)", out)
        if rc != 0 or m is None or not os.path.getsize(strip):
            raise AssertionError(f"phase 7: train_demo --tri failed (rc "
                                 f"{rc}):\n{out[-2000:]}")
        phase(f"phase 7: train_demo --tri: {out.strip().splitlines()[-2]}")
        if not float(m.group(2)) < float(m.group(1)):
            raise AssertionError("phase 7: train_demo's loss did not fall")
    k6_obj = tg.grad_tiles.launches - tg.grad_tiles.tri_launches
    k6_tri = tg.grad_tiles.tri_launches
    phase(f"phase 7: {k6_obj} object-mode and {k6_tri} triangle-mode "
          f"gradient-kernel launches, {mk.trace_tiles.launches} forward "
          f"launches ({mk.trace_tiles.mesh_launches} of the mesh "
          "instantiation)")
    if not (k6_obj and k6_tri and mk.trace_tiles.mesh_launches
            and mk.trace_tiles.launches > mk.trace_tiles.mesh_launches):
        raise AssertionError("phase 7: training did not launch every "
                             "kernel of its path")

    return rate, trate, k6_obj, k6_tri


# the launch counters of the training path's kernels (phase 7 walks)
K6_COUNTS = ("launches", "tri_launches", "tex_launches", "packet_launches",
             "ablate_launches")
K1_COUNTS = ("launches", "mesh_launches", "texel_launches",
             "packet_launches", "ablate_launches")
# phase 7 walks: the knobs of each run; the runs with a texel step on the
# textured teapot, a triangle step on `teapot`, and with 5 of each
TRAIN_WALKS = {k: v for k, v in F32_WALKS.items() if v}
TRAIN_WALKS_TRI = ("packet mode 2", "ablated", "packet ablated")


def zero_counts():
    for c in K6_COUNTS:
        setattr(tg.grad_tiles, c, 0)
    for c in K1_COUNTS:
        setattr(mk.trace_tiles, c, 0)


def read_counts() -> dict:
    return {**{f"K6 {c}": getattr(tg.grad_tiles, c) for c in K6_COUNTS},
            **{f"K1 {c}": getattr(mk.trace_tiles, c) for c in K1_COUNTS}}


def walk_training(dev, card, mesh_tris):
    """Phase 7 (the walks), the main path of training under the JAX walk
    knobs, each run of TRAIN_WALKS with every launch count set to 0 just
    before it and read just after. PT_SUBPACKET=2: make_megakernel_step_tri
    on `teapot` at W x H x TRI_STEP_SPP (5 steps: the loss must fall),
    `train_demo --tri` at W x H x 8 spp (5 steps: the loss must fall) and
    the texel recovery on the textured teapot (texel_recovery, 5 steps:
    the loss must fall). PT_ABLATE_LEAF=1, alone and with PT_SUBPACKET=2:
    one triangle step at the same size, which leaves the triangle colors
    as they were, and whose Function's triangle gradient at the step's
    seed (of the sums themselves) is exactly zero; and one texel step.
    PT_SUBPACKET=3, with and without the ablation: one texel step (the
    forward on the warp walk, the gradient per thread). Fails unless each
    run launched the instantiations of its walk. Returns {run: counts}."""
    crn = (1, 0)
    tcfg = RenderConfig(width=W, height=H, samples=TRI_STEP_SPP,
                        samples_per_pass=TRI_STEP_SPP)
    tsc = get_scene("teapot", tcfg)
    ttabs, tmeta, tarr, tpid = grad_inputs(tsc, tcfg, GRAD_TILE, dev)
    xcfg = RenderConfig(width=W, height=H, samples=SPP)
    xsc = textured_teapot(get_scene("teapot", xcfg), proctex.make)
    out = {}
    for run, env in TRAIN_WALKS.items():
        with walk_env(env):
            zero_counts()
            tag = f"phase 7 walks: {run}"
            if run in TRAIN_WALKS_TRI:
                n = 5 if run == "packet mode 2" else 1
                tstep, ttarget_of = make_megakernel_step_tri(
                    tarr, tmeta, tcfg, tsc.camera, n_passes=1,
                    tile=GRAD_TILE, lr=1000.0, spp=TRI_STEP_SPP)
                ttarget = ttarget_of(crn_target(ttabs, tmeta, tcfg, tpid,
                                                crn, TRI_STEP_SPP))
                tri = tarr.tri_color.clone()
                tri[:, 0] -= 0.3
                tri0, losses = tri.clone(), []
                for _ in range(n):
                    _, _, tri, loss = tstep(tarr.color, tarr.emission, tri,
                                            crn, ttarget)
                    losses.append(float(loss))
                if n > 1:
                    check_falls(f"{tag}: teapot ({mesh_tris['teapot']} "
                                f"triangles) {W}x{H}, {TRI_STEP_SPP} spp a "
                                f"step, triangle colors", losses)
                else:
                    render = tg.make_diff_render_tri(
                        tmeta, tcfg, TRI_STEP_SPP, GRAD_TILE,
                        spp=TRI_STEP_SPP)
                    p = tri0.clone().requires_grad_(True)
                    rgb = render.apply(tarr.color, tarr.emission, p, crn,
                                       *ttabs)
                    (g,) = torch.autograd.grad(
                        sum(x.sum() for x in rgb), (p,))
                    zero = not g.any() and torch.equal(tri, tri0)
                    phase(f"{tag}: one triangle step at {W}x{H}x"
                          f"{TRI_STEP_SPP} spp, loss {losses[0]:.6g}; its "
                          f"triangle gradient exactly zero and the colors "
                          f"unchanged: {zero}")
                    if not (zero and np.isfinite(losses[0])):
                        raise AssertionError(f"{tag}: the triangle gradient "
                                             f"is not zero without leaf "
                                             f"tests")
            if run == "packet mode 2":
                with tempfile.TemporaryDirectory() as tmp:
                    strip = os.path.join(tmp, "demo.png")
                    buf = io.StringIO()
                    with contextlib.redirect_stdout(buf):
                        rc = train_demo.main([
                            "--tri", "--scene", "teapot", "--width", str(W),
                            "--height", str(H), "--spp", "8", "--steps",
                            "5", "--out", strip])
                    text = buf.getvalue()
                    m = re.search(r"loss ([0-9.]+) -> ([0-9.]+); tri-color "
                                  r"MAD ([0-9.]+) -> ([0-9.]+)", text)
                    if rc != 0 or m is None or not os.path.getsize(strip):
                        raise AssertionError(f"{tag}: train_demo --tri "
                                             f"failed (rc {rc}):\n"
                                             f"{text[-2000:]}")
                    phase(f"{tag}: train_demo --tri {W}x{H}x8 spp: "
                          f"{text.strip().splitlines()[-2]}")
                    if not float(m.group(2)) < float(m.group(1)):
                        raise AssertionError(f"{tag}: train_demo --tri's "
                                             f"loss did not fall")
            n = 5 if run == "packet mode 2" else 1
            losses, mad0, mad1, n_train = texel_recovery(xsc, xcfg, dev, n)
            if n > 1:
                check_falls(f"{tag}: textured teapot {W}x{H}, {STEP_SPP} "
                            f"spp a step, {n_train} texels x 3 perturbed "
                            f"(texel MAD {mad0:.5f} -> {mad1:.5f})", losses)
            elif not np.isfinite(losses).all():
                raise AssertionError(f"{tag}: the texel step's loss is not "
                                     f"finite")
            counts = read_counts()
            gw, fw = mk.grad_walk(), mk.mesh_walk()
        need = {"K6 tex_launches": 1, "K1 texel_launches": 1,
                "K6 packet_launches": gw.walk != "thread",
                "K6 ablate_launches": gw.leaf == "none",
                "K1 packet_launches": fw.walk != "thread",
                "K1 ablate_launches": fw.leaf == "none",
                "K6 tri_launches": run in TRAIN_WALKS_TRI}
        phase(f"{tag}: launches {counts}; the gradient walk {tuple(gw)}, "
              f"the forward's {tuple(fw)}")
        missing = [k for k, v in need.items() if v and not counts[k]]
        if missing:
            raise AssertionError(f"{tag}: the run launched none of {missing}")
        out[run] = counts
    return out


def tex_forward(dev, card):
    """Phase 8 (f32 texels): `textures-train` at W x H x 8 spp on its own
    tile through the f32-texel instantiation fetching the decoded pool,
    bit-equal to rgb8 K1-tex and to the plain version; both kernels timed
    in one call, the f32 one with its bound. Returns the numbers."""
    cfg = RenderConfig(width=W, height=H, samples=8, samples_per_pass=8)
    sc = get_scene(TEX_TRAIN, cfg)
    tabs, meta, _, lay = port_inputs(sc, cfg, None, dev)
    arrays, _ = sc.pack(device=dev)
    kw = dict(meta=meta, cfg=cfg, spp=8, total_samples=8,
              tile=mk.default_tile(meta), **lay)
    fkw = {k: v for k, v in kw.items() if k != "tex_pool"}
    fkw["tex_texels"] = texel_params(arrays)
    rgb8 = torch.stack(mk.trace_tiles((1, 0), *tabs, **kw))
    f32 = torch.stack(mk.trace_tiles((1, 0), *tabs, **fkw))
    counts = {}
    p, p_ms = timed(lambda: mk.trace_tiles_reference((1, 0), *tabs, **fkw,
                                                     counts=counts))
    if not (torch.equal(f32, rgb8) and torch.equal(f32, p)):
        raise AssertionError("phase 8: the f32-texel forward differs from "
                             "rgb8 K1-tex or from its plain version")
    f_ms = cuda_ms(lambda: mk.trace_tiles((1, 0), *tabs, **fkw), 10)
    r_ms = cuda_ms(lambda: mk.trace_tiles((1, 0), *tabs, **kw), 10)
    b_ms, b_by, ops = fwd_bound(counts, tabs, fkw)
    j_ms, j_by, j_ops = fwd_bound(counts, tabs, fkw, jax=True)
    phase(f"phase 8: {TEX_TRAIN} {W}x{H}x8 spp (tile {kw['tile']}, "
          f"{fkw['tex_texels'].shape[0]} texels, {counts['texel_fetches']} "
          f"fetches): f32-texel kernel {f_ms:.4f} ms, rgb8 K1-tex {r_ms:.4f} "
          f"ms ({(f_ms - r_ms) / r_ms:+.2%}), bit-equal to each other and to "
          f"the plain version ({p_ms:.1f} ms); bound {b_ms:.4f} ms ({b_by}; "
          f"{ops:.4g} f32 ops: the kernel's own work), the JAX kernel's "
          f"work {j_ms:.4f} ms ({j_by}; {j_ops:.4g} f32 ops); card {card}")
    return dict(ms=f_ms, rgb8_ms=r_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, jax_work_bound_ms=j_ms,
                err=float((f32 - p).abs().max()))


def texel_recovery(sc, cfg, dev, steps):
    """The staged textures' texels of scene `sc` perturbed by U(-0.3, 0.3)
    and recovered toward a common-random-number target through
    make_diff_render_tex at W x H (STEP_SPP a step, Adam at TEX_LR, clipped
    to [0, 1]) for `steps` steps. Returns (losses, texel MAD before, after,
    trainable texels)."""
    tabs, meta, arrays, pid = grad_inputs(sc, cfg, GRAD_TILE, dev)
    table = torch.from_numpy(mk.build_tex_table(arrays, meta)).to(dev)
    render = tg.make_diff_render_tex(meta, cfg, STEP_SPP, cfg.samples,
                                     GRAD_TILE)
    tex_true = texel_params(arrays)
    train = trainable_texels(arrays, meta)
    rng = np.random.default_rng(7)
    tex0 = tex_true.clone()
    tex0[train] = torch.clamp(tex0[train] + torch.from_numpy(rng.uniform(
        -0.3, 0.3, (int(train.sum()), 3)).astype(np.float32)).to(dev),
        0.0, 1.0)
    crn = (1, 0)
    valid = torch.from_numpy((pid >= 0).reshape(tabs[-2].shape)
                             .astype(np.float32)).to(dev)
    n_valid = float((pid >= 0).sum())

    def forward(t):
        return render.apply(arrays.color, arrays.emission, t, crn, *tabs,
                            table)

    with torch.no_grad():
        target = forward(tex_true)
    tex = tex0.clone().requires_grad_(True)
    opt = torch.optim.Adam([tex], lr=TEX_LR)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = sum(torch.sum(((x - t) * valid) ** 2) for x, t in
                   zip(forward(tex), target)) / (3.0 * n_valid * STEP_SPP ** 2)
        loss.backward()
        opt.step()
        with torch.no_grad():
            tex.clamp_(0.0, 1.0)
        losses.append(float(loss.detach()))
    mad0 = float((tex0[train] - tex_true[train]).abs().mean())
    mad1 = float((tex.detach()[train] - tex_true[train]).abs().mean())
    return losses, mad0, mad1, int(train.sum())


def tex_training(dev, card):
    """Phase 8, the main path of texel training, with its launch counts set
    to 0 just before: `textures-train` at W x H, the staged textures'
    texels perturbed by U(-0.3, 0.3) and recovered toward a
    common-random-number target through make_diff_render_tex (STEP_SPP a
    step, Adam, clipped to [0, 1]; the loss must fall over 5 steps); the
    fwd+bwd rate of make_megakernel_step_tex as bench.py measures
    `fwd_bwd_textures-train`; a short `train_demo --tex`. Returns the
    numbers."""
    tg.grad_tiles.launches = 0
    tg.grad_tiles.tex_launches = 0
    mk.trace_tiles.launches = 0
    mk.trace_tiles.texel_launches = 0
    cfg = RenderConfig(width=W, height=H, samples=SPP)
    losses, mad0, mad1, n_train = texel_recovery(get_scene(TEX_TRAIN, cfg),
                                                 cfg, dev, 5)
    check_falls(f"phase 8: {TEX_TRAIN} {W}x{H}, {STEP_SPP} spp a step, "
                f"{n_train} texels x 3 perturbed (texel MAD {mad0:.5f}"
                f" -> {mad1:.5f})", losses)
    rate, dt = step_rate(*step_cases(THIS_TREE, dev, [TEX_TRAIN])[TEX_TRAIN])
    phase(f"phase 8: {TEX_TRAIN} fwd+bwd {rate:.1f} Msamples/s ({W}x{H}x"
          f"{STEP_SPP} spp x 3 steps in {dt:.4f} s, bench.py's "
          f"fwd_bwd_{TEX_TRAIN} measurement); card {card}")
    with tempfile.TemporaryDirectory() as tmp:
        strip = os.path.join(tmp, "demo.png")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train_demo.main(["--tex", "--width", "160", "--height",
                                  "120", "--spp", "8", "--steps", "5",
                                  "--out", strip])
        out = buf.getvalue()
        m = re.search(r"loss ([0-9.]+) -> ([0-9.]+); texel MAD "
                      r"([0-9.]+) -> ([0-9.]+)", out)
        if rc != 0 or m is None or not os.path.getsize(strip):
            raise AssertionError(f"phase 8: train_demo --tex failed (rc "
                                 f"{rc}):\n{out[-2000:]}")
        phase(f"phase 8: train_demo --tex: {out.strip().splitlines()[-2]}")
        if not float(m.group(2)) < float(m.group(1)):
            raise AssertionError("phase 8: train_demo --tex's loss did not "
                                 "fall")
    launches = dict(grad=tg.grad_tiles.launches,
                    tex=tg.grad_tiles.tex_launches,
                    fwd=mk.trace_tiles.launches,
                    texel=mk.trace_tiles.texel_launches)
    phase(f"phase 8: {launches['tex']} texel-mode gradient-kernel launches "
          f"(of {launches['grad']}), {launches['texel']} f32-texel forward "
          f"launches (of {launches['fwd']})")
    if not (launches["tex"] == launches["grad"] > 0
            and launches["texel"] == launches["fwd"] > 0):
        raise AssertionError("phase 8: texel training did not launch the "
                             "kernels of its path")
    return dict(rate=rate, losses=losses, mad=(mad0, mad1), **launches)


def main_size(grads, i):
    """Row i of grad_phase's results at STEP_SPP samples a launch, for the
    kernels line."""
    g = grads[STEP_SPP][i]
    return dict(spp=STEP_SPP, ms=g["ms"], plain_ms=g["plain_ms"],
                bound_ms=g["bound_ms"], bound_by=g["bound_by"],
                max_abs_err=g["max_abs_err"], gcol_rel_err=g["gcol"],
                gemi_rel_err=g["gemi"])


def grad_phases(args, dev, card, mesh_tris, ptxas):
    """Phase 6: the split of `--grad-split`'s trees (none: this tree
    alone), the spp-per-launch curve, the gradient kernel against its
    plain version at both launch sizes, on the per-thread walk and on the
    walks of the JAX knobs (grad_walk_phase), and the megakernel step's
    row-shared draws against the wavefront (row_shared_check). Returns
    (grad_phase's results, the curve, the split, grad_walk_phase's
    results, row_shared_check's)."""
    trees, ptxas_of = [("this", THIS_TREE)], {"this": ptxas_counts(ptxas)}
    for i, d in enumerate(args.grad_split):
        T = load_tree(d, f"grad_tree_{i}")
        T.mk.library()
        trees.append((d, T))
        ptxas_of[d] = ptxas_counts(ptxas_lines(
            T.build._target("megakernel").with_suffix(".log").read_text()))
    split = grad_split(trees, ptxas_of, dev, card)
    curve = grad_curve(dev, card)
    grads = grad_phase(dev, card, mesh_tris)
    walks = grad_walk_phase(dev, card, mesh_tris, grads, ptxas)
    return grads, curve, split, walks, row_shared_check(dev, card)


def check_forward_ptxas(parent: str, family: dict) -> None:
    """Raise if a forward instantiation of the K1 family that the tree
    `parent` has (ab_parent's {name: (parent counts, this build's)}) moved
    its ptxas counts in this build."""
    moved = {k: v for k, v in family.items()
             if not k.startswith("grad") and v[0] != v[1]}
    if moved:
        raise AssertionError(f"phase 5 A/B: the forward instantiations of "
                             f"{parent} moved their ptxas counts: {moved}")


def grad_only(args, dev, card, ptxas):
    """--grad-only: phase 6 (grad_phases), the walks of phases 7 and 8
    (walk_training, tex_forward_walks) and the A/B of --ab-parent, whose
    forward instantiations must keep their ptxas counts."""
    small = RenderConfig(width=160, height=120, samples=8)
    mesh_tris = {"teapot": n_triangles(get_scene("teapot", small)),
                 "size-check mesh": n_triangles(size_check_scene(
                     small, get_scene))}
    grad_phases(args, dev, card, mesh_tris, ptxas)
    walk_training(dev, card, mesh_tris)
    tex_forward_walks(dev, card)
    for i, d in enumerate(args.ab_parent):
        phase(f"phase 5 A/B: against {d}")
        check_forward_ptxas(d, ab_parent(d, f"ab_tree_{i}", AB_CASES, dev,
                                         card, ptxas)[1])
    phase("grad-only: done")


def walk_only(args, dev, card, ptxas):
    """--walk-only: the packet walks' phases: phase 3's walks (Kernel A bit
    for bit, Kernel B by the per-slot rule and its leaf check), phase 4's
    main paths under the walks (after the default `teapot` render their
    image means are held to), phase 5's walk timings, the split
    (walk_phases), phase 9's K5 walks and phase 10 (P3); then the A/B of
    --ab-parent and of --ab-chain on WALK_AB_CASES, without the fwd+bwd
    rates. Prints no result lines."""
    small = RenderConfig(width=160, height=120, samples=8,
                         samples_per_pass=8)
    walk_compare(dev, small, small.replace(nee=True))
    mesh_tris = {"teapot": n_triangles(get_scene("teapot", small))}
    with tempfile.TemporaryDirectory() as tmp:
        tea = teapot_main_path(tmp, dev, card, mesh_tris)
        for tag, env in MAIN_WALKS:
            variant_main_path(tmp, dev, card, tag, env, tea)
    walk_times = walk_timing(dev, card)
    walk_phases(args, dev, card, ptxas)
    intersect_walks(dev, card)
    leaf_phase(dev, card, walk_times["teapot"])
    differ = []
    for i, d in enumerate(args.ab_parent):
        phase(f"phase 5 A/B: against {d}")
        differ += ab_parent(d, f"ab_tree_{i}", WALK_AB_CASES, dev, card,
                            ptxas, strict=False, rates=False)[4]
    for chain in args.ab_chain:
        for r in ab_chain(chain.split(","), WALK_AB_CASES, dev,
                          card).values():
            differ += r[4]
    phase(f"walk-only: done; A/B cases whose outputs differ: {differ}")


def k1_only(args, dev, card, ptxas):
    """--k1-only: the object loop's filter check (filter_phase), the
    forward kernel's split (k1_phases) and the A/B of --ab-parent, the
    forward instantiations' ptxas counts beside each tree's."""
    filter_phase(dev, card)
    k1_phases(args, dev, card, ptxas)
    for i, d in enumerate(args.ab_parent):
        phase(f"phase 5 A/B: against {d}")
        ab_parent(d, f"ab_tree_{i}", AB_CASES, dev, card, ptxas)
    phase("k1-only: done")


# ---- phase 11: the wavefront forward (render/integrator.py) on K5 ----------

WF_SPP = 16                  # 2 passes of 8 spp: 9,830,400 rays a bounce
WF_SCENES = ("reference", "teapot")
WF_MK_LAUNCHES = 32          # 8-spp megakernel launches the mean rule takes
WF_SIGMAS = 4.0              # the mean rule: within 4 standard errors
WF_F64 = (320, 240, 8)       # the f64 render (torch walk, no kernel)
BENCH_TIMEOUT_S = 420


class _BounceCount:
    """Counts integrator.bounce_step's calls while installed."""

    def __init__(self):
        self.n = 0

    def __enter__(self):
        self.orig = integrator.bounce_step

        def counted(*a, **kw):
            self.n += 1
            return self.orig(*a, **kw)
        integrator.bounce_step = counted
        return self

    def __exit__(self, *exc):
        integrator.bounce_step = self.orig
        return False


def megakernel_mean(scene: str, nee: bool, dev):
    """The channel means of WF_MK_LAUNCHES 8-spp megakernel launches of
    `scene` at W x H on the driver's layout, each its own seed: (mean of
    the means, their standard error)."""
    cfg = RenderConfig(width=W, height=H, samples=8, samples_per_pass=8,
                       nee=nee)
    sc = get_scene(scene, cfg)
    arrays, meta = sc.pack(device=dev)
    run = mk.image_launch(arrays, meta, sc.camera, 8, dev)
    means = []
    for s in range(WF_MK_LAUNCHES):
        rgb = mk.trace_tiles((1000 + s, 0), *run.tables, meta=meta, cfg=cfg,
                             spp=8, total_samples=8, **run.kwargs)
        flat = torch.stack(rgb, -1).reshape(-1, 3).cpu().numpy() / 8.0
        means.append(mk.untile_image(flat, run.pid, W, H).reshape(-1, 3)
                     .mean(0))
    means = np.asarray(means, np.float64)
    return means.mean(0), means.std(0, ddof=1) / np.sqrt(len(means))


def wavefront_se(img, scene: str, nee: bool, dev):
    """The standard error of `img`'s channel means (a W x H x WF_SPP
    wavefront image) from its Monte-Carlo noise alone: a second image of
    the same configuration under another seed has the same expectation
    pixel by pixel, so half the mean square of the two images' difference
    is the mean per-pixel variance, free of the image's structure (walls,
    light, shadows); the pixels' noise is independent (a ray's draws come
    from its own threefry counters)."""
    cfg = RenderConfig(width=W, height=H, samples=WF_SPP,
                       samples_per_pass=8, nee=nee)
    cfg = cfg.replace(seed=cfg.seed + 1)
    sc = get_scene(scene, cfg)
    arrays, meta = sc.pack(device=dev)
    other = integrator.render(arrays, meta, sc.camera, cfg)
    d = (img.astype(np.float64) - other).reshape(-1, 3)
    return np.sqrt((d * d).mean(0) / 2 / d.shape[0])


def wavefront_main_path(tmp, dev, card, scene: str, nee: bool):
    """`scene` at W x H x WF_SPP through cli.main --backend wavefront (f32),
    with every launch count set to 0 just before: every bounce and shadow
    ray must have launched K5 (bounces x (1 + lights with --nee)) and no
    megakernel. The image is held to the megakernel's mean by the rule
    stated in PERF.md: WF_SIGMAS standard errors a channel, the
    megakernel's from the spread of WF_MK_LAUNCHES launches' means, the
    wavefront's from its noise alone (wavefront_se). Returns the
    numbers."""
    tag = f"phase 11: {scene}{' --nee' if nee else ''} --backend wavefront"
    raw = os.path.join(tmp, f"wf-{scene}.raw")
    metrics = os.path.join(tmp, f"wf-{scene}.json")
    mk.intersect_batch.launches = 0
    mk.trace_tiles.launches = 0
    with _BounceCount() as bc:
        rc = cli.main([
            "--scene", scene, "--backend", "wavefront", "--width", str(W),
            "--height", str(H), "--samples", str(WF_SPP),
            "--samples-per-pass", "8", "--raw-output", raw,
            "--output", os.path.join(tmp, f"wf-{scene}.png"),
            "--metrics-json", metrics] + ["--nee"] * nee)
    launches, bounces = mk.intersect_batch.launches, bc.n
    if rc != 0:
        raise AssertionError(f"{tag}: cli.main returned {rc}")
    with open(metrics) as f:
        m = json.load(f)
    img = read_raw(raw)
    if img.shape != (H, W, 3) or not np.isfinite(img).all():
        raise AssertionError(f"{tag}: image is not finite [H, W, 3]")
    if scene == "reference":
        # at WF_SPP one pixel is noisy: the walls' strips, averaged
        rows = slice(H // 2 - H // 8, H // 2 + H // 8)
        left = img[rows, 1:W // 16].reshape(-1, 3).mean(0)
        right = img[rows, W - W // 16:W - 1].reshape(-1, 3).mean(0)
        if not (left[0] > left[2] and right[2] > right[0]):
            raise AssertionError(f"{tag}: Cornell walls wrong: {left} "
                                 f"{right}")
    lights = len(get_scene(scene, RenderConfig()).pack(
        device=torch.device("cpu"))[1].light_indices) if nee else 0
    want = bounces * (1 + lights)
    if launches != want or mk.trace_tiles.launches or not bounces:
        raise AssertionError(
            f"{tag}: {launches} intersect launches for {bounces} bounces "
            f"({want} expected), {mk.trace_tiles.launches} megakernel "
            "launches")
    mk_mean, mk_se = megakernel_mean(scene, nee, dev)
    wf_mean = img.reshape(-1, 3).astype(np.float64).mean(0)
    wf_se = wavefront_se(img, scene, nee, dev)
    z = (wf_mean - mk_mean) / np.sqrt(wf_se ** 2 + mk_se ** 2)
    phase(f"{tag} {W}x{H}x{WF_SPP}: {m['wall_s']} s in the driver, "
          f"{m['total_wall_s']} s in all ({m['msamples_per_sec']} "
          f"Msamples/s); {bounces} bounces in {WF_SPP // 8} passes, "
          f"{launches} intersect launches ({launches / (WF_SPP // 8):.1f} a "
          f"pass), 0 megakernel launches; image mean {wf_mean} vs the "
          f"megakernel's {mk_mean} ({WF_MK_LAUNCHES} x 8 spp), standard "
          f"errors {wf_se} / {mk_se}: z {np.round(z, 3)}; card {card}")
    if not (np.abs(z) <= WF_SIGMAS).all():
        raise AssertionError(f"{tag}: image mean off the megakernel's by "
                             f"more than {WF_SIGMAS} standard errors")
    return dict(launches=launches, bounces=bounces, wall_s=m["wall_s"],
                total_wall_s=m["total_wall_s"],
                msamples_per_sec=m["msamples_per_sec"],
                z=[float(x) for x in z], mean=[float(x) for x in wf_mean],
                se=[float(x) for x in wf_se], mk_se=[float(x) for x in mk_se],
                mk_mean=[float(x) for x in mk_mean])


def delivered_bytes(*tensors) -> int:
    """The bytes a function must deliver in `tensors`: a stride-0 view
    (a constant output) counts as one element."""
    return sum(t.element_size() * (1 if 0 in t.stride() else t.numel())
               for t in tensors)


def k5_bound(meta, cfg, counts, got, o, d, tables):
    """(bound ms, "operations" or "bytes", ops) of one intersect launch
    whose work the plain version counted in `counts` (phase 9's rule),
    the kernel's outputs `got` counted as delivered_bytes (without groups
    the triangle outputs are constants, stride 0: the bytes the function
    must deliver, 56 a ray there against 85)."""
    R = counts["rays"]
    misses = int((got[0] == cfg.t_max).sum())
    ops = (R * (sum(OPS_OBJECT_NARROW[t] for t in meta.obj_types)
                + OPS_ISECT_RAY) + OPS_WINNER * (R - misses)
           + OPS_NODE * counts["node_visits"]
           + OPS_LEAF_SLOT * counts["leaf_slots"]
           + OPS_ISECT_TRI * counts["tri_hits"])
    return bound_of(ops, nbytes(*o, *d, *tables) + delivered_bytes(*got))


def k5_prebuilt(T, meta, cfg, o, d, tables):
    """A function that launches tree T's intersect kernel once on the rays
    (o, d): its C entry alone, with the arguments and outputs built once
    (nothing counted). A tree before the prepared launcher (ee563d0's: out
    f32 [14, n], the winners and slots apart) gets its entry's arguments
    built here, on the per-thread walk."""
    rays = (*o, *d)
    if hasattr(T.mk, "intersect_launch_args"):
        bufs = T.mk.intersect_outputs(rays[0].numel(), tables)
        fn, args = T.mk.intersect_launch_args(
            tables, rays, bufs, cfg.epsilon, cfg.t_max, T.mk.scene_walk(meta))
    else:
        n, dev = rays[0].numel(), rays[0].device
        bufs = (torch.empty((14, n), dtype=torch.float32, device=dev),
                torch.empty((2, n), dtype=torch.int32, device=dev))
        n_obj = len(meta.obj_types)
        ints = T.mk._I * n_obj
        roots, ends = ints(*([-1] * n_obj)), ints(*([-1] * n_obj))
        for g, r, e in meta.group_bvh:
            roots[g], ends[g] = r, e
        fn = T.mk.library().pt_intersect_launch
        args = (*(t.data_ptr() for t in rays), bufs[0].data_ptr(),
                bufs[1].data_ptr(), bufs[1][1].data_ptr(), n,
                tables[0].data_ptr(), ints(*meta.obj_types),
                *(t.data_ptr() for t in tables[1:]), roots, ends, n_obj,
                meta.leaf_size, meta.n_nodes if meta.octant_orders else 0,
                cfg.epsilon, cfg.t_max,
                torch.cuda.current_stream(dev).cuda_stream)

    def launch():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"intersect launch failed: CUDA error {err}")
    launch.bufs = bufs       # kept alive with the launch
    return launch


def k5_times(T, arrays, meta, cfg, o, d, tables, reps: int = K5_REPS):
    """K5's three times on tree T and the rays (o, d), in ms a call: the
    wrapper's call (CUDA events around `reps` back-to-back
    intersect_batch calls, as phases 9, 11 and 12 timed it before), the
    kernel alone (CUDA events around `reps` back-to-back launches of the C
    entry with its arguments built once, k5_prebuilt) and the launcher's
    host time (a host clock over `reps` calls, no sync inside the loop)."""
    def call():
        return T.mk.intersect_batch(arrays, meta, cfg, o, d, tables=tables)

    out = {"call_ms": cuda_ms(call, reps),
           "kernel_ms": cuda_ms(k5_prebuilt(T, meta, cfg, o, d, tables),
                                reps)}
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    out["host_ms"] = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return out


def k5_text(k) -> str:
    """K5's times of k5_times, for a phase line."""
    return (f"kernel alone {k['kernel_ms']:.4f} ms, call "
            f"{k['call_ms']:.4f} ms, launcher host {k['host_ms']:.4f} ms")


def k5_on_bounces(dev, card, scene: str):
    """One W x H x 8 pass of `scene` whose every bounce holds K5 bit for bit
    against intersect_batch_reference on the wavefront's own rays, and the
    pass again through the plain version alone: the two images must be
    bit-equal. K5 is then timed on the rays of bounce 1 (the wavefront's
    batch: every ray, live or not; k5_times), with its bound. Returns the
    numbers."""
    cfg = RenderConfig(width=W, height=H, samples=8, samples_per_pass=8)
    sc = get_scene(scene, cfg)
    arrays, meta = sc.pack(device=dev)
    tables = mk.intersect_tables(arrays, meta, dev)
    seen = []

    def checked(scn, meta_, cfg_, o, d, tables=None):
        got = mk.intersect_batch(scn, meta_, cfg_, o, d, tables=tables)
        want = mk.intersect_batch_reference(scn, meta_, cfg_, o, d, tables)
        bad = [i for i, (a, b) in enumerate(zip(flat_outputs(got),
                                                flat_outputs(want)))
               if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"phase 11: {scene} bounce {len(seen)}: "
                                 f"K5 differs from its plain version in "
                                 f"outputs {bad}")
        seen.append((o, d))
        return got

    px, py = integrator.pixel_grid(W, 0, H, dev)
    cam = sc.camera.pack(torch.float32, dev)
    key = threefry.fold_in(threefry.prng_key(cfg.seed), 0)

    def one_pass(fn):
        return torch.stack(integrator.render_pass(
            arrays, meta, cfg, cam, px, py, 0, 8, key,
            integrator.IntersectRoute(fn, tables)))

    k5_img = one_pass(checked)
    plain_img = one_pass(mk.intersect_batch_reference)
    torch.cuda.synchronize()
    if not torch.equal(k5_img, plain_img):
        raise AssertionError(f"phase 11: {scene}: the pass through K5 "
                             "differs from the pass through the plain "
                             "intersect")
    o, d = seen[1] if len(seen) > 1 else seen[0]
    counts = {}
    _, p_ms = timed(lambda: mk.intersect_batch_reference(
        arrays, meta, cfg, o, d, tables, counts), stack=False)
    k = k5_times(THIS_TREE, arrays, meta, cfg, o, d, tables)
    b_ms, b_by, ops = k5_bound(meta, cfg, counts, flat_outputs(
        mk.intersect_batch(arrays, meta, cfg, o, d, tables=tables)), o, d,
        tables)
    phase(f"phase 11: {scene} K5 on the wavefront's rays, {len(seen)} "
          f"bounces of one {W}x{H}x8 pass ({o[0].numel()} rays each): "
          f"bit-equal to the plain version at every bounce, the pass's "
          f"image bit-equal to the plain intersect's; bounce 1: "
          f"{k5_text(k)}, plain {p_ms:.1f} ms, bound {b_ms:.4f} ms "
          f"({b_by}; {ops:.4g} f32 ops); card {card}")
    return dict(bounces=len(seen), rays=o[0].numel(), ms=k["call_ms"],
                kernel_ms=k["kernel_ms"], host_ms=k["host_ms"],
                plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)


def wavefront_f64(tmp, card):
    """`reference` at WF_F64 through cli.main --dtype float64 (the torch
    walk in f64 on the card: the JAX package has no f64 kernel either)."""
    w, h, spp = WF_F64
    raw = os.path.join(tmp, "wf64.raw")
    metrics = os.path.join(tmp, "wf64.json")
    mk.intersect_batch.launches = 0
    rc = cli.main(["--scene", "reference", "--dtype", "float64", "--width",
                   str(w), "--height", str(h), "--samples", str(spp),
                   "--raw-output", raw, "--output",
                   os.path.join(tmp, "wf64.png"), "--metrics-json", metrics])
    if rc != 0:
        raise AssertionError(f"phase 11 f64: cli.main returned {rc}")
    img = read_raw(raw)
    with open(metrics) as f:
        m = json.load(f)
    if (img.shape != (h, w, 3) or not np.isfinite(img).all()
            or m["backend"] != "wavefront" or mk.intersect_batch.launches):
        raise AssertionError("phase 11 f64: not a finite wavefront image "
                             "without kernel launches")
    phase(f"phase 11 f64: reference --dtype float64 {w}x{h}x{spp}: "
          f"{m['wall_s']} s in the driver, {m['total_wall_s']} s in all "
          f"({m['msamples_per_sec']} Msamples/s), image mean "
          f"{img.reshape(-1, 3).mean(0)}; card {card}")
    return dict(wall_s=m["wall_s"], total_wall_s=m["total_wall_s"],
                shape=f"{w}x{h}x{spp}")


def bench_phase(card):
    """python -m pathtracer_tpu_torch.bench in a process of its own (the
    kernel library is already built); its JSON line is printed."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "pathtracer_tpu_torch.bench"],
                         capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT_S,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    line = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    phase(f"phase 11 bench: {line}")
    if out.returncode != 0:
        raise AssertionError(f"phase 11: the bench exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    rec = json.loads(line)
    phase(f"phase 11 bench: {time.perf_counter() - t0:.1f} s; card {card}")
    return rec


def trace_split(path: str) -> dict:
    """The device time of a --profile trace of the driver's segment loop:
    its window (first to last event), the share of it some kernel ran
    (the rest idle), each a segment ("pt.segment" spans), and the shares
    of kernel time that the render's own kernel (the megakernel or K5)
    and the driver's stack-and-add ("pt.accumulate" spans, a kernel
    attributed by the time its launch call ran) took."""
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in ev if e.get("cat") == "kernel"]
    segments = sum(1 for e in ev if e.get("cat") == "user_annotation"
                   and e.get("name") == "pt.segment")
    if not kernels:
        return {"kernel_share": None, "note": "no device events in the trace"}
    launch_ts = {e["args"].get("correlation"): e["ts"] for e in ev
                 if e.get("cat") == "cuda_runtime"}
    acc = [(e["ts"], e["ts"] + e["dur"]) for e in ev
           if e.get("cat") == "user_annotation"
           and e.get("name") == "pt.accumulate"]
    t0 = min(e["ts"] for e in ev)
    t1 = max(e["ts"] + e["dur"] for e in ev)
    busy, end = 0.0, t0
    for e in sorted(kernels, key=lambda e: e["ts"]):
        s, f = max(e["ts"], end), e["ts"] + e["dur"]
        if f > s:
            busy += f - s
            end = f
    total = sum(e["dur"] for e in kernels)

    def share(pred):
        return sum(e["dur"] for e in kernels if pred(e)) / total

    return {"segments": segments, "window_ms": (t1 - t0) / 1e3,
            "window_ms_a_segment": (t1 - t0) / 1e3 / max(segments, 1),
            "kernel_ms": total / 1e3, "kernels": len(kernels),
            "kernel_share": busy / (t1 - t0),
            "idle_share": 1 - busy / (t1 - t0),
            "megakernel_share_of_kernel_time": share(
                lambda e: "megakernel<" in e["name"]),
            "k5_share_of_kernel_time": share(
                lambda e: "intersect<" in e["name"]),
            "stack_add_share_of_kernel_time": share(lambda e: any(
                a <= launch_ts.get(e["args"].get("correlation"), -1) <= b
                for a, b in acc))}


PROFILED = (("megakernel", [], SPP), ("wavefront", ["--backend", "wavefront"],
                                      8))


def profile_phase(tmp, card):
    """`teapot` at W x H through cli.main --profile on each backend (the
    megakernel's main path, 2048 spp in 256 segments; the wavefront's one
    8-spp segment), and the split of each trace (trace_split)."""
    out = {}
    for tag, flags, spp in PROFILED:
        prof = os.path.join(tmp, f"profile-{tag}")
        rc = cli.main(["--scene", "teapot", "--width", str(W), "--height",
                       str(H), "--samples", str(spp), "--raw-output",
                       os.path.join(tmp, "prof.raw"), "--output",
                       os.path.join(tmp, "prof.png"), "--profile", prof]
                      + flags)
        path = os.path.join(prof, "trace.json")
        if rc != 0 or not os.path.exists(path):
            raise AssertionError(f"phase 11 profile: {tag}: cli.main "
                                 "--profile wrote no trace")
        out[tag] = trace_split(path)
        phase(f"phase 11 profile: teapot {W}x{H}x{spp} on the {tag}: "
              f"{json.dumps(out[tag])}; card {card}")
    return out


def wavefront_phases(dev, card, ptxas):
    """Phase 11: the wavefront main paths (reference and teapot, with and
    without --nee, through the CLI), K5 on the wavefront's bounced rays,
    the f64 render, the port's bench and the profiled split. Returns the
    numbers for the intersect row."""
    with tempfile.TemporaryDirectory() as tmp:
        main = {f"{s}{' --nee' if nee else ''}":
                wavefront_main_path(tmp, dev, card, s, nee)
                for s in WF_SCENES for nee in (False, True)}
        bounces = {s: k5_on_bounces(dev, card, s) for s in WF_SCENES}
        f64 = wavefront_f64(tmp, card)
        split = profile_phase(tmp, card)
    bench = bench_phase(card)
    k5_ptxas = {k: list(v) for k, v in ptxas_counts(ptxas).items()
                if k.startswith("intersect")}
    phase(f"phase 11: ptxas (registers, stack, spill stores, spill loads) "
          f"of the intersect instantiations: {k5_ptxas}")
    return dict(main=main, bounces=bounces, f64=f64, split=split,
                bench=bench, ptxas=k5_ptxas,
                launches=sum(v["launches"] for v in main.values()))


# ---- phase 12: the wavefront autograd path (diff.grad) on K5 ---------------

AD_SCENES = ("reference", "teapot", "textures")
AD_SPP = 1                   # bench.py's bench_diff_wavefront: 1 spp a step
AD_TIMED = 3                 # timed steps after a warm-up
AD_FALL = 5                  # steps over which the loss must fall
AD_LR = 0.02                 # Adam's step there
AD_CHECKED = (1, 2)          # the bounces whose rays K5 is held on
AD_SMALL = (160, 120)        # the route-against-walk comparison's size
AD_REL = 1e-3                # and its rule: tests/test_torch_wavefront_grad_tex.py's
AD_EST = (320, 240, 4)       # the two estimators' size and spp
AD_SEEDS = 8
AD_SIGMAS = 4.0
AD_DEMO = ["--width", "160", "--height", "120", "--spp", "8"]
AD_DEMO_STEPS = 50
AD_FIELDS = ("color", "emission", "tri_color", "tex_planar", "tex_sphere",
             "tex_cube")           # diff.extract_params' fields
AD_REMAT = "textures"        # the rematerialized scene's checks (ad_remat)
AD_REMAT_BIG = 8             # its SGD step at W x H x 8, train_demo's spp
AD_REMAT_SPP = (1, 2, 4)     # --ad-only: its steps at the smaller spp too
AD_REMAT_TIMED = 2           # timed steps a size after a warm-up
AD_REMAT_SHARE = 1 / 3       # its 1-spp peak against the plain loop's, at most
AD_AB_SPP = (1, 4)           # --ad-only --ab-parent: the AD step in turns
NO_ROOM, ROOM = 0, 1 << 62   # free_memory: every bounce recomputed, none


def ad_inputs(scene: str, dev, w=None, h=None, spp=AD_SPP):
    """(arrays, meta, cfg, camera vector, px, py, route) of `scene` at w x h
    (default W x H) for the wavefront autograd path on `dev`, the route
    built once."""
    w, h = w or W, h or H
    cfg = RenderConfig(width=w, height=h, samples=spp, samples_per_pass=spp)
    sc = get_scene(scene, cfg)
    arrays, meta = sc.pack(device=dev)
    cam = sc.camera.pack(torch.float32, dev)
    px, py = integrator.pixel_grid(w, 0, h, dev)
    route = integrator.intersect_route(arrays, meta,
                                       cfg.replace(early_exit=False))
    return arrays, meta, cfg, cam, px, py, route


def ad_loss_grads(inp, params, key, target, route=None):
    arrays, meta, cfg, cam, px, py, r = inp
    return loss_and_grads(params, arrays, meta, cfg, cam, px, py, key,
                          cfg.samples, target, route=r if route is None
                          else route)


@contextlib.contextmanager
def backward_counts():
    """Counts what runs inside torch.autograd.grad, the backward pass of
    loss_and_grads (where the rematerialized bounces are recomputed),
    apart from the rest: yields a dict whose "launches" (K5) and
    "reattach" (reattach_hit calls) add up the backward's, "calls" the
    backward passes, "checkpointed" the bounces the forward ran under
    torch.utils.checkpoint, and "inside" is True while a backward runs."""
    got = dict(launches=0, reattach=0, calls=0, checkpointed=0,
               inside=False)
    real = torch.autograd.grad
    real_checkpoint = integrator.checkpoint

    def checkpoint(*a, **kw):
        got["checkpointed"] += 1
        return real_checkpoint(*a, **kw)

    def grad(*a, **kw):
        l0, r0 = mk.intersect_batch.launches, reattach_hit.calls
        got["inside"] = True
        try:
            return real(*a, **kw)
        finally:
            got["inside"] = False
            got["launches"] += mk.intersect_batch.launches - l0
            got["reattach"] += reattach_hit.calls - r0
            got["calls"] += 1
    torch.autograd.grad, integrator.checkpoint = grad, checkpoint
    try:
        yield got
    finally:
        torch.autograd.grad, integrator.checkpoint = real, real_checkpoint


@contextlib.contextmanager
def free_memory(n: int):
    """integrator._free_bytes patched to n: NO_ROOM rematerializes every
    bounce of a textured scene's differentiated fixed trip
    (integrator._plain_bounces), ROOM none, as the loop ran before it."""
    real = integrator._free_bytes
    integrator._free_bytes = lambda dev: n
    try:
        yield
    finally:
        integrator._free_bytes = real


def ad_checked_step(inp, card, scene):
    """One differentiable step whose K5 launches at AD_CHECKED's bounces
    are held bit for bit against intersect_batch_reference on the step's
    own rays, all eight outputs (the triangle slot too); on a scene whose
    bounces may be rematerialized (integrator._remat_bounces) the step
    recomputes every bounce (free_memory(NO_ROOM)), and every launch of
    the backward's recompute is held bit for bit against the forward's
    launch on the same rays. K5 is then timed on bounce 1's rays
    (k5_times), with its bound. Returns the numbers."""
    arrays, meta, cfg, cam, px, py, route = inp
    remat = integrator._remat_bounces(meta)
    seen, fwd_out, replayed = [], [], []

    def checked(scn, meta_, cfg_, o, d, tables=None):
        got = mk.intersect_batch(scn, meta_, cfg_, o, d, tables=tables)
        if bwd["inside"]:
            # the recompute of a bounce: the forward's rays, its outputs
            same = [f for r, f in fwd_out if all(
                torch.equal(a, b) for a, b in zip((*o, *d), r))]
            if not same or any(not torch.equal(a, b) for a, b in zip(
                    flat_outputs(got), flat_outputs(same[0]))):
                raise AssertionError(
                    f"phase 12: {scene}: a recomputed bounce's K5 "
                    f"{'outputs differ from' if same else 'rays are not'} "
                    f"the forward's")
            replayed.append(len(same))
            return got
        if remat:
            fwd_out.append(((*o, *d), got))
        if len(seen) in AD_CHECKED:
            want = mk.intersect_batch_reference(scn, meta_, cfg_, o, d,
                                                tables)
            bad = [i for i, (a, b) in enumerate(zip(flat_outputs(got),
                                                    flat_outputs(want)))
                   if not torch.equal(a, b)]
            if bad or len(flat_outputs(got)) != 16:
                raise AssertionError(f"phase 12: {scene} bounce "
                                     f"{len(seen)}: K5 differs from its "
                                     f"plain version in outputs {bad}")
        seen.append((o, d))
        return got

    target = Vec3.zeros((px.shape[0],), torch.float32, px.device)
    with backward_counts() as bwd, free_memory(NO_ROOM):
        ad_loss_grads(inp, extract_params(arrays), threefry.prng_key(0),
                      target, integrator.IntersectRoute(checked,
                                                        route.tables))
    if (len(seen), len(replayed)) != (cfg.max_bounces, cfg.max_bounces
                                      if remat else 0):
        raise AssertionError(f"phase 12: {scene}: {len(seen)} forward and "
                             f"{len(replayed)} recomputed K5 calls")
    del fwd_out
    o, d = seen[1]
    counts = {}
    want, p_ms = timed(lambda: mk.intersect_batch_reference(
        arrays, meta, cfg, o, d, route.tables, counts), stack=False)
    k = k5_times(THIS_TREE, arrays, meta, cfg, o, d, route.tables)
    b_ms, b_by, ops = k5_bound(meta, cfg, counts, flat_outputs(
        mk.intersect_batch(arrays, meta, cfg, o, d, tables=route.tables)), o,
        d, route.tables)
    tri = int((want[7] >= 0).sum())
    phase(f"phase 12: {scene} K5 on the differentiable step's rays "
          f"({o[0].numel()} a bounce, {len(seen)} bounces): bit-equal to "
          f"the plain version, triangle slot included, at bounces "
          f"{list(AD_CHECKED)} ({tri} triangle winners at bounce 1); "
          f"{len(replayed)} bounces recomputed in the backward, each "
          f"launch bit-equal to the forward's on the same rays; "
          f"bounce 1: {k5_text(k)}, plain {p_ms:.1f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}; {ops:.4g} f32 ops); the launcher's host "
          f"time below the kernel's: {k['host_ms'] < k['kernel_ms']}; card "
          f"{card}")
    return dict(rays=o[0].numel(), bounces=len(seen),
                recomputed=len(replayed), ms=k["call_ms"],
                kernel_ms=k["kernel_ms"], host_ms=k["host_ms"],
                plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                tri_winners_bounce_1=tri)


def ad_live_rays(inp):
    """The live rays at the start of each bounce of one forward of the
    differentiable render (the fixed trip: K5 answers every ray at every
    bounce, live or not; ROADMAP W2)."""
    arrays, meta, cfg, cam, px, py, route = inp
    live = []
    orig = integrator.bounce_step

    def counted(scn, meta_, cfg_, state, key, route=None):
        live.append(int(state.alive.sum()))
        return orig(scn, meta_, cfg_, state, key, route)
    integrator.bounce_step = counted
    try:
        with torch.no_grad():
            render_image_diff(extract_params(arrays), arrays, meta, cfg,
                              cam, px, py, threefry.prng_key(0),
                              cfg.samples, route)
    finally:
        integrator.bounce_step = orig
    return live


def ad_main_path(scene: str, dev, card):
    """The wavefront autograd path's main path on `scene` at W x H x
    AD_SPP: K5 held on a step's rays (ad_checked_step), then, with every
    launch count set to 0 just before, bench.py's measurement (a warm-up
    SGD step of diff.train_step and AD_TIMED timed ones, every SceneParams
    field trainable, a zero target; bench.bench_diff_wavefront): K5 must
    launch once a bounce of every step and never the megakernel; the peak
    memory of those steps. Then Adam toward a common-random-number target
    from perturbed colors (and triangle colors): the loss must fall over
    AD_FALL steps. Returns the numbers."""
    tag = f"phase 12: {scene} {W}x{H}x{AD_SPP}"
    inp = ad_inputs(scene, dev)
    arrays, meta, cfg, cam, px, py, route = inp
    if route.fn is not mk.intersect_batch:
        raise AssertionError(f"{tag}: the route is not the intersect kernel")
    k5 = ad_checked_step(inp, card, scene)
    live = ad_live_rays(inp)
    remat = integrator._remat_bounces(meta)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.intersect_batch.launches = 0
    mk.trace_tiles.launches = 0
    reattach_hit.calls = reattach_hit.rays = 0
    with backward_counts() as bwd:
        samples, secs = bench.bench_diff_wavefront(
            cfg, types.SimpleNamespace(camera=get_scene(scene, cfg).camera),
            arrays, meta, 8 * AD_TIMED, dev)
    launches, calls = mk.intersect_batch.launches, reattach_hit.calls
    rays = reattach_hit.rays
    peak = torch.cuda.max_memory_allocated()
    steps = AD_TIMED + 1
    # the forward launches K5 once a bounce, the backward once more a
    # rematerialized bounce (its recompute); a 1-spp step fits in the
    # card's memory, so integrator._plain_bounces rematerializes none
    fwd, rec = launches - bwd["launches"], bwd["launches"]
    ckpt = bwd["checkpointed"]
    if (fwd != steps * cfg.max_bounces or bwd["calls"] != steps
            or rec != ckpt or ckpt or bwd["reattach"]
            or mk.trace_tiles.launches or samples != W * H * AD_TIMED):
        raise AssertionError(
            f"{tag}: {fwd} K5 launches in the forward and {rec} in the "
            f"backward of {bwd['calls']} steps ({steps} expected) of "
            f"{cfg.max_bounces} bounces, {ckpt} bounces rematerialized "
            f"(none expected: the batch fits), {bwd['reattach']} of "
            f"{calls} re-attaches in the backward, "
            f"{mk.trace_tiles.launches} megakernel launches")
    rate = samples / secs / 1e6
    phase(f"{tag}: fwd+bwd {rate:.3f} Msamples/s ({AD_TIMED} SGD steps in "
          f"{secs:.4f} s after a warm-up, bench.py's measurement); "
          f"{fwd / steps:.0f} + {rec / steps:.0f} K5 launches a step, "
          f"forward + the backward's recompute ({launches} in {steps} "
          f"steps; rematerializable scene: {remat}, bounces "
          f"rematerialized: {ckpt}), 0 megakernel launches; {calls} "
          f"re-attaches ({rays} rays); peak memory {peak / 2**30:.3f} GiB; "
          f"live rays a bounce {live}; card {card}")

    # the loss toward a target: Adam from perturbed colors
    true = extract_params(arrays)
    key = threefry.fold_in(threefry.prng_key(0), 12345)
    with torch.no_grad():
        target = Vec3(*(c.detach() for c in render_image_diff(
            true, arrays, meta, cfg, cam, px, py, key, cfg.samples, route)))
    rng = np.random.default_rng(3)
    bad = {"color": true.color.clamp(0.05, 1.0)}
    if meta.has_groups:
        bad["tri_color"] = true.tri_color
    leaves = {k: torch.clamp(v + torch.from_numpy(rng.uniform(
        -0.3, 0.3, tuple(v.shape)).astype(np.float32)).to(dev), 0.0, 1.0)
        .requires_grad_(True) for k, v in bad.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=AD_LR)
    losses = []
    for _ in range(AD_FALL):
        loss, g = ad_loss_grads(inp, true._replace(**leaves), key, target)
        opt.zero_grad()
        for k, v in leaves.items():
            v.grad = getattr(g, k)
        opt.step()
        losses.append(float(loss))
    check_falls(f"{tag}: Adam on {sorted(leaves)} toward a "
                "common-random-number target", losses)
    return dict(msamples_per_s=rate, seconds=secs, launches=launches,
                launches_a_step=launches / steps, rematerializable=remat,
                rematerialized=ckpt,
                forward_launches=fwd, recompute_launches=rec,
                reattach_calls=calls,
                reattach_rays=rays, peak_bytes=peak, live_rays=live,
                losses=losses, k5=k5)


def ad_route_vs_walk(scene: str, dev, card):
    """The same key's gradients on the card through the kernel's route and
    through the torch walk, at AD_SMALL: every SceneParams field within
    AD_REL x max|g| of the walk's (the textures rule of
    tests/test_torch_wavefront_grad_tex.py)."""
    w, h = AD_SMALL
    inp = ad_inputs(scene, dev, w, h)
    arrays, meta, cfg, cam, px, py, route = inp
    p = extract_params(arrays)
    target = Vec3.zeros((w * h,), torch.float32, dev)
    key = threefry.prng_key(5)
    _, g_k = ad_loss_grads(inp, p, key, target)
    _, g_w = ad_loss_grads(inp, p, key, target, integrator.IntersectRoute())
    worst = {}
    for k in AD_FIELDS:
        a, b = getattr(g_k, k), getattr(g_w, k)
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"phase 12: {scene}: {k} not finite")
        top = float(b.abs().max())
        worst[k] = (float((a - b).abs().max()), top)
        if worst[k][0] > AD_REL * top:
            raise AssertionError(f"phase 12: {scene}: the kernel's route "
                                 f"and the torch walk differ in {k}: "
                                 f"{worst[k]}")
    phase(f"phase 12: {scene} {w}x{h}x{AD_SPP} gradients through K5 against "
          f"the torch walk, the same key: (max |difference|, max |g|) "
          f"{worst}, within {AD_REL} x max|g|; card {card}")
    return worst


def fresh_peak():
    """Free the cached blocks and start the peak from what is allocated."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def pass_split(path: str) -> dict:
    """Of a torch.profiler trace of one AD step: for its forward and its
    backward ("pt.ad_forward", "pt.ad_backward" spans) the wall, the
    kernels launched in it (by the time of their launch call), their
    device time and its share of the wall (the rest: the device idle)."""
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    launch_ts = {e["args"].get("correlation"): e["ts"] for e in ev
                 if e.get("cat") == "cuda_runtime"}
    kernels = [(launch_ts.get(e["args"].get("correlation"), -1), e["dur"])
               for e in ev if e.get("cat") == "kernel"]
    out = {}
    for name in ("pt.ad_forward", "pt.ad_backward"):
        span = [e for e in ev if e.get("cat") == "user_annotation"
                and e.get("name") == name]
        if not span or not kernels:
            out[name[3:]] = {"note": "no span or no device events"}
            continue
        a, b = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
        ks = [d for t, d in kernels if a <= t <= b]
        out[name[3:]] = dict(wall_ms=(b - a) / 1e3, kernels=len(ks),
                             kernel_ms=sum(ks) / 1e3,
                             kernel_share=sum(ks) / (b - a))
    return out


def ad_step_split(inp, card, tmp):
    """The AD step (image_loss and its torch.autograd.grad, every
    SceneParams field trainable, a zero target) of the loop without the
    rematerialization (free_memory(ROOM)) and with it on every bounce
    (free_memory(NO_ROOM)): its forward and backward
    walls by host clock over AD_REMAT_TIMED steps after a warm-up (a
    synchronize ends each pass), then one step traced by torch.profiler
    (pass_split; the profiler's own cost is in that step's walls).
    Returns {"plain"|"remat": {"forward_s", "backward_s", "trace"}}."""
    arrays, meta, cfg, cam, px, py, route = inp
    target = Vec3.zeros((px.shape[0],), torch.float32, px.device)
    key = threefry.prng_key(0)
    prof = torch.profiler
    out = {}

    def one():
        p = extract_params(arrays)
        leaves = {k: getattr(p, k).detach().requires_grad_(True)
                  for k in AD_FIELDS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prof.record_function("pt.ad_forward"):
            loss = image_loss(p._replace(**leaves), arrays, meta, cfg, cam,
                              px, py, key, cfg.samples, target, route=route)
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        with prof.record_function("pt.ad_backward"):
            torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
            torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1
    for who, room in (("plain", ROOM), ("remat", NO_ROOM)):
        with free_memory(room):
            one()
            walls = [one() for _ in range(AD_REMAT_TIMED)]
            with prof.profile(activities=[prof.ProfilerActivity.CPU,
                                          prof.ProfilerActivity.CUDA]) as p:
                one()
        path = os.path.join(tmp, f"ad_{who}.json")
        p.export_chrome_trace(path)
        out[who] = dict(forward_s=float(np.median([f for f, _ in walls])),
                        backward_s=float(np.median([b for _, b in walls])),
                        trace=pass_split(path))
        fresh_peak()
    phase(f"phase 12: {AD_REMAT} {W}x{H}x{cfg.samples} AD step split, "
          f"forward / backward (s, host clock, median of "
          f"{AD_REMAT_TIMED}): without the rematerialization "
          f"{out['plain']['forward_s']:.4f} / "
          f"{out['plain']['backward_s']:.4f}, with it "
          f"{out['remat']['forward_s']:.4f} / "
          f"{out['remat']['backward_s']:.4f}; one traced step: "
          f"{json.dumps({w: o['trace'] for w, o in out.items()})}; card "
          f"{card}")
    return out


def ad_remat(args, dev, card):
    """The rematerialized bounces on AD_REMAT at W x H: the gradients of a
    1-spp step with every bounce recomputed (free_memory(NO_ROOM))
    against the same step with none (ROOM), every SceneParams field
    within AD_REL x max|g| (the card's index_add_ adds in another order
    each launch), and its peak memory at most AD_REMAT_SHARE of theirs;
    then the SGD step at AD_REMAT_BIG spp, which the plain loop cannot
    hold, under the memory it finds (ad_rate): K5 exactly once a bounce
    in the forward and once a rematerialized bounce in the backward, some
    bounces rematerialized, the new parameters and the loss finite, its
    peak memory and fwd+bwd Msamples/s. With --ad-only, the step at each
    spp of AD_REMAT_SPP too, and the 1-spp step's forward and backward
    split (ad_step_split). Returns the numbers."""
    scene, tag = AD_REMAT, f"phase 12: {AD_REMAT} rematerialized"
    fresh_peak()
    inp = ad_inputs(scene, dev)
    arrays, meta, cfg, cam, px, py, route = inp
    if not integrator._remat_bounces(meta):
        raise AssertionError(f"{tag}: the scene is not rematerialized")
    p = extract_params(arrays)
    target = Vec3.zeros((W * H,), torch.float32, dev)
    key = threefry.prng_key(7)
    peaks, grads = {}, {}
    for who, room in (("plain", ROOM), ("remat", NO_ROOM)):
        fresh_peak()
        base = torch.cuda.memory_allocated()
        with free_memory(room):
            grads[who] = ad_loss_grads(inp, p, key, target)[1]
        torch.cuda.synchronize()
        peaks[who] = torch.cuda.max_memory_allocated()
        peaks[f"{who}_above_start"] = peaks[who] - base
    worst = {}
    for k in AD_FIELDS:
        a, b = getattr(grads["remat"], k), getattr(grads["plain"], k)
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{tag}: {k} not finite")
        top = float(b.abs().max())
        worst[k] = (float((a - b).abs().max()), top)
        if worst[k][0] > AD_REL * top:
            raise AssertionError(f"{tag}: {k} differs from the plain "
                                 f"loop's: {worst[k]}")
    del grads
    share = peaks["remat"] / peaks["plain"]
    phase(f"{tag} {W}x{H}x1, every bounce, against the loop without it, "
          f"the same key: (max |difference|, max |g|) {worst}, within "
          f"{AD_REL} x max|g|; peak memory {peaks['remat'] / 2**30:.3f} GiB "
          f"against {peaks['plain'] / 2**30:.3f} ({share:.4f} of it; above "
          f"the step's start {peaks['remat_above_start'] / 2**30:.3f} "
          f"against {peaks['plain_above_start'] / 2**30:.3f}); card {card}")
    if share > AD_REMAT_SHARE:
        raise AssertionError(f"{tag}: the peak is {share:.4f} of the plain "
                             f"loop's (at most {AD_REMAT_SHARE:.4f})")
    out = dict(vs_plain=worst, peak_bytes=peaks["remat"],
               plain_peak_bytes=peaks["plain"], by_spp={})
    if args.ad_only:
        with tempfile.TemporaryDirectory() as tmp:
            out["split"] = ad_step_split(inp, card, tmp)
    del inp, arrays, route
    steps = AD_REMAT_TIMED + 1
    mk.intersect_batch.launches = 0
    with backward_counts() as bwd:
        big = ad_rate(THIS_TREE, scene, AD_REMAT_BIG, dev)
    fwd, rec = mk.intersect_batch.launches - bwd["launches"], bwd["launches"]
    ckpt = bwd["checkpointed"]
    size = f"{W}x{H}x{AD_REMAT_BIG}"
    if (fwd != steps * cfg.max_bounces or rec != ckpt or not ckpt
            or bwd["calls"] != steps or not big["finite"]):
        raise AssertionError(
            f"{tag} {size}: {fwd} K5 launches in the forward and {rec} in "
            f"the backward's recompute of {ckpt} rematerialized bounces in "
            f"{bwd['calls']} steps ({steps} expected; some bounces "
            f"rematerialized expected); parameters and loss finite: "
            f"{big['finite']}")
    phase(f"{tag} {size} SGD (diff.train_step): fwd+bwd "
          f"{big['msamples_per_s']:.3f} Msamples/s ({AD_REMAT_TIMED} steps "
          f"in {big['seconds']:.4f} s after a warm-up); peak memory "
          f"{big['peak_bytes'] / 2**30:.3f} GiB; {fwd // steps} + "
          f"{rec // steps} K5 launches a step, forward + the recompute of "
          f"the {ckpt // steps} rematerialized bounces; parameters and "
          f"loss finite; card {card}")
    out["big"] = dict(big, forward_launches=fwd, recompute_launches=rec)
    for spp in AD_REMAT_SPP if args.ad_only else ():
        with backward_counts() as bwd:
            r = ad_rate(THIS_TREE, scene, spp, dev)
        phase(f"{tag} {W}x{H}x{spp} SGD: fwd+bwd "
              f"{r['msamples_per_s']:.3f} Msamples/s; peak memory "
              f"{r['peak_bytes'] / 2**30:.3f} GiB; "
              f"{bwd['checkpointed'] // steps} bounces rematerialized a "
              f"step; parameters and loss finite: {r['finite']}; card "
              f"{card}")
        out["by_spp"][spp] = dict(r, rematerialized=bwd["checkpointed"])
    fresh_peak()
    return out


def ad_rate(T, scene: str, spp: int, dev) -> dict:
    """Tree T's diff.train_step at W x H x spp on `scene` (every
    SceneParams field trainable, a zero target, the route built once),
    one warm-up step and AD_REMAT_TIMED timed ones, on T's own code:
    {"msamples_per_s", "seconds", "peak_bytes", "finite" (the last
    step's parameters and loss)}. bench.bench_diff_wavefront, which
    phase 12's main path times, takes 1-spp steps only."""
    fresh_peak()
    cfg = T.RenderConfig(width=W, height=H, samples=spp,
                         samples_per_pass=spp)
    sc = T.get_scene(scene, cfg)
    arrays, meta = sc.pack(device=dev)
    cam = sc.camera.pack(torch.float32, dev)
    px, py = T.integrator.pixel_grid(W, 0, H, dev)
    route = T.integrator.intersect_route(arrays, meta,
                                         cfg.replace(early_exit=False))
    target = T.vec3.Vec3.zeros((W * H,), torch.float32, dev)
    key = T.threefry.prng_key(0)
    params = T.diff.extract_params(arrays)

    def step(params):
        return T.diff.train_step(params, arrays, meta, cfg, cam, px, py, key,
                                 spp, target, route=route)
    params, loss = step(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(AD_REMAT_TIMED):
        params, loss = step(params)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(v).all()) for v in params if v is not None)
    del params, arrays, route
    fresh_peak()
    return dict(msamples_per_s=W * H * spp * AD_REMAT_TIMED / secs / 1e6,
                seconds=secs, peak_bytes=peak, finite=finite)


def ad_ab(parent: str, dev, card) -> dict:
    """The AD step (ad_rate) on the tree under `parent` and on this one,
    in the order parent, this, this, parent, on AD_SCENES at each spp of
    AD_AB_SPP: {"scene spp": {"parent": [(rate, peak), ...], "this":
    [...]}}."""
    T = load_tree(parent, "ad_tree")
    trees = {"parent": T, "this": THIS_TREE}
    out = {}
    for scene in AD_SCENES:
        for spp in AD_AB_SPP:
            runs = {"parent": [], "this": []}
            for who in ("parent", "this", "this", "parent"):
                r = ad_rate(trees[who], scene, spp, dev)
                runs[who].append((r["msamples_per_s"], r["peak_bytes"]))
            rate = {w: float(np.median([r for r, _ in v]))
                    for w, v in runs.items()}
            peak = {w: max(b for _, b in v) for w, v in runs.items()}
            phase(f"phase 12 A/B: {scene} {W}x{H}x{spp} AD step: {parent} "
                  f"{rate['parent']:.3f} Msamples/s, peak "
                  f"{peak['parent'] / 2**30:.3f} GiB; this "
                  f"{rate['this']:.3f} ({(rate['this'] - rate['parent']) / rate['parent']:+.2%}), "
                  f"peak {peak['this'] / 2**30:.3f} GiB; rates "
                  f"{parent} {[round(r, 3) for r, _ in runs['parent']]}, "
                  f"this {[round(r, 3) for r, _ in runs['this']]}; card "
                  f"{card}")
            out[f"{scene} {spp}"] = runs
    return out


@functools.lru_cache(maxsize=None)
def estimator_samples(dev, coherent: str, n: int):
    """The gradient d loss / d (color, emission) on `reference` at AD_EST
    against a black target at the same spp (the squared loss's noise term
    is then the same for both estimators), over seeds 0 .. n - 1: the
    wavefront's (image_loss) with coherent None, else the megakernel
    step's (make_megakernel_step, its update at lr 1 taken back) under
    PT_COHERENT=coherent. [n, entries] float64, computed once."""
    w, h, spp = AD_EST
    inp = ad_inputs("reference", dev, w, h, spp)
    arrays, meta, cfg, cam, px, py, route = inp
    out = []
    if coherent is None:
        p = extract_params(arrays)
        for s in range(n):
            _, g = ad_loss_grads(inp, p, threefry.prng_key(100 + s),
                                 Vec3.zeros((w * h,), torch.float32, dev))
            out.append(torch.cat([g.color, g.emission]).cpu().double()
                       .numpy())
        return np.asarray(out)
    sc = get_scene("reference", cfg)
    step, target_of = make_megakernel_step(arrays, meta, cfg, sc.camera,
                                           spp, lr=1.0)
    target = target_of(np.zeros((h, w, 3), np.float32))
    with env_var("PT_COHERENT", coherent):
        for s in range(n):
            c, e, _ = step(arrays.color, arrays.emission, (200 + s, 0),
                           target)
            out.append(torch.cat([arrays.color - c, arrays.emission - e])
                       .cpu().double().numpy())
    return np.asarray(out)


def estimator_z(dev, coherent: str, n: int):
    """(z [entries], entries with noise, noiseless entries that differ) of
    the megakernel step's gradient under PT_COHERENT=coherent against the
    wavefront's, over n seeds each: each entry's difference of means over
    its standard error (each estimator's spread over sqrt(n))."""
    a = estimator_samples(dev, None, max(n, ROW_SHARED_SEEDS))[:n]
    b = estimator_samples(dev, coherent, n)
    se = np.sqrt(a.var(0, ddof=1) / n + b.var(0, ddof=1) / n)
    live = se > 0
    z = np.zeros_like(se)
    z[live] = (a.mean(0) - b.mean(0))[live] / se[live]
    still = ~live & (np.abs(a.mean(0) - b.mean(0)) > 0)
    return z, int(live.sum()), int(still.sum())


def ad_estimators(dev, card):
    """Two estimators of the same gradient on `reference` at AD_EST
    (estimator_samples): the wavefront's and the megakernel step's with
    per-slot draws (PT_COHERENT=0), each over AD_SEEDS seeds, every entry
    within AD_SIGMAS standard errors. The megakernel's default row-shared
    draws are held by the same rule at ROW_SHARED_SEEDS seeds in phase 6
    (row_shared_check)."""
    w, h, spp = AD_EST
    z, live, still = estimator_z(dev, "0", AD_SEEDS)
    phase(f"phase 12: reference {w}x{h}x{spp} d loss / d (color, emission), "
          f"the wavefront's and the megakernel's (per-slot draws, "
          f"PT_COHERENT=0) over {AD_SEEDS} seeds each: {live} entries with "
          f"noise, |z| max {np.abs(z).max():.3f}, {still} noiseless entries "
          f"that differ; card {card}")
    if np.abs(z).max() > AD_SIGMAS or still:
        raise AssertionError(f"phase 12: the two estimators disagree: z "
                             f"{np.round(z, 2).tolist()}")
    return dict(entries=live, z_max=float(np.abs(z).max()))


def ad_demo(dev, card, tmp):
    """train_demo's default mode at 160x120x8 for AD_DEMO_STEPS steps: the
    sphere-color MAD must fall. Then the checkpoint: an unbroken 6-step
    run against one stopped after 3 steps and resumed from its
    checkpoint, their colors and Adam's moments by the gradient rule of
    tests/_torch_scenes.py (the gathers' backward adds with atomics)."""
    args = AD_DEMO + ["--out", os.path.join(tmp, "demo.png")]
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        err0, err1 = train_demo.main_colors(train_demo.build_parser()
                                            .parse_args(args + [
                                                "--steps",
                                                str(AD_DEMO_STEPS)]), dev)
    line = [ln for ln in buf.getvalue().splitlines() if "MAD" in ln][-1]
    phase(f"phase 12: train_demo (default mode) {' '.join(AD_DEMO)} "
          f"--steps {AD_DEMO_STEPS}: {line}; {time.perf_counter() - t0:.1f} "
          f"s; card {card}")
    if not err1 < err0:
        raise AssertionError("phase 12: train_demo's color MAD did not fall")
    full, part = os.path.join(tmp, "full"), os.path.join(tmp, "part")
    with contextlib.redirect_stdout(io.StringIO()):
        for a in (["--steps", "6", "--checkpoint", full],
                  ["--steps", "3", "--checkpoint", part],
                  ["--steps", "6", "--checkpoint", part, "--resume"]):
            if train_demo.main(args + a + ["--device", str(dev)]) != 0:
                raise AssertionError(f"phase 12: train_demo {a} failed")
    like = extract_params(get_scene("reference", RenderConfig(
        width=160, height=120)).pack(device=dev)[0])
    got, want = (restore_train_state(d, like, {}) for d in (part, full))
    moments = [[st[m] for st in o["state"].values()
                for m in ("exp_avg", "exp_avg_sq")] for o in (got[2],
                                                              want[2])]
    if (got[0], want[0]) != (6, 6):
        raise AssertionError(f"phase 12: the checkpoints' steps "
                             f"{got[0]}, {want[0]} (6 expected)")
    rule = grad_rule((got[1].color, *moments[0][:1]),
                     (want[1].color, *moments[1][:1]), mesh=False)
    rule2 = grad_rule((moments[0][1], got[1].emission),
                      (moments[1][1], want[1].emission), mesh=False)
    phase(f"phase 12: train_demo resumed at step 3 of 6 against the "
          f"unbroken run: colors, Adam's first moments {rule}, second "
          f"moments {rule2}; card {card}")
    return dict(mad=[err0, err1], resume=rule, resume_second=rule2)


def ptxas_vs_parent(parent: str, ptxas) -> dict:
    """The ptxas counts (registers, stack, spill stores and loads) of this
    build against the tree under `parent`: every instantiation but the
    intersect kernel's must keep its counts; the intersect kernel's are
    printed before and after."""
    T = load_tree(parent, "ptxas_tree")
    T.mk.library()
    theirs, ours = ptxas_counts(tree_ptxas(T)), ptxas_counts(ptxas)
    isect = {k: (list(v), list(ours[k]) if k in ours else None)
             for k, v in theirs.items() if k.startswith("intersect")}
    moved = {k: (v, ours.get(k)) for k, v in theirs.items()
             if not k.startswith("intersect") and ours.get(k) != v}
    phase(f"phase 12: ptxas of the intersect instantiations, {parent} then "
          f"this: {isect}")
    phase(f"phase 12: ptxas of the other {len(theirs) - len(isect)} "
          f"instantiations against {parent}: "
          f"{'unchanged' if not moved else moved}")
    if moved:
        raise AssertionError(f"phase 12: ptxas counts moved: {moved}")
    return isect


def ad_phases(args, dev, card, ptxas):
    """Phase 12: the wavefront autograd path on K5 (ad_main_path on each of
    AD_SCENES), the kernel's route against the torch walk, the two
    estimators, the demo and the checkpoint; with --ab-parent under
    --ad-only, the ptxas counts against those trees. Returns the
    numbers."""
    out = {"main": {s: ad_main_path(s, dev, card) for s in AD_SCENES}}
    out["remat"] = ad_remat(args, dev, card)
    out["route_vs_walk"] = {s: ad_route_vs_walk(s, dev, card)
                            for s in AD_SCENES}
    out["estimators"] = ad_estimators(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        out["demo"] = ad_demo(dev, card, tmp)
    if args.ad_only:
        out["ptxas_vs_parent"] = {d: ptxas_vs_parent(d, ptxas)
                                  for d in args.ab_parent}
        out["ab"] = {d: ad_ab(d, dev, card) for d in args.ab_parent}
    return out


# ---- the intersect kernel's split and A/B (--k5-only, --k5-split) ---------

# the A/B of K5's redesign: the AD step's batches and the wavefront's
# batch size, the meshes at the port's leaf size, K5 under packet mode 3
# (the packet launch), and the meshes on bounced rays
K5_AB_CASES = {
    **{k: v for k, v in AB_CASES.items()
       if v["kind"] == "isect" and v.get("spp") == 1},
    f"K5 reference {W * H * 8} rays": dict(kind="isect", scene="reference"),
    f"K5 teapot leaf 4 {W * H * 8} rays": dict(kind="isect", scene="teapot",
                                               leaf=4),
    f"K5 size-check mesh leaf 4 {W * H * 8} rays": dict(
        kind="isect", scene="size-check mesh", leaf=4),
    f"K5 packet mode 3 teapot {W * H * 8} rays": dict(
        kind="isect", scene="teapot", leaf=4, env=WALKS["packet mode 3"]),
    # the main paths' rays are bounced ones: on a mesh, fewer walking lanes
    # a walking warp than camera rays give
    f"K5 teapot bounce {W * H} rays": dict(kind="isect", scene="teapot",
                                           spp=1, leaf=4, bounce=True),
    f"K5 teapot bounce {W * H * 8} rays": dict(kind="isect", scene="teapot",
                                               leaf=4, bounce=True),
    f"K5 size-check mesh bounce {W * H * 8} rays": dict(
        kind="isect", scene="size-check mesh", leaf=4, bounce=True),
}
K5_TURNS = 3             # the split's timings a tree, in turns


def k5_main_rays(dev):
    """The rays K5's main paths hand it at bounce 1: a differentiable step
    of each of AD_SCENES at W x H x 1 (ad_checked_step's batch) and a
    wavefront pass of each of WF_SCENES at W x H x 8 (k5_on_bounces').
    Returns {shape: (scene, spp, origin, direction)}."""
    out = {}

    def grab(seen):
        def fn(scn, meta_, cfg_, o, d, tables=None):
            seen.append((o, d))
            return mk.intersect_batch(scn, meta_, cfg_, o, d, tables=tables)
        return fn

    for scene in AD_SCENES:
        inp = ad_inputs(scene, dev)
        arrays, _, _, _, px, _, route = inp
        seen = []
        ad_loss_grads(inp, extract_params(arrays), threefry.prng_key(0),
                      Vec3.zeros((px.shape[0],), torch.float32, px.device),
                      integrator.IntersectRoute(grab(seen), route.tables))
        out[f"AD step {scene}"] = (scene, AD_SPP, *seen[1])
    for scene in WF_SCENES:
        cfg = RenderConfig(width=W, height=H, samples=8, samples_per_pass=8)
        sc = get_scene(scene, cfg)
        arrays, meta = sc.pack(device=dev)
        px, py = integrator.pixel_grid(W, 0, H, dev)
        seen = []
        integrator.render_pass(
            arrays, meta, cfg, sc.camera.pack(torch.float32, dev), px, py, 0,
            8, threefry.fold_in(threefry.prng_key(cfg.seed), 0),
            integrator.IntersectRoute(grab(seen), mk.intersect_tables(
                arrays, meta, dev)))
        out[f"wavefront {scene}"] = (scene, 8, *seen[1])
    torch.cuda.synchronize()
    return out


def k5_profiled(kernel, reps: int = K5_REPS):
    """The device time a launch of `kernel` (a k5_prebuilt launch) by
    torch.profiler over `reps` launches, in ms, or None where the profiler
    shows no device time."""
    prof = torch.profiler
    kernel()
    torch.cuda.synchronize()
    with prof.profile(activities=[prof.ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            kernel()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) or
             getattr(e, "cuda_time_total", 0)
             for e in p.key_averages() if "intersect" in e.key)
    return us / 1e3 / reps if us else None


def k5_split(trees, dev, card):
    """K5's Step 0 split (--k5-only): on each main-path shape (k5_main_rays)
    the three times of k5_times on this tree and on each tree of `trees`
    (--k5-split DIR: another checkout, or a copy made by
    tools/k5_variants.py), K5_TURNS times in turns, medians; each tree's
    outputs against this tree's plain version (a copy that changes them is
    reported, not raised), the bound and the plain time from this tree's
    plain run, on the mesh scenes the share of warps in which some ray
    walks the group, and this tree's kernel by torch.profiler. Returns
    {shape: numbers}."""
    rays = k5_main_rays(dev)
    named = [("this", THIS_TREE)] + [(d, load_tree(d, f"k5_split_{i}"))
                                     for i, d in enumerate(trees)]
    for _, T in named:
        T.mk.library()
    out = {}
    for shape, (scene, spp, o, d) in rays.items():
        inputs = {}
        for tag, T in named:
            cfg = T.RenderConfig(width=W, height=H, samples=spp,
                                 samples_per_pass=spp)
            arrays, meta = T.get_scene(scene, cfg).pack(device=dev)
            inputs[tag] = (T, arrays, meta, cfg,
                           T.mk.intersect_tables(arrays, meta, dev))
        _, arrays, meta, cfg, tables = inputs["this"]
        counts = {}
        want, p_ms = timed(lambda: mk.intersect_batch_reference(
            arrays, meta, cfg, o, d, tables, counts), stack=False)
        want = flat_outputs(want)
        b_ms, b_by, ops = k5_bound(meta, cfg, counts, flat_outputs(
            mk.intersect_batch(arrays, meta, cfg, o, d, tables=tables)), o,
            d, tables)
        runs = {tag: [] for tag, _ in named}
        for _ in range(K5_TURNS):
            for tag, _ in named:
                T, arrays_, meta_, cfg_, tables_ = inputs[tag]
                runs[tag].append(k5_times(T, arrays_, meta_, cfg_, o, d,
                                          tables_))
        walk = (f"; the group walked by {counts['walk_rays']} rays, in "
                f"{counts['walk_warps']} of {counts['warps']} warps "
                f"({counts['walk_warps'] / counts['warps']:.4f})"
                if meta.has_groups else "")
        phase(f"k5 split: {shape} bounce 1, {o[0].numel()} rays: plain "
              f"{p_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}; {ops:.4g} f32 "
              f"ops){walk}; card {card}")
        rows = {}
        for tag, _ in named:
            T, arrays_, meta_, cfg_, tables_ = inputs[tag]
            got = flat_outputs(T.mk.intersect_batch(arrays_, meta_, cfg_, o,
                                                    d, tables=tables_))
            same = len(got) == len(want) and all(
                torch.equal(a, b) for a, b in zip(got, want))
            med = {k: float(np.median([r[k] for r in runs[tag]]))
                   for k in runs[tag][0]}
            phase(f"k5 split: {shape}: {tag}: {k5_text(med)} "
                  f"({b_ms / med['kernel_ms']:.1%} of the bound alone); "
                  f"outputs {'bit-equal to' if same else 'DIFFER from'} the "
                  f"plain version's; kernel alone by turn "
                  f"{[round(r['kernel_ms'], 4) for r in runs[tag]]}, host "
                  f"{[round(r['host_ms'], 4) for r in runs[tag]]}; card "
                  f"{card}")
            rows[tag] = dict(med, bit_equal=same)
        prof = k5_profiled(k5_prebuilt(THIS_TREE, meta, cfg, o, d, tables))
        phase(f"k5 split: {shape}: this tree's kernel by torch.profiler: "
              f"{'no device time' if prof is None else f'{prof:.4f} ms'}")
        out[shape] = dict(rows=rows, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, rays=o[0].numel(), profiled_ms=prof,
                          walk_warps=counts["walk_warps"],
                          warps=counts["warps"])
    return out


def k5_host_split(dev, card, reps: int = 200):
    """The launcher's host time a call split into its steps, in us (this
    tree, a host clock over `reps` back-to-back runs of each step, no sync
    inside), on the AD step's batch size (W x H camera rays) of
    `reference` and `teapot` (and the Stream object the launcher no longer
    builds). Returns {scene: {step: us}}."""
    out = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for scene in ("reference", "teapot"):
        cfg = RenderConfig(width=W, height=H, samples=1)
        sc = get_scene(scene, cfg)
        arrays, meta = sc.pack(device=dev)
        tables = mk.intersect_tables(arrays, meta, dev)
        o, d = camera_rays(sc.camera, W, H, 1, gen)
        rays, n = (*o, *d), o[0].numel()
        walk = mk.scene_walk(meta)
        bufs = mk.intersect_outputs(n, tables)
        fn, args = mk.intersect_launch_args(tables, rays, bufs, cfg.epsilon,
                                            cfg.t_max, walk)
        steps = {
            "checks": lambda: mk._check_rays(o, d),
            "walk": lambda: mk.scene_walk(meta),
            "current_device": torch.cuda.current_device,
            "Stream object": lambda: torch.cuda.current_stream(dev)
            .cuda_stream,
            "raw stream": lambda: mk._raw_stream(dev),
            "outputs": lambda: mk.intersect_outputs(n, tables),
            "launch args": lambda: mk.intersect_launch_args(
                tables, rays, bufs, cfg.epsilon, cfg.t_max, walk),
            "ctypes call and launch": lambda: fn(*args),
            "result views": lambda: mk.intersect_result(bufs, tables),
            "unbind": lambda: bufs[0].unbind(0),
            "whole call": lambda: mk.intersect_batch(arrays, meta, cfg, o, d,
                                                     tables=tables),
        }
        us = {}
        for name, step in steps.items():
            for _ in range(10):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                step()
            us[name] = (time.perf_counter() - t0) * 1e6 / reps
            torch.cuda.synchronize()
        phase(f"k5 host split: {scene}, {n} rays, us a call: "
              f"{ {k: round(v, 2) for k, v in us.items()} }; card {card}")
        out[scene] = us
    return out


def k5_only(args, dev, card, ptxas):
    """--k5-only: the intersect kernel's ptxas counts, its split (k5_split
    over --k5-split trees), then the A/B of --ab-parent and of --ab-chain
    on K5_AB_CASES, without the fwd+bwd rates. Prints no result lines."""
    phase(f"k5-only: ptxas (registers, stack, spill stores, spill loads) of "
          f"the intersect instantiations: "
          f"{ {k: v for k, v in ptxas_counts(ptxas).items() if k.startswith('intersect')} }")
    k5_host_split(dev, card)
    k5_split(args.k5_split, dev, card)
    differ = []
    for i, d in enumerate(args.ab_parent):
        phase(f"phase 5 A/B: against {d}")
        differ += ab_parent(d, f"ab_tree_{i}", K5_AB_CASES, dev, card,
                            ptxas, strict=False, rates=False)[4]
    for chain in args.ab_chain:
        for r in ab_chain(chain.split(","), K5_AB_CASES, dev,
                          card).values():
            differ += r[4]
    phase(f"k5-only: done; A/B cases whose outputs differ: {differ}")


# ---- phase 13: multi-GPU rendering and training (parallel/) ---------------
# Ranks of a torch.distributed group: 13a one rank over NCCL through the
# CLI's --distributed; 13b-e two ranks sharing the one card over gloo
# (NCCL takes one rank a device), started by this script through
# PT_COORDINATOR, PT_NUM_PROCESSES and PT_PROCESS_ID, each running
# dist_phase's list of jobs through the entry points a user calls
# (`--dist-rank SPEC`).
# Every rank's result is held against one process playing every rank on
# the card (parallel.mesh.LogicalMesh). The card machine has one H100: the
# walls time the sharded path's work and its collectives, not a speed-up
# from more cards.
DIST_RENDERS = (("2x1", "reference"), ("1x2", "reference"),
                ("1x2", "teapot"), ("2x1", "textures"))   # 13b, at W x H x SPP
DIST_STEP_MESH = "1x2"       # 13c: make_sharded_megakernel_step, STEP_SPP
DIST_STEPS = 5
DIST_STEP_SEEDS = (1, 2, 3, 4)   # 13c: one descent from each seed pair (k, 0)
DIST_STEP_LR = 1.0
DIST_TARGET_SPP = 256        # 13c's target: the true colors under another seed
DIST_TRAIN_MESH = "2x1"      # 13d: make_sharded_train_step at W x H x 1
DIST_TRAIN_LR = 0.05
DIST_TRAIN_REPEATS = 8       # 13d: one-process steps, their own spread
DIST_CK = ("1x2", "2x1", 256, 4, 16)   # 13e: mesh, other mesh, spp, every,
                                       # the chunk the run stops at
DIST_TIMEOUT = 600.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def reset_launches() -> None:
    for k in ("launches", "mesh_launches", "tex_launches", "nee_launches",
              "packet_launches", "mma_launches", "ablate_launches"):
        setattr(mk.trace_tiles, k, 0)
    tg.grad_tiles.launches = 0
    mk.intersect_batch.launches = 0


def launches() -> dict:
    return dict(k1=mk.trace_tiles.launches,
                k1_mesh=mk.trace_tiles.mesh_launches,
                k1_tex=mk.trace_tiles.tex_launches,
                k6=tg.grad_tiles.launches, k5=mk.intersect_batch.launches)


def dist_cli(job: dict):
    """cli.main(job["args"]) under job["env"], the launch counts and the
    collectives' times set to 0 just before; the image the driver returned
    is kept (every rank's, though rank 0 alone writes it). An exception
    is returned as its text."""
    from pathtracer_tpu_torch import driver

    box, orig = {}, driver.render_driver

    def keep(*a, **kw):
        box["img"], box["stats"] = orig(*a, **kw)
        return box["img"], box["stats"]

    reset_launches()
    dist_mesh.reset_collective_time()
    res = dict(error=None, rc=None)
    t0 = time.perf_counter()
    driver.render_driver = keep
    try:
        with env_vars(job.get("env", {})):
            res["rc"] = cli.main(job["args"])
    except Exception as e:      # noqa: BLE001 - returned to the caller
        res["error"] = f"{type(e).__name__}: {e}"
    finally:
        driver.render_driver = orig
    res.update(wall_s=time.perf_counter() - t0, launches=launches(),
               collective_s=dict(dist_mesh.COLLECTIVE_S))
    if "stats" in box:
        s = box["stats"]
        res.update(render_wall_s=s.wall_s, msamples_per_s=s.msamples_per_sec,
                   backend=s.backend, segments=s.segments)
    return res, ({"img": box["img"]} if "img" in box else {})


def dist_step(dev, mesh, seeds=DIST_STEP_SEEDS):
    """13c: DIST_STEPS steps of make_sharded_megakernel_step on `reference`
    at W x H, STEP_SPP samples a step, from the diffuse colors halved
    toward the true-color image at DIST_TARGET_SPP under another seed (no
    common random numbers: the spp ranks draw apart, and each rank's loss
    keeps its estimate's variance, which the emission's gradient pulls
    down; phase 7's small perturbation at its step size would not show
    through it), once from each seed pair (k, 0) of `seeds`, each from the
    same start. Returns ({each run's losses and step times},
    {colors, emissions} [seed, step, ...], the start first)."""
    cfg = RenderConfig(width=W, height=H, samples=SPP)
    sc = get_scene("reference", cfg)
    tabs, meta, arr, pid = grad_inputs(sc, cfg, GRAD_TILE, dev)
    step, target_of = make_sharded_megakernel_step(
        arr, meta, cfg, sc.camera, mesh, spp=STEP_SPP, lr=DIST_STEP_LR)
    target = target_of(crn_target(tabs, meta, cfg, pid, (11, 0),
                                  DIST_TARGET_SPP))
    c0 = arr.color.clone()
    c0[~arr.emission.any(dim=1)] *= 0.5
    runs, cols, emis = [], [], []
    reset_launches()
    for k in seeds:
        c, e = c0, arr.emission
        cs, es, losses, times = [c], [e], [], []
        for _ in range(DIST_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c, e, loss = step(c, e, (k, 0), target)
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
            cs.append(c)
            es.append(e)
        runs.append(dict(seed=k, losses=losses, step_s=times))
        cols.append(torch.stack(cs))
        emis.append(torch.stack(es))
    return (dict(runs=runs, launches=launches()),
            dict(colors=torch.stack(cols).cpu().numpy(),
                 emissions=torch.stack(emis).cpu().numpy()))


@contextlib.contextmanager
def deterministic():
    """torch's deterministic kernels (no atomic adds in the backward), the
    warnings of ops that have none kept in the returned list."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield caught
        finally:
            torch.use_deterministic_algorithms(False)


class GradTap(torch.optim.SGD):
    """SGD that keeps a copy of the gradients it is handed (`grads`, in the
    order of its tensors) before it applies them."""

    def step(self, closure=None):
        self.grads = [t.grad.detach().clone() for g in self.param_groups
                      for t in g["params"]]
        return super().step(closure)


def dist_train(dev, mesh, repeats=1):
    """13d: one step of make_sharded_train_step (the wavefront autograd
    path, K5 on every bounce) on `reference` at W x H x 1 toward a gray
    target: timed with its peak memory, then once under torch's
    deterministic kernels, then `repeats` times more through GradTap for
    the averaged gradients themselves. Returns ({loss, wall, peak,
    launches of the first, the deterministic mode's warnings}, {the new
    color and emission of the first step and of the deterministic one,
    and the gradients of each tapped step [repeats, ...]})."""
    cfg = RenderConfig(width=W, height=H, samples=1, samples_per_pass=1)
    sc = get_scene("reference", cfg)
    arr, meta = sc.pack(device=dev)
    cam = sc.camera.pack(torch.float32, dev)
    px, py = integrator.pixel_grid(W, 0, H, dev)
    target = Vec3(*(torch.full((W * H,), 0.5, device=dev)
                    for _ in range(3)))
    p = extract_params(arr)._replace(tri_color=None, tex_planar=None,
                                     tex_sphere=None, tex_cube=None)
    route = integrator.intersect_route(arr, meta, cfg)
    step = make_sharded_train_step(mesh, meta, cfg, n_samples=1,
                                   lr=DIST_TRAIN_LR, route=route)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    new, loss = step(p, arr, cam, px, py, target, threefry.prng_key(3))
    res = dict(loss=float(loss), wall_s=time.perf_counter() - t0,
               launches=launches(),
               peak_bytes=torch.cuda.max_memory_allocated(dev))
    with deterministic() as caught:
        det, _ = step(p, arr, cam, px, py, target, threefry.prng_key(3))
        torch.cuda.synchronize()
    res["det_warnings"] = sorted({str(w.message)[:160] for w in caught})
    # the gradients as the step hands them over, not (old - new) / lr: the
    # light's emission of 9.0 rounds its update to a float32 ulp of
    # 9.5e-7, which is 1.8e-4 of the largest emission gradient over lr
    grads = []
    for _ in range(repeats):
        q = p._replace(color=p.color.clone(), emission=p.emission.clone())
        tap = GradTap([q.color, q.emission], lr=DIST_TRAIN_LR)
        make_sharded_train_step(mesh, meta, cfg, n_samples=1,
                                optimizer=tap, route=route)(
            q, arr, cam, px, py, target, threefry.prng_key(3))
        grads.append(tap.grads)
    return res, dict(
        color=new.color.cpu().numpy(), emission=new.emission.cpu().numpy(),
        det_color=det.color.cpu().numpy(),
        det_emission=det.emission.cpu().numpy(),
        **{f"grad_{k}": torch.stack([g[j] for g in grads]).cpu().numpy()
           for j, k in enumerate(("color", "emission"))})


def dist_rank(spec_path: str) -> int:
    """One rank of phase 13 (`--dist-rank SPEC`): SPEC's jobs in order, each
    joining its own group (a CLI job through PT_COORDINATOR, a step
    through parallel.initialize_multihost); writes their results to
    SPEC's out (.json and .npz)."""
    from pathtracer_tpu_torch.parallel import (global_render_mesh,
                                               initialize_multihost)

    with open(spec_path) as f:
        spec = json.load(f)
    rank, world = spec["rank"], spec["world"]
    results, arrays = [], {}
    for i, job in enumerate(spec["jobs"]):
        coord = f"127.0.0.1:{job['port']}"
        if job["kind"] == "cli":
            with env_vars({"PT_COORDINATOR": coord,
                           "PT_NUM_PROCESSES": str(world),
                           "PT_PROCESS_ID": str(rank)}):
                res, arrs = dist_cli(job)
        else:
            dev = initialize_multihost(coord, world, rank)
            try:
                mesh = global_render_mesh(dist_mesh.parse_mesh(job["mesh"]))
                res, arrs = (dist_step if job["kind"] == "step"
                             else dist_train)(dev, mesh)
            finally:
                torch.distributed.destroy_process_group()
        results.append(res)
        arrays.update({f"{i}_{k}": v for k, v in arrs.items()})
        print(f"rank {rank}: job {i} ({job['kind']}) done", flush=True)
    with open(spec["out"] + ".json", "w") as f:
        json.dump(results, f)
    np.savez(spec["out"] + ".npz", **arrays)
    return 0


def dist_run_ranks(jobs: list, tmp: str) -> list:
    """Start this script as ranks 0 and 1 of a gloo group on the card
    (PT_DIST_BACKEND=gloo), running `jobs`; wait for both, within
    DIST_TIMEOUT or both are killed. Returns each rank's (results,
    arrays)."""
    procs, outs = [], []
    env = {k: v for k, v in os.environ.items() if not k.startswith("PT_")}
    env["PT_DIST_BACKEND"] = "gloo"
    for rank in range(2):
        out = os.path.join(tmp, f"rank{rank}")
        spec = dict(rank=rank, world=2, jobs=jobs, out=out)
        path = out + ".spec.json"
        with open(path, "w") as f:
            json.dump(spec, f)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-rank", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env))
        outs.append(out)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DIST_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"phase 13: rank {rank} failed:\n"
                                 f"{log[-4000:]}")
    got = []
    for out in outs:
        with open(out + ".json") as f:
            res = json.load(f)
        with np.load(out + ".npz") as z:
            got.append((res, {k: z[k] for k in z.files}))
    return got


def dist_cli_args(tmp: str, tag: str, scene: str, mesh: str, spp: int,
                  extra=()):
    return ["--scene", scene, "--width", str(W), "--height", str(H),
            "--samples", str(spp), "--mesh", mesh,
            "--raw-output", os.path.join(tmp, f"{tag}.raw"),
            "--output", os.path.join(tmp, f"{tag}.png"), *extra]


def logical_render(scene: str, shape: str, spp: int, dev, **driver_kw):
    """The driver's render of `scene` at W x H x spp (the CLI's config) on
    one process playing every rank of the mesh, on the card."""
    cfg = RenderConfig(width=W, height=H, samples=spp)
    sc = get_scene(scene, cfg)
    arr, meta = sc.pack(device=dev)
    mesh = None if shape is None else LogicalMesh(dist_mesh.parse_mesh(shape))
    return render_driver(arr, meta, sc.camera, cfg, mesh=mesh, **driver_kw)


def same(tag: str, a, b) -> None:
    if a.shape != b.shape or not np.array_equal(a, b):
        raise AssertionError(f"{tag}: not bit-equal")


def dist_phase(dev, card) -> dict:
    """Phase 13 (`--dist-only` alone): the multi-GPU paths at W x H, each
    launch count set to 0 just before its run. Returns the results by
    part (a-e) and the sharded launches by kernel."""
    out, tmp = {}, tempfile.mkdtemp(prefix="pt_dist_")
    try:
        # 13a: one rank over NCCL, --distributed (the 1x1 mesh), which on
        # `reference` is the single-device render bit for bit (same seeds,
        # same layout without packing)
        with env_vars({"PT_COORDINATOR": f"127.0.0.1:{free_port()}",
                       "PT_NUM_PROCESSES": "1", "PT_PROCESS_ID": "0"},
                      unset=("PT_DIST_BACKEND",)):
            res, arrs = dist_cli({"args": [
                "--scene", "reference", "--width", str(W), "--height", str(H),
                "--samples", str(SPP), "--distributed",
                "--raw-output", os.path.join(tmp, "a.raw"),
                "--output", os.path.join(tmp, "a.png")]})
        if res["error"] or res["rc"] != 0:
            raise AssertionError(f"phase 13a: {res}")
        if res["backend"] != "megakernel@1x1":
            raise AssertionError(f"phase 13a: backend {res['backend']}")
        check_image("phase 13a", arrs["img"])
        same("phase 13a: --distributed against the single-device driver",
             arrs["img"], logical_render("reference", None, SPP, dev)[0])
        phase(f"phase 13a: reference {W}x{H}x{SPP} --distributed, one rank "
              f"over nccl: {res['backend']}, {res['msamples_per_s']:.1f} "
              f"Msamples/s (driver wall {res['render_wall_s']:.3f} s, CLI "
              f"{res['wall_s']:.3f} s), {res['launches']['k1']} K1 launches;"
              f" bit-equal to the single-device driver; card {card}")
        out["a"] = res

        # 13b-e: two ranks on the card over gloo, one job list
        k_mesh, k_other, k_spp, k_every, k_stop = DIST_CK
        ck = os.path.join(tmp, "ck.npz")
        ck_args = ["--checkpoint", ck, "--checkpoint-every", str(k_every)]
        jobs = [dict(kind="cli", args=dist_cli_args(tmp, f"b{i}", s, m, SPP))
                for i, (m, s) in enumerate(DIST_RENDERS)]
        jobs += [dict(kind="step", mesh=DIST_STEP_MESH),
                 dict(kind="train", mesh=DIST_TRAIN_MESH)]
        jobs += [
            dict(kind="cli", args=dist_cli_args(
                tmp, "e_full", "reference", k_mesh, k_spp,
                ["--checkpoint", os.path.join(tmp, "full.npz"),
                 "--checkpoint-every", str(k_every)])),
            dict(kind="cli", args=dist_cli_args(
                tmp, "e_stop", "reference", k_mesh, k_spp, ck_args),
                env={"PT_FAULT_INJECT": str(k_stop), "PT_FAULT_COUNT": "9"}),
            dict(kind="cli", args=dist_cli_args(
                tmp, "e_other", "reference", k_other, k_spp,
                ck_args + ["--resume"])),
            dict(kind="cli", args=dist_cli_args(
                tmp, "e_resume", "reference", k_mesh, k_spp,
                ck_args + ["--resume"]))]
        ports = set()
        while len(ports) < len(jobs):
            ports.add(free_port())
        for j, port in zip(jobs, sorted(ports)):
            j["port"] = port
        reset_launches()
        t0 = time.perf_counter()
        (r0, a0), (r1, a1) = dist_run_ranks(jobs, tmp)
        phase(f"phase 13: two ranks over gloo on the card ran {len(jobs)} "
              f"jobs in {time.perf_counter() - t0:.1f} s (their start "
              f"included); card {card}")

        out["b"] = {}
        for i, (m, s) in enumerate(DIST_RENDERS):
            tag = f"phase 13b: {s} {W}x{H}x{SPP} --mesh {m}"
            for r in (r0[i], r1[i]):
                if r["error"] or r["rc"] != 0 \
                        or r["backend"] != f"megakernel@{m}":
                    raise AssertionError(f"{tag}: {r}")
            img = a0[f"{i}_img"]
            same(f"{tag}: rank 1 against rank 0", a1[f"{i}_img"], img)
            if img.shape != (H, W, 3) or not np.isfinite(img).all():
                raise AssertionError(f"{tag}: image is not finite [H, W, 3]")
            same(f"{tag}: against one process playing both ranks", img,
                 logical_render(s, m, SPP, dev)[0])
            walls = [r["render_wall_s"] for r in (r0[i], r1[i])]
            coll = [r["collective_s"] for r in (r0[i], r1[i])]
            phase(f"{tag}: both ranks' frames identical and bit-equal to "
                  f"one process playing both; driver walls "
                  f"{walls[0]:.3f} / {walls[1]:.3f} s, "
                  f"{r0[i]['msamples_per_s']:.1f} Msamples/s, "
                  f"{r0[i]['segments']} segments; all_reduce "
                  f"{coll[0]['all_reduce']:.4f} / {coll[1]['all_reduce']:.4f}"
                  f" s, all_gather {coll[0]['all_gather']:.4f} / "
                  f"{coll[1]['all_gather']:.4f} s, host votes "
                  f"{coll[0]['host']:.4f} / {coll[1]['host']:.4f} s; "
                  f"launches a rank {r0[i]['launches']} / "
                  f"{r1[i]['launches']}; card {card}")
            out["b"][f"{s} {m}"] = dict(
                walls=walls, msamples_per_s=r0[i]["msamples_per_s"],
                collective_s=coll,
                launches=[r0[i]["launches"], r1[i]["launches"]])

        i = len(DIST_RENDERS)
        tag = (f"phase 13c: make_sharded_megakernel_step, reference {W}x{H}, "
               f"{STEP_SPP} spp a step, mesh {DIST_STEP_MESH}")
        for k in ("colors", "emissions"):
            same(f"{tag}: rank 1's {k}", a1[f"{i}_{k}"], a0[f"{i}_{k}"])
        runs = r0[i]["runs"]
        if [r["losses"] for r in runs] != [r["losses"] for r in r1[i]["runs"]]:
            raise AssertionError(f"{tag}: the ranks' losses differ")
        for r in runs:
            phase(f"{tag}: seed ({r['seed']}, 0): losses "
                  f"{[float(f'{x:.6g}') for x in r['losses']]}")
        check_falls(f"{tag}, the mean over {len(runs)} seeds",
                    np.mean([r["losses"] for r in runs], axis=0).tolist())
        want, wcol = dist_step(dev, LogicalMesh(
            dist_mesh.parse_mesh(DIST_STEP_MESH)), seeds=DIST_STEP_SEEDS[:1])
        got = [torch.from_numpy((a0[f"{i}_{k}"][0, 0] - a0[f"{i}_{k}"][0, 1])
                                / DIST_STEP_LR) for k in ("colors",
                                                          "emissions")]
        ref = [torch.from_numpy((wcol[k][0, 0] - wcol[k][0, 1]) / DIST_STEP_LR)
               for k in ("colors", "emissions")]
        rule = grad_rule(got, ref, mesh=False)
        dt = float(np.median([t for r in runs for t in r["step_s"][1:]]))
        rate = W * H * STEP_SPP / dt / 1e6
        phase(f"{tag}: ranks identical; the first step's gradient against "
              f"one process playing both: gcol {rule['gcol']:.2e}, gemi "
              f"{rule['gemi']:.2e} of max (rule {GRAD_REL}); fwd+bwd "
              f"{rate:.1f} Msamples/s (median step {dt * 1e3:.2f} ms, both "
              f"ranks on the card); K6 launches a rank "
              f"{r0[i]['launches']['k6']}; card {card}")
        out["c"] = dict(losses=[r["losses"] for r in runs], rule=rule,
                        step_ms=dt * 1e3, msamples_per_s=rate, launches=[
                            r0[i]["launches"], r1[i]["launches"]])

        i += 1
        tag = (f"phase 13d: make_sharded_train_step, reference {W}x{H}x1, "
               f"mesh {DIST_TRAIN_MESH}")
        for k in ("color", "emission", "det_color", "det_emission",
                  "grad_color", "grad_emission"):
            same(f"{tag}: rank 1's {k}", a1[f"{i}_{k}"], a0[f"{i}_{k}"])
        want, wnew = dist_train(dev, LogicalMesh(
            dist_mesh.parse_mesh(DIST_TRAIN_MESH)), DIST_TRAIN_REPEATS)
        # torch's deterministic kernels: the same sums in the same order
        for k in ("det_color", "det_emission"):
            same(f"{tag}: deterministic kernels, {k} against one process "
                 f"playing both", a0[f"{i}_{k}"], wnew[k])

        def grads(got, j):
            return [torch.from_numpy(got[f"grad_{k}"][j])
                    for k in ("color", "emission")]
        rank0 = {k: a0[f"{i}_{k}"] for k in ("grad_color", "grad_emission")}
        rule = grad_rule(grads(rank0, 0), grads(wnew, 0), mesh=False)
        # the default kernels add in no fixed order: one process against
        # itself, step by step
        spread = [grad_rule(grads(wnew, j), grads(wnew, 0), mesh=False)
                  for j in range(1, DIST_TRAIN_REPEATS)]
        spread = {k: max(x[k] for x in spread) for k in ("gcol", "gemi")}
        phase(f"{tag}: ranks identical; under torch's deterministic kernels "
              f"bit-equal to one process playing both (their warnings: "
              f"{r0[i]['det_warnings'] or 'none'}); default kernels: the "
              f"gradient against one process gcol {rule['gcol']:.2e}, gemi "
              f"{rule['gemi']:.2e} of max (rule {GRAD_REL}), one process "
              f"against itself over {DIST_TRAIN_REPEATS} steps up to "
              f"{spread['gcol']:.2e} / {spread['gemi']:.2e}; loss "
              f"{r0[i]['loss']:.6g} (one process {want['loss']:.6g}); step "
              f"{r0[i]['wall_s']:.3f} s; peak memory a rank "
              f"{r0[i]['peak_bytes'] / 2**30:.3f} / "
              f"{r1[i]['peak_bytes'] / 2**30:.3f} GiB (one process "
              f"{want['peak_bytes'] / 2**30:.3f}); K5 launches a rank "
              f"{r0[i]['launches']['k5']}; card {card}")
        out["d"] = dict(rule=rule, spread=spread, loss=r0[i]["loss"],
                        wall_s=r0[i]["wall_s"],
                        peak_bytes=[r0[i]["peak_bytes"], r1[i]["peak_bytes"]],
                        launches=[r0[i]["launches"], r1[i]["launches"]])

        i += 1
        tag = (f"phase 13e: the driver under --mesh {k_mesh} with a "
               f"checkpoint, reference {W}x{H}x{k_spp}")
        full, stop, other, resume = (
            (r0[i + j], r1[i + j]) for j in range(4))
        for r in (*full, *resume):
            if r["error"] or r["rc"] != 0:
                raise AssertionError(f"{tag}: {r}")
        for r in stop:
            if not (r["error"] or "").startswith("DeviceFailure"):
                raise AssertionError(f"{tag}: the stop did not fail: {r}")
        for r in other:
            if "backend" not in (r["error"] or ""):
                raise AssertionError(f"{tag}: a resume under --mesh "
                                     f"{k_other} was not refused: {r}")
        same(f"{tag}: resumed against uninterrupted", a0[f"{i + 3}_img"],
             a0[f"{i}_img"])
        same(f"{tag}: rank 1's resumed image", a1[f"{i + 3}_img"],
             a0[f"{i}_img"])
        same(f"{tag}: the image rank 0 wrote", read_raw(os.path.join(
            tmp, "e_resume.raw")), a0[f"{i}_img"])
        phase(f"{tag}: stopped at chunk {k_stop} of {k_spp // 8}, resumed "
              f"bit-equal to the uninterrupted run ({resume[0]['segments']} "
              f"of {full[0]['segments']} segments); a resume under --mesh "
              f"{k_other} refused ({other[0]['error'][:90]}); card {card}")
        out["e"] = dict(segments=[full[0]["segments"],
                                  resume[0]["segments"]])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    renders = [(s, r) for i, (m, s) in enumerate(DIST_RENDERS)
               for r in (r0[i], r1[i])]
    out["launches"] = dict(
        k1=out["a"]["launches"]["k1"] + sum(
            r["launches"]["k1"] for s, r in renders if s == "reference"),
        k1_mesh=sum(r["launches"]["k1_mesh"] for s, r in renders),
        k1_tex=sum(r["launches"]["k1_tex"] for s, r in renders),
        k6=sum(x["k6"] for x in out["c"]["launches"]),
        k5=sum(x["k5"] for x in out["d"]["launches"]))
    phase(f"phase 13: sharded launches {out['launches']}; card {card}")
    if not all(out["launches"].values()):
        raise AssertionError("phase 13: a kernel of the sharded paths was "
                             "not launched")
    return out


# ---- phase 14: the host scene core (native.py, csrc/scenecore.cpp) --------

CORE_SCENES = ("teapot", "gopher", "glass", "size-check mesh")
CORE_BIG = (128, 260)        # a 66,040-triangle UV sphere, timed natively
CORE_TILES = 64              # K1-mesh's plain version: phase 5's 64 tiles


def core_scene(name: str, cfg, lat_lon=None):
    """A scene of phase 14: one of CORE_SCENES, or `teapot` with the UV
    sphere of lat_lon as its model."""
    if lat_lon is not None:
        return size_check_scene(cfg, get_scene, lat_lon)
    if name == "size-check mesh":
        return size_check_scene(cfg, get_scene)
    return get_scene(name, cfg)


@contextlib.contextmanager
def clocked(*targets):
    """Sum the host seconds of every call of each (module, function name)
    in `targets` while in the block, into the dict it yields (keyed by
    "module.name")."""
    spans, saved = {}, []
    for mod, name in targets:
        fn = getattr(mod, name)
        key = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"
        saved.append((mod, name, fn))

        def wrapped(*a, _fn=fn, _key=key, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                spans[_key] = spans.get(_key, 0.0) + time.perf_counter() - t0
        setattr(mod, name, wrapped)
    try:
        yield spans
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def core_equality(dev, card, given):
    """Each CORE_SCENES scene packed on the card natively and under
    PT_NATIVE=0 (`given`: {scene: those two (scene, arrays, meta, s)}
    already made): every SceneArrays tensor and SceneMeta field must be
    equal. Returns {scene: (native s, Python s)}, host seconds to load and
    pack."""
    cfg = RenderConfig(width=W, height=H, samples=8, samples_per_pass=8)
    out = {}
    for name in CORE_SCENES:
        packed = given.get(name, [])
        for env in ({}, {"PT_NATIVE": "0"})[len(packed):]:
            with env_vars(env, unset=("PT_NATIVE",)):
                t0 = time.perf_counter()
                sc = core_scene(name, cfg)
                arrays, meta = sc.pack(device=dev)
                torch.cuda.synchronize()
                packed.append((sc, arrays, meta, time.perf_counter() - t0))
        (nat, a, m, t_nat), (py, b, mb, t_py) = packed
        groups = [[o for o in sc.objects if isinstance(o, shapes.Group)
                   and o.n_triangles()] for sc in (nat, py)]
        if not (all(isinstance(g.soup, native.ObjData) for g in groups[0])
                and all(g.soup is None for g in groups[1])):
            raise AssertionError(f"phase 14: {name}: the two paths did not "
                                 "both run (scene core, then Python)")
        differ = [f for f in a._fields
                  if not torch.equal(getattr(a, f), getattr(b, f))]
        if differ or m != mb:
            raise AssertionError(f"phase 14: {name}: the scene core's pack "
                                 f"differs from PT_NATIVE=0's: fields "
                                 f"{differ}, meta equal {m == mb}")
        phase(f"phase 14: {name} ({n_triangles(nat)} triangles, leaf "
              f"{m.leaf_size}, {m.n_nodes} nodes): the {len(a._fields)} "
              f"SceneArrays tensors and {len(dataclasses.fields(m))} "
              f"SceneMeta fields equal with and without PT_NATIVE=0; load "
              f"and pack {t_nat:.4f} s natively, {t_py:.4f} s in Python "
              f"(host clock); card {card}")
        out[name] = (t_nat, t_py)
    return out


def setup_split(lat_lon, dev, python=False):
    """`teapot` with the UV sphere of lat_lon as its model, set up for a
    W x H x 8 spp launch on the mesh layout, split by host clock (s):
    parse, normals (the scene's: normals_groups=1), BVH build (the builder
    within it as `builder`), octant copies, tables (the rest of pack_scene
    and the kernel's tables and pixel layout on the card), the first
    launch (synchronized) and `other` (writing and reading the .obj, the
    scene's shapes, bounds). Under `python`, PT_NATIVE=0. Returns (split,
    the launch's inputs, its output, (scene, arrays, meta, seconds to load
    and pack))."""
    cfg = RenderConfig(width=W, height=H, samples=8, samples_per_pass=8)
    if python:
        keys = ("_models.parse_obj", "_models.compute_vertex_normals",
                "pack.build_bvh", "bvh._emit_python")
        targets = [(_models, "parse_obj"), (_models, "compute_vertex_normals"),
                   (pack, "build_bvh"), (bvh, "_emit_python")]
    else:
        keys = ("native.parse_obj", "native.vertex_normals",
                "pack.build_bvh_arrays", "native.build_bvh")
        targets = [(native, "parse_obj"), (native, "vertex_normals"),
                   (pack, "build_bvh_arrays"), (native, "build_bvh")]
    targets.append((pack, "octant_node_orders"))
    with env_vars({"PT_NATIVE": "0"} if python else {},
                  unset=("PT_NATIVE",)), clocked(*targets) as sp:
        t0 = time.perf_counter()
        sc = core_scene("teapot", cfg, lat_lon)
        t1 = time.perf_counter()
        arrays, meta = sc.pack(device=dev)
        torch.cuda.synchronize()
        t_pack = time.perf_counter()
        tabs, meta, _, layout = port_inputs(sc, cfg, MESH_TILE, dev,
                                            (arrays, meta))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    kw = dict(meta=meta, cfg=cfg, spp=8, total_samples=8, tile=MESH_TILE,
              **layout)
    t3 = time.perf_counter()
    out = torch.stack(mk.trace_tiles((1, 0), *tabs, **kw))
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    parse, normals, bvh_s, builder = (sp.get(k, 0.0) for k in keys)
    octants = sp.get("pack.octant_node_orders", 0.0)
    # native.parse_obj runs the normals' pass itself; the Python loader
    # calls compute_vertex_normals after its parse
    model = parse + normals if python else parse
    split = dict(triangles=n_triangles(sc), nodes=meta.n_nodes,
                 parse=model - normals, normals=normals, bvh=bvh_s,
                 builder=builder, octants=octants,
                 tables=(t2 - t1) - bvh_s - octants, first_launch=t4 - t3,
                 other=(t1 - t0) - model, total=t4 - t0)
    return split, (tabs, kw), out, (sc, arrays, meta, t_pack - t0)


def split_text(sp: dict) -> str:
    return (f"parse {sp['parse']:.6f}, normals {sp['normals']:.6f}, BVH "
            f"build {sp['bvh']:.6f} (builder {sp['builder']:.6f}), octant "
            f"copies {sp['octants']:.6f}, tables {sp['tables']:.6f}, first "
            f"launch {sp['first_launch']:.6f}, other {sp['other']:.6f}; "
            f"total {sp['total']:.6f} s")


def scene_core_phase(dev, card):
    """Phase 14: the scene core's packs equal PT_NATIVE=0's on CORE_SCENES
    (core_equality); K1-mesh on the natively built size-check mesh, one
    W x H x 8 spp launch, bit-equal to its plain version on the first
    CORE_TILES tiles; the set-up split (setup_split) of the size-check
    mesh natively and in Python (whose packs core_equality compares), and
    of the CORE_BIG sphere natively, with the vertex normals of every
    group timed apart (the scenes' own pass covers the model's first
    group, empty in a UV sphere). Returns the numbers for the kernels
    line."""
    native.library()
    torch.zeros(1, device=dev)          # the device's context, made
    torch.cuda.synchronize()
    splits, size_check = {}, []
    for tag, lat_lon, python in (
            ("size-check native", SIZE_CHECK_LAT_LON, False),
            ("size-check python", SIZE_CHECK_LAT_LON, True),
            ("uv-sphere-66040 native", CORE_BIG, False)):
        sp, (tabs, kw), k, packed = setup_split(lat_lon, dev, python)
        splits[tag] = sp
        if tag.startswith("size-check"):
            size_check.append(packed)
        phase(f"phase 14: set-up of {tag} ({sp['triangles']} triangles, "
              f"{sp['nodes']} nodes at leaf 4) on the card's host: "
              f"{split_text(sp)}; card {card}")
        if tag == "size-check native":
            sub = first_tiles(tabs, MESH_TILE, CORE_TILES)
            p = torch.stack(mk.trace_tiles_reference((1, 0), *sub, **kw))
            k = k[:, :CORE_TILES * MESH_TILE[0]]
            torch.cuda.synchronize()
            bit_eq = float((k == p).float().mean())
            err = float((k - p).abs().max())
            phase(f"phase 14: K1-mesh on the natively built size-check "
                  f"mesh, {W}x{H}x8 spp: bit-equal to its plain version on "
                  f"{bit_eq:.6f} of the first {CORE_TILES} tiles' slot "
                  f"values, max abs err {err:.3e}; card {card}")
            if bit_eq != 1.0:
                raise AssertionError("phase 14: K1-mesh differs from its "
                                     "plain version on the natively built "
                                     "size-check mesh")
    normals = {}
    for tag, lat_lon in (("size-check", SIZE_CHECK_LAT_LON),
                         ("uv-sphere-66040", CORE_BIG)):
        soup = native.parse_obj(uv_sphere_obj(*lat_lon, name="teapot"))
        t0 = time.perf_counter()
        native.vertex_normals(soup, -1)
        normals[tag] = time.perf_counter() - t0
    tris = objfile.parse_obj(uv_sphere_obj(*SIZE_CHECK_LAT_LON,
                                           name="teapot")).all_triangles()
    t0 = time.perf_counter()
    objfile.compute_vertex_normals(tris)
    normals["size-check python"] = time.perf_counter() - t0
    equal = core_equality(dev, card, {"size-check mesh": size_check})
    phase(f"phase 14: vertex normals of every group: size-check natively "
          f"{normals['size-check']:.6f} s, in Python "
          f"{normals['size-check python']:.6f} s; the 66040-triangle "
          f"sphere natively {normals['uv-sphere-66040']:.6f} s (host "
          f"clock); card {card}")
    return dict(equal_packs=list(equal), load_pack_s=equal, split_s=splits,
                normals_every_group_s=normals, k1_mesh_bit_equal=bit_eq,
                k1_mesh_max_abs_err=err)


def walk_rows(gwalks, wtrain, f32_walks, ptxas):
    """The kernels line's rows of the gradient kernel's walk instantiations
    (K6 in triangle mode on `teapot`, K6-tex on the textured teapot, each
    at its training step's launch size where it was held there, else at
    GRAD_SPP; its other size and, in triangle mode, the size-check mesh
    beside it) and of the f32-texel forward's walks (the textured teapot at
    8 spp), each with its launches in phase 7's run of its walk and its
    ptxas counts."""
    walks, mode1, _ = gwalks
    counts = ptxas_counts(ptxas)
    kinds = {"packet mode 2": "block-packet ", "ablated": "ablated ",
             "packet ablated": "block-packet ablated ",
             "packet mode 3": "warp-packet ",
             "warp ablated": "warp-packet ablated "}
    replaces = {"packet mode 2": "1543", "ablated": "1487",
                "packet ablated": "1487", "packet mode 3": "1984",
                "warp ablated": "1487"}
    words = {"packet mode 2": "packet", "ablated": "ablated",
             "packet ablated": "packet-ablated", "packet mode 3": "warp",
             "warp ablated": "warp-ablated"}
    keys = ("ms", "plain_ms", "bound_ms", "own_work_bound_ms", "max_abs_err")
    rows = []
    for walk in GRAD_WALKS:
        for mode, case, jax in (("tri", "teapot", "267,361"),
                                ("tex", "textured teapot", "267,65,361")):
            by_spp = walks[walk][case]
            spp = max(by_spp)
            r = by_spp[spp]
            row = {"name": f"grad-megakernel-{mode}-{words[walk]}",
                   "route": "cuda",
                   "source": "pathtracer_tpu_torch/csrc/megakernel.cu",
                   "replaces": f"pathtracer_tpu/render/pallas_grad.py:{jax}",
                   "walk_replaces": "pathtracer_tpu/render/pallas_kernel.py:"
                                    + replaces[walk],
                   "launches": wtrain[walk][f"K6 {mode}_launches"],
                   "max_abs_err": r["max_abs_err"],
                   "shape": f"{case} {W}x{H}x{spp}spp",
                   "ms": r["ms"], "plain_ms": r["plain_ms"],
                   "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                   "library_ms": None,
                   "own_work_bound_ms": r["own_work_bound_ms"],
                   "per_thread_ms": walks["per-thread"][case][spp]["ms"],
                   "ptxas": counts.get(
                       f"grad {'textured f32-texel ' * (mode == 'tex')}"
                       f"{kinds[walk]}mesh"),
                   "by_spp": {n: {k: x[k] for k in keys}
                              for n, x in by_spp.items()}}
            if mode == "tri":
                row["size_check"] = {n: {k: x[k] for k in keys} for n, x
                                     in walks[walk]["size-check"].items()}
                if walk == "packet mode 2":
                    row["mode_1"] = {k: mode1[k] for k in keys}
            rows.append(row)
    for walk, r in f32_walks.items():
        if walk == "per-thread":
            continue
        rows.append({"name": f"megakernel-tex-f32-{words[walk]}",
                     "route": "cuda",
                     "source": "pathtracer_tpu_torch/csrc/megakernel.cu",
                     "replaces": "pathtracer_tpu/render/pallas_kernel.py:999,"
                                 + replaces[walk],
                     "launches": wtrain[walk]["K1 texel_launches"],
                     "max_abs_err": r["err"], "bit_equal": True,
                     "shape": f"textured teapot {W}x{H}x8spp",
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": None,
                     "own_work_bound_ms": r["own_work_bound_ms"],
                     "ptxas": counts.get(
                         f"textured f32-texel {kinds[walk]}mesh"),
                     "per_thread_ms": f32_walks["per-thread"]["ms"]})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab-parent", metavar="DIR", action="append",
                    default=[],
                    help="A/B the K1 family (AB_CASES) against the "
                         "pathtracer_tpu_torch under DIR, on its own code "
                         "(phase 5); may be given more than once")
    ap.add_argument("--tex-split", metavar="DIR", action="append",
                    default=[],
                    help="time the texture path's split (phase 5) on the "
                         "pathtracer_tpu_torch under DIR too, e.g. a copy "
                         "made by tools/tex_variants.py; may be given more "
                         "than once")
    ap.add_argument("--grad-split", metavar="DIR", action="append",
                    default=[],
                    help="time the gradient kernel's rows (phase 6) on the "
                         "pathtracer_tpu_torch under DIR too, e.g. a copy "
                         "made by tools/grad_variants.py; may be given more "
                         "than once")
    ap.add_argument("--k1-split", metavar="DIR", action="append",
                    default=[],
                    help="time the forward kernel's rows (phase 5, K1_ROWS) "
                         "on the pathtracer_tpu_torch under DIR too, e.g. a "
                         "copy made by tools/k1_variants.py; may be given "
                         "more than once")
    ap.add_argument("--walk-split", metavar="DIR", action="append",
                    default=[],
                    help="time the packet walks' rows (phase 5, WALK_ROWS) "
                         "on the pathtracer_tpu_torch under DIR too, e.g. a "
                         "copy made by tools/walk_variants.py; may be given "
                         "more than once")
    ap.add_argument("--ab-chain", metavar="DIR,DIR,...", action="append",
                    default=[],
                    help="A/B the pathtracer_tpu_torch of each of these "
                         "trees against the one before it in the list, on "
                         "its own code (the packet walks' rows; phase 5); "
                         "may be given more than once, a chain each")
    ap.add_argument("--walk-only", action="store_true",
                    help="after the build, run the packet walks' phases, "
                         "their split and the A/B of --ab-parent and "
                         "--ab-chain alone and print no result lines")
    ap.add_argument("--k1-only", action="store_true",
                    help="after the build, run the forward kernel's split "
                         "and the A/B of --ab-parent alone and print no "
                         "result lines")
    ap.add_argument("--grad-only", action="store_true",
                    help="after the build, run the gradient kernel's phases "
                         "alone (the split, the curve, phase 6 against the "
                         "plain version on every walk, the walks' training "
                         "and f32-texel forward, the A/B of --ab-parent) "
                         "and print no result lines")
    ap.add_argument("--wavefront-only", action="store_true",
                    help="after the build, run the wavefront's phase 11 "
                         "alone and print no result lines")
    ap.add_argument("--k5-split", metavar="DIR", action="append",
                    default=[],
                    help="time the intersect kernel's main-path shapes "
                         "(--k5-only's split) on the pathtracer_tpu_torch "
                         "under DIR too, e.g. a copy made by "
                         "tools/k5_variants.py; may be given more than once")
    ap.add_argument("--k5-only", action="store_true",
                    help="after the build, run the intersect kernel's "
                         "split and the A/B of --ab-parent and --ab-chain "
                         "on its cases alone and print no result lines")
    ap.add_argument("--ad-only", action="store_true",
                    help="after the build, run the wavefront autograd "
                         "path's phase 12 alone (with --ab-parent: the "
                         "ptxas counts against those trees, no A/B) and "
                         "print no result lines")
    ap.add_argument("--dist-only", action="store_true",
                    help="after the build, run the multi-GPU phase 13 alone "
                         "and print no result lines")
    ap.add_argument("--scene-core-only", action="store_true",
                    help="after the build, run the host scene core's "
                         "phase 14 alone and print no result lines")
    ap.add_argument("--dist-rank", metavar="SPEC", default=None,
                    help=argparse.SUPPRESS)   # one rank of phase 13
    args = ap.parse_args(argv)
    if args.dist_rank:
        return dist_rank(args.dist_rank)
    # ---- phase 1: the card ----------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0] if smi else "unknown"
    phase(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("phase 1: no CUDA device visible; nothing to test")
    dev = torch.device("cuda:0")
    phase(f"phase 1: card {card}")

    # ---- phase 2: build the kernel library ------------------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the host scene core (csrc/scenecore.cpp) builds beside the nvccs
        core_build = pool.submit(_build.build_host, "scenecore")
        lib, plib = _build.build_all(["megakernel", "probes"])
        core_lib = core_build.result()
    phase(f"phase 2: built {lib.name} and {plib.name} (two nvcc at once) "
          f"and {core_lib.name} (the host's C++ compiler, beside them) in "
          f"{time.perf_counter() - t0:.1f} s")
    log = lib.with_suffix(".log")
    ptxas = ptxas_lines(log.read_text() if log.exists() else "")
    for line in ptxas + ptxas_lines(plib.with_suffix(".log").read_text()):
        phase(f"phase 2: ptxas: {line}")
    others = list(dict.fromkeys(args.ab_parent + args.tex_split
                                + args.grad_split + args.k1_split
                                + args.walk_split + args.k5_split
                                + [d for c in args.ab_chain
                                   for d in c.split(",")]))
    if others:
        t0 = time.perf_counter()
        prebuild(others)
        phase(f"phase 2: built the kernels of {len(others)} other trees "
              f"({len(others)} nvcc at once) in "
              f"{time.perf_counter() - t0:.1f} s")
    if args.scene_core_only:
        scene_core_phase(dev, card)
        return 0
    # P2 first: the bounds of every later phase divide by its rate
    p2_rates, p2_row = op_rate_phase(dev, card)
    if args.grad_only:
        grad_only(args, dev, card, ptxas)
        return 0
    if args.k1_only:
        k1_only(args, dev, card, ptxas)
        return 0
    if args.walk_only:
        walk_only(args, dev, card, ptxas)
        return 0
    if args.wavefront_only:
        wavefront_phases(dev, card, ptxas)
        return 0
    if args.ad_only:
        ad_phases(args, dev, card, ptxas)
        return 0
    if args.k5_only:
        k5_only(args, dev, card, ptxas)
        return 0
    if args.dist_only:
        dist_phase(dev, card)
        return 0

    # ---- phase 14: the host scene core (every mesh scene below uses it) --
    core = scene_core_phase(dev, card)

    # ---- phase 3: kernel vs plain version on the card -------------------
    small = RenderConfig(width=160, height=120, samples=16,
                         samples_per_pass=16)
    dof = small.replace(aperture=0.1, focal_length=1.6)
    cases = [
        ("reference", get_scene("reference", small), small, 0),
        ("transparency_f_light", get_scene("transparency_f_light", small),
         small, 0),
        ("cylinder", cylinder_scene(small, gx, material, shapes, pack,
                                    cornell), small, 0),
        ("reference dof", get_scene("reference", dof), dof, 16),
    ]
    errs = []
    for name, sc, cfg, base in cases:
        errs.append(compare(name, sc, cfg, TILE, base, dev)[0])

    # mesh scenes with the driver's mesh layout: tile (8, 512), block
    # order, 4 sample replicas on the lane chunks; bit for bit
    msmall = small.replace(samples=8, samples_per_pass=8)
    mdof = msmall.replace(aperture=0.1, focal_length=1.6)
    mesh_cases = [(n, get_scene(n, msmall), msmall, 0) for n in (
        "teapot", "default", "glass", "transparent_teapot", "gopher-window")]
    mesh_cases += [
        ("teapot dof", get_scene("teapot", mdof), mdof, 16),
        ("size-check mesh", size_check_scene(msmall, get_scene), msmall, 0),
    ]
    mesh_errs, mesh_tris = [], {}
    for name, sc, cfg, base in mesh_cases:
        mesh_errs.append(compare(name, sc, cfg, MESH_TILE, base, dev,
                                 exact=True)[0])
        mesh_tris[name] = n_triangles(sc)

    # textured scenes on the scene's own tile, the first 64 tiles of the
    # full size; bit for bit
    tcfg = RenderConfig(width=W, height=H, samples=8, samples_per_pass=8)
    tex_errs = [compare(name, get_scene(name, tcfg), tcfg, None, 0, dev,
                        exact=True, tiles=64)[0] for name in TEX_SCENES]
    # the fetches' wrap without a division, against the JAX formula
    wrap = wrap_phase(dev, card)
    # the object loop's filter, against the exact tests
    filt = filter_phase(dev, card)

    # NEE (the kNee instantiations) bit for bit: 1, 4 and 3 lights, the
    # mesh shadow walk on the driver's mesh layout, the textured
    # instantiations (`cubemap`: textured and mesh), depth of field and
    # per-slot draws (PT_COHERENT=0), and the shadow query's ties: each
    # light with a copy of itself after it and before it (tie_scene), on
    # the primitive and the mesh instantiation
    nsmall = small.replace(nee=True)
    nmesh = msmall.replace(nee=True)
    nee_cases = [(n, get_scene(n, nsmall), nsmall, TILE, 0) for n in (
        "reference", "transparency_quad_lights", "transparency_f_light")]
    nee_cases += [
        ("teapot", get_scene("teapot", nmesh), nmesh, MESH_TILE, 0),
        ("textures", get_scene("textures", nmesh), nmesh, None, 0),
        ("cubemap", get_scene("cubemap", nmesh), nmesh, None, 0),
        ("reference dof", get_scene("reference", dof.replace(nee=True)),
         dof.replace(nee=True), TILE, 16),
        ("tie", tie_scene(nsmall, get_scene), nsmall, TILE, 0),
        ("tie mesh", tie_scene(nmesh, get_scene, "teapot"), nmesh,
         MESH_TILE, 0)]
    nee_errs = [compare(f"nee {name}", sc, cfg, tile, base, dev,
                        exact=True)[0]
                for name, sc, cfg, tile, base in nee_cases]
    with env_var("PT_COHERENT", "0"):
        nee_errs.append(compare("nee reference, PT_COHERENT=0",
                                get_scene("reference", nsmall), nsmall, TILE,
                                0, dev, exact=True)[0])
    # the light point's sin/cos: one sincosf an angle in the kernel,
    # torch.sin and torch.cos in the plain version, on every f32 angle
    t0 = time.perf_counter()
    n_ang, bad = sincos_mismatches(mk.light_sincos, dev)
    sincos = dict(angles=n_ang, differing=bad,
                  seconds=time.perf_counter() - t0)
    phase(f"phase 3 nee: light_sincos (sincosf) against torch.sin and "
          f"torch.cos on {n_ang} f32 angles (latitudes -3 .. -2 pi, "
          f"longitudes 0 .. 2 pi): {bad} differ; {sincos['seconds']:.2f} s")
    if bad:
        raise AssertionError("phase 3: the light point's sincosf differs "
                             "from torch.sin / torch.cos")
    # the mesh walks of the JAX package's knobs (Kernels A and B)
    walk_errs, leaf_check = walk_compare(dev, msmall, nmesh)

    with tempfile.TemporaryDirectory() as tmp:
        # ---- phase 4: the main paths: reference, teapot, textures -------
        ref = reference_main_path(tmp, dev, card)
        tea = teapot_main_path(tmp, dev, card, mesh_tris)
        tex_main = tex_main_path(tmp, dev, card)
        # ---- phase 4 (NEE): reference --nee and teapot --nee ------------
        ref_nee = reference_main_path(tmp, dev, card, nee=True)
        tea_nee = teapot_main_path(tmp, dev, card, mesh_tris, nee=True)
        # ---- phase 4 (the walks): teapot under the knobs, this slice's --
        walk_main = {tag: variant_main_path(tmp, dev, card, tag, env, tea)
                     for tag, env in MAIN_WALKS}
    # the other meshes at the JAX package's leaf size, with and without NEE
    leaf_diff = {"teapot": tea["leaf_diff"],
                 "teapot --nee": tea_nee["leaf_diff"], **leaf_counts(dev, card)}
    errs.append(ref["err"])
    mesh_errs.append(tea["err"])
    tex_errs.append(tex_main["err"])
    nee_errs += [ref_nee["err"], tea_nee["err"]]
    launches, bit_eq, frac = ref["launches"], ref["bit_eq"], ref["frac"]
    seed, tabs, kw, p_ms = ref["seed"], ref["tabs"], ref["kw"], ref["p_ms"]
    seg_spp, seg_counts = kw["spp"], ref["counts"]
    tabs8, kw8 = ref["tabs8"], ref["kw8"]
    mseed, mtabs, mkw = tea["seed"], tea["tabs"], tea["kw"]
    t_mesh, t_bit_eq, checked = tea["mesh"], tea["bit_eq"], tea["checked"]
    full, tp_ms, p64_ms, mcounts = (tea["full"], tea["p_ms"], tea["p64_ms"],
                                    tea["counts"])

    # ---- phase 5: kernel vs plain time ----------------------------------
    k_ms = cuda_ms(lambda: mk.trace_tiles(seed, *tabs, **kw), 5)
    k8_ms = cuda_ms(lambda: mk.trace_tiles((1, 0), *tabs8, **kw8), 10)
    p8_ms = cuda_ms(lambda: mk.trace_tiles_reference((1, 0), *tabs8, **kw8),
                    2)
    phase(f"phase 5: reference {W}x{H}x{seg_spp} spp (one segment): kernel "
          f"{k_ms:.3f} ms ({W * H * seg_spp / k_ms / 1e3:.1f} Msamples/s), "
          f"plain {p_ms:.3f} ms; card {card}")
    phase(f"phase 5: reference {W}x{H}x8 spp: kernel {k8_ms:.4f} ms "
          f"({W * H * 8 / k8_ms / 1e3:.1f} Msamples/s), plain {p8_ms:.3f} "
          f"ms; card {card}")
    tk_ms = cuda_ms(lambda: mk.trace_tiles(mseed, *mtabs, **mkw), 10)
    tp_txt = (f"plain {tp_ms:.1f} ms" if tp_ms is not None else
              f"plain not run at full size (first 64 tiles {p64_ms:.1f} ms)")
    phase(f"phase 5: teapot ({mesh_tris['teapot']} triangles) {W}x{H}x8 "
          f"spp: kernel {tk_ms:.4f} ms ({W * H * 8 / tk_ms / 1e3:.1f} "
          f"Msamples/s), {tp_txt}; card {card}")

    # the size-check mesh at the benchmark size: 16640 triangles, leaf 16
    scfg = RenderConfig(width=W, height=H, samples=8, samples_per_pass=8)
    stabs, smeta, _, slay = port_inputs(size_check_scene(scfg, get_scene),
                                        scfg, MESH_TILE, dev)
    skw = dict(meta=smeta, cfg=scfg, spp=8, total_samples=8,
               tile=MESH_TILE, **slay)
    sk_ms = cuda_ms(lambda: mk.trace_tiles((1, 0), *stabs, **skw), 5)
    s_tiles = stabs[-2].shape[0] // MESH_TILE[0]
    sp64, sp64_ms, sfull = plain_affordable("phase 5", (1, 0), stabs, skw,
                                            s_tiles, 64)
    sk = torch.stack(mk.trace_tiles((1, 0), *stabs, **skw))
    if sfull:
        sp, sp_ms = timed(lambda: mk.trace_tiles_reference((1, 0), *stabs,
                                                           **skw))
        s_checked = "every slot"
    else:
        sp, sp_ms = sp64, None
        sk = sk[:, :64 * MESH_TILE[0]]
        s_checked = "the first 64 tiles"
    torch.cuda.synchronize()
    s_bit_eq = float((sk == sp).float().mean())
    mesh_errs.append(float((sk - sp).abs().max()))
    sp_txt = (f"plain {sp_ms:.1f} ms" if sp_ms is not None else
              f"plain not run at full size (first 64 tiles {sp64_ms:.1f} ms)")
    phase(f"phase 5: size-check mesh ({mesh_tris['size-check mesh']} "
          f"triangles, leaf {smeta.leaf_size}, {smeta.n_nodes} nodes) "
          f"{W}x{H}x8 spp: kernel {sk_ms:.4f} ms "
          f"({W * H * 8 / sk_ms / 1e3:.1f} Msamples/s), {sp_txt}; "
          f"bit-equal on {s_bit_eq:.6f} of {s_checked}; card {card}")
    if s_bit_eq != 1.0:
        raise AssertionError("phase 5: kernel differs from the plain "
                             "version on the size-check mesh")
    k1_bound = fwd_bound(seg_counts, tabs, kw)
    mesh_bound = fwd_bound(mcounts, mtabs, mkw)
    mesh_jax_bound = fwd_bound(mcounts, mtabs, mkw, jax=True)
    phase(f"phase 5: bounds: reference {W}x{H}x{seg_spp} spp "
          f"{k1_bound[0]:.4f} ms ({k1_bound[1]}; {k1_bound[2]:.4g} f32 ops), "
          f"teapot {W}x{H}x8 spp {mesh_bound[0]:.4f} ms ({mesh_bound[1]}; "
          f"{mesh_bound[2]:.4g} f32 ops; the JAX kernel's object loop "
          f"{mesh_jax_bound[0]:.4f} ms, {mesh_jax_bound[2]:.4g} ops"
          f"{'' if full else ', from the first 64 tiles scaled'}); card {card}")

    # textured timings, the fetch probe, the JAX package's mip
    tex_times = tex_timing(tex_main, dev, card)
    probe = fetch_probe(dev, card)
    split_trees, split_ptxas = [("this", THIS_TREE)], {
        "this": ptxas_counts(ptxas)}
    for i, d in enumerate(args.tex_split):
        T = load_tree(d, f"split_tree_{i}")
        T.mk.library()
        split_trees.append((d, T))
        split_ptxas[d] = ptxas_counts(ptxas_lines(
            T.build._target("megakernel").with_suffix(".log").read_text()))
    tsplit = tex_split(split_trees, tex_times, probe, split_ptxas, dev, card)
    mip_blur(dev, card)
    # NEE: K1-nee beside K1 on the same samples, and what a runtime branch
    # would cost the renders without NEE
    nee_times = nee_timing(ref_nee, tea_nee, card)
    # the per-thread NEE instantiations, whose shadow rays ask light_visible
    query_ptxas = {k: v for k, v in ptxas_counts(ptxas).items()
                   if "nee" in k.split() and "packet" not in k}
    phase(f"phase 5 nee: ptxas (registers, stack, spill stores, spill "
          f"loads) of the per-thread NEE instantiations (light_visible): "
          f"{query_ptxas}")
    branch = branch_cost({
        f"reference {W}x{H}x8 spp": ((1, 0), tabs8, kw8),
        f"teapot {W}x{H}x8 spp": (mseed, mtabs, mkw),
        f"textures {W}x{H}x8 spp": (tex_main["seed"], tex_main["tabs"],
                                    tex_main["kw"])}, ptxas, card)
    ab = {}
    for i, d in enumerate(args.ab_parent):
        phase(f"phase 5 A/B: against {d}")
        ab[d] = ab_parent(d, f"ab_tree_{i}", {**AB_CASES, **WALK_AB_CASES},
                          dev, card, ptxas)
        check_forward_ptxas(d, ab[d][1])
        for name in ("reference", "teapot"):
            pm, tm = ab[d][0][f"K1-nee {name} {W}x{H}x8 spp"]
            phase(f"phase 5 nee: {name}: K1-nee {tm:.4f} ms against "
                  f"{d}'s {pm:.4f} ms ({tm / pm:.3f}x), in turns; card "
                  f"{card}")

    # the forward kernel's split (this tree and --k1-split's)
    k1split = k1_phases(args, dev, card, ptxas)

    # the mesh walks, each on the same samples, with K1-mesh's bound
    walk_times = walk_timing(dev, card)
    wsplit = walk_phases(args, dev, card, ptxas)
    split = split_phase(walk_times, k8_ms, {"reference": kw8["meta"],
                                            "teapot": mkw["meta"]}, card)
    sweep = leaf_sweep(dev, card)

    grads, curve, gsplit, gwalks, shared = grad_phases(args, dev, card,
                                                      mesh_tris, ptxas)
    g_ref, g_tea, g_big, g_tex = grads[GRAD_SPP]
    rate, trate, k6_obj, k6_tri = training_phase(dev, card, mesh_tris)
    # ---- phase 7 (the walks): training under the JAX walk knobs ---------
    wtrain = walk_training(dev, card, mesh_tris)

    # ---- phase 8: the texel path (K6-tex, f32 texels) -------------------
    f32_fwd = tex_forward(dev, card)
    f32_walks = tex_forward_walks(dev, card)
    phase(f"phase 8: K6-tex {g_tex['ms']:.4f} ms vs K6 on reference "
          f"{g_ref['ms']:.4f} ms for the same {W}x{H}x{GRAD_SPP} samples "
          f"({g_tex['ms'] / g_ref['ms']:.2f}x); card {card}")
    tex_train = tex_training(dev, card)

    # ---- phase 9: the intersect-only kernel (K5) --------------------------
    isect = intersect_phase(dev, card)
    isect_walks, isect_walk_n = intersect_walks(dev, card)

    # ---- phase 10: the probes (P3; P2 ran in phase 2) --------------------
    leaf_rates, p3_row = leaf_phase(dev, card, walk_times["teapot"])
    for v, r in p2_rates.items():
        phase(f"phase 10 P2: {v}: {r['ops_per_s']:.4e} ops/s; card {card}")
    a_main = [walk_main[t] for t, _ in MAIN_WALKS[:2]]
    b_main = walk_main[MAIN_WALKS[2][0]]
    tw = walk_times["teapot"]

    # ---- phase 11: the wavefront forward on K5, the bench, the profile ---
    wf = wavefront_phases(dev, card, ptxas)
    # ---- phase 12: the wavefront autograd path on K5 ---------------------
    ad = ad_phases(args, dev, card, ptxas)
    # ---- phase 13: multi-GPU rendering and training (parallel/) ----------
    dist = dist_phase(dev, card)
    dl = dist["launches"]

    print(json.dumps({"kernels": [
        {"name": "megakernel", "route": "cuda",
         "source": "pathtracer_tpu_torch/csrc/megakernel.cu",
         "replaces": "pathtracer_tpu/render/pallas_kernel.py:1903",
         "launches": launches, "max_abs_err": max(errs),
         "bit_equal_frac": bit_eq, "slot_frac_within_tol": frac,
         "shape": f"{W}x{H}x{seg_spp}spp", "ms": k_ms, "plain_ms": p_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": None,
         "ms_8spp": k8_ms, "plain_ms_8spp": p8_ms,
         "k1_split": {"ms": k1split[0], "ptxas": k1split[1]},
         "filter_check": filt,
         "sharded": {"launches": dl["k1"], "a": dist["a"],
                     "b": dist["b"], "e": dist["e"]}},
        {"name": "megakernel-mesh", "route": "cuda",
         "source": "pathtracer_tpu_torch/csrc/megakernel.cu",
         "replaces": "pathtracer_tpu/render/pallas_kernel.py:1334,1256,1231",
         "launches": t_mesh, "max_abs_err": max(mesh_errs),
         "bit_equal_frac": t_bit_eq, "checked": checked,
         "shape": f"teapot {W}x{H}x8spp", "ms": tk_ms,
         "plain_ms": tp_ms if full else p64_ms,
         "bound_ms": mesh_bound[0], "bound_by": mesh_bound[1],
         "library_ms": None, "jax_work_bound_ms": mesh_jax_bound[0],
         "plain_shape": (f"teapot {W}x{H}x8spp" if full
                         else "teapot first 64 tiles x8spp"),
         "plain_ms_first_64_tiles": p64_ms,
         "size_check_ms": sk_ms,
         "size_check_plain_ms": sp_ms if sfull else sp64_ms,
         "size_check_plain_shape": (f"{W}x{H}x8spp" if sfull
                                    else "first 64 tiles x8spp"),
         "size_check_bit_equal_frac": s_bit_eq,
         "triangles": mesh_tris, "ptxas": ptxas, "split": split,
         "sharded_launches": dl["k1_mesh"],
         "leaf_sweep": sweep, "leaf": mkw["meta"].leaf_size,
         "slots_differing_at_jax_leaf": leaf_diff, "scene_core": core,
         "ab_parent": {d: {"ms": {k: list(v) for k, v in a[0].items()},
                           "ptxas": {k: [list(x) if x else None for x in v]
                                     for k, v in a[1].items()},
                           "sass_differ": a[2].get("differ"),
                           "fwd_bwd_msamples_per_s": {
                               k: list(v) for k, v in a[3].items()}}
                       for d, a in ab.items()}},
        {"name": "grad-megakernel", "route": "cuda",
         "source": "pathtracer_tpu_torch/csrc/megakernel.cu",
         "replaces": "pathtracer_tpu/render/pallas_grad.py:267",
         "launches": k6_obj, "max_abs_err": g_ref["max_abs_err"],
         "gcol_rel_err": g_ref["gcol"], "gemi_rel_err": g_ref["gemi"],
         "shape": f"reference {W}x{H}x{GRAD_SPP}spp", "ms": g_ref["ms"],
         "plain_ms": g_ref["plain_ms"], "bound_ms": g_ref["bound_ms"],
         "bound_by": g_ref["bound_by"], "library_ms": None,
         "relaunch_bit_identical": g_ref["same_bits"],
         "at_step_spp": main_size(grads, 0), "spp_curve": curve["K6 reference"],
         "split": gsplit,
         "fwd_bwd_msamples_per_s": rate,
         "sharded": {"launches": dl["k6"], "step": dist["c"]},
         "fwd_bwd_shape": f"reference {W}x{H}x{STEP_SPP}spp x 3 steps",
         "row_shared_draws": shared},
        {"name": "grad-megakernel-tri", "route": "cuda",
         "source": "pathtracer_tpu_torch/csrc/megakernel.cu",
         "replaces": "pathtracer_tpu/render/pallas_grad.py:267,221",
         "launches": k6_tri,
         "max_abs_err": max(g_tea["max_abs_err"], g_big["max_abs_err"]),
         "gtri_slot_frac": g_tea["gtri_frac"],
         "shape": f"teapot {W}x{H}x{GRAD_SPP}spp", "ms": g_tea["ms"],
         "plain_ms": g_tea["plain_ms"], "bound_ms": g_tea["bound_ms"],
         "bound_by": g_tea["bound_by"], "library_ms": None,
         "relaunch_bit_identical": g_tea["same_bits"],
         "at_step_spp": main_size(grads, 1),
         "spp_curve": curve["K6 teapot triangles"],
         "size_check_at_step_spp": main_size(grads, 2),
         "size_check_ms": g_big["ms"],
         "size_check_plain_ms": g_big["plain_ms"],
         "size_check_gtri_slot_frac": g_big["gtri_frac"],
         "fwd_bwd_msamples_per_s": trate,
         "fwd_bwd_shape": f"teapot {W}x{H}x{TRI_STEP_SPP}spp x 3 steps"},
        {"name": "megakernel-tex", "route": "cuda",
         "source": "pathtracer_tpu_torch/csrc/megakernel.cu",
         "replaces": "pathtracer_tpu/render/pallas_kernel.py:968,999,1130",
         "launches": tex_main["launches"], "max_abs_err": max(tex_errs),
         "bit_equal_frac": tex_main["bit_eq"],
         "shape": f"textures {W}x{H}x8spp",
         "ms": tex_times["textures"]["ms"],
         "plain_ms": tex_times["textures"]["plain_ms"],
         "bound_ms": tex_times["textures"]["bound_ms"],
         "bound_by": tex_times["textures"]["bound_by"], "library_ms": None,
         "jax_work_bound_ms": tex_times["textures"]["jax_work_bound_ms"],
         "by_scene": tex_times, "fetch_probe": probe, "split": tsplit,
         "sharded_launches": dl["k1_tex"],
         "wrap_check": wrap},
        {"name": "megakernel-tex-f32", "route": "cuda",
         "source": "pathtracer_tpu_torch/csrc/megakernel.cu",
         "replaces": "pathtracer_tpu/render/pallas_kernel.py:999,1130",
         "launches": tex_train["texel"], "max_abs_err": f32_fwd["err"],
         "bit_equal_to_rgb8": True, "shape": f"{TEX_TRAIN} {W}x{H}x8spp",
         "ms": f32_fwd["ms"], "rgb8_ms": f32_fwd["rgb8_ms"],
         "plain_ms": f32_fwd["plain_ms"], "bound_ms": f32_fwd["bound_ms"],
         "bound_by": f32_fwd["bound_by"], "library_ms": None,
         "jax_work_bound_ms": f32_fwd["jax_work_bound_ms"]},
        {"name": "grad-megakernel-tex", "route": "cuda",
         "source": "pathtracer_tpu_torch/csrc/megakernel.cu",
         "replaces": "pathtracer_tpu/render/pallas_grad.py:267,65,148",
         "launches": tex_train["tex"], "max_abs_err": g_tex["max_abs_err"],
         "gcol_rel_err": g_tex["gcol"], "gemi_rel_err": g_tex["gemi"],
         "gtex_touched_frac": g_tex["gtex_frac"],
         "gtex_touched": g_tex["gtex_touched"],
         "gtex_sum_rel_err": g_tex["gtex_sum_rel"],
         "texel_scatters": g_tex["scatters"],
         "shape": f"{TEX_TRAIN} {W}x{H}x{GRAD_SPP}spp", "ms": g_tex["ms"],
         "plain_ms": g_tex["plain_ms"], "bound_ms": g_tex["bound_ms"],
         "bound_by": g_tex["bound_by"], "library_ms": None,
         "relaunch_bit_identical": g_tex["same_bits"],
         "at_step_spp": main_size(grads, 3),
         "spp_curve": curve["K6-tex textures-train"],
         "vs_k6_reference": g_tex["ms"] / g_ref["ms"],
         "fwd_bwd_msamples_per_s": tex_train["rate"],
         "fwd_bwd_shape": f"{TEX_TRAIN} {W}x{H}x{STEP_SPP}spp x 3 steps",
         "train_losses": tex_train["losses"],
         "train_texel_mad": tex_train["mad"]},
        *walk_rows(gwalks, wtrain, f32_walks, ptxas),
        {"name": "megakernel-nee", "route": "cuda",
         "source": "pathtracer_tpu_torch/csrc/megakernel.cu",
         "replaces": "pathtracer_tpu/render/pallas_kernel.py:2421",
         "launches": ref_nee["nee"] + tea_nee["nee"],
         "launches_by_scene": {"reference": ref_nee["nee"],
                               "teapot": tea_nee["nee"]},
         "max_abs_err": max(nee_errs), "bit_equal_frac": ref_nee["bit_eq"],
         "shape": f"reference {W}x{H}x8spp", "ms": nee_times["reference"]["ms"],
         "plain_ms": nee_times["reference"]["plain_ms"],
         "bound_ms": nee_times["reference"]["bound_ms"],
         "bound_by": nee_times["reference"]["bound_by"], "library_ms": None,
         "by_scene": nee_times,
         "msamples_per_s": {"reference": ref_nee["metrics"]["msamples_per_sec"],
                            "teapot": tea_nee["metrics"]["msamples_per_sec"]},
         "runtime_branch_ms": {k: {"flag": v[0], "branch": v[1]}
                               for k, v in branch[0].items()},
         "ptxas_nee_vs_twin": {k: [list(a), list(b) if b else None]
                               for k, (a, b) in branch[1].items()},
         "jax_work_bound_ms": nee_times["reference"]["jax_work_bound_ms"],
         "sincos_check": sincos,
         "shadow_shares": {n: nee_times[n]["shares"] for n in nee_times},
         "ptxas_query": {k: list(v) for k, v in query_ptxas.items()},
         "ptxas_nee_parent": {d: {k: list(v[0]) for k, v in a[1].items()
                                  if "nee" in k.split()}
                              for d, a in ab.items()},
         "parent_ms": {d: {k: v[0] for k, v in a[0].items() if "K1-nee" in k}
                       for d, a in ab.items()}},
        {"name": "intersect", "route": "cuda",
         "source": "pathtracer_tpu_torch/csrc/megakernel.cu",
         "replaces": "pathtracer_tpu/render/pallas_kernel.py:2690",
         "launches": wf["launches"],
         "launches_by_path": {k: v["launches"] for k, v in wf["main"].items()},
         "max_abs_err": max(v["err"] for v in isect[1].values()),
         "bit_equal_frac": 1.0,
         "shape": f"reference primary {W * H * 8} rays",
         "ms": isect[1]["reference primary"]["ms"],
         "kernel_ms": isect[1]["reference primary"]["kernel_ms"],
         "host_ms": isect[1]["reference primary"]["host_ms"],
         "plain_ms": isect[1]["reference primary"]["plain_ms"],
         "bound_ms": isect[1]["reference primary"]["bound_ms"],
         "bound_by": isect[1]["reference primary"]["bound_by"],
         "library_ms": None, "by_batch": isect[1],
         "wavefront_bounce_1": wf["bounces"], "ptxas": wf["ptxas"],
         "wavefront_main": wf["main"], "wavefront_f64": wf["f64"],
         "profile_split": wf["split"], "phase9_launches": isect[0],
         "by_walk": isect_walks, "walk_launches": list(isect_walk_n),
         "sharded": {"launches": dl["k5"], "train_step": dist["d"]},
         "ad_path": {
             "launches": {s: v["launches"] for s, v in ad["main"].items()},
             "launches_a_step": {s: v["launches_a_step"]
                                 for s, v in ad["main"].items()},
             "forward_launches": {s: v["forward_launches"]
                                  for s, v in ad["main"].items()},
             "recompute_launches": {s: v["recompute_launches"]
                                    for s, v in ad["main"].items()},
             "rematerialized": {s: v["rematerialized"]
                                for s, v in ad["main"].items()},
             "remat": ad["remat"],
             "ms_bounce_1": {s: v["k5"]["ms"] for s, v in ad["main"].items()},
             "kernel_ms_bounce_1": {s: v["k5"]["kernel_ms"]
                                    for s, v in ad["main"].items()},
             "host_ms_bounce_1": {s: v["k5"]["host_ms"]
                                  for s, v in ad["main"].items()},
             "plain_ms_bounce_1": {s: v["k5"]["plain_ms"]
                                   for s, v in ad["main"].items()},
             "bound_ms_bounce_1": {s: v["k5"]["bound_ms"]
                                   for s, v in ad["main"].items()},
             "shape": f"{W}x{H}x{AD_SPP}spp, {AD_TIMED} timed steps",
             "fwd_bwd_msamples_per_s": {s: v["msamples_per_s"]
                                        for s, v in ad["main"].items()},
             "peak_bytes": {s: v["peak_bytes"] for s, v in ad["main"].items()},
             "reattach_calls": {s: v["reattach_calls"]
                                for s, v in ad["main"].items()},
             "live_rays": {s: v["live_rays"] for s, v in ad["main"].items()},
             "route_vs_walk": ad["route_vs_walk"],
             "estimators": ad["estimators"], "demo": ad["demo"]}},
        {"name": "megakernel-mesh-packet", "route": "cuda",
         "source": "pathtracer_tpu_torch/csrc/megakernel.cu",
         "replaces": "pathtracer_tpu/render/pallas_kernel.py:1543,1403,1984",
         "launches": sum(m["packet"] for m in a_main),
         "max_abs_err": max(walk_errs["A"] + [m["err"] for m in a_main]),
         "bit_equal_frac": min(m["bit_eq"] for m in a_main),
         "shape": f"teapot {W}x{H}x8spp (packet mode 2)",
         "ms": tw["packet mode 2"]["ms"],
         "plain_ms": a_main[0]["p_ms"],
         "bound_ms": tw["packet mode 2"]["bound_ms"],
         "bound_by": tw["packet mode 2"]["bound_by"], "library_ms": None,
         "main_path": {t: {k: walk_main[t][k] for k in (
             "launches", "msamples", "wall", "mean_rel", "bit_eq", "p_ms")}
             for t, _ in MAIN_WALKS},
         "by_walk": walk_times, "walk_split": wsplit[0]},
        {"name": "megakernel-mesh-mma", "route": "cuda",
         "source": "pathtracer_tpu_torch/csrc/megakernel.cu",
         "replaces": "pathtracer_tpu/render/pallas_kernel.py:1678,347",
         "launches": b_main["mma"],
         "max_abs_err": max(walk_errs["B"] + [b_main["err"]]),
         "bit_equal_frac": b_main["bit_eq"],
         "slot_frac_within_tol": b_main["frac"],
         "shape": f"teapot {W}x{H}x8spp", "ms": tw["tensor core"]["ms"],
         "plain_ms": b_main["p_ms"], "bound_ms": tw["tensor core"]["bound_ms"],
         "bound_by": tw["tensor core"]["bound_by"], "library_ms": None,
         "leaf_check": leaf_check},
        {"name": "op-rate-probe", "route": "cuda",
         "source": "pathtracer_tpu_torch/csrc/probes.cu",
         "replaces": "tools/vpu_peak_probe.py:37",
         "launches": p2_row["launches"],
         "max_abs_err": max([p2_row["max_abs_err"]] + [
             r["max_abs_err"] for r in p2_rates.values()]),
         "shape": f"mul_par8 {op_rate.THREADS} threads x 100 iterations",
         "ms": p2_row["ms"], "plain_ms": p2_row["plain_ms"],
         "bound_ms": p2_row["bound_ms"], "bound_by": p2_row["bound_by"],
         "library_ms": None,
         "ops_per_s": {v: r["ops_per_s"] for v, r in p2_rates.items()},
         "bound_rate": bound_rate},
        {"name": "leaf-bench", "route": "cuda",
         "source": "pathtracer_tpu_torch/csrc/megakernel.cu",
         "replaces": "tools/leaf_microbench.py:59",
         "launches": p3_row["launches"], "max_abs_err": p3_row["max_abs_err"],
         "shape": (f"prod {leaf_bench.RAYS} rays x {leaf_bench.VISITS} "
                   "visits, leaf 32"),
         "ms": p3_row["ms"], "plain_ms": p3_row["plain_ms"],
         "bound_ms": p3_row["bound_ms"], "bound_by": p3_row["bound_by"],
         "library_ms": None,
         "gtests_per_s": {v: r["gtests_per_s"] for v, r in leaf_rates.items()},
         "ns_per_visit": {v: r["ns_per_visit"] for v, r in leaf_rates.items()},
         "cross_check_msamples": {"k1_mesh": p3_row["k1_msamples"],
                                  "leaf_rate_over_tests":
                                      p3_row["predicted_msamples"]}}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
