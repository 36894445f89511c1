"""Differentiable megakernel: fused forward replay and backward pass.

Counterpart of pathtracer_tpu.render.pallas_grad without NEE. The
estimator per sample is S = sum_b contrib_b m_b e_b, with
m_{b+1} = m_b c_b cos_b on bounces that update the mask and a direct light
hit overwriting S with the light's color (tracer.cl:1116-1176). Color and
emission enter linearly given the sampled trajectory, so the pathwise
gradient needs the trajectory replayed, not differentiated: the backward
pass replays each slot's paths with the same counter-hash draws, records a
tape per bounce and runs the reverse recurrence

    T_b = e_{b+1} + (upd_{b+1} ? c_{b+1} cos_{b+1} : 1) T_{b+1}
    dS/dc_b = upd_b ? cot cos_b m_b T_b : 0      (direct hit: cot, rest 0)
    dS/de_b = contrib_b ? cot m_b : 0            (none after a direct hit)

summed per object (`gcol`, `gemi`) and, with `tri_grads`, per triangle
slot (`gtri`; mesh hits carry no object color gradient). With `tex_grads`
(textured scenes) a bounce whose winner's color is a texel scatters its
dS/dc through the transposed bilinear fetch into the texels (`gtex`,
[T, 3] over the texel pool; only the textures the JAX package stages
train, procedural ones are programs, not parameters), and a textured
object's own color gradient is exactly zero.

`grad_tiles` launches the gradient instantiation of csrc/megakernel.cu for
CUDA tensors (the forward's own code, so the replay cannot drift) and runs
`grad_tiles_reference`, the plain vectorised version, for CPU tensors.
`make_diff_render`, `make_diff_render_tri` and `make_diff_render_tex`
wrap the forward megakernel (`trace_tiles`) and one `grad_tiles` launch in
a torch.autograd.Function.

On the TPU the per-triangle scatter was a one-hot MXU matmul
(`_scatter_slots`) or an HBM tape and `segment_sum`, and the texel scatter
a transposed one-hot fetch into the staged atlas (`_scatter_staged`, or
`_scatter_staged_unified` under PT_TEX_UNIFIED); here each is an atomic
add in every mode: a triangle's or a texel tap's three sums one 16-byte
atomic into [n, 4] rows (`padded_sums`, returned as [n, 3]), after the
lanes of a warp that add into the same object or triangle are merged.
"""
from __future__ import annotations

import functools
import os
from typing import Tuple

import torch

from ..config import RenderConfig
from ..scene.pack import SceneMeta, staged_objects
from ..spans import span
from . import megakernel as mk

_TRI_MODES = ("onehot", "tape")

_MAX_TAPE = 16      # kMaxTape of csrc/megakernel.cu
_BLOCK = 128        # kGradThreads of csrc/megakernel.cu
_GRAD_COLS = 6      # color rgb | emission rgb per object


def _assemble_obj(obj_table: torch.Tensor, color: torch.Tensor,
                  emission: torch.Tensor, n: int) -> torch.Tensor:
    """Overwrite the object table's color/emission columns (24:30) from
    the [>= n, 3] parameters. All 45 columns are kept: the JAX version
    returns 40 (pallas_grad.py:1200-1209), dropping the NEE light columns
    40:45, which its grad path never reads."""
    return torch.cat([obj_table[:, 0:24],
                      color[:n].to(torch.float32),
                      emission[:n].to(torch.float32),
                      obj_table[:, 30:]], dim=1).contiguous()


def _assemble_tri(shade_table: torch.Tensor,
                  tri_color: torch.Tensor) -> torch.Tensor:
    """The shading table [Ns, 12] with its color columns (9:12) overwritten
    from the [Ns, 3] parameter; the node and test tables stay as they
    are."""
    if tri_color.shape[0] != shade_table.shape[0]:
        raise ValueError(f"tri_color has {tri_color.shape[0]} slots; the "
                         f"shading table holds {shade_table.shape[0]}")
    return torch.cat([shade_table[:, :9], tri_color.to(torch.float32)],
                     dim=1).contiguous()


def _check_diff_scene(meta: SceneMeta, cfg: RenderConfig,
                      tex: bool = False) -> None:
    """What the differentiable render refuses, as the JAX asserts do
    (pallas_grad.py:1151-1159, :1330-1339): NEE; a textured scene in
    object or triangle mode; in texel mode (`tex`), normal maps and a
    scene with no staged texture."""
    if cfg.nee:
        raise NotImplementedError(
            "the differentiable megakernel does not replay NEE shadow "
            "draws, as the JAX package's does not (train with nee=False)")
    textured = bool(meta.textured_types or meta.has_normal_maps
                    or meta.obj_tex or meta.obj_tex_nm)
    if textured and not tex:
        raise NotImplementedError(
            "a textured scene is differentiated in texel mode: "
            "make_diff_render_tex (grad_tiles(tex_grads=True))")
    if tex and (meta.has_normal_maps or meta.obj_tex_nm):
        raise NotImplementedError(
            "normal maps redirect rays, which is not linear in their "
            "texels; the texel gradients exclude scenes with normal maps "
            "(e.g. train textures-train, not textures-file)")
    if tex and not staged_objects(meta):
        raise ValueError(
            "texel gradients need a scene with a staged texture (an image "
            "the JAX package stages, e.g. textures-train); procedural "
            "textures are programs, not parameters")
    if meta.has_groups:
        mk.grad_walk()   # raises under PT_TRAVERSAL=mxu


def _check_grad_args(seed, cam_vec, obj_table, node_table, tri_table,
                     shade_table, px, py, cots, meta, cfg, spp, tile, tri_grads, tex_grads,
                     tri_mode, tex=None, tex_table=None):
    """Validate grad_tiles' arguments (the forward's checks plus the
    cotangents); returns the (seed, sample_base) ints."""
    if tri_mode not in _TRI_MODES:
        raise ValueError(f"tri_mode {tri_mode!r} is not one of {_TRI_MODES}")
    if tex_grads and tri_grads:
        raise ValueError("tex_grads and tri_grads are separate paths "
                         "(alternate steps to train both)")
    _check_diff_scene(meta, cfg, tex=tex_grads)
    if not tex_grads and (tex is not None or tex_table is not None):
        raise ValueError("tex/tex_table are the texel mode's inputs "
                         "(tex_grads=True)")
    seed = mk._check_args(seed, cam_vec, obj_table, node_table, tri_table,
                          shade_table, px, py, meta, cfg, spp, tile, 1, "row",
                          tex_table=tex_table, tex_texels=tex)
    for name, c in zip(("cot_r", "cot_g", "cot_b"), cots):
        if not isinstance(c, torch.Tensor) or c.device != px.device:
            raise ValueError(f"{name} must be a tensor on {px.device}")
        if (c.dtype != torch.float32 or not c.is_contiguous()
                or tuple(c.shape) != tuple(px.shape)):
            raise ValueError(
                f"{name} must be contiguous float32 {tuple(px.shape)}, got "
                f"{c.dtype} {tuple(c.shape)} contiguous={c.is_contiguous()}")
    return seed


def _split(gobj: torch.Tensor):
    return gobj[:, 0:3].contiguous(), gobj[:, 3:6].contiguous()


def check_tape(max_bounces: int) -> None:
    """Raise ValueError unless the gradient kernel's per-thread tape holds
    max_bounces entries (kMaxTape)."""
    if max_bounces > _MAX_TAPE:
        raise ValueError(f"max_bounces={max_bounces}; the gradient kernel's "
                         f"tape holds {_MAX_TAPE}")


def padded_sums(n: int, device) -> torch.Tensor:
    """The kernel's [n, 4] f32 sums (rgb and a pad column, so that a row is
    one 16-byte atomic), zeroed."""
    return torch.zeros((n, 4), dtype=torch.float32, device=device)


def unpadded(g4: torch.Tensor) -> torch.Tensor:
    """The [n, 3] gradients of padded_sums' [n, 4] rows."""
    return g4[:, :3].contiguous()


def grad_tiles_reference(seed, cam_vec, obj_table, node_table, tri_table,
                         shade_table, px, py, cot_r, cot_g, cot_b,
                         meta: SceneMeta = None, cfg: RenderConfig = None,
                         spp: int = 1, total_samples: int = 1,
                         tile: Tuple[int, int] = (8, 512),
                         tri_grads: bool = False, tex_grads: bool = False,
                         tri_mode: str = "onehot", counts: dict = None,
                         tex=None, tex_table=None):
    """Plain PyTorch version of the gradient kernel: the same arguments and
    results as grad_tiles. The forward replay is trace_tiles_reference
    itself (spp_pack 1, row axis, the walk of mk.grad_scene_walk), which
    hands over each sample's tape
    ([bounces] of [T*S*L] tensors); the reverse recurrence runs over it
    vectorised in f32 and index_add_ sums the per-object, per-slot and
    per-texel gradients in f64 (millions of terms go into one object's
    sum; the result is rounded to f32 once). `counts` gains the forward
    replay's work, as trace_tiles_reference counts it, and with tex_grads
    the texel scatters ("texel_scatters")."""
    cots = (cot_r, cot_g, cot_b)
    _check_grad_args(seed, cam_vec, obj_table, node_table, tri_table,
                     shade_table, px, py, cots, meta, cfg, spp, tile,
                     tri_grads, tex_grads, tri_mode, tex, tex_table)
    dev = px.device
    n_obj = len(meta.obj_types)
    gobj = torch.zeros((n_obj, _GRAD_COLS), dtype=torch.float64, device=dev)
    gtri = (torch.zeros((meta.n_tri_slots, 3), dtype=torch.float64,
                        device=dev) if tri_grads else None)
    gtex = textured = train = None
    if tex_grads:
        gtex = torch.zeros((tex.shape[0], 3), dtype=torch.float64,
                           device=dev)
        # per object: a color texture (its color gradient is zero) and a
        # trainable one (its texels take the gradient)
        textured = torch.cat([tex_table[:, 0] > 0.5,
                              torch.zeros(1, dtype=torch.bool, device=dev)])
        train = torch.zeros(n_obj + 1, dtype=torch.bool, device=dev)
        train[list(staged_objects(meta))] = True
    cot = [c.reshape(-1) for c in cots]

    def backward(tape):
        if not tape:
            return
        direct_any = torch.stack([e.flags >= 4 for e in tape]).any(dim=0)
        T = [torch.zeros_like(cot[0]) for _ in range(3)]
        for e in reversed(tape):
            contrib = e.flags >= 1
            updf = e.flags == 3
            directf = e.flags >= 4
            g_c = [torch.where(direct_any,
                               torch.where(directf, cot[ch], 0.0),
                               torch.where(updf,
                                           cot[ch] * e.cos * e.mask[ch]
                                           * T[ch], 0.0))
                   for ch in range(3)]
            g_e = [torch.where(~direct_any & contrib, cot[ch] * e.mask[ch],
                               0.0) for ch in range(3)]
            on_obj = torch.nonzero(contrib & (e.who >= 0)).squeeze(1)
            g_obj = g_c
            if tex_grads:
                # index n_obj: no object (a mesh hit)
                who = torch.where(e.who >= 0, e.who, n_obj)
                g_obj = [torch.where(textured[who], 0.0, g) for g in g_c]
                # the kernel's scatters: a direct hit's entry, else the
                # entries that update the mask
                rows = torch.nonzero(
                    train[who] & torch.where(direct_any, directf, updf)
                ).squeeze(1)
                scatter_texels(gtex, tex_table, e, rows, g_c)
                if counts is not None:
                    counts["texel_scatters"] = (counts.get("texel_scatters", 0)
                                                + rows.numel())
            if on_obj.numel():
                gobj.index_add_(0, e.who[on_obj],
                                torch.stack(g_obj + g_e, dim=1)[on_obj]
                                .to(torch.float64))
            if tri_grads:
                on_tri = torch.nonzero(
                    updf & (e.who < 0) & ~direct_any).squeeze(1)
                if on_tri.numel():
                    gtri.index_add_(0, -1 - e.who[on_tri],
                                    torch.stack(g_c, dim=1)[on_tri]
                                    .to(torch.float64))
            T = [torch.where(contrib, e.emi[ch], 0.0)
                 + torch.where(updf, e.col[ch] * e.cos, 1.0) * T[ch]
                 for ch in range(3)]

    mk.trace_tiles_reference(
        seed, cam_vec, obj_table, node_table, tri_table, shade_table, px, py,
        meta=meta,
        cfg=cfg, spp=spp, total_samples=total_samples, tile=tile,
        spp_pack=1, pack_axis="row", sample_tape=backward, counts=counts,
        tex_table=tex_table, tex_texels=tex, walk=mk.grad_scene_walk(meta))
    gcol, gemi = _split(gobj.to(torch.float32))
    if tri_grads:
        return gcol, gemi, gtri.to(torch.float32)
    if tex_grads:
        return gcol, gemi, gtex.to(torch.float32)
    return gcol, gemi


def scatter_texels(gtex, tex_table, entry, rows, g_c):
    """Transpose of sample_texels for one tape entry (plain version of the
    kernel's scatter_texels): at the slots `rows`, each channel's dS/dc
    times the four bilinear weights of the entry's color fetch, added in
    f64 into gtex [T, 3] at the fetch's indices."""
    if not rows.numel():
        return
    trow = tex_table[entry.who[rows]]
    idx, tx, ty = mk.texel_taps(trow[:, 1], trow[:, 2], trow[:, 3],
                                entry.uv[0][rows], entry.uv[1][rows])
    g = torch.stack([c[rows] for c in g_c], dim=1)
    for i, wt in zip(idx, ((1.0 - tx) * (1.0 - ty), tx * (1.0 - ty),
                           (1.0 - tx) * ty, tx * ty)):
        gtex.index_add_(0, i, (g * wt[:, None]).to(torch.float64))


def grad_tiles(seed, cam_vec, obj_table, node_table, tri_table, shade_table,
               px, py, cot_r, cot_g, cot_b, meta: SceneMeta = None,
               cfg: RenderConfig = None, spp: int = 1,
               total_samples: int = 1, tile: Tuple[int, int] = (8, 512),
               tri_grads: bool = False, tex_grads: bool = False,
               tri_mode: str = "onehot", tex=None, tex_table=None):
    """Backward pass of trace_tiles (spp_pack 1, row axis) with respect to
    the object table's color and emission columns, for the per-slot
    cotangents cot_* [T*S, L] of its (r, g, b) sums. Returns (gcol [No, 3],
    gemi [No, 3]) summed over all slots and samples; with `tri_grads`
    also gtri [n_tri_slots, 3], the per-triangle color gradients (both
    PT_TRI_GRAD modes: an atomic add); with `tex_grads` (a textured scene:
    the replay fetches from the f32 texels `tex` [T, 3] by the texture
    table `tex_table`, mk.build_tex_table) also gtex [T, 3], the texel
    gradients, nonzero only on the textures of staged_objects.

    A mesh scene replays the walk of the JAX gradient kernel's knobs
    (mk.grad_walk: the per-thread walk, the block-packet walk under
    PT_SUBPACKET=1 or 2, no leaf tests under PT_ABLATE_LEAF=1).

    CUDA tensors launch the gradient instantiation of csrc/megakernel.cu on
    the current stream (counted in grad_tiles.launches, and in
    .tri_launches with tri_grads or .tex_launches with tex_grads, and in
    .packet_launches on the block-packet walk or .ablate_launches without
    leaf tests); CPU tensors run grad_tiles_reference. The kernel takes
    whole blocks of 128 slots and at most 16 bounces (check_tape); its
    triangle and texel sums are [n, 4] rows (padded_sums), returned as
    [n, 3]. Raises for NEE, for textures without tex_grads, for normal
    maps or no staged texture with it, for tri_grads with tex_grads and
    for PT_TRAVERSAL=mxu."""
    if px.device.type != "cuda":
        return grad_tiles_reference(
            seed, cam_vec, obj_table, node_table, tri_table, shade_table, px,
            py, cot_r, cot_g, cot_b, meta=meta, cfg=cfg, spp=spp,
            total_samples=total_samples, tile=tile, tri_grads=tri_grads,
            tex_grads=tex_grads, tri_mode=tri_mode, tex=tex,
            tex_table=tex_table)
    seed0, sample_base = _check_grad_args(
        seed, cam_vec, obj_table, node_table, tri_table, shade_table, px, py,
        (cot_r, cot_g, cot_b), meta, cfg, spp, tile, tri_grads, tex_grads,
        tri_mode, tex, tex_table)
    mk._check_aligned(node_table=node_table, tri_table=tri_table,
                      shade_table=shade_table)
    walk = mk.grad_scene_walk(meta)
    codes = (mk.WALK_CODES[walk.walk], mk.LEAF_CODES[walk.leaf])
    n_obj = len(meta.obj_types)
    if not 0 < n_obj <= mk._MAX_OBJECTS:
        raise ValueError(
            f"{n_obj} objects; the kernel takes 1..{mk._MAX_OBJECTS}")
    n_slots = px.numel()
    if n_slots % _BLOCK:
        raise ValueError(f"{n_slots} slots; the gradient kernel takes whole "
                         f"blocks of {_BLOCK}")
    check_tape(cfg.max_bounces)
    lib = mk.library()
    S, L = tile
    dev = px.device
    gobj = torch.zeros((n_obj, _GRAD_COLS), dtype=torch.float32, device=dev)
    gtri = padded_sums(meta.n_tri_slots, dev) if tri_grads else None
    types = (mk._I * n_obj)(*meta.obj_types)
    roots = (mk._I * n_obj)(*([-1] * n_obj))
    ends = (mk._I * n_obj)(*([-1] * n_obj))
    for g, r, e in meta.group_bvh:
        roots[g], ends[g] = r, e
    sun_cut, sun_den, golden2 = mk._sun_constants(total_samples)
    scene = (px.data_ptr(), py.data_ptr(), obj_table.data_ptr(), types,
             cam_vec.data_ptr(), node_table.data_ptr(), tri_table.data_ptr(),
             shade_table.data_ptr(), roots, ends, n_obj, n_slots, S, L, int(spp), seed0 & mk._M32,
             sample_base, cfg.max_bounces, cfg.max_effective_bounces,
             meta.leaf_size, meta.n_nodes if meta.octant_orders else 0,
             cfg.epsilon, cfg.t_max, sun_cut, sun_den, golden2,
             int(mk._coherent_sampling()))
    cots = (cot_r.data_ptr(), cot_g.data_ptr(), cot_b.data_ptr(),
            gobj.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if tex_grads:
            gtex = padded_sums(tex.shape[0], dev)
            texels4 = mk.texels_padded(tex)
            train = sum(1 << j for j in staged_objects(meta))
            err = lib.pt_grad_tex_launch(
                *cots, *scene, stream, texels4.data_ptr(), texels4.shape[0],
                tex_table.data_ptr(), gtex.data_ptr(), train, *codes)
        else:
            err = lib.pt_grad_launch(
                *cots, gtri.data_ptr() if tri_grads else None, *scene,
                stream, *codes)
    if err != 0:
        raise RuntimeError(f"gradient kernel launch failed: CUDA error {err}")
    grad_tiles.launches += 1
    if walk.walk != "thread":
        grad_tiles.packet_launches += 1   # the block-packet walk
    if walk.leaf == "none":
        grad_tiles.ablate_launches += 1   # the node walk alone
    gcol, gemi = _split(gobj)
    if tri_grads:
        grad_tiles.tri_launches += 1
        return gcol, gemi, unpadded(gtri)
    if tex_grads:
        grad_tiles.tex_launches += 1
        return gcol, gemi, unpadded(gtex)
    return gcol, gemi


grad_tiles.launches = 0
grad_tiles.tri_launches = 0
grad_tiles.tex_launches = 0
grad_tiles.packet_launches = 0
grad_tiles.ablate_launches = 0


def _cotangents(grads, px: torch.Tensor):
    """autograd's output gradients as grad_tiles takes them: zeros shaped
    like px for an output that had none, then contiguous float32."""
    return [(torch.zeros(px.shape, dtype=torch.float32, device=px.device)
             if g is None else g.to(torch.float32)).contiguous()
            for g in grads]


def _pad_to(g: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """The [n, 3] gradient placed into the (possibly padded) parameter's
    shape and type."""
    out = torch.zeros_like(param)
    out[:g.shape[0]] = g.to(param.dtype)
    return out


@functools.lru_cache(maxsize=None)
def make_diff_render(meta: SceneMeta, cfg: RenderConfig, spp: int,
                     total_samples: int, tile: Tuple[int, int]):
    """The megakernel render, differentiable in (color, emission).

    Returns a torch.autograd.Function; its apply(color [>= No, 3],
    emission [>= No, 3], seed (prng seed, sample base), cam_vec, obj_table,
    nodes, tris, shade, px, py) gives the (r, g, b) per-slot radiance sums of
    trace_tiles (the caller divides by spp). The object table carries the
    geometry; its color and emission columns are overwritten from the
    differentiable inputs. The backward pass is one grad_tiles launch."""
    _check_diff_scene(meta, cfg)
    n = meta.n_objects

    class DiffRender(torch.autograd.Function):
        @staticmethod
        def forward(ctx, color, emission, seed, cam_vec, obj_table, nodes,
                    tris, shade, px, py):
            with span("pt.grad.forward"):
                obj = _assemble_obj(obj_table, color, emission, n)
                ctx.save_for_backward(color, emission, cam_vec, obj_table,
                                      nodes, tris, shade, px, py)
                ctx.seed = seed
                return mk.trace_tiles(
                    seed, cam_vec, obj, nodes, tris, shade, px, py,
                    meta=meta, cfg=cfg, spp=spp,
                    total_samples=total_samples, tile=tile, spp_pack=1,
                    pack_axis="row")

        @staticmethod
        def backward(ctx, g_r, g_g, g_b):
            with span("pt.grad.backward"):
                (color, emission, cam_vec, obj_table, nodes, tris, shade,
                 px, py) = ctx.saved_tensors
                obj = _assemble_obj(obj_table, color, emission, n)
                gcol, gemi = grad_tiles(
                    ctx.seed, cam_vec, obj, nodes, tris, shade, px, py,
                    *_cotangents((g_r, g_g, g_b), px),
                    meta=meta, cfg=cfg, spp=spp,
                    total_samples=total_samples, tile=tile)
                return (_pad_to(gcol, color), _pad_to(gemi, emission),
                        *([None] * 8))

    return DiffRender


@functools.lru_cache(maxsize=None)
def make_diff_render_tri(meta: SceneMeta, cfg: RenderConfig,
                         total_samples: int, tile: Tuple[int, int],
                         spp: int = 1):
    """The megakernel render, differentiable in (object color, object
    emission, per-triangle color).

    Returns a torch.autograd.Function; its apply(color, emission,
    tri_color [n_slots, 3], seed, cam_vec, obj_table, nodes, tris, shade,
    px, py) gives the (r, g, b) per-slot sums of `spp` samples. tri_color
    is SceneArrays.tri_color (padding slots never win a hit, so their
    gradients are exactly zero); it overwrites the colors of the shading
    table, the only table it rebuilds. Accumulate more samples by calling it with other seeds; the
    gradients add through autograd."""
    _check_diff_scene(meta, cfg)
    n = meta.n_objects

    class DiffRenderTri(torch.autograd.Function):
        @staticmethod
        def forward(ctx, color, emission, tri_color, seed, cam_vec,
                    obj_table, nodes, tris, shade, px, py):
            with span("pt.grad.forward"):
                obj = _assemble_obj(obj_table, color, emission, n)
                shd = _assemble_tri(shade, tri_color)
                ctx.save_for_backward(color, emission, tri_color, cam_vec,
                                      obj_table, nodes, tris, shade, px, py)
                ctx.seed = seed
                return mk.trace_tiles(
                    seed, cam_vec, obj, nodes, tris, shd, px, py, meta=meta,
                    cfg=cfg, spp=spp, total_samples=total_samples,
                    tile=tile, spp_pack=1, pack_axis="row")

        @staticmethod
        def backward(ctx, g_r, g_g, g_b):
            with span("pt.grad.backward"):
                (color, emission, tri_color, cam_vec, obj_table, nodes, tris,
                 shade, px, py) = ctx.saved_tensors
                obj = _assemble_obj(obj_table, color, emission, n)
                shd = _assemble_tri(shade, tri_color)
                gcol, gemi, gtri = grad_tiles(
                    ctx.seed, cam_vec, obj, nodes, tris, shd, px, py,
                    *_cotangents((g_r, g_g, g_b), px),
                    meta=meta, cfg=cfg, spp=spp,
                    total_samples=total_samples, tile=tile, tri_grads=True,
                    tri_mode=os.environ.get("PT_TRI_GRAD", "onehot"))
                return (_pad_to(gcol, color), _pad_to(gemi, emission),
                        _pad_to(gtri[:tri_color.shape[0]], tri_color),
                        *([None] * 8))

    return DiffRenderTri


@functools.lru_cache(maxsize=None)
def make_diff_render_tex(meta: SceneMeta, cfg: RenderConfig, spp: int,
                         total_samples: int, tile: Tuple[int, int]):
    """The megakernel render, differentiable in (object color, object
    emission, texels).

    Returns a torch.autograd.Function; its apply(color, emission, tex
    [T, 3], seed, cam_vec, obj_table, nodes, tris, shade, px, py,
    tex_table) gives
    the (r, g, b) per-slot sums of `spp` samples. tex is the f32 copy of
    the scene's texel pool (scene.pack.texel_params; the JAX package's
    staged atlas, carried over by scene.pack.atlas_to_texels); the forward
    fetches from it, so a step sees its own update. tex_table
    (mk.build_tex_table) places each object's texture in it: the JAX
    package bakes that into its kernel from meta, this package's kernel
    reads it. The texels of staged_objects' textures get gradients, every
    other texel exactly zero; a texture the JAX package stages as a mip
    trains at full resolution here. The backward pass is one grad_tiles
    launch with tex_grads. Raises as the JAX package refuses: NEE, normal
    maps, no staged texture."""
    _check_diff_scene(meta, cfg, tex=True)
    n = meta.n_objects

    class DiffRenderTex(torch.autograd.Function):
        @staticmethod
        def forward(ctx, color, emission, tex, seed, cam_vec, obj_table,
                    nodes, tris, shade, px, py, tex_table):
            with span("pt.grad.forward"):
                obj = _assemble_obj(obj_table, color, emission, n)
                ctx.save_for_backward(color, emission, tex, cam_vec,
                                      obj_table, nodes, tris, shade, px, py,
                                      tex_table)
                ctx.seed = seed
                return mk.trace_tiles(
                    seed, cam_vec, obj, nodes, tris, shade, px, py,
                    meta=meta, cfg=cfg, spp=spp,
                    total_samples=total_samples, tile=tile, spp_pack=1,
                    pack_axis="row", tex_table=tex_table,
                    tex_texels=_texels(tex))

        @staticmethod
        def backward(ctx, g_r, g_g, g_b):
            with span("pt.grad.backward"):
                (color, emission, tex, cam_vec, obj_table, nodes, tris,
                 shade, px, py, tex_table) = ctx.saved_tensors
                obj = _assemble_obj(obj_table, color, emission, n)
                gcol, gemi, gtex = grad_tiles(
                    ctx.seed, cam_vec, obj, nodes, tris, shade, px, py,
                    *_cotangents((g_r, g_g, g_b), px),
                    meta=meta, cfg=cfg, spp=spp,
                    total_samples=total_samples, tile=tile, tex_grads=True,
                    tex=_texels(tex), tex_table=tex_table)
                return (_pad_to(gcol, color), _pad_to(gemi, emission),
                        gtex.to(tex.dtype), *([None] * 9))

    return DiffRenderTex


def _texels(tex: torch.Tensor) -> torch.Tensor:
    return tex.detach().to(torch.float32).contiguous()

