"""Differentiable rendering: gradients of an image loss with respect to
material parameters, by two estimators.

Counterpart of pathtracer_tpu.diff.grad, on the scene's device, eagerly:

- the wavefront autograd path (`extract_params`, `apply_params`,
  `render_image_diff`, `image_loss`, `train_step`): the wavefront
  integrator's fixed-trip bounce loop (render/integrator.py) differentiated
  by torch autograd, every SceneParams field at once (object colors,
  emission, triangle colors and the three float texture atlases, which
  also carry the normal maps). On the card every nearest hit comes from
  the intersect kernel, K5 (integrator.intersect_route), with the winner
  re-attached where the rays carry a gradient;
- the differentiable megakernel's step factories: the same tile (8, 512),
  `default_order(meta)` layout, masked MSE and SGD update as the JAX
  package's, the loss and its gradient through the autograd Functions of
  render/grad.py (forward = the megakernel, backward = one gradient-kernel
  launch).

Each update runs under torch.no_grad(). The sharded steps split both
estimators over a (pixels, spp) mesh of ranks (parallel/mesh.py):
`make_sharded_megakernel_step` (whole tile rows a pixel shard, the sample
budget over the spp axis, one K6 launch a rank's backward) and
`make_sharded_train_step` (the wavefront autograd path on contiguous
pixel slices). Loss and gradients are summed over the ranks with
all_reduce(SUM) and divided (gloo has no AVG), so every rank takes the same
update. Each rank's work is a plain function of its coordinate; a
parallel.mesh.LogicalMesh runs every coordinate in one process.
"""
from __future__ import annotations

import types
from typing import NamedTuple

import numpy as np
import torch

from ..config import RenderConfig
from ..parallel.mesh import shard_rows
from ..render import integrator, threefry
from ..render import megakernel as mk
from ..render.camera import CameraArrays
from ..render.grad import (make_diff_render, make_diff_render_tex,
                           make_diff_render_tri)
from ..render.vec3 import Vec3
from ..scene.pack import SceneArrays, SceneMeta, atlas_to_texels, texel_params
from ..spans import span

_ATLASES = ("tex_planar", "tex_sphere", "tex_cube")


class SceneParams(NamedTuple):
    """The trainable subset of SceneArrays. The wavefront path trains the
    JAX package's six fields (color, emission, tri_color and the float
    atlases tex_planar, tex_sphere, tex_cube, [3, n, H, W] each); the
    megakernel's texel steps train `tex`, an f32 copy of the texel pool
    (scene.pack.texel_params), where the JAX package trains its staged
    atlas. A field that is None does not train."""
    color: torch.Tensor      # [No, 3]
    emission: torch.Tensor   # [No, 3]
    tri_color: torch.Tensor  # [Nt, 3]
    tex: torch.Tensor = None  # [T, 3]
    tex_planar: torch.Tensor = None
    tex_sphere: torch.Tensor = None
    tex_cube: torch.Tensor = None


def from_jax_params(params, device, meta=None) -> SceneParams:
    """Carry the JAX package's trainable parameters over to this one (the
    companion of scene.pack.from_jax_scene, which carries the geometry).

    `params` holds numpy arrays `color`, `emission` and `tri_color` (the
    JAX SceneArrays or SceneParams with each field converted by the
    caller, or a mapping of those names); returns float32 tensors on
    `device`. The float atlases `tex_planar`, `tex_sphere` and `tex_cube`
    come across where `params` holds them, else they are None. When it
    also holds the texel pool (`tex_pool_u32`, `tex_base`, `tex_w`,
    `tex_h`: the JAX SceneArrays), `tex` is the decoded pool, and
    with the scene's `meta` and its staged atlas (`tex_staged`) each texel
    of a texture staged at full size takes the atlas's value
    (scene.pack.atlas_to_texels): the carried-over values, not the bytes
    decoded again, so both packages train the same numbers. Else `tex` is
    None."""
    get = (params.__getitem__ if isinstance(params, dict)
           else lambda k: getattr(params, k))

    def has(k):
        return k in params if isinstance(params, dict) else hasattr(params, k)

    out = [torch.from_numpy(np.array(get(k), dtype=np.float32)).to(device)
           for k in ("color", "emission", "tri_color")]
    tex = None
    if all(has(k) for k in ("tex_pool_u32", "tex_base", "tex_w", "tex_h")):
        pool = types.SimpleNamespace(
            tex_pool_u32=torch.from_numpy(np.array(
                get("tex_pool_u32"), np.uint32)).to(device),
            **{k: np.asarray(get(k)) for k in ("tex_base", "tex_w",
                                               "tex_h")})
        tex = texel_params(pool)
        if meta is not None and has("tex_staged"):
            tex = atlas_to_texels(get("tex_staged"), pool, meta, tex)
    atlases = {k: torch.from_numpy(np.array(get(k), dtype=np.float32)).to(
        device) for k in _ATLASES if has(k)}
    return SceneParams(*out, tex, **atlases)


# --- the wavefront autograd path ------------------------------------------

def extract_params(scn: SceneArrays) -> SceneParams:
    """The wavefront path's trainable fields of `scn` (tex None)."""
    return SceneParams(color=scn.color, emission=scn.emission,
                       tri_color=scn.tri_color,
                       **{k: getattr(scn, k) for k in _ATLASES})


def apply_params(scn: SceneArrays, p: SceneParams) -> SceneArrays:
    """`scn` with the wavefront path's fields of `p` that are not None."""
    return scn._replace(**{k: getattr(p, k) for k in (
        "color", "emission", "tri_color", *_ATLASES)
        if getattr(p, k) is not None})


def render_image_diff(params: SceneParams, scn: SceneArrays,
                      meta: SceneMeta, cfg: RenderConfig, cam: CameraArrays,
                      px: torch.Tensor, py: torch.Tensor, key: torch.Tensor,
                      n_samples: int,
                      route: integrator.IntersectRoute = None) -> Vec3:
    """Differentiable estimate of P pixels (px, py: int32 [P]) at n_samples
    spp under the threefry key `key` -> Vec3 of [P]. As the JAX package's:
    the fixed-trip bounce loop (early_exit False) and the float atlases
    (trainable_textures), through integrator.render_pass. The JAX package
    rematerializes every bounce of that loop (jax.checkpoint); the port
    does so where a bounce samples a texture or a normal map, which keeps
    about 1 KB a ray for its backward against the 58 B of the state the
    checkpoint keeps (integrator._remat_bounces), and only for the
    bounces whose intermediates would not fit in the memory free on the
    device (integrator._plain_bounces): a batch that fits keeps the plain
    loop's rate. An untextured bounce keeps less than that state, so it
    always runs without. `route` defaults
    to integrator.intersect_route's (build it once to reuse its tables):
    on a CUDA device in f32 the intersect kernel answers every nearest
    hit, and a scene it does not take raises rather than fall back to the
    torch walk (which a caller may still ask for: route=
    integrator.IntersectRoute())."""
    scn = apply_params(scn, params)
    cfg = cfg.replace(early_exit=False, trainable_textures=True)
    if route is None:
        route = integrator.intersect_route(scn, meta, cfg)
        if (route.fn is None and scn.color.device.type == "cuda"
                and cfg.dtype == "float32"):
            raise NotImplementedError(
                "the wavefront autograd path on the card answers its "
                "nearest hits with the intersect kernel, which takes scenes "
                "of planes, spheres, cylinders, boxes and groups only "
                "(megakernel.supports_intersect)")
    acc = integrator.render_pass(scn, meta, cfg, cam, px, py, 0, n_samples,
                                 key, route)
    return acc * (1.0 / float(n_samples))


def image_loss(params, scn, meta, cfg, cam, px, py, key, n_samples,
               target: Vec3, route=None) -> torch.Tensor:
    """Mean over pixels and channels of the squared difference between
    render_image_diff and `target` (Vec3 of [P])."""
    img = render_image_diff(params, scn, meta, cfg, cam, px, py, key,
                            n_samples, route)
    d = img - target
    return torch.mean(d.x * d.x + d.y * d.y + d.z * d.z) / 3.0


def loss_and_grads(params: SceneParams, *args, **kw):
    """(loss, grads): image_loss(params, *args, **kw) and its gradient with
    respect to every field of `params` that is not None (None where the
    field is None). The forward runs in the span "pt.ad.forward", the
    backward in "pt.ad.backward" (spans.py)."""
    names = [k for k in SceneParams._fields if getattr(params, k) is not None]
    with torch.enable_grad():
        leaves = {k: getattr(params, k).detach().requires_grad_(True)
                  for k in names}
        with span("pt.ad.forward"):
            loss = image_loss(params._replace(**leaves), *args, **kw)
        with span("pt.ad.backward"):
            grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                        allow_unused=True)
    # a field the render never reads (tri_color without a mesh) gets zeros,
    # as jax.grad gives them
    got = {k: torch.zeros_like(leaves[k]) if g is None else g
           for k, g in zip(names, grads)}
    return loss.detach(), SceneParams(*(got.get(k)
                                        for k in SceneParams._fields))


def train_step(params, scn, meta, cfg, cam, px, py, key, n_samples,
               target: Vec3, lr=0.05, route=None):
    """Single-device SGD step; returns (new_params, loss)."""
    loss, grads = loss_and_grads(params, scn, meta, cfg, cam, px, py, key,
                                 n_samples, target, route=route)
    with torch.no_grad():
        new = {k: getattr(params, k) - lr * getattr(grads, k)
               for k in SceneParams._fields if getattr(params, k) is not None}
    return params._replace(**new), loss


def _make_target_of(pid: np.ndarray, tile_shape, device):
    """Map an [H, W, 3] target image into the step's tiled (r, g, b)
    layout on `device` (pid: tile slot -> flat pixel index, -1 =
    padding)."""
    def target_of(img):
        flat = np.asarray(img, np.float32).reshape(-1, 3)
        out = np.zeros((pid.shape[0], 3), np.float32)
        sel = pid >= 0
        out[sel] = flat[pid[sel]]
        t = out.reshape(tuple(tile_shape) + (3,))
        return tuple(torch.from_numpy(np.ascontiguousarray(t[..., c]))
                     .to(device) for c in range(3))

    return target_of


def _step_inputs(scn, meta, camera, tile, shard_granule=1):
    """The tiled layout (no sample packing; whole tiles a pixel shard of
    `shard_granule`), camera vector and tables of the scene on its device,
    as the JAX steps build them."""
    dev = scn.color.device
    xs, ys, pid = mk.tile_pixel_layout(camera.width, camera.height, *tile,
                                       shard_granule=shard_granule,
                                       order=mk.default_order(meta))
    px = torch.from_numpy(xs).to(dev)
    py = torch.from_numpy(ys).to(dev)
    cam_vec = torch.from_numpy(mk.build_camera_vec(camera)).to(dev)
    obj = torch.from_numpy(mk.build_scene_table(scn, meta)).to(dev)
    nodes, tris, shade = (torch.from_numpy(t).to(dev) for t in
                          mk.build_mesh_tables(scn, meta,
                                               traversal="classic"))
    valid = torch.from_numpy((pid >= 0).reshape(xs.shape)
                             .astype(np.float32)).to(dev)
    return dict(px=px, py=py, cam_vec=cam_vec, obj=obj, nodes=nodes,
                tris=tris, shade=shade, valid=valid, n_valid=float((pid >= 0).sum()),
                pid=pid)


def _masked_mse(rgb, target, valid, inv, n_valid):
    """(sum over channels and valid slots of (x * inv - t)^2) / (3 n)."""
    tot = 0.0
    for x, t in zip(rgb, target):
        d = (x * inv - t) * valid
        tot = tot + torch.sum(d * d)
    return tot / (3.0 * n_valid)


def make_megakernel_step(scn, meta, cfg, camera, spp, tile=(8, 512),
                         lr=0.05):
    """SGD step on (color, emission) through the differentiable megakernel
    (render/grad.make_diff_render): forward = the megakernel, backward =
    one gradient-kernel launch.

    Returns (step, target_of): step(color, emission, seed (prng seed,
    sample base), target) -> (new_color, new_emission, loss), and
    target_of(img [H, W, 3]) -> the step's tiled (r, g, b) target."""
    inp = _step_inputs(scn, meta, camera, tile)
    render = make_diff_render(meta, cfg, spp, cfg.samples, tuple(tile))
    inv_spp = 1.0 / float(spp)
    target_of = _make_target_of(inp["pid"], inp["px"].shape,
                                scn.color.device)

    def step(color, emission, seed, target):
        with torch.enable_grad():
            c = color.detach().requires_grad_(True)
            e = emission.detach().requires_grad_(True)
            rgb = render.apply(c, e, seed, inp["cam_vec"], inp["obj"],
                               inp["nodes"], inp["tris"], inp["shade"],
                               inp["px"], inp["py"])
            loss = _masked_mse(rgb, target, inp["valid"], inv_spp,
                               inp["n_valid"])
            gc, ge = torch.autograd.grad(loss, (c, e))
        with torch.no_grad():
            return color - lr * gc, emission - lr * ge, loss.detach()

    return step, target_of


def make_megakernel_step_tex(scn, meta, cfg, camera, spp, tile=(8, 512),
                             lr=0.05):
    """SGD step on (color, emission, texels) through the differentiable
    megakernel's texel mode (render/grad.make_diff_render_tex): forward =
    the megakernel fetching the f32 texels, backward = one launch of the
    texel-gradient kernel.

    Returns (step, target_of): step(color, emission, tex [T, 3], seed
    (prng seed, sample base), target) -> (new_color, new_emission,
    new_tex, loss), and target_of(img [H, W, 3]) -> the step's tiled
    (r, g, b) target. tex starts as scene.pack.texel_params(scn) (or the
    JAX atlas carried over by from_jax_params); texels outside the staged
    textures get exactly-zero gradients."""
    inp = _step_inputs(scn, meta, camera, tile)
    tex_table = torch.from_numpy(mk.build_tex_table(scn, meta)).to(
        scn.color.device)
    render = make_diff_render_tex(meta, cfg, spp, cfg.samples, tuple(tile))
    inv_spp = 1.0 / float(spp)
    target_of = _make_target_of(inp["pid"], inp["px"].shape,
                                scn.color.device)

    def step(color, emission, tex, seed, target):
        with torch.enable_grad():
            params = [p.detach().requires_grad_(True)
                      for p in (color, emission, tex)]
            rgb = render.apply(*params, seed, inp["cam_vec"], inp["obj"],
                               inp["nodes"], inp["tris"], inp["shade"],
                               inp["px"], inp["py"], tex_table)
            loss = _masked_mse(rgb, target, inp["valid"], inv_spp,
                               inp["n_valid"])
            grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            return (*(p - lr * g for p, g in
                      zip((color, emission, tex), grads)), loss.detach())

    return step, target_of


def make_megakernel_step_tri(scn, meta, cfg, camera, n_passes=2,
                             tile=(8, 512), lr=0.05, spp=4):
    """SGD step on (color, emission, per-triangle color) through the
    differentiable megakernel's triangle mode (render/grad.
    make_diff_render_tri). Each of the `n_passes` launches renders `spp`
    samples with its own random stream (seed + i * 7919, sample base + i *
    spp), so a step takes n_passes * spp samples; the kernel has no
    per-launch sample cap, so n_passes=1 with the whole budget also works.

    Returns (step, target_of): step(color, emission, tri_color, seed,
    target) -> (new_color, new_emission, new_tri_color, loss). tri_color
    is SceneArrays.tri_color [n_slots, 3]; padding slots get exactly zero
    gradients."""
    inp = _step_inputs(scn, meta, camera, tile)
    total = n_passes * spp
    render = make_diff_render_tri(meta, cfg, total, tuple(tile), spp=spp)
    inv = 1.0 / float(total)
    target_of = _make_target_of(inp["pid"], inp["px"].shape,
                                scn.color.device)

    def step(color, emission, tri_color, seed, target):
        s0, s1 = (int(v) for v in (seed.tolist()
                                   if isinstance(seed, torch.Tensor)
                                   else seed))
        with torch.enable_grad():
            params = [p.detach().requires_grad_(True)
                      for p in (color, emission, tri_color)]
            acc = None
            for i in range(n_passes):
                rgb = render.apply(*params, (s0 + i * 7919, s1 + i * spp),
                                   inp["cam_vec"], inp["obj"], inp["nodes"],
                                   inp["tris"], inp["shade"], inp["px"],
                                   inp["py"])
                acc = rgb if acc is None else [a + x for a, x in
                                               zip(acc, rgb)]
            loss = _masked_mse(acc, target, inp["valid"], inv,
                               inp["n_valid"])
            grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            return (*(p - lr * g for p, g in
                      zip((color, emission, tri_color), grads)),
                    loss.detach())

    return step, target_of


# --- the sharded steps ----------------------------------------------------

def make_sharded_megakernel_step(scn, meta, cfg, camera, mesh, spp,
                                 tile=(8, 512), lr=0.05):
    """Distributed SGD step on (color, emission) through the differentiable
    megakernel, over `mesh` (make_sharded_megakernel_step of the JAX
    package, diff/grad.py:303-393 there).

    The tile rows are split over the pixels axis (tile_pixel_layout's
    shard_granule keeps whole tiles a shard) and the sample budget over
    the spp axis: each rank renders ceil(spp / S) samples under the seed
    (seed[0] * 7919 + pix_rank * S + spp_rank + 1, seed[1] + spp_rank *
    local_spp). A rank's loss is the masked MSE of its rows normalised by
    the whole image's valid slots, its gradient one K6 launch; both are
    summed over the pixels axis and averaged over the spp axis, and the
    update is the same on every rank.

    Returns (step, target_of): step(color, emission, seed (prng seed,
    sample base), target) -> (new_color, new_emission, loss), and
    target_of(img [H, W, 3]) -> the step's whole tiled (r, g, b) target,
    of which each rank reads its rows."""
    P, S_axis = mesh.shape["pixels"], mesh.shape["spp"]
    local_spp = max(1, -(-spp // S_axis))
    inp = _step_inputs(scn, meta, camera, tile, shard_granule=P)
    tabs = [inp[k] for k in ("cam_vec", "obj", "nodes", "tris", "shade")]
    render = make_diff_render(meta, cfg, local_spp, cfg.samples, tuple(tile))
    inv_spp = 1.0 / float(local_spp)
    target_of = _make_target_of(inp["pid"], inp["px"].shape,
                                scn.color.device)

    def step(color, emission, seed, target):
        s0, s1 = (int(v) for v in (seed.tolist()
                                   if isinstance(seed, torch.Tensor)
                                   else seed))

        def shard(p, s):
            sd = (s0 * 7919 + p * S_axis + s + 1, s1 + s * local_spp)
            rows = [shard_rows(t, p, P) for t in (
                inp["px"], inp["py"], inp["valid"], *target)]
            with torch.enable_grad():
                c = color.detach().requires_grad_(True)
                e = emission.detach().requires_grad_(True)
                rgb = render.apply(c, e, sd, *tabs, rows[0], rows[1])
                loss = _masked_mse(rgb, rows[3:], rows[2], inv_spp,
                                   inp["n_valid"])
                gc, ge = torch.autograd.grad(loss, (c, e))
            return loss.detach().reshape(1), gc, ge

        loss, gc, ge = (t / S_axis for t in mesh.sum_all(shard))
        with torch.no_grad():
            return color - lr * gc, emission - lr * ge, loss[0]

    return step, target_of


def make_sharded_train_step(mesh, meta, cfg, n_samples, lr=0.05,
                            optimizer=None, route=None):
    """Distributed training step of the wavefront autograd path over
    `mesh` (make_sharded_train_step of the JAX package, diff/grad.py:
    396-462 there).

    step(params, scn, cam, px, py, target, key) -> (new_params, loss):
    px, py (int32 [N]) and target (Vec3 of [N]) are the whole batch, N a
    multiple of the pixels axis, of which the rank at (pix_rank, spp_rank)
    takes the pix_rank-th contiguous slice under the threefry key
    fold_in(fold_in(key, pix_rank), spp_rank); its image_loss and
    gradients are averaged over both axes, so every rank holds the same
    loss and update. Without `optimizer` the update is SGD at `lr`. With a
    torch.optim optimizer over the tensors of params' trainable fields
    (the fields that are not None), the averaged gradients are set as
    their .grad and optimizer.step() updates them in place, the same on
    every rank; the step then returns params itself. `route` is
    render_image_diff's (built each call by default)."""
    P, S_axis = mesh.shape["pixels"], mesh.shape["spp"]

    def step(params, scn, cam, px, py, target, key):
        names = [k for k in SceneParams._fields
                 if getattr(params, k) is not None]
        if px.shape[0] % P:
            raise ValueError(f"{px.shape[0]} pixels do not split over "
                             f"{P} pixel shards")

        def shard(p, s):
            k = threefry.fold_in(threefry.fold_in(key, p), s)
            tgt = Vec3(*(shard_rows(c, p, P) for c in target))
            loss, grads = loss_and_grads(
                params, scn, meta, cfg, cam, shard_rows(px, p, P),
                shard_rows(py, p, P), k, n_samples, tgt, route=route)
            return [loss.reshape(1)] + [getattr(grads, n) for n in names]

        out = [t / (P * S_axis) for t in mesh.sum_all(shard)]
        loss, grads = out[0][0], dict(zip(names, out[1:]))
        if optimizer is None:
            with torch.no_grad():
                return params._replace(**{n: getattr(params, n) - lr * g
                                          for n, g in grads.items()}), loss
        owned = {id(t) for grp in optimizer.param_groups
                 for t in grp["params"]}
        for n, g in grads.items():
            t = getattr(params, n)
            if id(t) not in owned:
                raise ValueError(f"params.{n} is not a tensor of the "
                                 "optimizer")
            t.grad = g.to(t.dtype)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return params, loss

    return step
