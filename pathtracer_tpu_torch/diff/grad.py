"""Training steps through the differentiable megakernel.

Counterpart of the megakernel half of pathtracer_tpu.diff.grad: the same
step factories, tile (8, 512), `default_order(meta)` layout, masked MSE and
SGD update. They run eagerly on the scene's device: the loss and its
gradient through the autograd Functions of render/grad.py (forward = the
megakernel, backward = one gradient-kernel launch), the update under
torch.no_grad().

Not ported yet: the sharded steps (ROADMAP queue 1, item 13) and the
wavefront `render_image_diff`/`train_step` (item 12).
"""
from __future__ import annotations

import types
from typing import NamedTuple

import numpy as np
import torch

from ..render import megakernel as mk
from ..render.grad import (make_diff_render, make_diff_render_tex,
                           make_diff_render_tri)
from ..scene.pack import atlas_to_texels, texel_params


class SceneParams(NamedTuple):
    """The trainable subset of SceneArrays that this package differentiates.
    The JAX package trains its staged texture atlas; this one trains an f32
    copy of the texel pool (scene.pack.texel_params), `tex`."""
    color: torch.Tensor      # [No, 3]
    emission: torch.Tensor   # [No, 3]
    tri_color: torch.Tensor  # [Nt, 3]
    tex: torch.Tensor = None  # [T, 3]


def from_jax_params(params, device, meta=None) -> SceneParams:
    """Carry the JAX package's trainable parameters over to this one (the
    companion of scene.pack.from_jax_scene, which carries the geometry).

    `params` holds numpy arrays `color`, `emission` and `tri_color` (the
    JAX SceneArrays or SceneParams with each field converted by the
    caller, or a mapping of those names); returns float32 tensors on
    `device`. When it also holds the texel pool (`tex_pool_u32`, `tex_base`,
    `tex_w`, `tex_h`: the JAX SceneArrays), `tex` is the decoded pool, and
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
    return SceneParams(*out, tex)


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


def _step_inputs(scn, meta, camera, tile):
    """The tiled layout (no sample packing), camera vector and tables of
    the scene on its device, as the JAX steps build them."""
    dev = scn.color.device
    xs, ys, pid = mk.tile_pixel_layout(camera.width, camera.height, *tile,
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
