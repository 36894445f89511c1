"""Inverse-rendering demo: recover scene colors from a target image by
gradient descent, through the wavefront autograd path (the default mode)
or the differentiable megakernel (--tri, --tex).

The default mode is tools/train_demo.py's: the `reference` scene's sphere
colors perturbed by U(-0.5, 0.5) (numpy default_rng(3)) and clipped to
[0.05, 1], a target rendered with the true colors under the key
fold_in(PRNGKey(0), 12345), the same key and spp as every training
estimate (common random numbers), torch.optim.Adam on the gradient of
diff.image_loss (the wavefront integrator's autograd; on the card every
nearest hit comes from the intersect kernel), each step projected back
onto the sphere rows (every other parameter stays true) and into [0, 1].
It prints the loss curve, the sphere-color MAD before and after and the
fwd+bwd Msamples/s, and writes a PNG strip (target | perturbed |
recovered, each rendered at 64 spp under keys of its own). --checkpoint
DIR saves the training state (diff.checkpoint: the colors and Adam's
state) after every step; --resume continues from its latest step.

The --tri and --tex modes are tools/train_demo.py's main_tri and main_tex:
the parameters are perturbed, the target is rendered with the
true ones and the same seeds as every training estimate (common random
numbers, so the Monte-Carlo noise cancels in the loss), and
torch.optim.Adam recovers them, clipped to [0, 1] after each step. --tri
perturbs every real triangle's color; --tex (scene `textures-train` by
default) perturbs the texels of the textures the JAX package stages by
U(-0.3, 0.3) and measures their mean abs error over all three channels of
exactly those texels (the JAX demo's mask covers the wrong atlas lanes, a
fault this port does not share: it trains the texel pool itself). Prints
the loss curve, the MAD and the fwd+bwd Msamples/s, and writes a PNG strip
(target | perturbed | recovered).

Usage:
    python -m pathtracer_tpu_torch.train_demo
    python -m pathtracer_tpu_torch.train_demo --checkpoint ck --resume
    python -m pathtracer_tpu_torch.train_demo --tri --scene teapot
    python -m pathtracer_tpu_torch.train_demo --tex

Runs on the CUDA card (--device cuda, the default), or on the CPU with the
plain PyTorch versions at a tiny size (--device cpu).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="pathtracer_tpu_torch.train_demo")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=120)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--out", default=None,
                    help="PNG strip (default out-train_demo.png, "
                         "out-train_demo_tri.png or out-train_demo_tex.png)")
    ap.add_argument("--tri", action="store_true",
                    help="mesh mode: recover per-triangle colors")
    ap.add_argument("--tex", action="store_true",
                    help="texture mode: recover the staged textures' texels")
    ap.add_argument("--scene", default=None,
                    help="default teapot (--tri), textures-train (--tex); "
                         "the default mode trains `reference`")
    ap.add_argument("--checkpoint", metavar="DIR", default=None,
                    help="default mode: save the training state under DIR "
                         "after every step (diff.save_train_state)")
    ap.add_argument("--resume", action="store_true",
                    help="default mode: continue from the latest step under "
                         "--checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.tri and args.tex:
        print("error: --tri and --tex are separate modes", file=sys.stderr)
        return 2
    mode = "tex" if args.tex else "tri" if args.tri else None
    if mode is None and args.scene not in (None, "reference"):
        print("error: the default mode trains `reference`'s sphere colors",
              file=sys.stderr)
        return 2
    if mode is not None and (args.checkpoint or args.resume):
        print("error: --checkpoint and --resume are the default mode's",
              file=sys.stderr)
        return 2
    if args.resume and not args.checkpoint:
        print("error: --resume needs --checkpoint DIR", file=sys.stderr)
        return 2
    if args.scene is None:
        args.scene = {"tex": "textures-train", "tri": "teapot",
                      None: "reference"}[mode]
    if args.out is None:
        args.out = ("out-train_demo.png" if mode is None
                    else f"out-train_demo_{mode}.png")
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("error: no CUDA device (pass --device cpu for the plain "
              "versions at a small size)", file=sys.stderr)
        return 1
    {"tex": main_tex, "tri": main_tri, None: main_colors}[mode](
        args, torch.device(args.device))
    return 0


def main_colors(args, device):
    """The default mode (tools/train_demo.py main): sphere colors of
    `reference` recovered through diff.image_loss's gradient with Adam;
    returns the sphere-color MAD before and after."""
    import torch

    from .config import RenderConfig
    from .diff import (extract_params, loss_and_grads, render_image_diff,
                       restore_train_state, save_train_state)
    from .io.png import write_png
    from .render import integrator, threefry
    from .render.vec3 import Vec3
    from .scene.shapes import SPHERE
    from .scenes import get_scene

    W, H = args.width, args.height
    cfg = RenderConfig(width=W, height=H, samples=args.spp,
                       samples_per_pass=args.spp)
    sc = get_scene("reference", cfg)
    arrays, meta = sc.pack(device=device)
    cam = sc.camera.pack(torch.float32, device)
    px, py = integrator.pixel_grid(W, 0, H, device)
    route = integrator.intersect_route(
        arrays, meta, cfg.replace(early_exit=False))

    def render(params, key, spp):
        acc = render_image_diff(params, arrays, meta, cfg, cam, px, py, key,
                                spp, route)
        return acc.to_array().detach().cpu().numpy().reshape(H, W, 3)

    true_params = extract_params(arrays)
    key = threefry.prng_key(0)
    # common random numbers: the target takes the key and spp of every
    # training estimate, so the Monte-Carlo noise cancels in the loss
    train_key = threefry.fold_in(key, 12345)
    with torch.no_grad():
        target = render_image_diff(true_params, arrays, meta, cfg, cam, px,
                                   py, train_key, args.spp, route)
        target = Vec3(*(c.detach() for c in target))

    # perturb the sphere colors: directly visible, so the problem is
    # well identified
    sphere = np.asarray([t == SPHERE for t in meta.obj_types]
                        + [False] * (meta.max_objects - meta.n_objects))
    rng = np.random.default_rng(3)
    true_c = true_params.color.detach().cpu().numpy()
    bad = true_c.copy()
    bad[sphere] = np.clip(bad[sphere] + rng.uniform(
        -0.5, 0.5, bad[sphere].shape), 0.05, 1.0)
    mask = torch.from_numpy(sphere[:, None].astype(np.float32)).to(device)
    color = torch.from_numpy(bad.astype(np.float32)).to(device)
    color.requires_grad_(True)
    opt = torch.optim.Adam([color], lr=args.lr)
    start = 0
    if args.resume:
        start, restored, opt_state = restore_train_state(
            args.checkpoint, true_params._replace(color=color.detach()),
            opt.state_dict())
        with torch.no_grad():
            color.copy_(restored.color)
        opt.load_state_dict(opt_state)
        print(f"resumed from {args.checkpoint} at step {start}")

    def step():
        loss, grads = loss_and_grads(true_params._replace(color=color),
                                     arrays, meta, cfg, cam, px, py,
                                     train_key, args.spp, target,
                                     route=route)
        opt.zero_grad()
        color.grad = grads.color
        opt.step()
        # projected descent: the sphere rows only, in [0, 1]
        with torch.no_grad():
            color.copy_(torch.clamp(color, 0.0, 1.0) * mask
                        + true_params.color * (1.0 - mask))
        return float(loss)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    losses = []
    t0 = time.perf_counter()
    timed_from = t0
    for i in range(start, args.steps):
        losses.append(step())
        if i == start:                # the first step builds the kernels
            sync()
            timed_from = time.perf_counter()
        if args.checkpoint:
            save_train_state(args.checkpoint, i + 1,
                             true_params._replace(color=color.detach()),
                             opt.state_dict())
        if i % 25 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.6f}", flush=True)
    sync()
    n_timed = max(1, len(losses) - 1)
    dt = time.perf_counter() - timed_from
    rate = W * H * args.spp * n_timed / max(dt, 1e-9) / 1e6
    err0 = float(np.abs(true_c[sphere] - bad[sphere]).mean())
    err1 = float(np.abs(true_c[sphere]
                        - color.detach().cpu().numpy()[sphere]).mean())
    dev_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
    loss_txt = (f"loss {losses[0]:.6f} -> {losses[-1]:.6f}; " if losses
                else "")
    print(f"{args.steps - start} steps ({n_timed} timed, {dt:.3f}s) on "
          f"{dev_name} ({rate:.2f} Msamples/s fwd+bwd); {loss_txt}"
          f"color MAD {err0:.4f} -> {err1:.4f}")
    with torch.no_grad():
        strip = np.concatenate([
            render(true_params, threefry.fold_in(key, 999), 64),
            render(true_params._replace(color=torch.from_numpy(
                bad.astype(np.float32)).to(device)),
                threefry.fold_in(key, 998), 64),
            render(true_params._replace(color=color.detach()),
                   threefry.fold_in(key, 997), 64)], axis=1)
    write_png(args.out, strip)
    print(f"wrote {args.out} (target | perturbed | recovered)")
    return err0, err1


def main_tri(args, device):
    """Mesh inverse rendering through make_diff_render_tri; returns the
    tri-color MAD before and after."""
    import torch

    from .config import RenderConfig
    from .io.png import write_png
    from .render import megakernel as mk
    from .render.grad import make_diff_render_tri
    from .scenes import get_scene

    W, H = args.width, args.height
    cfg = RenderConfig(width=W, height=H, samples=args.spp,
                       samples_per_pass=args.spp)
    sc = get_scene(args.scene, cfg)
    arrays, meta = sc.pack(device=device)
    if not meta.has_groups:
        raise SystemExit(f"--tri needs a mesh scene (e.g. teapot), not "
                         f"{args.scene!r}")
    S, L = (8, 512) if device.type == "cuda" else (8, 128)
    xs, ys, pid = mk.tile_pixel_layout(W, H, S, L,
                                       order=mk.default_order(meta))
    px = torch.from_numpy(xs).to(device)
    py = torch.from_numpy(ys).to(device)
    cam_vec = torch.from_numpy(mk.build_camera_vec(sc.camera)).to(device)
    obj = torch.from_numpy(mk.build_scene_table(arrays, meta)).to(device)
    nodes, tris, shade = (torch.from_numpy(t).to(device) for t in
                          mk.build_mesh_tables(arrays, meta,
                                               traversal="classic"))
    # one launch carries the whole budget: the atomic scatter has no
    # per-launch sample cap
    spp = args.spp
    render = make_diff_render_tri(meta, cfg, spp, (S, L), spp=spp)
    valid = torch.from_numpy((pid >= 0).reshape(xs.shape)
                             .astype(np.float32)).to(device)
    n_valid = float((pid >= 0).sum())
    inv = 1.0 / float(spp)
    seed = (11, 0)   # common random numbers: target and every estimate

    color, emission = arrays.color, arrays.emission

    def forward(tc):
        r, g, b = render.apply(color, emission, tc, seed, cam_vec, obj,
                               nodes, tris, shade, px, py)
        return r * inv, g * inv, b * inv

    tc_true = arrays.tri_color.clone()
    # real (non-padding) triangle slots have a nonzero geometric normal
    ng = torch.linalg.cross(arrays.tri_e1, arrays.tri_e2)
    real = (ng * ng).sum(dim=1) > 0
    rng = np.random.default_rng(5)
    noise = torch.from_numpy(rng.uniform(
        -0.35, 0.35, (int(real.sum()), 3)).astype(np.float32)).to(device)
    tc0 = tc_true.clone()
    tc0[real] = torch.clamp(tc0[real] + noise, 0.05, 1.0)

    with torch.no_grad():
        target = forward(tc_true)

    def loss_fn(tc):
        return sum(torch.sum(((x - t) * valid) ** 2)
                   for x, t in zip(forward(tc), target)) / (3.0 * n_valid)

    tc = tc0.clone().requires_grad_(True)
    opt = torch.optim.Adam([tc], lr=args.lr)

    def step():
        opt.zero_grad()
        loss = loss_fn(tc)
        loss.backward()
        opt.step()
        with torch.no_grad():
            tc.clamp_(0.0, 1.0)
        return float(loss.detach())

    losses = [step()]                 # step 0 builds the kernels
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(1, args.steps):
        losses.append(step())
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.6f}", flush=True)
    dt = time.perf_counter() - t0
    rate = W * H * spp * max(1, args.steps - 1) / max(dt, 1e-9) / 1e6

    err0 = float((tc_true[real] - tc0[real]).abs().mean())
    err1 = float((tc_true[real] - tc.detach()[real]).abs().mean())
    dev_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
    print(f"{args.steps} tri steps ({max(1, args.steps - 1)} timed, "
          f"{dt:.3f}s) on {dev_name} "
          f"({rate:.2f} Msamples/s fwd+bwd, {int(real.sum())} triangles); "
          f"loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
          f"tri-color MAD {err0:.4f} -> {err1:.4f}")

    def to_img(tcv):
        with torch.no_grad():
            r, g, b = forward(tcv)
        img = torch.stack([r, g, b], dim=-1).reshape(-1, 3).cpu().numpy()
        return mk.untile_image(img, pid, W, H).reshape(H, W, 3)

    strip = np.concatenate(
        [to_img(tc_true), to_img(tc0), to_img(tc.detach())], axis=1)
    write_png(args.out, strip)
    print(f"wrote {args.out} (target | perturbed | recovered)")
    return err0, err1


def main_tex(args, device):
    """Texel recovery through make_diff_render_tex; returns the texel MAD
    before and after."""
    import torch

    from .config import RenderConfig
    from .io.png import write_png
    from .render import megakernel as mk
    from .render.grad import make_diff_render_tex
    from .scene.pack import staged_objects, texel_params, trainable_texels
    from .scenes import get_scene

    W, H = args.width, args.height
    cfg = RenderConfig(width=W, height=H, samples=args.spp,
                       samples_per_pass=args.spp)
    sc = get_scene(args.scene, cfg)
    arrays, meta = sc.pack(device=device)
    if not staged_objects(meta):
        raise SystemExit(f"--tex needs a scene with staged textures (e.g. "
                         f"textures-train), not {args.scene!r}")
    S, L = (8, 512) if device.type == "cuda" else (8, 128)
    xs, ys, pid = mk.tile_pixel_layout(W, H, S, L,
                                       order=mk.default_order(meta))
    px = torch.from_numpy(xs).to(device)
    py = torch.from_numpy(ys).to(device)
    cam_vec = torch.from_numpy(mk.build_camera_vec(sc.camera)).to(device)
    obj = torch.from_numpy(mk.build_scene_table(arrays, meta)).to(device)
    nodes, tris, shade = (torch.from_numpy(t).to(device) for t in
                          mk.build_mesh_tables(arrays, meta,
                                               traversal="classic"))
    tex_table = torch.from_numpy(mk.build_tex_table(arrays, meta)).to(device)
    spp = args.spp
    render = make_diff_render_tex(meta, cfg, spp, spp, (S, L))
    valid = torch.from_numpy((pid >= 0).reshape(xs.shape)
                             .astype(np.float32)).to(device)
    n_valid = float((pid >= 0).sum())
    inv = 1.0 / float(spp)
    seed = (23, 0)   # common random numbers: target and every estimate

    color, emission = arrays.color, arrays.emission

    def forward(tex):
        r, g, b = render.apply(color, emission, tex, seed, cam_vec, obj,
                               nodes, tris, shade, px, py, tex_table)
        return r * inv, g * inv, b * inv

    tex_true = texel_params(arrays)
    # the texels that train: every texel of the staged textures, all three
    # channels
    active = trainable_texels(arrays, meta)
    rng = np.random.default_rng(7)
    noise = torch.from_numpy(rng.uniform(
        -0.3, 0.3, (int(active.sum()), 3)).astype(np.float32)).to(device)
    tex0 = tex_true.clone()
    tex0[active] = torch.clamp(tex0[active] + noise, 0.0, 1.0)

    with torch.no_grad():
        target = forward(tex_true)

    def loss_fn(tex):
        return sum(torch.sum(((x - t) * valid) ** 2)
                   for x, t in zip(forward(tex), target)) / (3.0 * n_valid)

    tex = tex0.clone().requires_grad_(True)
    opt = torch.optim.Adam([tex], lr=args.lr)

    def step():
        opt.zero_grad()
        loss = loss_fn(tex)
        loss.backward()
        opt.step()
        with torch.no_grad():
            tex.clamp_(0.0, 1.0)
        return float(loss.detach())

    losses = [step()]                 # step 0 builds the kernels
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(1, args.steps):
        losses.append(step())
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.6f}", flush=True)
    dt = time.perf_counter() - t0
    rate = W * H * spp * max(1, args.steps - 1) / max(dt, 1e-9) / 1e6

    err0 = float((tex0[active] - tex_true[active]).abs().mean())
    err1 = float((tex.detach()[active] - tex_true[active]).abs().mean())
    dev_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
    print(f"{args.steps} tex steps ({max(1, args.steps - 1)} timed, "
          f"{dt:.3f}s) on {dev_name} "
          f"({rate:.2f} Msamples/s fwd+bwd, {int(active.sum())} texels x 3 "
          f"channels); loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
          f"texel MAD {err0:.4f} -> {err1:.4f}")

    def to_img(t):
        with torch.no_grad():
            r, g, b = forward(t)
        img = torch.stack([r, g, b], dim=-1).reshape(-1, 3).cpu().numpy()
        return mk.untile_image(img, pid, W, H).reshape(H, W, 3)

    strip = np.concatenate(
        [to_img(tex_true), to_img(tex0), to_img(tex.detach())], axis=1)
    write_png(args.out, strip)
    print(f"wrote {args.out} (target | perturbed | recovered)")
    return err0, err1


if __name__ == "__main__":
    sys.exit(main())
