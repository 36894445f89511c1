"""Inverse-rendering steps through the wavefront autograd path: the
default job of the program's train_demo at the cell's size, one client in
a closed loop.

Traffic keys: "samples" (spp of every estimate), "lr" (Adam's), "noise"
(the colors' perturbation, uniform in +-noise, clipped to "clip"). From
--seed: the sphere colors' perturbation and the threefry key that the
target and every step share (common random numbers). The target is
rendered at set-up with the configuration's colors. A step is
`diff.loss_and_grads` on the whole image, Adam, and the projection onto
the sphere rows in [0, 1]; it ends when its loss is read on the host.

Set-up drives the one training state through its first three steps by
the window's own call, and the window goes on from there. The check, once
the window has closed: the reference (ptbench/ref/wavefront.py) takes the
same three steps from the same inputs; compared are each step's loss, the
norm of the first gradient as Adam got it (its first moment after one
step over 1 - beta1) and the norm of the colors' change after three
steps, each as the gap of the program's from the reference's over the
reference's.
"""
from __future__ import annotations

import gc

import numpy as np

from ptbench.harness import derived_seed
from ptbench.ref import scene as ref_scene
from ptbench.ref import threefry as ref_threefry
from ptbench.ref import wavefront as ref_wf

FIRST = 3          # the steps the reference follows
BETA1 = 0.9        # torch.optim.Adam's default


def inputs(config: dict, traffic: dict, seed: int):
    """What the benchmark hands to both sides: the configuration's colors
    and emission [n, 3], the perturbed colors, the sphere rows and the
    threefry seed."""
    objs = config["scene"]["objects"]
    true = np.asarray([o.get("color", (1.0, 1.0, 1.0)) for o in objs],
                      np.float32)
    emission = np.asarray([o.get("emission", (0.0, 0.0, 0.0)) for o in objs],
                          np.float32)
    sphere = np.asarray([o["type"] == "sphere" for o in objs])
    rng = np.random.default_rng(derived_seed(seed, "colors"))
    bad = true.copy()
    noise = rng.uniform(-traffic["noise"], traffic["noise"],
                        bad[sphere].shape)
    bad[sphere] = np.clip(bad[sphere] + noise, *traffic["clip"])
    return true, emission, bad.astype(np.float32), sphere, derived_seed(
        seed, "key")


def gap(prog: float, ref: float) -> float:
    """|prog - ref| / |ref|; 1e30, which JSON can carry, where either is
    not finite or ref is 0."""
    if not (np.isfinite(prog) and np.isfinite(ref)) or ref == 0.0:
        return 1e30
    return abs(prog - ref) / abs(ref)


class Job:
    kind = "train"

    def __init__(self, ctx):
        self.ctx = ctx
        self.config = ctx.cell.config
        self.traffic = ctx.cell.traffic
        self.samples = int(self.traffic["samples"])
        self.failed = 0
        self.step_samples = (self.config["width"] * self.config["height"]
                             * self.samples)
        self.losses = []

    def setup(self):
        import time

        import torch

        from pathtracer_tpu_torch import diff
        from pathtracer_tpu_torch.config import RenderConfig
        from pathtracer_tpu_torch.render import integrator, threefry
        from pathtracer_tpu_torch.render.vec3 import Vec3
        from pathtracer_tpu_torch.scenes import get_scene

        self.torch, self.diff = torch, diff
        c, dev = self.config, self.ctx.device
        W, H = c["width"], c["height"]
        self.cfg = RenderConfig(width=W, height=H, samples=self.samples,
                                samples_per_pass=self.samples, **c["render"])
        t = time.perf_counter()
        sc = get_scene(c["program_scene"], self.cfg)
        self.arrays, self.meta = sc.pack(device=dev)
        self.ctx.spans["pack"] = time.perf_counter() - t
        self.cam = sc.camera.pack(torch.float32, dev)
        self.px, self.py = integrator.pixel_grid(W, 0, H, dev)
        self.route = integrator.intersect_route(
            self.arrays, self.meta, self.cfg.replace(early_exit=False))
        self.true_params = diff.extract_params(self.arrays)
        true, _, bad, sphere, key_seed = inputs(c, self.traffic,
                                                self.ctx.seed)
        self.key = threefry.prng_key(key_seed)
        n, no = len(true), self.meta.max_objects
        if not np.array_equal(self.true_params.color[:n].cpu().numpy(),
                              true):
            raise ValueError("the program's scene colors are not the "
                             "configuration's")
        with torch.no_grad():
            target = diff.render_image_diff(
                self.true_params, self.arrays, self.meta, self.cfg, self.cam,
                self.px, self.py, self.key, self.samples, self.route)
            self.target = Vec3(*(a.detach() for a in target))
        start = self.true_params.color.detach().clone()
        start[:n] = torch.from_numpy(bad).to(dev)
        self.mask = torch.zeros((no, 1), dtype=torch.float32, device=dev)
        self.mask[:n, 0] = torch.from_numpy(sphere.astype(np.float32))
        self.color = start.clone().requires_grad_(True)
        self.opt = torch.optim.Adam([self.color], lr=self.traffic["lr"])
        self.start = start
        for i in range(FIRST):
            self.step(-1 - i)
            if i == 0:
                # what Adam got, from its first moment (none: no gradient)
                m = self.opt.state[self.color].get("exp_avg")
                self.grad1 = (torch.zeros_like(start) if m is None
                              else (m / (1.0 - BETA1)).detach().clone())
        self.change = (self.color.detach() - start).clone()

    def step(self, i: int) -> int:
        torch, diff = self.torch, self.diff
        loss, grads = diff.loss_and_grads(
            self.true_params._replace(color=self.color), self.arrays,
            self.meta, self.cfg, self.cam, self.px, self.py, self.key,
            self.samples, self.target, route=self.route)
        self.opt.zero_grad()
        self.color.grad = grads.color
        self.opt.step()
        with torch.no_grad():
            self.color.copy_(torch.clamp(self.color, 0.0, 1.0) * self.mask
                             + self.true_params.color * (1.0 - self.mask))
        self.losses.append(float(loss))
        return self.step_samples

    def release(self):
        self.arrays = self.route = self.target = self.opt = None
        self.true_params = self.color = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def reference(self, dtype=None, half: bool = False):
        """(losses, first gradient, change after FIRST steps) of the
        reference's own steps from the same inputs; with `half`, on every
        other pixel alone (a fault: half of the batch left out, the mean
        taken over the rest)."""
        import torch

        dtype = dtype or torch.float32
        c, dev = self.config, self.ctx.device
        W, H = c["width"], c["height"]
        sc = ref_scene.build(c, "", dev)
        true, emission, bad, sphere, key_seed = inputs(c, self.traffic,
                                                       self.ctx.seed)
        key = ref_threefry.prng_key(key_seed)
        ys, xs = np.mgrid[0:H, 0:W]
        every = 2 if half else 1
        px = torch.from_numpy(xs.ravel()[::every].astype(np.int32)).to(dev)
        py = torch.from_numpy(ys.ravel()[::every].astype(np.int32)).to(dev)
        t_true = torch.from_numpy(true).to(dev, dtype)
        emi = torch.from_numpy(emission).to(dev, dtype)

        def render(color):
            return ref_wf.render_image(sc, c["render"], color, emi, px, py,
                                       key, self.samples, self.samples,
                                       dtype)

        with torch.no_grad():
            target = render(t_true)
        mask = torch.from_numpy(sphere.astype(np.float32))[:, None].to(
            dev, dtype)
        color = torch.from_numpy(bad).to(dev, dtype)
        start = color.clone()
        state, losses, grad1 = {}, [], None
        for i in range(FIRST):
            leaf = color.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = ref_wf.image_loss(render(leaf), target)
                (g,) = torch.autograd.grad(loss, [leaf])
            losses.append(float(loss.detach()))
            with torch.no_grad():
                color = leaf.detach().clone()
                ref_wf.adam(color, g, state, self.traffic["lr"])
                if i == 0:
                    grad1 = state["exp_avg"] / (1.0 - BETA1)
                color = (torch.clamp(color, 0.0, 1.0) * mask
                         + t_true * (1.0 - mask))
        return losses, grad1, color - start

    def compare(self, losses, grad1, change) -> dict:
        """The numbers compared: the program's first steps against
        (losses, grad1, change)."""
        n = grad1.shape[0]
        mine = (self.losses[:FIRST], self.grad1[:n].float(),
                self.change[:n].float())
        return {
            "loss_gap": max(gap(a, b) for a, b in zip(mine[0], losses)),
            "grad_gap": gap(float(mine[1].norm()), float(grad1.float().norm())),
            "change_gap": gap(float(mine[2].norm()),
                              float(change.float().norm()))}

    def reading(self, control: bool, fault: str = None) -> dict:
        """The numbers the check compares for the seed's first steps: the
        program's (a fresh set-up), or with `control` the reference's in
        bfloat16 put in the program's place, or with `fault` "half-batch"
        the reference's on half of the pixels (ptbench/calibrate.py)."""
        import torch

        if fault == "half-batch":
            self.losses, self.grad1, self.change = self.reference(half=True)
        elif fault is not None:
            raise ValueError(f"no fault {fault!r} to plant")
        elif control:
            self.losses, self.grad1, self.change = self.reference(
                dtype=torch.bfloat16)
        else:
            self.losses = []
            self.setup()
        return self.compare(*self.reference())

    def check(self):
        limits = self.ctx.cell.checks.get("limits", {})
        self.grad1 = self.grad1.cpu()
        self.change = self.change.cpu()
        self.release()
        losses, grad1, change = self.reference()
        got = self.compare(losses, grad1.cpu(), change.cpu())
        return [{"name": k, "value": v, "limit": limits.get(k)}
                for k, v in got.items()]
