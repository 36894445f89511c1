"""Triangle-colour training steps through the differentiable megakernel:
the job of the program's `train_demo --tri` at the cell's size, one client
in a closed loop.

Traffic keys: "samples" (spp of every estimate, one launch), "lr"
(Adam's), "noise" (each triangle's colour perturbed, uniform in +-noise,
clipped to "clip"), "check_steps" (the steps the check follows). From
--seed: the perturbation, made by triangle of the model's .obj text and
handed to each side in its own slot order, and the launch's seed, which
the target and every step share (common random numbers). The target is
rendered at set-up with the true colours. A step is the forward (K1-mesh)
and backward (K6) of `render.grad.make_diff_render_tri`, the masked mean
squared error, Adam and the clamp to [0, 1]; it ends when its loss is
read on the host.

Set-up drives the training state through its first "check_steps" steps
by the window's own call, and the window goes on from there. The check,
once the window has closed: the reference (ptbench/ref/tristep.py) takes
the same steps from the same inputs; compared are each step's loss, the
norm of the first gradient as Adam got it (its first moment after one
step over 1 - beta1) and the norm of the colours' change after those
steps, as relative gaps, and the first gradient's direction: one less
the cosine between the two sides' gradients, triangle by triangle of the
model's .obj order (a gradient whose sign is wrong on some triangles keeps
its norm but not its direction).
"""
from __future__ import annotations

import gc
import time

import numpy as np

from ptbench.harness import derived_seed
from ptbench.jobs.ad_steps import BETA1, gap
from ptbench.jobs.render_frames import write_model
from ptbench.ref import objtext
from ptbench.ref import scene as ref_scene
from ptbench.ref import tristep
from ptbench.ref import wavefront as ref_wf


def triangle_keys(p1, e1, e2) -> list:
    """A key a triangle: the bytes of its float32 corner and edges, as
    both sides store them."""
    rows = np.concatenate([p1, e1, e2], axis=1).astype(np.float32)
    return [r.tobytes() for r in rows]


class Job:
    kind = "train"

    def __init__(self, ctx):
        self.ctx = ctx
        self.config = ctx.cell.config
        self.traffic = ctx.cell.traffic
        self.samples = int(self.traffic["samples"])
        self.first = int(self.traffic["check_steps"])
        self.failed = 0
        self.step_samples = (self.config["width"] * self.config["height"]
                             * self.samples)
        self.losses = []
        self.obj_text = objtext.model_text(self.config["model"])
        self.n_tri = int(self.config["model"]["triangles"])

    def inputs(self):
        """(colours by triangle [T, 3], launch seed), from the seed."""
        p1 = objtext.parse(self.obj_text)[0]
        rng = np.random.default_rng(derived_seed(self.ctx.seed, "colors"))
        noise = rng.uniform(-self.traffic["noise"], self.traffic["noise"],
                            (p1.shape[0], 3))
        colors = np.clip(1.0 + noise, *self.traffic["clip"])
        return colors.astype(np.float32), derived_seed(self.ctx.seed, "key")

    def setup(self):
        import torch

        from pathtracer_tpu_torch.config import RenderConfig
        from pathtracer_tpu_torch.render import megakernel as mk
        from pathtracer_tpu_torch.render.grad import make_diff_render_tri
        from pathtracer_tpu_torch.scenes import get_scene

        self.torch = torch
        c, dev = self.config, self.ctx.device
        W, H = c["width"], c["height"]
        write_model(c)
        cfg = RenderConfig(width=W, height=H, samples=self.samples,
                           samples_per_pass=self.samples, **c["render"])
        t = time.perf_counter()
        sc = get_scene(c["program_scene"], cfg)
        arrays, meta = sc.pack(device=dev)
        self.ctx.spans["pack"] = time.perf_counter() - t
        S, L = tristep.TILE
        xs, ys, pid = mk.tile_pixel_layout(W, H, S, L,
                                           order=mk.default_order(meta))
        px = torch.from_numpy(xs).to(dev)
        py = torch.from_numpy(ys).to(dev)
        cam = torch.from_numpy(mk.build_camera_vec(sc.camera)).to(dev)
        obj = torch.from_numpy(mk.build_scene_table(arrays, meta)).to(dev)
        nodes, tris, shade = (torch.from_numpy(t).to(dev) for t in
                              mk.build_mesh_tables(arrays, meta,
                                                   traversal="classic"))
        render = make_diff_render_tri(meta, cfg, self.samples, (S, L),
                                      spp=self.samples)
        valid = torch.from_numpy((pid >= 0).reshape(xs.shape).astype(
            np.float32)).to(dev)
        n_valid = float((pid >= 0).sum())
        inv = 1.0 / float(self.samples)
        colors, seed = self.inputs()

        def forward(tc):
            r, g, b = render.apply(arrays.color, arrays.emission, tc,
                                   (seed, 0), cam, obj, nodes, tris, shade,
                                   px, py)
            return r * inv, g * inv, b * inv

        # each of the program's slots takes its triangle's colour
        ids = {k: i for i, k in enumerate(triangle_keys(
            *self.geometry()))}
        keys = triangle_keys(*(a.cpu().numpy() for a in (
            arrays.tri_p1, arrays.tri_e1, arrays.tri_e2)))
        slot_ids = np.asarray([ids.get(k, -1) for k in keys])
        tc_true = arrays.tri_color.clone()
        start = tc_true.clone()
        real = torch.from_numpy(slot_ids >= 0).to(dev)
        start[real] = torch.from_numpy(colors[slot_ids[slot_ids >= 0]]).to(
            dev)
        with torch.no_grad():
            target = forward(tc_true)

        def loss_fn(tc):
            return sum(torch.sum(((x - t) * valid) ** 2)
                       for x, t in zip(forward(tc), target)) / (3.0 * n_valid)

        self.loss_fn = loss_fn
        self.tc = start.clone().requires_grad_(True)
        self.opt = torch.optim.Adam([self.tc], lr=self.traffic["lr"])
        for i in range(self.first):
            self.step(-1 - i)
            if i == 0:
                m = self.opt.state[self.tc].get("exp_avg")
                self.grad1 = (torch.zeros_like(start) if m is None
                              else (m / (1.0 - BETA1)).detach().clone())
                self.grad1_tri = self.by_triangle(self.grad1, slot_ids)
        self.change = (self.tc.detach() - start).clone()

    def geometry(self):
        """(p1, e1, e2) float32 of the model's triangles, by .obj order."""
        p1, p2, p3 = objtext.parse(self.obj_text)[:3]
        return (p1.astype(np.float32), (p2 - p1).astype(np.float32),
                (p3 - p1).astype(np.float32))

    def by_triangle(self, a, ids):
        """[T, 3] float64 of slot-ordered `a` in the model's .obj order,
        given each slot's triangle (-1: none)."""
        out = np.zeros((self.n_tri, 3))
        a = a.detach().double().cpu().numpy()
        out[ids[ids >= 0]] = a[ids >= 0]
        return out

    def step(self, i: int) -> int:
        self.opt.zero_grad()
        loss = self.loss_fn(self.tc)
        loss.backward()
        self.opt.step()
        with self.torch.no_grad():
            self.tc.clamp_(0.0, 1.0)
        self.losses.append(float(loss.detach()))
        return self.step_samples

    def release(self):
        self.loss_fn = self.opt = self.tc = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def reference(self, dtype=None, every: int = 1):
        """(losses, first gradient, change, first gradient by triangle)
        of the reference's own first steps from the same inputs, in the
        reference's slot order; with `every` > 1 the loss of every
        every-th slot alone (a fault)."""
        import torch

        dtype = dtype or torch.float32
        c, dev = self.config, self.ctx.device
        sc = ref_scene.build(c, self.obj_text, dev)
        colors, seed = self.inputs()
        ids = sc.tri_ids
        true = torch.from_numpy(np.where(
            ids[:, None] >= 0, np.ones((1, 3)), 0.0).astype(np.float32)).to(dev)
        color = torch.from_numpy(np.where(
            ids[:, None] >= 0, colors[np.clip(ids, 0, None)], 0.0).astype(
            np.float32)).to(dev)
        target = tristep.render(sc, c, seed, self.samples, true, dev, dtype)
        start = color.clone()
        state, losses, grad1 = {}, [], None
        for i in range(self.first):
            loss, g = tristep.loss_and_grad(sc, c, seed, self.samples, color,
                                            target, dev, dtype, every)
            losses.append(loss)
            ref_wf.adam(color, g.float(), state, self.traffic["lr"])
            if i == 0:
                grad1 = state["exp_avg"] / (1.0 - BETA1)
            color = torch.clamp(color, 0.0, 1.0)
        return losses, grad1, color - start, self.by_triangle(grad1, ids)

    def compare(self, losses, grad1, change, grad1_tri) -> dict:
        ga, gb = self.grad1_tri.ravel(), grad1_tri.ravel()
        na, nb = np.linalg.norm(ga), np.linalg.norm(gb)
        cos = float(ga @ gb / (na * nb)) if na > 0 and nb > 0 else 0.0
        return {
            "loss_gap": max(gap(a, b) for a, b in
                            zip(self.losses[:self.first], losses)),
            "grad_gap": gap(float(self.grad1.float().norm()),
                            float(grad1.float().norm())),
            "change_gap": gap(float(self.change.float().norm()),
                              float(change.float().norm())),
            "grad_dir_gap": 1.0 - cos if np.isfinite(cos) else 1e30}

    def reading(self, control: bool, fault: str = None) -> dict:
        """The numbers the check compares for the seed's first steps: the
        program's (a fresh set-up), or with `control` the reference's in
        bfloat16 put in the program's place, or with `fault` "half-batch"
        the reference's on every other slot (ptbench/calibrate.py)."""
        import torch

        if fault == "half-batch":
            (self.losses, self.grad1, self.change,
             self.grad1_tri) = self.reference(every=2)
        elif fault is not None:
            raise ValueError(f"no fault {fault!r} to plant")
        elif control:
            (self.losses, self.grad1, self.change,
             self.grad1_tri) = self.reference(dtype=torch.bfloat16)
        else:
            self.losses = []
            self.setup()
        return self.compare(*self.reference())

    def check(self):
        limits = self.ctx.cell.checks.get("limits", {})
        self.grad1 = self.grad1.cpu()
        self.change = self.change.cpu()
        self.release()
        losses, grad1, change, grad1_tri = self.reference()
        got = self.compare(losses, grad1.cpu(), change.cpu(), grad1_tri)
        return [{"name": k, "value": v, "limit": limits.get(k)}
                for k, v in got.items()]
