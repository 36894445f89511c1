"""Whole frames through the program's render driver, back to back: the
CLI's path (`driver.render_driver`), one client in a closed loop.

Traffic keys: "samples" (spp a frame). Frame i of a run takes the seed
derived from (--seed, i); the warm-up frame before the window takes
(--seed, "warm-up"). The check, once the window has closed: one finished
frame (kept by reservoir sampling from the seed, so that the window holds
one image) and a set of its pixels drawn from the seed ("pixels" of the
cell's check file), the program's values against the reference's
(ptbench/ref/frame.py), as the mean and the largest absolute gap over
those pixels' channels, each over the reference's mean value there.
"""
from __future__ import annotations

import gc
import os
from pathlib import Path

import numpy as np

from ptbench import roofline
from ptbench.harness import derived_seed
from ptbench.ref import frame as ref_frame
from ptbench.ref import layout as ref_layout
from ptbench.ref import objtext
from ptbench.ref import scene as ref_scene


def write_model(config: dict) -> str:
    """The configuration's stand-in .obj text, written to PT_ASSETS where
    the program's asset path finds it ("" for a scene without a model)."""
    model = config.get("model")
    if model is None:
        return ""
    text = objtext.model_text(model)
    path = Path(os.environ["PT_ASSETS"]) / model["file"]
    if not path.is_file() or path.read_text() != text:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(text)
        os.replace(tmp, path)
    return text


def gaps(prog: np.ndarray, ref: np.ndarray) -> dict:
    """The mean and the largest absolute gap of the program's values from
    the reference's, each over the reference's mean absolute value (1e30,
    which JSON can carry, where a value is not finite)."""
    scale = float(np.abs(ref).mean())
    d = np.abs(prog.astype(np.float64) - ref.astype(np.float64))
    if not np.isfinite(d).all() or scale <= 0.0:
        return {"gap_mean": 1e30, "gap_max": 1e30}
    return {"gap_mean": float(d.mean() / scale),
            "gap_max": float(d.max() / scale)}


class Job:
    kind = "render"

    def __init__(self, ctx):
        self.ctx = ctx
        self.config = ctx.cell.config
        self.samples = int(ctx.cell.traffic["samples"])
        self.failed = 0
        self.kept = None                 # (frame index, image)
        self.keep = np.random.default_rng(derived_seed(ctx.seed, "keep"))
        self.frame_samples = (self.config["width"] * self.config["height"]
                              * self.samples)

    def setup(self):
        import time

        import torch

        from pathtracer_tpu_torch import driver
        from pathtracer_tpu_torch.config import RenderConfig
        from pathtracer_tpu_torch.scenes import get_scene

        self.torch, self.driver = torch, driver
        self.obj_text = write_model(self.config)
        c = self.config
        self.cfg = RenderConfig(width=c["width"], height=c["height"],
                                samples=self.samples, **c["render"])
        t = time.perf_counter()
        sc = get_scene(c["program_scene"], self.cfg)
        self.arrays, self.meta = sc.pack(device=self.ctx.device)
        self.camera = sc.camera
        self.ctx.spans["pack"] = time.perf_counter() - t
        self.render(derived_seed(self.ctx.seed, "warm-up"))

    def render(self, seed: int) -> np.ndarray:
        img, _ = self.driver.render_driver(
            self.arrays, self.meta, self.camera, self.cfg.replace(seed=seed))
        return img

    def step(self, i: int) -> int:
        img = self.render(derived_seed(self.ctx.seed, i))
        if self.keep.integers(i + 1) == 0:
            self.kept = (i, img)
        return self.frame_samples

    def release(self):
        """Drop the program's state before the reference runs."""
        self.arrays = self.meta = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def pixels(self):
        """The sorted pixel ids the check compares, drawn from the seed."""
        rng = np.random.default_rng(derived_seed(self.ctx.seed, "check"))
        c = self.config
        k = int(self.ctx.cell.checks["pixels"])
        return np.sort(rng.choice(c["width"] * c["height"], k,
                                  replace=False))

    def reference(self, frame_seed, pixels, dtype=None, counts=None,
                  samples=None):
        import torch

        sc = ref_scene.build(self.config, self.obj_text, self.ctx.device)
        return ref_frame.frame_pixels(
            sc, self.config, samples or self.samples, frame_seed, pixels,
            self.ctx.device, dtype=dtype or torch.float32, counts=counts)

    def check(self):
        limits = self.ctx.cell.checks.get("limits", {})
        if self.kept is None:
            return [{"name": "frames", "value": 0, "limit": None}]
        j, img = self.kept
        pix = self.pixels()
        prog = img.reshape(-1, 3)[pix]
        self.kept = None
        self.release()
        ref = self.reference(derived_seed(self.ctx.seed, j), pix)
        return [{"name": k, "value": v, "limit": limits.get(k)}
                for k, v in gaps(prog, ref).items()]

    def reading(self, control: bool) -> dict:
        """The numbers the check compares, on frame 0 of the seed: the
        program's frame, or with `control` the reference in bfloat16 put
        in the program's place (ptbench/calibrate.py)."""
        import torch

        fs = derived_seed(self.ctx.seed, 0)
        pix = self.pixels()
        ref = self.reference(fs, pix)
        if control:
            got = self.reference(fs, pix, dtype=torch.bfloat16)
        else:
            got = self.render(fs).reshape(-1, 3)[pix]
        return gaps(got, ref)

    def forward_bound_s(self, n_samples: int, n_frames: int):
        """The roofline bound (seconds, by) of the forward kernel's work
        for n_samples samples in n_frames frames: the work per sample
        counted by the reference over one whole 8-spp frame; the bytes of
        each launch (tables and pixel maps in, three sums a slot out).
        None on a mesh scene, whose work depends on the BVH walked."""
        c = self.config
        sc = ref_scene.build(c, self.obj_text, self.ctx.device)
        if sc.has_mesh:
            return None
        counts = {}
        W, H = c["width"], c["height"]
        self.reference(derived_seed(self.ctx.seed, "work"),
                       np.arange(W * H), counts=counts, samples=8)
        scale = n_samples / counts["samples"]
        ops = roofline.forward_ops(counts, sc.types) * scale
        segs = ref_layout.segments(self.samples, sc.has_mesh)
        (S, L), order, pack, axis = ref_layout.policy(False, segs[0][1])
        slots = ref_layout.pixel_layout(W, H, S, L, order, pack, axis).size
        tables = sum(t.numel() * 4 for t in (sc.obj_table, sc.nodes, sc.tris,
                                             sc.shade)) + 17 * 4
        per_launch = tables + 2 * slots * 4 + 3 * slots * 4
        return roofline.bound_of(ops, per_launch * len(segs) * n_frames)
