"""Whole frames through the program's render driver over a (pixels, spp)
mesh of ranks on one host, one process and one card a rank, back to back:
the path of the CLI's --distributed under torchrun
(`parallel.initialize_multihost`, `parallel.global_render_mesh`,
`driver.render_driver(mesh=)`), one client in a closed loop.

Traffic keys: "samples" (spp a frame) and "mesh" ([pixels, spp]; its
product is the number of ranks). The harness's process is rank 0, on the
harness's device. Set-up starts ranks 1.. as child processes of this file
(`python ptbench/jobs/render_frames_mesh.py --rank R --spec JSON`), which
the program places on cuda:R (the CPU where the harness runs there),
joined by a TCP rendezvous on 127.0.0.1 under the program's backend (NCCL
on the card, gloo on the CPU). Frame i takes the seed derived from
(--seed, i) on every rank: rank 0 hands it to the others in one broadcast
over a gloo group of the job's own; the warm-up frame takes (--seed,
"warm-up"). A step returns the whole frame's samples, as on one card. The
check is render_frames.py's, against ptbench/ref/mesh.py, once the other
ranks have stopped. On the card with fewer cards than ranks the run is
refused (code 2) before any rank starts.

Every wait across ranks is bounded: the rendezvous and the groups the job
asks for time out after TIMEOUT_S, the set-up after SETUP_S, a frame after
STEP_S, the other ranks' exit after JOIN_S. Rank 0 watches the others: one
that exits before it is told to, or a set-up or a frame past its bound,
ends the run at once (exit code 1, no result line), the other ranks
killed. A rank whose rank 0 is gone exits too.
"""
from __future__ import annotations

import argparse
import atexit
import datetime
import gc
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

if __name__ == "__main__":   # a rank of its own: the checkout on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from ptbench.harness import (Refused, derived_seed,  # noqa: E402
                              loaded_forbidden)
from ptbench.jobs import render_frames  # noqa: E402
from ptbench.ref import mesh as ref_mesh  # noqa: E402
from ptbench.ref import scene as ref_scene  # noqa: E402

TIMEOUT_S = 120
SETUP_S = 600
STEP_S = 120
JOIN_S = 60
STOP = -1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _exit_now(msg: str, procs=()) -> None:
    """End this process at once (exit code 1), the ranks in `procs`
    killed first."""
    print(f"render_frames_mesh: {msg}", file=sys.stderr, flush=True)
    for p in procs:
        if p.poll() is None:
            p.kill()
    os._exit(1)


class Rank:
    """One rank of the mesh: its group, its mesh, the scene on its device,
    the frames' config."""

    def __init__(self, spec: dict, rank: int):
        import torch.distributed as dist

        from pathtracer_tpu_torch import driver, parallel
        from pathtracer_tpu_torch.config import RenderConfig
        from pathtracer_tpu_torch.scenes import get_scene

        shape = tuple(spec["mesh"])
        self.device = parallel.initialize_multihost(
            f"127.0.0.1:{spec['port']}", shape[0] * shape[1], rank,
            device_type=spec["device"], timeout_s=TIMEOUT_S)
        self.mesh = parallel.global_render_mesh(shape)
        self.seeds = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=TIMEOUT_S))
        self.driver = driver
        c = spec["config"]
        self.cfg = RenderConfig(width=c["width"], height=c["height"],
                                samples=spec["samples"], **c["render"])
        t = time.perf_counter()
        sc = get_scene(c["program_scene"], self.cfg)
        self.arrays, self.meta = sc.pack(device=self.device)
        self.camera = sc.camera
        self.pack_s = time.perf_counter() - t

    def seed(self, value: int = 0) -> int:
        """Rank 0's `value` on every rank: one broadcast."""
        import torch
        import torch.distributed as dist

        t = torch.tensor([value], dtype=torch.int64)
        dist.broadcast(t, 0, group=self.seeds)
        return int(t[0])

    def render(self, seed: int):
        img, _ = self.driver.render_driver(
            self.arrays, self.meta, self.camera, self.cfg.replace(seed=seed),
            mesh=self.mesh)
        return img

    def close(self) -> None:
        import torch.distributed as dist

        self.arrays = self.meta = None
        if dist.is_initialized():
            dist.destroy_process_group()


class Job(render_frames.Job):
    kind = "render"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.shape = tuple(int(v) for v in ctx.cell.traffic["mesh"])
        self.rank = None
        self.procs = []
        self.stopped = False
        self.deadline = None     # the bound of the set-up or frame under way

    def check_cards(self):
        """Refuse (code 2, before any rank starts) a configuration whose
        "layout" names another mesh than the traffic's, and on the card
        fewer cards than ranks: the program's NCCL takes one rank a
        card."""
        n = self.shape[0] * self.shape[1]
        layout = self.config.get("layout")
        if layout is not None and (tuple(layout["mesh"]) != self.shape
                                   or layout["cards"] != n):
            raise Refused(f"the configuration lays its frame out on "
                          f"{layout['cards']} cards as {layout['mesh']}, "
                          f"the traffic on {n} as {list(self.shape)}", 2)
        if self.ctx.device.type == "cuda":
            import torch

            if torch.cuda.device_count() < n:
                raise Refused(f"{n} ranks, one card each, and "
                              f"{torch.cuda.device_count()} card(s) present",
                              2)

    def setup(self):
        import torch

        self.torch = torch          # render_frames.Job.release's
        self.check_cards()
        self.obj_text = render_frames.write_model(self.config)
        spec = {"config": self.config, "samples": self.samples,
                "mesh": list(self.shape), "port": free_port(),
                "device": self.ctx.device.type}
        self.deadline = time.monotonic() + SETUP_S
        code_root = str(Path(__file__).resolve().parents[2])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [code_root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        for r in range(1, self.shape[0] * self.shape[1]):
            self.procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--rank",
                 str(r), "--spec", json.dumps(spec)],
                cwd=str(self.ctx.root), env=env, stdout=2))
        atexit.register(self._at_exit)
        threading.Thread(target=self._watch, daemon=True).start()
        self.rank = Rank(spec, 0)
        if self.rank.device != self.ctx.device:
            _exit_now(f"rank 0 placed on {self.rank.device}, the harness "
                      f"measures {self.ctx.device}", self.procs)
        self.ctx.spans["pack"] = self.rank.pack_s
        self.render(derived_seed(self.ctx.seed, "warm-up"))
        self.deadline = None

    def _watch(self):
        while not self.stopped:
            time.sleep(0.2)
            if self.stopped:
                return
            dead = [(i + 1, p.returncode) for i, p in enumerate(self.procs)
                    if p.poll() is not None]
            if dead:
                _exit_now(f"rank(s) exited under way (rank, code): {dead}",
                          self.procs)
            if self.deadline is not None and time.monotonic() > self.deadline:
                _exit_now("a set-up or frame outlasted its bound",
                          self.procs)

    def render(self, seed: int):
        self.rank.seed(seed)
        return self.rank.render(seed)

    def step(self, i: int) -> int:
        self.deadline = time.monotonic() + STEP_S
        work = super().step(i)
        self.deadline = None
        return work

    def stop_workers(self):
        """Tell the other ranks to stop, leave the group with them (NCCL's
        teardown waits for every rank of a communicator) and wait for
        their exit (JOIN_S in all); the run ends at once where one does
        not exit cleanly."""
        if self.stopped:
            return
        self.stopped = True
        self.rank.seed(STOP)
        self.rank.close()
        end = time.monotonic() + JOIN_S
        bad = []
        for i, p in enumerate(self.procs):
            try:
                rc = p.wait(timeout=max(0.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = None
            if rc != 0:
                bad.append((i + 1, rc))
        if bad:
            _exit_now(f"rank(s) did not stop cleanly (rank, code): {bad}",
                      self.procs)

    def _at_exit(self):
        # a run that ends with a set-up or frame under way ends here, the
        # other ranks killed, before a process group is torn down
        if self.stopped:
            return
        if self.deadline is not None:
            _exit_now("ended with a set-up or frame under way", self.procs)
        self.stop_workers()

    def release(self):
        self.rank = None
        gc.collect()
        super().release()

    def check(self):
        self.stop_workers()
        return super().check()

    def reference(self, frame_seed, pixels, dtype=None, counts=None,
                  samples=None):
        import torch

        sc = ref_scene.build(self.config, self.obj_text, self.ctx.device)
        return ref_mesh.frame_pixels(
            sc, self.config, samples or self.samples, frame_seed, pixels,
            self.ctx.device, shape=self.shape, dtype=dtype or torch.float32)

    def reading(self, control: bool) -> dict:
        """render_frames.Job.reading; the other ranks stop at the first
        control (ptbench/calibrate.py reads every program seed first)."""
        if control:
            self.stop_workers()
        return super().reading(control)


def _orphan_watch():
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(0.5)
            if os.getppid() != parent:
                os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def worker(argv) -> int:
    """Rank --rank of the mesh: frames until rank 0 hands it STOP."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--spec", required=True)
    a = ap.parse_args(argv)
    _orphan_watch()
    spec = json.loads(a.spec)
    if spec["device"] == "cpu":
        import torch

        torch.set_num_threads(1)   # the CPU's ranks share its cores
    rank = Rank(spec, a.rank)
    while True:
        seed = rank.seed()
        if seed == STOP:
            break
        rank.render(seed)
    rank.close()
    found = loaded_forbidden()
    if found:
        print(f"rank {a.rank}: modules of JAX or the JAX package loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1:]))
