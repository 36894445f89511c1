"""The four-card cell `reference-render-4chip` cut to the CPU: its job
(ptbench/jobs/render_frames_mesh.py) over four gloo ranks, the harness's
process rank 0 and three child processes, at 32x24; the faults its check
has to catch; a rank killed in the window; the sharded reference
(ptbench/ref/mesh.py) against the program's one-process mesh; the readers
of the mesh's spans and NCCL kernels on canned traces."""
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY
from ptbench import harness
from ptbench.jobs import render_frames
from ptbench.ref import mesh as ref_mesh
from ptbench.ref import scene as ref_scene

CELL = "reference-render-4chip"
METRICS = {0: {"render_msamples_s", "setup_s"}, 1: {"device_idle_pct.mesh"}}


def shrink(c):
    """The cell cut to conftest.TINY's frame: the same scene, mesh and
    traffic."""
    c.config.update(width=TINY["width"], height=TINY["height"])
    if "model" in c.config:
        m = c.config["model"]
        m.update(lat=TINY["lat"], lon=TINY["lon"],
                 triangles=2 * TINY["lon"] * (TINY["lat"] - 1))
    c.traffic["samples"] = TINY["samples"]
    c.checks = dict(c.checks, pixels=TINY["pixels"])
    return c


@pytest.fixture
def one_thread():
    """Rank 0 on one thread, as the job runs the other ranks on the CPU:
    four ranks share its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mesh_run(monkeypatch, tmp_path, one_thread):
    """run(trace=0, patch=None, seconds) -> (result, lines): one run of
    the cell cut to TINY on the CPU, four gloo ranks."""
    real = harness.cell
    monkeypatch.setattr(harness, "cell",
                        lambda root, name: shrink(real(ROOT, name)))

    def run(trace=0, patch=None, seconds=0.5, seed=3000000001):
        return harness.run(
            ["--workload", CELL, "--seed", str(seed), "--seconds",
             str(seconds), "--trace", str(trace)], time.perf_counter(),
            root=tmp_path, device=torch.device("cpu"), patch=patch)
    return run


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(mesh_run, trace):
    res, lines = mesh_run(trace=trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] >= 1, res["checks"]
    assert res["failed"] == 0 and res["device"]["count"] == 4
    assert set(res["metrics"]) == METRICS[trace]
    assert set(res["checks"]) == {"gap_mean", "gap_max"}
    # the plain versions on four ranks, bit for bit
    assert all(ch["value"] == 0.0 for ch in res["checks"].values()), lines
    assert lines[0].startswith(f"steps {res['attempted']}: seconds min ")


def _other_slice(monkeypatch):
    # rank 0 renders the samples of its pixel shard's other spp rank
    from pathtracer_tpu_torch.parallel import render_dist

    real = render_dist.megakernel_shard

    def shard(sh, pix_rank, spp_rank, *a, **kw):
        return real(sh, pix_rank, 1 - spp_rank, *a, **kw)
    monkeypatch.setattr(render_dist, "megakernel_shard", shard)


def _gather_order(monkeypatch):
    # rank 0 joins the gathered pixel shards in reverse order
    from pathtracer_tpu_torch.parallel import mesh

    real = mesh.RenderMesh.total

    def total(self, t):
        out = real(self, t)
        return torch.cat(out.chunk(self.shape["pixels"])[::-1])
    monkeypatch.setattr(mesh.RenderMesh, "total", total)


@pytest.mark.parametrize("fault", [_other_slice, _gather_order])
def test_faults_fail_the_check(mesh_run, monkeypatch, fault):
    fault(monkeypatch)
    res, _ = mesh_run(seconds=0.2)
    assert res["correct"] is False
    assert any(ch["value"] > ch["limit"] for ch in res["checks"].values())


KILL = """
import sys, time, torch
torch.set_num_threads(1)
sys.path.insert(0, {tests!r})
sys.path.insert(0, {root!r})
from pathlib import Path
from ptbench import harness
import test_ptb_mesh
real = harness.cell
harness.cell = lambda root, name: test_ptb_mesh.shrink(
    real(Path({root!r}), name))

def patch(job):
    step = job.step

    def killing(i):
        if i == 1:
            job.procs[0].kill()
        return step(i)
    job.step = killing

res = harness.run(["--workload", {cell!r}, "--seed", "7", "--seconds",
                   "60"], time.perf_counter(), root=Path({tmp!r}),
                  device=torch.device("cpu"), patch=patch)
print(res)
"""


def test_a_rank_killed_in_the_window_ends_the_run(tmp_path):
    """Rank 1 killed in the window: the run ends nonzero within seconds,
    with no result, and leaves no rank behind."""
    code = KILL.format(tests=str(ROOT / "ptbench" / "tests"),
                       root=str(ROOT), cell=CELL, tmp=str(tmp_path))
    t = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path))
    took = time.perf_counter() - t
    assert p.returncode != 0 and p.stdout.strip() == "", p.stdout[-2000:]
    assert "render_frames_mesh" in p.stderr or "Error" in p.stderr
    # set-up (tens of seconds on the CPU) and a frame, well inside the
    # window it asked for
    assert took < 120, took
    end = time.monotonic() + 10
    while _ranks_in(tmp_path) and time.monotonic() < end:
        time.sleep(0.2)
    assert not _ranks_in(tmp_path)


def _ranks_in(path):
    """The pids of the job's ranks working in `path`."""
    found = []
    for pid in subprocess.run(["pgrep", "-f", "render_frames_mesh.py"],
                              capture_output=True, text=True).stdout.split():
        try:
            if os.readlink(f"/proc/{pid}/cwd") == str(path):
                found.append(pid)
        except OSError:
            pass
    return found


@pytest.mark.parametrize("config", ["reference", "gopher16k"])
def test_reference_is_the_programs_mesh_frame(monkeypatch, tmp_path,
                                              one_thread, config):
    """ptbench/ref/mesh.py against the program's render driver over a
    one-process (2, 2) mesh (parallel.mesh.LogicalMesh), every pixel, bit
    for bit; the primitive scene's tiles and the mesh scene's blocks; the
    reference's pixels in many batches."""
    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.driver import render_driver
    from pathtracer_tpu_torch.parallel.mesh import LogicalMesh
    from pathtracer_tpu_torch.scenes import get_scene

    c = shrink(harness.cell(ROOT, {"reference": "reference-render",
                                   "gopher16k": "gopher16k-render"}[config]))
    conf = c.config
    monkeypatch.setenv("PT_ASSETS", str(tmp_path))
    text = render_frames.write_model(conf)
    samples = 16 if config == "reference" else 8
    cfg = RenderConfig(width=conf["width"], height=conf["height"],
                       samples=samples, seed=123456789, **conf["render"])
    sc = get_scene(conf["program_scene"], cfg)
    arrays, meta = sc.pack(device=torch.device("cpu"))
    img, stats = render_driver(arrays, meta, sc.camera, cfg,
                               mesh=LogicalMesh((2, 2)))
    assert stats.backend == "megakernel@2x2"
    rs = ref_scene.build(conf, text, torch.device("cpu"))
    pix = np.arange(conf["width"] * conf["height"])
    monkeypatch.setattr(ref_mesh, "RAYS_A_BATCH", 100 * samples)
    want = ref_mesh.frame_pixels(rs, conf, samples, 123456789, pix,
                                 torch.device("cpu"), shape=(2, 2))
    assert np.array_equal(img.reshape(-1, 3), want)
    # another mesh shape is another frame
    other = ref_mesh.frame_pixels(rs, conf, samples, 123456789, pix,
                                  torch.device("cpu"), shape=(2, 1))
    assert not np.array_equal(other, want)


def test_reference_schedule_and_layout():
    """The driver's schedule under a mesh: 2048 spp as 16 segments of 64
    spp a rank on a primitive scene; the layout's rows padded to whole
    tiles for each pixel shard."""
    segs, total = ref_mesh.segments(2048, False, 2)
    assert total == 2048 and len(segs) == 16
    assert segs[1] == (16, 64) and all(n == 64 for _, n in segs)
    segs, total = ref_mesh.segments(16, True, 2)
    assert segs == [(0, 8)] and total == 16
    pid = ref_mesh.shard_layout(1280, 960, 64, 256, "linear", 2)
    assert pid.size == 76 * 64 * 256 and (pid[75 * 64 * 256:] == -1).all()
    ss = ref_mesh.shard_slots(1280, 960, 64, 256, "linear", 2,
                              np.array([0, 38 * 64 * 256]))
    assert ss.pix_rank.tolist() == [0, 1] and ss.tile.tolist() == [0, 0]


def test_the_deployment_is_the_reference_frame_laid_out_on_four_cards():
    """The cell's configuration is `reference`'s scene, frame and render
    settings unchanged, with a layout of its own: the traffic's mesh on
    the cell's cards, from a source of its own."""
    c = harness.cell(ROOT, CELL)
    ref = harness.cell(ROOT, "reference-render").config
    assert c.workload["config"] != "reference"
    lay = c.config["layout"]
    assert tuple(lay["mesh"]) == tuple(c.traffic["mesh"])
    assert lay["cards"] == c.chips == 4 and lay["hosts"] == 1
    assert lay["axes"] == ["pixels", "spp"] and lay["scene"] == "replicated"
    assert c.config["source"] != ref["source"]
    drop = ("name", "source", "layout")
    assert ({k: v for k, v in c.config.items() if k not in drop}
            == {k: v for k, v in ref.items() if k not in drop})


@pytest.mark.parametrize("layout", [{"mesh": [4, 1], "cards": 4},
                                    {"mesh": [2, 2], "cards": 8}])
def test_a_layout_other_than_the_traffics_is_refused(layout):
    """A configuration that lays the frame out on another mesh, or on
    other cards, than the traffic runs is refused (code 2) before any
    rank starts."""
    mod = harness.load_module(
        ROOT / "ptbench" / "jobs" / "render_frames_mesh.py", "mesh_job")
    c = harness.cell(ROOT, CELL)
    c.config["layout"] = dict(c.config["layout"], **layout)
    job = mod.Job(SimpleNamespace(cell=c, seed=1,
                                  device=torch.device("cpu")))
    with pytest.raises(harness.Refused) as e:
        job.check_cards()
    assert e.value.code == 2
    c.config["layout"] = harness.cell(ROOT, CELL).config["layout"]
    job.check_cards()


def test_rank_0_leaves_the_group_before_it_waits_for_the_others():
    """NCCL's teardown of a communicator waits for each of its ranks, so
    rank 0 leaves the group with the others, after the STOP it hands
    them and before it waits for their exit (a wait first would hold
    every rank until the join's bound)."""
    mod = harness.load_module(
        ROOT / "ptbench" / "jobs" / "render_frames_mesh.py", "mesh_job")
    log = []
    job = mod.Job.__new__(mod.Job)
    job.stopped = False
    job.rank = SimpleNamespace(seed=lambda v: log.append(("seed", v)),
                               close=lambda: log.append("close"))
    job.procs = [SimpleNamespace(wait=lambda timeout: log.append("wait")
                                 or 0) for _ in range(3)]
    job.stop_workers()
    assert log == [("seed", mod.STOP), "close", "wait", "wait", "wait"]
    job.stop_workers()
    assert len(log) == 5


def test_calibration_readings(monkeypatch, tmp_path, one_thread):
    """What ptbench.calibrate reads: the program's frame exact against
    the reference, the control (bfloat16) over the limits; the other
    ranks stop at the first control."""
    monkeypatch.setenv("PT_ASSETS", str(tmp_path))
    c = shrink(harness.cell(ROOT, CELL))
    ctx, job = harness.make_job(tmp_path, c, 12, torch.device("cpu"))
    job.setup()
    assert max(job.reading(False).values()) == 0.0
    got = job.reading(True)
    assert job.stopped and all(p.returncode == 0 for p in job.procs)
    limits = c.checks["limits"]
    assert any(got[k] > limits[k] for k in limits), got


# --- the readers, on canned traces -----------------------------------------

def ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 7, "tid": tid, "args": {}}


MESH_FRAMES = [
    ev("ptbench.window", "user_annotation", 0, 2000),
    ev("ptbench.step", "user_annotation", 0, 1000),
    ev("ptbench.step", "user_annotation", 1000, 1000),
    ev("pt.collective.host", "user_annotation", 100, 4),
    ev("pt.collective.host", "user_annotation", 200, 6),
    ev("pt.collective.host", "user_annotation", 1100, 10),
    ev("pt.collective.all_reduce", "user_annotation", 500, 30),
    ev("pt.collective.all_gather", "user_annotation", 540, 20),
    ev("pt.collective.all_reduce", "user_annotation", 1500, 50),
    ev("pt.collective.all_gather", "user_annotation", 1560, 40),
    ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)",
       "kernel", 505, 12, tid=99),
    ev("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgs)", "kernel", 545,
       8, tid=99),
    ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)",
       "kernel", 1505, 20, tid=99),
    ev("void megakernel<false>(float*)", "kernel", 10, 400, tid=99),
]


def _ctx(tmp_path, events, device="cuda"):
    from ptbench import tracing

    path = tmp_path / "build" / "ptbench" / f"trace-{CELL}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": events}))
    return SimpleNamespace(timeline=tracing.Timeline.load(str(path)),
                           device=SimpleNamespace(type=device),
                           root=tmp_path,
                           cell=SimpleNamespace(workload={"name": CELL}))


def _read(metric, ctx, kind="render"):
    mod = harness.load_module(harness.reader_path(ROOT / "ptbench", metric),
                              f"reader_{metric}")
    return mod.read(ctx, SimpleNamespace(kind=kind))


def test_mesh_readers(tmp_path):
    ctx = _ctx(tmp_path, MESH_FRAMES)
    # a frame: (30 + 20 + 50 + 40) / 2 us; the votes (4 + 6 + 10) / 2; the
    # NCCL kernels (12 + 8 + 20) / 2
    assert _read("mesh_collective_ms", ctx) == pytest.approx(70e-3)
    assert _read("mesh_vote_ms", ctx) == pytest.approx(10e-3)
    assert _read("mesh_nccl_ms", ctx) == pytest.approx(20e-3)


def test_mesh_readers_silent_where_nothing_applies(tmp_path):
    names = ["mesh_collective_ms", "mesh_vote_ms", "mesh_nccl_ms"]
    ctx = _ctx(tmp_path, MESH_FRAMES)
    assert all(_read(m, ctx, "train") is None for m in names)
    # a program without the spans (the NCCL kernels remain)
    old = _ctx(tmp_path, [e for e in MESH_FRAMES
                          if not e["name"].startswith("pt.")])
    assert _read("mesh_collective_ms", old) is None
    assert _read("mesh_vote_ms", old) is None
    assert _read("mesh_nccl_ms", old) == pytest.approx(20e-3)
    # gloo: no NCCL kernel
    gloo = _ctx(tmp_path, [e for e in MESH_FRAMES
                           if "nccl" not in e["name"]])
    assert _read("mesh_nccl_ms", gloo) is None
    # off the card, untraced
    cpu = _ctx(tmp_path, MESH_FRAMES, device="cpu")
    assert _read("mesh_collective_ms", cpu) is None
    assert _read("mesh_vote_ms", cpu) is None
    untraced = SimpleNamespace(**{**vars(ctx), "timeline": None})
    assert all(_read(m, untraced) is None for m in names)
