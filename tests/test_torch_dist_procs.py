"""Two processes over gloo: the port's multi-GPU path with real ranks, on
the CPU (the counterpart of tests/test_multihost.py).

Two ranks (tests/_torch_dist_worker.py) join a gloo group, render
`reference` over a (2, 1) and a (1, 2) mesh (render_sharded_megakernel,
render_sharded) and then run the CLI under --mesh with a checkpoint.
Every rank must gather the identical frame, bit for bit equal to one
process playing every rank (parallel.mesh.LogicalMesh); the CLI's image,
written by rank 0 alone, equals the driver's on the LogicalMesh. A
failure on one rank stops or rewinds both, and a resume from the
checkpoint that rank 0 alone holds is bit-equal. No JAX runs in the
ranks.

Four processes over gloo (the "driver" form of the worker): the render
driver over the (2, 2) mesh of global_render_mesh, bit for bit the
LogicalMesh's frame; the collectives' counters of the frame's one flush
and its votes; every collective inside its "pt.collective." span under a
profiler; the mesh's groups under the timeout the group was joined with.
"""
import json
import os

import numpy as np
import pytest
import torch

from _torch_dist import run_driver_ranks, run_two_ranks
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.driver import render_driver
from pathtracer_tpu_torch.io.raw import read_raw
from pathtracer_tpu_torch.parallel import (render_sharded,
                                           render_sharded_megakernel)
from pathtracer_tpu_torch.parallel.mesh import LogicalMesh
from pathtracer_tpu_torch.scenes import get_scene

torch.set_num_threads(2)


@pytest.mark.parametrize("shape", ["2x1", "1x2"])
def test_two_gloo_ranks_gather_the_logical_mesh_frame(tmp_path, shape,
                                                      monkeypatch):
    outs = run_two_ranks(tmp_path, shape)
    r0, r1 = (np.load(o) for o in outs)
    # every rank gathered the same whole frame
    for k in ("mega", "wave"):
        assert np.array_equal(r0[k], r1[k])
        assert r0[k].shape == (24, 32, 3) and np.isfinite(r0[k]).all()
        assert r0[k].mean() > 0.01
    # the spp axis summed, the pixels axis gathered: each rank spent time in
    # the collective of its mesh's axis of size 2
    kind = "all_gather" if shape == "2x1" else "all_reduce"
    assert float(r0[kind]) > 0 and float(r1[kind]) > 0
    # rank 0's flag holds on both ranks (a flush they take together)
    assert r0["agree"].tolist() == r1["agree"].tolist() == [True, False]
    # one process playing both ranks: bit for bit
    cfg = RenderConfig(width=32, height=24, samples=4, samples_per_pass=2)
    sc = get_scene("reference", cfg)
    arrays, meta = sc.pack(device=torch.device("cpu"))
    mesh = LogicalMesh(tuple(int(v) for v in shape.split("x")))
    assert np.array_equal(r0["mega"], render_sharded_megakernel(
        arrays, meta, sc.camera, cfg, mesh))
    assert np.array_equal(r0["wave"], render_sharded(
        arrays, meta, sc.camera, cfg, mesh))
    # the CLI: rank 0 wrote the image (and the checkpoint) alone
    assert os.path.exists(outs[0][:-4] + ".raw")
    assert not os.path.exists(outs[1][:-4] + ".raw")
    assert not os.path.exists(outs[1][:-4] + ".png")
    assert os.path.exists(outs[0][:-4] + ".ck.npz")
    assert not os.path.exists(outs[1][:-4] + ".ck.npz")
    ccfg = cfg.replace(samples=8)
    want, stats = render_driver(
        arrays, meta, sc.camera, ccfg, checkpoint_every=2, mesh=mesh,
        checkpoint_path=str(tmp_path / "logical.ck.npz"))
    assert stats.backend == f"megakernel@{shape}"
    assert np.array_equal(read_raw(outs[0][:-4] + ".raw"), want)
    # a flush after every segment: the ranks flush together
    monkeypatch.setenv("PT_FLUSH_S", "0")
    monkeypatch.setenv("PT_SEG_SPP", "2")
    want, stats = render_driver(arrays, meta, sc.camera, ccfg, mesh=mesh)
    assert stats.segments == (4 if shape == "2x1" else 2)
    assert np.array_equal(read_raw(outs[0][:-4] + ".flush.raw"), want)
    assert not os.path.exists(outs[1][:-4] + ".flush.raw")
    # rank 0 failed at chunk 2 until it gave up, and rank 1 with it
    assert str(r0["stopped"]).startswith("DeviceFailure: PT_FAULT_INJECT")
    assert str(r1["stopped"]).startswith(
        "DeviceFailure: another rank failed at chunk 2")
    assert not os.path.exists(outs[1][:-4] + ".stop.ck.npz")
    # resumed from rank 0's checkpoint on both ranks (rank 1 has none),
    # through a failure on rank 1 alone: the uninterrupted image
    rec = json.loads(open(outs[0][:-4] + ".resume.json").read())
    assert rec["recoveries"] == 1 and rec["segments"] == 1
    assert np.array_equal(read_raw(outs[0][:-4] + ".resume.raw"),
                          read_raw(outs[0][:-4] + ".raw"))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The four ranks' outputs of one 2x2 render (the worker's "driver"
    form), loaded."""
    outs = run_driver_ranks(tmp_path_factory.mktemp("four"), "2x2")
    return [np.load(o, allow_pickle=True) for o in outs]


def _logical_frame():
    cfg = RenderConfig(width=32, height=24, samples=8, samples_per_pass=2)
    sc = get_scene("reference", cfg)
    arrays, meta = sc.pack(device=torch.device("cpu"))
    return render_driver(arrays, meta, sc.camera, cfg,
                         mesh=LogicalMesh((2, 2)))


def test_four_gloo_ranks_gather_the_logical_mesh_frame(four_ranks,
                                                       monkeypatch):
    for r in four_ranks[1:]:
        assert np.array_equal(r["img"], four_ranks[0]["img"])
    monkeypatch.setenv("PT_SEG_SPP", "2")
    want, stats = _logical_frame()
    assert stats.backend == "megakernel@2x2" and stats.segments == 2
    assert int(four_ranks[0]["segments"]) == 2
    assert want.shape == (24, 32, 3) and want.mean() > 0.01
    assert np.array_equal(four_ranks[0]["img"], want)


def test_mesh_counters_read_the_frames_flush_and_votes(four_ranks):
    """One flush (the frame's end): one all_reduce over the spp axis and
    one all_gather over the pixels axis, each of this rank's shard (64 of
    the 128 padded tile rows of 256 slots, 3 f32 sums a slot); one vote of
    two int64 flags a segment."""
    shard = 64 * 256 * 3 * 4
    for r in four_ranks:
        assert r["calls"].tolist() == [1, 1, 2]
        assert r["nbytes"].tolist() == [shard, shard, 2 * 2 * 8]
        assert (r["seconds"] > 0).all()


def test_every_collective_lies_inside_its_span(four_ranks):
    want = {"c10d::allreduce_": ("pt.collective.all_reduce",
                                 "pt.collective.host"),
            "c10d::allgather_": ("pt.collective.all_gather",)}
    for r in four_ranks:
        events = [tuple(e) for e in r["events"]]
        spans = [e for e in events if e[0].startswith("pt.collective.")]
        ops = [e for e in events if e[0].startswith("c10d::")]
        assert sorted(n for n, _, _ in spans) == (
            ["pt.collective.all_gather", "pt.collective.all_reduce"]
            + ["pt.collective.host"] * 2)
        assert sorted(n for n, _, _ in ops) == (
            ["c10d::allgather_"] + ["c10d::allreduce_"] * 3)
        for name, a, b in ops:
            inside = [s for s in spans if s[1] <= a and b <= s[2]]
            assert len(inside) == 1 and inside[0][0] in want[name], (
                name, inside)
        # one collective a span
        for s in spans:
            assert sum(s[1] <= a and b <= s[2] for _, a, b in ops) == 1


def test_mesh_groups_take_the_groups_timeout(four_ranks):
    """The axes' groups of global_render_mesh time out with the group
    initialize_multihost joined (60 s here), not after
    torch.distributed's default for their backend (30 minutes for gloo,
    10 for NCCL)."""
    for r in four_ranks:
        assert r["timeouts"].tolist() == [60.0, 60.0]
