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
"""
import json
import os

import numpy as np
import pytest
import torch

from _torch_dist import run_two_ranks
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
