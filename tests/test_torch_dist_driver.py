"""The render driver and the CLI over a mesh (render_driver(mesh=),
--mesh/--distributed), on the CPU.

The driver's sharded segments against the JAX driver's on its virtual CPU
mesh: the megakernel (its segments' kernel run in interpret mode) within
1e-5 with at least 90% of the values bit-equal (tests/test_torch_dist_
render.py's rule), the wavefront within 1e-5. Checkpoint and resume under
a mesh bit for bit, a resume on another mesh shape refused; the CLI's
mesh flags, its group from torchrun's environment, and the refusals of
joining a group (a mesh that does not cover the world, NCCL with two
ranks on one device, no card).
"""
import functools
import json

import jax
import numpy as np
import pytest
import torch

from _torch_parity import jax_pack, scene_pair
from pathtracer_tpu.driver import render_driver as jax_driver
from pathtracer_tpu.parallel import make_mesh as jax_mesh
from pathtracer_tpu.render import pallas_kernel as pk
from pathtracer_tpu_torch import cli
from pathtracer_tpu_torch.driver import DeviceFailure, render_driver
from pathtracer_tpu_torch.io.raw import read_raw
from pathtracer_tpu_torch.parallel import multihost
from pathtracer_tpu_torch.parallel.mesh import LogicalMesh

torch.set_num_threads(2)

CPU = torch.device("cpu")
CFG = dict(width=32, height=24, samples=8, samples_per_pass=2)


def _pair(**kw):
    js, jc, ts, tc = scene_pair("reference", **{**CFG, **kw})
    ja, jm = jax_pack(js, ts)
    ta, tm = ts.pack(device=CPU)
    return js, jc, ja, jm, ts, tc, ta, tm


@pytest.mark.parametrize("backend", ["pallas", "wavefront"])
def test_driver_mesh_matches_jax_driver(monkeypatch, backend):
    # two segments of 2 chunks (PT_SEG_SPP 4) over a (2, 2) mesh: the
    # segment seeds hold c0 * mesh size, the sample bases c0 * chunk
    monkeypatch.setenv("PT_SEG_SPP", "4")
    js, jc, ja, jm, ts, tc, ta, tm = _pair(backend=backend)
    # the JAX driver's segments launch its kernel for the TPU; on the CPU
    # mesh they run it in interpret mode
    monkeypatch.setattr(pk, "trace_tiles",
                        functools.partial(pk.trace_tiles, interpret=True))
    mesh = jax_mesh(jax.devices()[:4], shape=(2, 2))
    want, wstats = jax_driver(ja, jm, js.camera, jc, mesh=mesh)
    got, stats = render_driver(ta, tm, ts.camera, tc,
                               mesh=LogicalMesh((2, 2)))
    name = "megakernel" if backend == "pallas" else "wavefront"
    assert stats.backend == f"{name}@2x2"
    assert wstats.backend.endswith("@2x2")
    assert stats.segments == wstats.segments == 2
    assert stats.samples == wstats.samples == 32 * 24 * 8
    assert got.shape == (24, 32, 3) and np.isfinite(got).all()
    assert np.abs(got - np.asarray(want)).max() <= 1e-5
    if backend == "pallas":
        assert (got == np.asarray(want)).mean() >= 0.9


@pytest.mark.parametrize("backend", ["pallas", "wavefront"])
def test_driver_mesh_checkpoint_resume_bit_identical(monkeypatch, tmp_path,
                                                     backend):
    *_, ts, tc, ta, tm = _pair(backend=backend, samples=16)
    mesh = LogicalMesh((1, 2))

    def render(path, **kw):
        return render_driver(ta, tm, ts.camera, tc, checkpoint_every=2,
                             checkpoint_path=str(path), **kw)

    full, stats = render(tmp_path / "full.npz", mesh=mesh)
    assert stats.segments == 4
    ck = tmp_path / "ck.npz"
    # a persistent outage at chunk 4 stops the run halfway ...
    monkeypatch.setenv("PT_FAULT_INJECT", "4")
    monkeypatch.setenv("PT_FAULT_COUNT", "9")
    with pytest.raises(DeviceFailure):
        render(ck, mesh=mesh)
    monkeypatch.delenv("PT_FAULT_INJECT")
    with np.load(ck) as z:
        assert int(z["chunks_done"]) == 4
        meta = json.loads(str(z["meta"]))
    name = "megakernel" if backend == "pallas" else "wavefront"
    assert meta["backend"] == f"{name}@1x2"
    # ... a resume on another mesh shape is refused (its random stream and
    # slots differ) ...
    with pytest.raises(ValueError, match="backend"):
        render(ck, mesh=LogicalMesh((2, 1)), resume=True)
    with pytest.raises(ValueError, match="backend"):
        render(ck, resume=True)
    # ... and the resumed run finishes it bit for bit
    img, stats = render(ck, mesh=mesh, resume=True)
    assert stats.segments == 2
    assert np.array_equal(img, full)


def test_cli_mesh_flags(tmp_path, capsys):
    tiny = ["--width", "16", "--height", "12", "--samples", "4",
            "--samples-per-pass", "2", "--device", "cpu"]
    # a world of one rank: --distributed is the 1x1 mesh
    raw, metrics = tmp_path / "d.raw", tmp_path / "m.json"
    assert cli.main(tiny + ["--distributed", "--raw-output", str(raw),
                            "--output", str(tmp_path / "d.png"),
                            "--metrics-json", str(metrics)]) == 0
    rec = json.loads(metrics.read_text())
    assert rec["backend"] == "megakernel@1x1" and rec["mesh"] == "1x1"
    assert rec["world_size"] == 1 and rec["all_reduce_s"] == 0.0
    img = read_raw(str(raw))
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    capsys.readouterr()
    # --mesh must cover the world
    assert cli.main(tiny + ["--mesh", "2x1"]) == 2
    assert "does not cover the world of 1" in capsys.readouterr().err
    assert cli.main(tiny + ["--mesh", "2"]) == 2
    assert "PIXELSxSPP" in capsys.readouterr().err


def test_joining_refuses_nccl_on_a_shared_device(monkeypatch, capsys):
    monkeypatch.delenv("PT_DIST_BACKEND", raising=False)
    assert multihost.dist_backend("cuda") == "nccl"
    assert multihost.dist_backend("cpu") == "gloo"
    assert multihost.rank_device("cpu", [("h", 0)] * 2, 1, "gloo") == CPU
    # no card: an error, never the CPU
    with pytest.raises(RuntimeError, match="no CUDA device on h"):
        multihost.rank_device("cuda", [("h", 0)], 0, "nccl")
    # one card, two ranks of one host: NCCL raises on every rank; gloo
    # shares it
    one_card = [("h", 1), ("h", 1)]
    for rank in (0, 1):
        with pytest.raises(ValueError, match="NCCL takes one rank a device"):
            multihost.rank_device("cuda", one_card, rank, "nccl")
        assert multihost.rank_device("cuda", one_card, rank, "gloo") == \
            torch.device("cuda:0")
    assert multihost.rank_device("cuda", [("h", 1)], 0, "nccl") == \
        torch.device("cuda:0")
    # through the CLI, with the ranks' placement as the rendezvous would
    # give it: it stops before joining the group
    monkeypatch.setattr(torch.distributed, "rendezvous",
                        lambda url, rank, world_size, timeout:
                        iter([(None, rank, world_size)]))
    monkeypatch.setattr(multihost, "_placement", lambda *a: one_card)
    monkeypatch.setenv("PT_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("PT_NUM_PROCESSES", "2")
    monkeypatch.setenv("PT_PROCESS_ID", "1")
    assert cli.main(["--mesh", "1x2"]) == 1
    err = capsys.readouterr().err
    assert "NCCL takes one rank a device" in err and "gloo" in err
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("hosts,want", [
    # two hosts of one card each: cuda:0 on both, NCCL allowed
    ([("a", 1), ("b", 1)], [0, 0]),
    # two hosts of 8 cards: each rank's index among its host's ranks
    ([("a", 8)] * 8 + [("b", 8)] * 8, list(range(8)) * 2),
    # ranks dealt to the hosts in turn
    ([("a", 2), ("b", 2), ("a", 2), ("b", 2)], [0, 0, 1, 1]),
])
def test_ranks_are_placed_by_their_host(hosts, want):
    got = [multihost.rank_device("cuda", hosts, r, "nccl").index
           for r in range(len(hosts))]
    assert got == want
    # host a is full in every case: one rank more there is refused on
    # every rank
    crowded = hosts + [hosts[0]]
    for r in range(len(crowded)):
        with pytest.raises(ValueError, match="ranks on a would share"):
            multihost.rank_device("cuda", crowded, r, "nccl")


def test_ranks_tell_their_placement_through_the_store():
    store = torch.distributed.HashStore()
    store.set("pt/placement/1", "4 other")
    got = multihost._placement(store, 0, 2, "cpu")
    assert got[1] == ("other", 4) and got[0][1] == 0


def test_cli_joins_torchruns_group(monkeypatch, tmp_path):
    # torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
    # joins a group of one rank over gloo on the CPU, which --distributed
    # renders on and the CLI leaves at the end
    from _torch_dist import free_port

    for k in ("PT_COORDINATOR", "PT_DIST_BACKEND"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    metrics = tmp_path / "m.json"
    assert cli.main(["--width", "16", "--height", "12", "--samples", "2",
                     "--samples-per-pass", "2", "--device", "cpu",
                     "--distributed", "--raw-output", str(tmp_path / "x.raw"),
                     "--output", str(tmp_path / "x.png"),
                     "--metrics-json", str(metrics)]) == 0
    assert json.loads(metrics.read_text())["backend"] == "megakernel@1x1"
    assert not torch.distributed.is_initialized()
