"""The frame's finish (render/megakernel.py finish_frame) on the CPU: the
layout it launches its kernel with (each base slot's pixel, base_slot_pixels,
and the stride between a pixel's replicas, replica_stride) gives the host's
finish (the slots back to pixels by untile_image in float64, the divide by
the frame's samples, the f32 cast) bit for bit when the replicas are added
as the kernel adds them, on the layouts tile_pixel_layout makes; off the
card finish_frame is the host's finish; trace_tiles writes into a buffer it
is given (the render driver's segments); and a render with a checkpoint
path takes the host finish. The kernel itself is held to the same layouts
on the card (tests/test_torch_cuda.py) and through the g++ shim
(tools/cuda_shim/run.py finish). No JAX."""
import json

import numpy as np
import pytest
import torch

from _torch_scenes import (FINISH_LAYOUTS, finish_launch, finish_partial,
                           host_finish, port_inputs)
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.driver import render_driver
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scenes import get_scene

CPU = torch.device("cpu")


def _as_the_kernel(acc, run, total_spp, reverse=False):
    """csrc/megakernel.cu finish_frame's index arithmetic and order in
    NumPy: base slot i is slot (i // g) * g * pack + i % g, its replica r
    lies r * g after it, the replicas are added in float64 from 0.0 (r = 0
    first; last with `reverse`), then the divide and the cast, written to
    the base slot's pixel."""
    S, L = run.kwargs["tile"]
    pack = run.kwargs["spp_pack"]
    g = mk.replica_stride(S, L, pack, run.kwargs["pack_axis"])
    i = np.arange(run.base_pid.shape[0])
    slot = (i // g) * g * pack + i % g
    s = np.zeros((3, i.size))
    for r in (reversed(range(pack)) if reverse else range(pack)):
        s = s + acc[:, slot + r * g].astype(np.float64)
    val = (s / float(total_spp)).astype(np.float32)
    base = run.base_pid.numpy()
    img = np.zeros((run.n_pixels, 3), dtype=np.float32)
    img[base[base >= 0]] = val[:, base >= 0].T
    return img


@pytest.mark.parametrize("W,H,tile,order,pack,axis", FINISH_LAYOUTS)
def test_finish_layout_gives_the_host_finish(W, H, tile, order, pack, axis):
    run = finish_launch(W, H, tile, order, pack, axis)
    acc = finish_partial(run, seed=W * pack)
    want = host_finish(acc, run.pid, W, H, 2048)
    # a base slot's replicas are one pixel's, every pixel has one base
    # slot, and only padding has none
    g = mk.replica_stride(*tile, pack, axis)
    reps = run.pid.reshape(-1, pack, g)
    assert (reps == reps[:, :1]).all()
    base = run.base_pid.numpy()
    assert base.dtype == np.int32 and base.size == run.pid.size // pack
    assert np.array_equal(np.sort(base[base >= 0]), np.arange(W * H))
    assert np.array_equal(_as_the_kernel(acc, run, 2048), want)
    before = mk.finish_frame.launches
    got = mk.finish_frame(torch.from_numpy(acc), run, 2048)
    assert mk.finish_frame.launches == before   # no launch off the card
    assert got.dtype == torch.float32 and got.shape == (W * H, 3)
    assert np.array_equal(got.numpy(), want)
    if pack >= 3:
        # the partial is one whose image the order of the adds changes:
        # the replicas in reverse give another
        assert not np.array_equal(
            _as_the_kernel(acc, run, 2048, reverse=True), want)


def test_finish_refuses_a_partial_of_another_layout():
    run = finish_launch(32, 24, (8, 512), "block", 4, "chunk")
    acc = torch.zeros((run.pid.shape[0], 3), dtype=torch.float32)
    with pytest.raises(ValueError, match=r"\[3, "):
        mk.finish_frame(acc, run, 8)


def test_trace_tiles_writes_into_out():
    # the render driver hands trace_tiles the segment's [3, slots] buffer:
    # the same sums, written there, and a buffer of another shape refused
    cfg = RenderConfig(width=8, height=6, samples=2, samples_per_pass=2)
    tabs, meta, pid, lay = port_inputs(get_scene("reference", cfg), cfg,
                                       (8, 16), CPU)
    kw = dict(meta=meta, cfg=cfg, spp=2, total_samples=2, tile=(8, 16),
              **lay)
    want = torch.stack(mk.trace_tiles((3, 0), *tabs, **kw))
    out = torch.full((3, pid.shape[0]), float("nan"))
    r, g, b = mk.trace_tiles((3, 0), *tabs, **kw, out=out.view(3, -1, 16))
    assert torch.equal(out.view_as(want), want)
    assert r.data_ptr() == out.data_ptr()
    assert b.data_ptr() == out[2].data_ptr()
    with pytest.raises(ValueError, match="out must be"):
        mk.trace_tiles((3, 0), *tabs, **kw, out=out)


def test_render_with_a_checkpoint_takes_the_host_finish(monkeypatch,
                                                        tmp_path):
    monkeypatch.setenv("PT_SEG_SPP", "2")
    cfg = RenderConfig(width=8, height=6, samples=4, samples_per_pass=2)
    sc = get_scene("reference", cfg)
    scn, meta = sc.pack(device=CPU)
    img, stats = render_driver(scn, meta, sc.camera, cfg,
                               checkpoint_path=str(tmp_path / "ck.npz"))
    assert stats.finish == "host"
    assert json.loads(stats.to_json())["finish"] == "host"
    # the same frame without the checkpoint (off the card: the host
    # finish too) is the same image
    again, stats = render_driver(scn, meta, sc.camera, cfg)
    assert stats.finish == "host" and np.array_equal(img, again)
