"""The gradient kernel's memory layout in pathtracer_tpu_torch
(render/grad.py, csrc/megakernel.cu), on the CPU.

The kernel adds a triangle's or a texel's three sums as one 16-byte
atomic into [n, 4] rows (rgb and a pad column that stays 0); the wrapper
allocates them (padded_sums) and returns [n, 3] (unpadded). Its tape holds
kMaxTape entries a thread; the wrapper refuses, before any launch, a
max_bounces the tape does not hold (check_tape). On the CPU grad_tiles
runs its plain version, so here the padded rows are filled as the kernel
fills them, from the plain version's sums, and must give back the plain
version's [n, 3] gradients; the wrapper's limits are held to the kernel
source's constants.
No JAX: the plain version is held against the JAX kernels by
test_torch_grad.py, test_torch_grad_tri.py and test_torch_tex_grad.py.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_scenes import grad_inputs
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.render import grad as tg
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scene.pack import texel_params
from pathtracer_tpu_torch.scenes import get_scene

torch.set_num_threads(2)

CU = (Path(tg.__file__).resolve().parent.parent / "csrc"
      / "megakernel.cu").read_text()
W, H, SPP = 32, 24, 2
TILE = (8, 128)


def _case(name, mode):
    """grad_tiles' inputs for scene `name` in `mode` ("triangle" or
    "texel"): (tables, cotangents, keywords)."""
    cfg = RenderConfig(width=W, height=H, samples=SPP)
    tabs, meta, arrays, _ = grad_inputs(get_scene(name, cfg), cfg, TILE,
                                        torch.device("cpu"))
    rng = np.random.default_rng(3)
    cots = [torch.from_numpy(rng.random(tuple(tabs[-2].shape),
                                        dtype=np.float32))
            for _ in range(3)]
    kw = dict(meta=meta, cfg=cfg, spp=SPP, total_samples=SPP, tile=TILE)
    if mode == "triangle":
        kw["tri_grads"] = True
    else:
        kw.update(tex_grads=True, tex=texel_params(arrays),
                  tex_table=torch.from_numpy(mk.build_tex_table(arrays,
                                                                meta)))
    return tabs, cots, kw


def test_padded_sums_are_zeroed_16_byte_rows():
    g = tg.padded_sums(7, torch.device("cpu"))
    assert g.shape == (7, 4) and g.dtype == torch.float32
    assert g.is_contiguous() and not g.any()
    assert g.stride() == (4, 1)     # a row is 16 bytes, one vector atomic


def test_unpadded_gives_the_rgb_columns():
    g = torch.arange(20, dtype=torch.float32).reshape(5, 4)
    out = tg.unpadded(g)
    assert out.shape == (5, 3) and out.is_contiguous()
    assert torch.equal(out, g[:, :3])
    out[0, 0] = -1.0                # a copy, not a view of the rows
    assert g[0, 0] == 0.0


@pytest.mark.parametrize("name,mode", [("teapot", "triangle"),
                                       ("textures-train", "texel")])
def test_padded_rows_give_the_plain_gradients(name, mode):
    # the kernel's adds, replayed on the CPU: each nonzero row of the
    # plain version's [n, 3] sums added as (r, g, b, 0) into the padded
    # rows, in shuffled order and split in two halves as atomics from two
    # blocks would; unpadded gives the [n, 3] sums back and the pad
    # column stays 0
    tabs, cots, kw = _case(name, mode)
    want = tg.grad_tiles_reference((5, 0), *tabs, *cots, **kw)[2]
    assert want.shape[1] == 3 and want.abs().sum() > 0
    rows = torch.nonzero(want.abs().sum(1) > 0).squeeze(1)
    rows = rows[torch.from_numpy(np.random.default_rng(0).permutation(
        rows.numel()))]
    g4 = tg.padded_sums(want.shape[0], torch.device("cpu"))
    half = [want[rows] * 0.25, want[rows] * 0.75]
    for part in half:
        g4.index_add_(0, rows, torch.cat(
            [part, torch.zeros(rows.numel(), 1)], dim=1))
    got = tg.unpadded(g4)
    assert not g4[:, 3].any()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("name,mode", [("teapot", "triangle"),
                                       ("textures-train", "texel")])
def test_grad_tiles_returns_rgb_rows(name, mode):
    # the wrapper on CPU tensors: the plain version's [n, 3] f32 sums
    tabs, cots, kw = _case(name, mode)
    got = tg.grad_tiles((5, 0), *tabs, *cots, **kw)
    want = tg.grad_tiles_reference((5, 0), *tabs, *cots, **kw)
    n = kw["meta"].n_tri_slots if mode == "triangle" else kw["tex"].shape[0]
    assert got[2].shape == (n, 3) and got[2].dtype == torch.float32
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_limits_are_the_kernel_sources():
    # the wrapper's tape length and block size are csrc/megakernel.cu's
    for pat in (r"kMaxTape = 16;", r"kThreads = 128;",
                r"kGradThreads = kThreads;", r"kGradCols = 6;"):
        assert re.search(pat, CU), pat
    assert (tg._MAX_TAPE, tg._BLOCK, tg._GRAD_COLS) == (16, 128, 6)


@pytest.mark.parametrize("max_bounces", [1, 10, 16])
def test_tape_holds_up_to_its_length(max_bounces):
    tg.check_tape(max_bounces)


@pytest.mark.parametrize("max_bounces", [17, 64])
def test_tape_refuses_what_it_does_not_hold(max_bounces):
    with pytest.raises(ValueError, match="tape holds 16"):
        tg.check_tape(max_bounces)


def test_grad_tiles_checks_the_tape_before_the_launch():
    # the CUDA path checks the tape before it builds or launches anything:
    # check_tape comes before mk.library() in grad_tiles
    import inspect
    src = inspect.getsource(tg.grad_tiles)
    assert 0 < src.index("check_tape(") < src.index("mk.library()")
