"""The CUDA megakernel of pathtracer_tpu_torch against its plain PyTorch
version, on the card. Imports no jax (the card's machine has none), so run
it without the repository's conftest, which pins jax to the CPU:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Every test skips without a CUDA device. Rule for the primitive scenes:
>= 99% of slot values within atol=1e-4, rtol=1e-3, each image-mean channel
within 1%. The mesh scenes must be bit-equal: the kernel and the plain
version walk each ray's BVH in the same order with the same f32 operations.
"""
import numpy as np
import pytest
import torch

from _torch_scenes import (MESH_SCENES, SLICE_SCENES, assert_slot_rule,
                           cylinder_scene, port_inputs, size_check_scene)
from pathtracer_tpu_torch import cli
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.geometry import transforms as gx
from pathtracer_tpu_torch.io.raw import read_raw
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scene import material, pack, shapes
from pathtracer_tpu_torch.scenes import cornell, get_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(name, dev, tile, **cfg_kw):
    cfg = RenderConfig(**cfg_kw)
    if name == "cylinder":
        sc = cylinder_scene(cfg, gx, material, shapes, pack, cornell)
    elif name == "size-check":
        sc = size_check_scene(cfg, get_scene)
    else:
        sc = get_scene(name, cfg)
    tabs, meta, _, layout = port_inputs(sc, cfg, tile, dev)
    return tabs, meta, cfg, layout


@pytest.mark.parametrize("tile", [(8, 128), (64, 256)])
@pytest.mark.parametrize("name,aperture,base",
                         [(n, 0.0, 0) for n in SLICE_SCENES]
                         + [("cylinder", 0.0, 0), ("reference", 0.1, 16)])
def test_kernel_matches_plain(dev, tile, name, aperture, base):
    tabs, meta, cfg, layout = _inputs(name, dev, tile, width=160,
                                      height=120, samples=8,
                                      aperture=aperture,
                                      focal_length=1.6 if aperture else 0.0)
    kw = dict(meta=meta, cfg=cfg, spp=8, total_samples=8 + base, tile=tile,
              **layout)
    before = mk.trace_tiles.launches
    got = torch.stack(mk.trace_tiles((5, base), *tabs, **kw))
    assert mk.trace_tiles.launches == before + 1
    want = torch.stack(mk.trace_tiles_reference((5, base), *tabs, **kw))
    torch.cuda.synchronize()
    assert_slot_rule(got.cpu().numpy(), want.cpu().numpy())


def test_kernel_matches_plain_incoherent(dev, monkeypatch):
    # PT_COHERENT=0 switches the kernel's roulette and hemisphere draws
    # from row-shared to per slot, on both sides
    monkeypatch.setenv("PT_COHERENT", "0")
    tabs, meta, cfg, layout = _inputs("transparency_f_light", dev,
                                      (64, 256), width=160, height=120,
                                      samples=8)
    kw = dict(meta=meta, cfg=cfg, spp=8, total_samples=8, tile=(64, 256),
              **layout)
    got = torch.stack(mk.trace_tiles((5, 0), *tabs, **kw))
    want = torch.stack(mk.trace_tiles_reference((5, 0), *tabs, **kw))
    torch.cuda.synchronize()
    assert_slot_rule(got.cpu().numpy(), want.cpu().numpy())
    monkeypatch.setenv("PT_COHERENT", "1")
    assert not torch.equal(got, torch.stack(mk.trace_tiles((5, 0), *tabs,
                                                           **kw)))


@pytest.mark.parametrize("name,aperture,base,env", [
    (n, 0.0, 0, {}) for n in MESH_SCENES] + [
    ("teapot", 0.1, 16, {}),                     # DoF over chunk replicas
    ("teapot", 0.1, 16, {"PT_PACK_AXIS": "row"}),
    ("teapot", 0.0, 0, {"PT_OCTANT": "0"}),
    ("teapot", 0.0, 0, {"PT_COHERENT": "0"}),
    ("size-check", 0.0, 0, {}),                  # 16640 triangles, leaf 16
])
def test_mesh_kernel_bit_equal_plain(dev, monkeypatch, name, aperture, base,
                                     env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tile = (8, 512)
    tabs, meta, cfg, layout = _inputs(name, dev, tile, width=160,
                                      height=120, samples=8,
                                      aperture=aperture,
                                      focal_length=1.6 if aperture else 0.0)
    assert meta.has_groups
    kw = dict(meta=meta, cfg=cfg, spp=8, total_samples=8 + base, tile=tile,
              **layout)
    before = mk.trace_tiles.launches
    got = torch.stack(mk.trace_tiles((5, base), *tabs, **kw))
    assert mk.trace_tiles.launches == before + 1
    want = torch.stack(mk.trace_tiles_reference((5, base), *tabs, **kw))
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), (got != want).float().mean().item()


def test_kernel_refuses_tables_off_the_card(dev):
    tabs, meta, cfg, _ = _inputs("reference", dev, (8, 128), width=32,
                                 height=24)
    tabs[1] = tabs[1].cpu()
    with pytest.raises(ValueError, match="obj_table"):
        mk.trace_tiles((0, 0), *tabs, meta=meta, cfg=cfg, spp=1,
                       total_samples=1, tile=(8, 128))


def test_cli_renders_through_the_kernel(dev, tmp_path):
    raw = tmp_path / "r.raw"
    before = mk.trace_tiles.launches
    rc = cli.main(["--scene", "reference", "--width", "64", "--height",
                   "48", "--samples", "32", "--raw-output", str(raw),
                   "--output", str(tmp_path / "r.png")])
    assert rc == 0
    assert mk.trace_tiles.launches == before + 1   # 32 spp = 1 segment
    img = read_raw(str(raw))
    assert img.shape == (48, 64, 3) and np.isfinite(img).all()
    left, right = img[:, :3].mean((0, 1)), img[:, -3:].mean((0, 1))
    assert left[0] > left[2] and right[2] > right[0]


def test_cli_renders_teapot_through_the_kernel(dev, tmp_path):
    raw = tmp_path / "t.raw"
    before = mk.trace_tiles.launches
    rc = cli.main(["--scene", "teapot", "--width", "64", "--height", "48",
                   "--samples", "16", "--raw-output", str(raw),
                   "--output", str(tmp_path / "t.png")])
    assert rc == 0
    assert mk.trace_tiles.launches == before + 2   # 8-spp mesh segments
    img = read_raw(str(raw))
    assert img.shape == (48, 64, 3) and np.isfinite(img).all()
    left, right = img[:, :3].mean((0, 1)), img[:, -3:].mean((0, 1))
    assert left[0] > left[2] and right[2] > right[0]
