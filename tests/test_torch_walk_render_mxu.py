"""pathtracer_tpu_torch's forward megakernel with the tensor-core leaf tests
(PT_TRAVERSAL=mxu) against the JAX kernel's MXU leaf machine in interpret
mode, per slot (tests/_torch_scenes.py's rule; _torch_parity.kernel_pair on
the driver's mesh layout, the rowblock order of the MXU machine), and
against the port's own classic render at the JAX package's tolerance for
the two machines (tests/test_pallas.py:523-545: per-pixel MAD < 1e-4 at
24x16, 2 spp, tile (8, 128))."""
import numpy as np
import torch

from _torch_parity import kernel_pair
from _torch_scenes import assert_slot_rule, port_inputs
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.scenes import get_scene

torch.set_num_threads(2)


def test_mxu_render_matches_jax_interpret(monkeypatch):
    monkeypatch.setenv("PT_TRAVERSAL", "mxu")
    monkeypatch.setenv("PT_TILE_ORDER", "rowblock")
    got, want, tm = kernel_pair("teapot", (8, 512), spp=2, W=24, H=16,
                                fresh_jit=True)
    assert_slot_rule(got, want)


def test_mxu_render_matches_classic(monkeypatch):
    cfg = RenderConfig(width=24, height=16, samples=2, samples_per_pass=2)
    sc = get_scene("teapot", cfg)
    imgs = []
    for mxu in (False, True):
        if mxu:
            monkeypatch.setenv("PT_TRAVERSAL", "mxu")
        tabs, meta, pid, lay = port_inputs(sc, cfg, (8, 128),
                                           torch.device("cpu"))
        rgb = mk.trace_tiles((cfg.seed, 0), *tabs, meta=meta, cfg=cfg,
                             spp=2, total_samples=2, tile=(8, 128), **lay)
        flat = torch.stack(rgb, -1).reshape(-1, 3).numpy()
        imgs.append(mk.untile_image(flat, pid, 24, 16) / 2.0)
    assert tabs[3].shape[0] > meta.n_tri_slots  # the MXU rows
    assert np.isfinite(imgs[1]).all() and imgs[1].min() >= 0.0
    assert np.abs(imgs[1] - imgs[0]).mean() < 1e-4
