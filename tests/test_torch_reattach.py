"""intersect.reattach_hit: the winner found by the intersect kernel (its
plain version, megakernel.intersect_batch_reference) recomputed by the
torch walk's own operations, so that rays that carry a gradient get the
walk's gradient (render/integrator.py's route under autograd).

On camera rays and one bounce of random rays of `reference`, `textures`
and `teapot` (origin and direction leaves that require a gradient), on
every ray whose winner (object and triangle slot) is the walk's
(intersect.intersect_scene), the re-attached t, object-space ray and
barycentrics must equal the walk's bit for bit, and torch.autograd.grad of
sum(c * t) with respect to origin and direction (c random) must equal the
walk's too. The winners must agree on at least 99% of the rays (the two
differ only at near-ties: tests/test_torch_wavefront_render.py). No JAX."""
import pytest
import torch

from _torch_scenes import bounce_rays, camera_rays
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.render.intersect import (intersect_scene,
                                                   reattach_hit)
from pathtracer_tpu_torch.render.vec3 import Vec3
from pathtracer_tpu_torch.scenes import get_scene

torch.set_num_threads(2)

W, H, N = 16, 12, 2


def _rays(name):
    cfg = RenderConfig(width=W, height=H, samples=N)
    sc = get_scene(name, cfg)
    scn, meta = sc.pack(device="cpu")
    gen = torch.Generator()
    gen.manual_seed(7)
    o, d = camera_rays(sc.camera, W, H, N, gen)
    t = mk.intersect_batch_reference(scn, meta, cfg, o, d)[0]
    return scn, meta, cfg, {"camera": (o, d),
                            "bounce": bounce_rays(o, d, t, cfg.t_max, gen)}


@pytest.mark.parametrize("name", ["reference", "textures", "teapot"])
@pytest.mark.parametrize("batch", ["camera", "bounce"])
def test_reattach_equals_the_walk(name, batch):
    scn, meta, cfg, rays = _rays(name)
    o0, d0 = rays[batch]
    got = mk.intersect_batch_reference(scn, meta, cfg, o0, d0)
    t_k, oi, slot = got[0], got[1], got[7]

    def leaves():
        return (Vec3(*(a.clone().requires_grad_(True) for a in o0)),
                Vec3(*(a.clone().requires_grad_(True) for a in d0)))

    o_w, d_w = leaves()
    walk = intersect_scene(scn, meta, o_w, d_w, cfg.epsilon, cfg.t_max)
    o_r, d_r = leaves()
    before = (reattach_hit.calls, reattach_hit.rays)
    re = reattach_hit(scn, meta, o_r, d_r, oi, slot, t_k, cfg.epsilon,
                      cfg.t_max)
    assert (reattach_hit.calls, reattach_hit.rays) == (
        before[0] + 1, before[1] + t_k.numel())
    same = ((walk.obj_idx == oi) & (walk.tri_slot == slot)
            & ((walk.t < cfg.t_max) == (t_k < cfg.t_max)))
    assert float(same.float().mean()) >= 0.99
    hit = same & (t_k < cfg.t_max)
    assert bool(hit.any())
    if meta.has_groups and batch == "camera":
        assert bool((hit & re.is_tri).any())     # triangles re-attached
    assert torch.equal(re.is_tri[same], walk.is_tri[same])
    for a, b in [(re.t, walk.t), (re.tri_u, walk.tri_u),
                 (re.tri_v, walk.tri_v), *zip(re.local_origin,
                                              walk.local_origin),
                 *zip(re.local_dir, walk.local_dir)]:
        assert torch.equal(a[same].detach(), b[same].detach())
    # the kernel's t and the walk's agree to an ulp or so
    assert torch.allclose(re.t[hit].detach(), t_k[hit], rtol=1e-5)
    # d t / d (origin, direction), weighted per ray, on the agreeing rays
    c = torch.rand(t_k.shape, generator=torch.Generator().manual_seed(3))
    c = torch.where(same, c, torch.zeros_like(c))
    gw = torch.autograd.grad((c * walk.t).sum(), (*o_w, *d_w),
                             allow_unused=True)
    gr = torch.autograd.grad((c * re.t).sum(), (*o_r, *d_r),
                             allow_unused=True)
    for a, b in zip(gr, gw):
        a = torch.zeros_like(t_k) if a is None else a
        b = torch.zeros_like(t_k) if b is None else b
        assert torch.isfinite(a).all() and torch.equal(a, b)
    assert any(bool((g != 0).any()) for g in gr if g is not None)


def test_reattach_keeps_misses_and_the_world_ray():
    scn, meta, cfg, rays = _rays("reference")
    o, d = rays["camera"]
    # rays pointing away from the box: every one a miss
    d_out = tuple(-a for a in d)
    o_out = tuple(a + 50.0 * b for a, b in zip(o, d_out))
    got = mk.intersect_batch_reference(scn, meta, cfg, o_out, d_out)
    miss = got[0] == cfg.t_max
    assert bool(miss.any())
    ov, dv = Vec3(*o_out), Vec3(*d_out)
    re = reattach_hit(scn, meta, ov, dv, got[1], got[7], got[0],
                      cfg.epsilon, cfg.t_max)
    assert torch.equal(re.t[miss], got[0][miss])
    for a, b in zip((*re.local_origin, *re.local_dir), (*ov, *dv)):
        assert torch.equal(a[miss], b[miss])
    assert not bool(re.is_tri[miss].any())
