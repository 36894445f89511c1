"""Shared setup of tests/test_torch_wavefront_grad*.py: the same scene in
both packages (the JAX side on its NumPy scene-core at the port's BVH
leaf size, as tests/_torch_parity.py's jax_pack builds it, with the port's
group bounds), the pixels of the whole W x H image, flat, and the rule
that holds the port's gradients against the JAX package's."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import torch

import pathtracer_tpu.native as jnative
from _torch_parity import jax_pack, scene_pair
from pathtracer_tpu_torch.render import integrator
from pathtracer_tpu_torch.render import megakernel as mk

CPU = torch.device("cpu")
FIELDS = ("color", "emission", "tri_color", "tex_planar", "tex_sphere",
          "tex_cube")


def wavefront_pair(name, W, H, spp):
    """(JAX arrays, meta, cfg, camera, px, py; port arrays, meta, cfg,
    camera, px, py) of scene `name` at W x H, `spp` samples a pass."""
    with mock.patch.object(jnative, "available", lambda: False):
        js, jc, ts, tc = scene_pair(name, width=W, height=H, samples=spp,
                                    samples_per_pass=spp)
        ja, jm = jax_pack(js, ts)
    ta, tm = ts.pack(device=CPU)
    if tm.has_groups:
        # the JAX NumPy path packs NaN group bounds for a parsed model
        # (ROADMAP queue 3): hand it the port's
        ja = ja._replace(bb_min=jnp.asarray(ta.bb_min.numpy()),
                         bb_max=jnp.asarray(ta.bb_max.numpy()))
    ys, xs = np.mgrid[0:H, 0:W]
    jpx = jnp.asarray(xs.ravel(), jnp.int32)
    jpy = jnp.asarray(ys.ravel(), jnp.int32)
    px, py = integrator.pixel_grid(W, 0, H, CPU)
    return ((ja, jm, jc, js.camera.pack(), jpx, jpy),
            (ta, tm, tc, ts.camera.pack(torch.float32, CPU), px, py))


def kernel_route(ta, tm, tc):
    """The intersect kernel's route, forced with its plain version."""
    return integrator.intersect_route(ta, tm, tc,
                                      fn=mk.intersect_batch_reference)


def compare_grads(got, want, rtol=None, atol=None, scale_rel=None):
    """Hold the port's gradients (a SceneParams of tensors) against the
    JAX package's (its SceneParams, numpy-convertible) field by field:
    with rtol/atol, every entry |g - w| <= atol + rtol |w|; with
    scale_rel, every entry |g - w| <= scale_rel * max|w| of its field.
    An entry where the JAX gradient is NaN (its sqrt fault,
    sampling._sqrt0) must be finite here. Prints and returns the worst
    entry of each field: {field: (ratio to the rule, |g - w|, max|w|,
    JAX NaN entries)}."""
    out = {}
    for k in FIELDS:
        g = getattr(got, k).detach().cpu().numpy().astype(np.float64)
        w = np.asarray(getattr(want, k), np.float64)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        assert np.isfinite(g).all(), k
        fin = np.isfinite(w)
        d = np.abs(g - w)[fin]
        top = float(np.abs(w[fin]).max()) if fin.any() else 0.0
        lim = (atol + rtol * np.abs(w[fin]) if scale_rel is None
               else np.full(d.shape, scale_rel * top))
        ratio = float((d / np.maximum(lim, 1e-30)).max()) if d.size else 0.0
        out[k] = (ratio, float(d.max()) if d.size else 0.0, top,
                  int((~fin).sum()))
        print(f"{k}: worst |g - w| {out[k][1]:.3g} ({ratio:.3g} of the "
              f"rule), max|w| {top:.3g}, JAX NaN entries {out[k][3]}")
        assert (d <= lim).all(), (k, out[k])
    return out
