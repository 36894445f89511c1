#!/usr/bin/env python3
"""Run a tree's kernels, built for the CPU by build.py, through that tree's
own wrappers on CPU tensors, against the plain versions, bit for bit.

    python3 tools/cuda_shim/run.py TREE LIB.so [case ...]

TREE holds a pathtracer_tpu_torch (`.` for this checkout). Cases: `thread`,
`mode2`, `mode3`, `mxu` render a scene through trace_tiles (the walk's
knobs set) and through trace_tiles_reference; `isect` runs the
intersect-only kernel through intersect_batch on camera rays and one
bounce from their hits against intersect_batch_reference (all 16
outputs); `pairs` holds Kernel B's
leaf (leaf_bench `pairs` and `mma`) to its plain version on teapot's
leaves of 4, 8, 16 and 32; `finish` runs the frame's finish
(finish_frame) on a partial of each of _torch_scenes.FINISH_LAYOUTS
against untile_image's float64 finish; `grad` runs the gradient
kernel in triangle mode through grad_tiles against grad_tiles_reference
(by the gradient
rule, or without leaf tests by ablated_grad_rule: its atomic adds land
in thread order), `gradtex` in texel mode and
`texels` the f32-texel forward (bit for bit), both on the textured teapot
(tests/_torch_scenes.textured_teapot), each on the walk the knobs in the
environment select (PT_SUBPACKET, PT_ABLATE_LEAF). Environment: SCENE
(teapot; `size` for the size-check mesh, or any scene name), W, H (32,
16), NEE=1, LEAF (the BVH leaf size). torch.sin, cos and sqrt are made correctly rounded for
f32 here, as the shim's are, so both sides round alike. Exits 1 if a
case (Kernel B's renders aside, held by the per-slot rule on the card)
is not bit-equal."""
import contextlib
import ctypes
import inspect
import os
import sys
import textwrap
from pathlib import Path

tree, so = sys.argv[1], sys.argv[2]
cases = sys.argv[3:] or ["mode2", "mode3", "mxu", "pairs"]
sys.path.insert(0, str(Path(tree).resolve()))
sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "tests"))
import torch  # noqa: E402

from pathtracer_tpu_torch.config import RenderConfig  # noqa: E402
from pathtracer_tpu_torch.probes import leaf_bench  # noqa: E402
from pathtracer_tpu_torch.render import grad as tg  # noqa: E402
from pathtracer_tpu_torch.render import megakernel as mk  # noqa: E402
from pathtracer_tpu_torch.render import proctex  # noqa: E402
from pathtracer_tpu_torch.scene.pack import texel_params  # noqa: E402
from pathtracer_tpu_torch.scenes import get_scene  # noqa: E402
from _torch_scenes import (FINISH_LAYOUTS, ablated_grad_rule,  # noqa: E402
                           bounce_rays, camera_rays, finish_launch,
                           finish_partial, grad_inputs, grad_rule,
                           host_finish, port_inputs, size_check_scene,
                           tex_grad_rule, textured_teapot)

_f = {n: getattr(torch, n) for n in ("sin", "cos", "sqrt")}


def _rounded(f):
    def g(x, *a, **k):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            return f(x.double()).float()
        return f(x, *a, **k)
    return g


for _n, _fn in _f.items():
    setattr(torch, _n, _rounded(_fn))
lib = ctypes.CDLL(str(Path(so).resolve()))
for fn, (args, res) in mk.SIGNATURES.items():
    getattr(lib, fn).argtypes = args
    getattr(lib, fn).restype = res
mk.library = lambda: lib


class _Stream:
    cuda_stream = None


torch.cuda.device = lambda d: contextlib.nullcontext()
torch.cuda.current_stream = lambda d=None: _Stream()
torch.cuda.current_device = lambda: None   # a CPU device's index
mk._raw_stream = lambda device: None


def _on_cpu(fn, var):
    """fn with its CPU branch (the plain version) taken away."""
    src = textwrap.dedent(inspect.getsource(fn)).replace(
        f'if {var}.device.type != "cuda":', "if False:")
    ns = {}
    exec(compile(src, f"<{fn.__name__}>", "exec"), fn.__globals__, ns)
    return ns[fn.__name__]


trace = _on_cpu(mk.trace_tiles, "px")
grad = _on_cpu(tg.grad_tiles, "px")
isect = _on_cpu(mk.intersect_batch, "dev")
finish = _on_cpu(mk.finish_frame, "acc")
ENV = {"mode2": {"PT_SUBPACKET": "2"}, "mode3": {"PT_SUBPACKET": "3"},
       "mxu": {"PT_TRAVERSAL": "mxu"}, "thread": {}}
W, H = int(os.environ.get("W", 32)), int(os.environ.get("H", 16))
scene = os.environ.get("SCENE", "teapot")
nee = os.environ.get("NEE") == "1"
fails = 0
for case in cases:
    if case == "pairs":
        for K in (4, 8, 16, 32):
            if "leaf" in inspect.signature(leaf_bench.teapot_leaves).parameters:
                tabs, meta, arrays = leaf_bench.teapot_leaves("cpu", K)
            else:                        # a tree before the leaf argument
                leaf_bench.LEAF = K
                tabs, meta, arrays = leaf_bench.teapot_leaves("cpu")
            rays = leaf_bench.mesh_rays(arrays, 64, "cpu")
            want = leaf_bench.plain("pairs", rays, tabs, meta, 1)[0]
            got = leaf_bench.run("pairs", rays, tabs, meta, 1)[0]
            kt, ks = leaf_bench.run("mma", rays, tabs, meta, 3)
            pt, ps = leaf_bench.plain("mma", rays, tabs, meta, 3)
            ok = (torch.equal(got.reshape(want.shape), want)
                  and torch.equal(kt, pt) and torch.equal(ks.long(),
                                                          ps.long()))
            print(f"pairs and mma, leaf {K}: bit-equal {ok}", flush=True)
            fails += not ok
        continue
    if case == "finish":
        # the frame's finish against the host's float64 untile, divide
        # and cast, on partials whose image the order of the adds changes
        for W_, H_, tile, order, pack, axis in FINISH_LAYOUTS:
            run = finish_launch(W_, H_, tile, order, pack, axis)
            acc = finish_partial(run, seed=W_ * pack)
            ok = bool((finish(torch.from_numpy(acc), run, 2048).numpy()
                       == host_finish(acc, run.pid, W_, H_, 2048)).all())
            print(f"finish {W_}x{H_} {order} pack {pack} {axis}: bit-equal "
                  f"{ok}", flush=True)
            fails += not ok
        continue
    if case == "isect":
        # K5 on camera rays and one bounce from their hits: all 16 outputs
        if os.environ.get("LEAF"):
            os.environ["PT_BVH_LEAF"] = os.environ["LEAF"]
        cfg = RenderConfig(width=W, height=H, samples=2)
        sc = (size_check_scene(cfg, get_scene) if scene == "size"
              else get_scene(scene, cfg))
        arrays, meta = sc.pack(device="cpu")
        tables = mk.intersect_tables(arrays, meta, "cpu")
        gen = torch.Generator().manual_seed(0)
        o, d = camera_rays(sc.camera, W, H, 2, gen)
        for batch in range(2):
            got = isect(arrays, meta, cfg, o, d, tables=tables)
            want = mk.intersect_batch_reference(arrays, meta, cfg, o, d,
                                                tables)
            flat = [[x for r in res for x in (r if isinstance(r, tuple)
                                              else (r,))]
                    for res in (got, want)]
            bad = [i for i, (a, b) in enumerate(zip(*flat))
                   if not torch.equal(a, b)]
            print(f"isect {scene} batch {batch} ({o[0].numel()} rays): "
                  f"{len(flat[0])} outputs, differing {bad}", flush=True)
            fails += bool(bad) or len(flat[0]) != 16
            o, d = bounce_rays(o, d, want[0], cfg.t_max, gen)
        continue
    if case in ("grad", "gradtex", "texels"):
        cfg = RenderConfig(width=W, height=H, samples=2, samples_per_pass=2)
        sc = (size_check_scene(cfg, get_scene) if scene == "size"
              else get_scene(scene, cfg))
        if case != "grad":
            sc = textured_teapot(sc, proctex.make)
        tabs, meta, arrays, _ = grad_inputs(sc, cfg, (8, 512), "cpu")
        kw = dict(meta=meta, cfg=cfg, spp=2, total_samples=2, tile=(8, 512))
        walk = mk.grad_scene_walk(meta)
        if case == "texels":
            kw.update(tex_table=torch.from_numpy(mk.build_tex_table(
                arrays, meta)), tex_texels=texel_params(arrays))
            k = torch.stack(trace((3, 0), *tabs, **kw))
            p = torch.stack(mk.trace_tiles_reference((3, 0), *tabs, **kw))
            ok = torch.equal(k, p)
            print(f"texels {mk.scene_walk(meta)}: bit-equal {ok}",
                  flush=True)
            fails += not ok
            continue
        gen = torch.Generator().manual_seed(0)
        cots = [torch.rand(tabs[-2].shape, generator=gen) for _ in range(3)]
        if case == "gradtex":
            kw.update(tex_grads=True, tex=texel_params(arrays),
                      tex_table=torch.from_numpy(mk.build_tex_table(
                          arrays, meta)))
        else:
            kw.update(tri_grads=True)
        k = grad((3, 0), *tabs, *cots, **kw)
        p = tg.grad_tiles_reference((3, 0), *tabs, *cots, **kw)
        try:
            err = (tex_grad_rule(k, p) if case == "gradtex"
                   else ablated_grad_rule(k, p) if walk.leaf == "none"
                   else grad_rule(k, p, mesh=True))
        except AssertionError as e:
            err = f"OFF THE RULE: {e}"
            fails += 1
        print(f"{case} {scene} {walk}: {err}", flush=True)
        continue
    os.environ.update(ENV[case])
    if os.environ.get("LEAF"):
        os.environ["PT_BVH_LEAF"] = os.environ["LEAF"]
    cfg = RenderConfig(width=W, height=H, samples=2, samples_per_pass=2,
                       nee=nee)
    sc = (size_check_scene(cfg, get_scene) if scene == "size"
          else get_scene(scene, cfg))
    tile = None if scene == "cubemap" else (8, 512)
    tabs, meta, _, lay = port_inputs(sc, cfg, tile, "cpu")
    kw = dict(meta=meta, cfg=cfg, spp=2, total_samples=2,
              tile=tile or mk.default_tile(meta), **lay)
    k = torch.stack(trace((3, 0), *tabs, **kw))
    p = torch.stack(mk.trace_tiles_reference((3, 0), *tabs, **kw))
    eq = float((k == p).float().mean())
    print(f"{case} {scene} nee={nee} leaf={meta.leaf_size}: bit-equal on "
          f"{eq:.6f} of the slot values, max abs err "
          f"{float((k - p).abs().max()):.3e}", flush=True)
    fails += eq != 1.0 and case != "mxu"
    for k_ in ENV[case]:
        os.environ.pop(k_)
sys.exit(1 if fails else 0)
