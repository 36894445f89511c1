"""The rematerialized bounces of the wavefront autograd path
(render/integrator.py `_remat_bounces`, `_plain_bounces`, `render_rays`):
on a scene whose bounces sample a texture or a normal map, where the
bounces' intermediates would not fit in the memory free on the device, the
fixed-trip loop runs the bounces past the first `_plain_bounces` under
torch.utils.checkpoint, as the JAX package's loop runs each under
jax.checkpoint, and the backward pass recomputes them. The memory free is
patched here (`integrator._free_bytes`): 0 rematerializes every bounce.

- The rule: every bounce plain where the batch fits (a test-size batch
  does), on untextured scenes, in the early-exit loop and under
  torch.no_grad(); else as many plain as leave room for one recompute.
- The gradients are those of the loop without the checkpoint, bit for bit
  (torch.equal, field by field): `textures` through the torch walk and
  through the intersect kernel's route (its plain version), `textures-train`
  and `cubemap`, at 16x12x2, every bounce rematerialized; and `textures`
  with its first 4 bounces plain.
- The bytes the autograd graph holds at the end of the forward, a ray, at
  16x12x1 on every registered scene (the kernel's route, its plain
  version): the tensors autograd saves outside the checkpoints plus the
  inputs each checkpoint keeps (its own saved-tensor hooks hide the saves
  inside it), the scene's and the parameters' storages left out. Below
  2,000 B on `textures` with every bounce rematerialized (about 11,200
  without the checkpoint); unchanged on every scene the predicate leaves
  out; without the checkpoint at most `_BOUNCE_BYTES` a bounce on every
  scene it selects, as `_plain_bounces` counts them.
- debug_ray prints one line a bounce: the recompute does not print.
- make_sharded_train_step on `textures` over a LogicalMesh is bit-equal to
  one process's loss_and_grads of each shard without the checkpoint.

One thread, set for this module's tests and restored after them: an exact
comparison would otherwise meet torch's CPU sqrt transient on its second
thread (ROADMAP.md §3). No JAX."""
import contextlib
import re
from unittest import mock

import pytest
import torch
import torch.utils._pytree as pytree

from _torch_scenes import at_backward, free_bytes, free_for
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.diff import (extract_params, image_loss,
                                       loss_and_grads,
                                       make_sharded_train_step)
from pathtracer_tpu_torch.parallel.mesh import LogicalMesh, shard_rows
from pathtracer_tpu_torch.render import integrator, threefry
from pathtracer_tpu_torch.render import megakernel as mk
from pathtracer_tpu_torch.render.intersect import reattach_hit
from pathtracer_tpu_torch.render.vec3 import Vec3
from pathtracer_tpu_torch.scenes import get_scene, list_scenes

CPU = torch.device("cpu")
W, H = 16, 12
# the scenes whose bounces sample a texture or a normal map
TEXTURED = {"textures", "textures-file", "textures-train", "cubemap",
            "envmap", "envmap-file"}
TEXTURES_MAX_BYTES = 2000
FIELDS = ("color", "emission", "tri_color", "tex_planar", "tex_sphere",
          "tex_cube")
REMAT = integrator._remat_bounces
NO_ROOM = 0              # integrator._free_bytes: every bounce recomputed
ROOM = 1 << 62           # and none


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name, spp):
    cfg = RenderConfig(width=W, height=H, samples=spp, samples_per_pass=spp)
    sc = get_scene(name, cfg)
    scn, meta = sc.pack(device=CPU)
    cam = sc.camera.pack(torch.float32, CPU)
    px, py = integrator.pixel_grid(W, 0, H, CPU)
    return scn, meta, cfg, cam, px, py


def _kernel_route(scn, meta, cfg):
    return integrator.intersect_route(scn, meta, cfg,
                                      fn=mk.intersect_batch_reference)


@contextlib.contextmanager
def _checkpoints():
    """Counts integrator.checkpoint's calls: yields a list, one entry a
    rematerialized bounce."""
    calls = []
    real = integrator.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    with mock.patch.object(integrator, "checkpoint", counted):
        yield calls


def _grads(scn, meta, cfg, cam, px, py, route, key=3, target=None):
    target = Vec3.zeros((px.shape[0],), torch.float32, CPU) \
        if target is None else target
    return loss_and_grads(extract_params(scn), scn, meta, cfg, cam, px, py,
                          threefry.prng_key(key), cfg.samples, target,
                          route=route)


def _assert_equal(a, b):
    (la, ga), (lb, gb) = a, b
    assert torch.equal(la, lb)
    for k in FIELDS:
        assert torch.equal(getattr(ga, k), getattr(gb, k)), k


def test_remat_rule():
    scn, meta, cfg, cam, px, py = _setup("textures", 1)
    cfg = cfg.replace(early_exit=False)     # as render_image_diff runs it
    tm = _setup("reference", 1)[1]
    R, n = 1000, cfg.max_bounces
    per = R * integrator._BOUNCE_BYTES
    plain = integrator._plain_bounces
    # a test-size batch fits in what the host has free
    assert plain(meta, cfg, W * H, CPU) == n
    most = (n * per * 4 + 2) // 3         # three quarters hold them all
    with free_bytes(most):
        assert plain(meta, cfg, R, CPU) == n
    with free_bytes(most - 8):            # room for 9: 8, and a recompute
        assert plain(meta, cfg, R, CPU) == n - 2
    for k in range(n - 1):
        with free_bytes(free_for(k, R)):
            assert plain(meta, cfg, R, CPU) == k
    with free_bytes(NO_ROOM):
        assert plain(meta, cfg, R, CPU) == 0
        # the scenes, loops and modes it leaves plain with no room at all
        assert plain(tm, cfg, R, CPU) == n
        assert plain(meta, cfg.replace(early_exit=True), R, CPU) == n
        with torch.no_grad():
            assert plain(meta, cfg, R, CPU) == n


def test_remat_not_where_the_batch_fits():
    scn, meta, cfg, cam, px, py = _setup("textures", 2)
    with _checkpoints() as calls:
        _grads(scn, meta, cfg, cam, px, py, _kernel_route(scn, meta, cfg))
    assert calls == []


@pytest.mark.parametrize("name,route", [("textures", "walk"),
                                        ("textures", "kernel"),
                                        ("textures-train", "kernel"),
                                        ("cubemap", "kernel")])
def test_remat_grads_equal_the_plain_loop(name, route):
    scn, meta, cfg, cam, px, py = _setup(name, 2)
    assert REMAT(meta)
    r = _kernel_route(scn, meta, cfg) if route == "kernel" else None
    with _checkpoints() as calls, free_bytes(NO_ROOM):
        got = _grads(scn, meta, cfg, cam, px, py, r)
    assert len(calls) == cfg.max_bounces
    with free_bytes(ROOM):
        want = _grads(scn, meta, cfg, cam, px, py, r)
    _assert_equal(got, want)
    # the atlases the scene samples have a gradient
    assert any(bool((getattr(got[1], k) != 0).any())
               for k in ("tex_planar", "tex_sphere", "tex_cube"))


def test_remat_grads_equal_with_the_first_bounces_plain():
    scn, meta, cfg, cam, px, py = _setup("textures", 2)
    r = _kernel_route(scn, meta, cfg)
    with _checkpoints() as calls, free_bytes(free_for(4, W * H * 2)):
        got = _grads(scn, meta, cfg, cam, px, py, r)
    assert len(calls) == cfg.max_bounces - 4
    with free_bytes(ROOM):
        want = _grads(scn, meta, cfg, cam, px, py, r)
    _assert_equal(got, want)


def _graph_bytes_a_ray(scn, meta, cfg, cam, px, py):
    """Bytes a ray that the autograd graph of one image_loss holds after
    its forward (the kernel's route, its plain version): the storages
    autograd saves outside the checkpoints, and every tensor a checkpoint
    keeps as its input, each storage once; the scene's, the route's and
    the parameters' left out."""
    route = _kernel_route(scn, meta, cfg)
    p = extract_params(scn)
    leaves = {k: getattr(p, k).detach().requires_grad_(True)
              for k in p._fields if getattr(p, k) is not None}
    p = p._replace(**leaves)
    skip = {t.untyped_storage().data_ptr() for t in pytree.tree_leaves(
        (tuple(scn), tuple(leaves.values()), tuple(route.tables)))
        if isinstance(t, torch.Tensor)}
    held = {}

    def note(t):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st.data_ptr() not in skip:
                held[st.data_ptr()] = st.nbytes()
        return t
    real = integrator.checkpoint

    def kept(fn, *args, **kw):
        pytree.tree_map(note, args)
        return real(fn, *args, **kw)
    with mock.patch.object(integrator, "checkpoint", kept), \
            torch.autograd.graph.saved_tensors_hooks(note, lambda t: t):
        image_loss(p, scn, meta, cfg, cam, px, py, threefry.prng_key(3),
                   cfg.samples, Vec3.zeros((px.shape[0],), torch.float32,
                                           CPU), route=route)
    return sum(held.values()) / (px.shape[0] * cfg.samples)


@pytest.mark.parametrize("name", list_scenes())
def test_remat_graph_bytes(name):
    scn, meta, cfg, cam, px, py = _setup(name, 1)
    assert REMAT(meta) == (name in TEXTURED)
    with free_bytes(NO_ROOM):
        got = _graph_bytes_a_ray(scn, meta, cfg, cam, px, py)
    with free_bytes(ROOM):
        plain = _graph_bytes_a_ray(scn, meta, cfg, cam, px, py)
    print(f"{name}: {got:.1f} B a ray held after the forward "
          f"({plain:.1f} without the checkpoint)")
    if name not in TEXTURED:
        assert got == plain
    else:
        assert got < plain
        # what _plain_bounces counts a bounce bounds the loop's
        assert plain <= cfg.max_bounces * integrator._BOUNCE_BYTES
    if name == "textures":
        assert got < TEXTURES_MAX_BYTES < plain


def test_remat_debug_ray_prints_once_a_bounce(capsys):
    scn, meta, cfg, cam, px, py = _setup("textures", 1)
    cfg = cfg.replace(debug_ray=5)
    before = reattach_hit.calls
    with free_bytes(NO_ROOM), at_backward(lambda: reattach_hit.calls) as at:
        _grads(scn, meta, cfg, cam, px, py, _kernel_route(scn, meta, cfg))
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("bounce ")]
    assert [int(re.match(r"bounce (\d+) ray 5:", ln).group(1))
            for ln in lines] == list(range(cfg.max_bounces))
    # the bounced rays (not the camera's) re-attached in the forward, and
    # again in the recompute
    assert at == [before + cfg.max_bounces - 1]
    assert reattach_hit.calls - at[0] == cfg.max_bounces - 1


def test_remat_sharded_step_equals_one_process():
    scn, meta, cfg, cam, px, py = _setup("textures", 2)
    gen = torch.Generator().manual_seed(2)
    target = Vec3(*torch.rand((3, W * H), generator=gen).unbind(0))
    key, lr, P = threefry.prng_key(0), 0.05, 2
    p = extract_params(scn)
    step = make_sharded_train_step(LogicalMesh((P, 1)), meta, cfg,
                                   n_samples=2, lr=lr)
    with _checkpoints() as calls, free_bytes(NO_ROOM):
        new, loss = step(p, scn, cam, px, py, target, key)
    assert len(calls) == P * cfg.max_bounces
    # one process, each shard's loss and gradients without the checkpoint,
    # added in the mesh's order
    parts = []
    with free_bytes(ROOM):
        for i in range(P):
            tgt = Vec3(*(shard_rows(c, i, P) for c in target))
            parts.append(loss_and_grads(
                p, scn, meta, cfg, cam, shard_rows(px, i, P),
                shard_rows(py, i, P),
                threefry.fold_in(threefry.fold_in(key, i), 0), 2, tgt))
    want_loss = (parts[0][0].reshape(1) + parts[1][0].reshape(1)) / P
    assert torch.equal(loss, want_loss[0])
    for k in FIELDS:
        g = (getattr(parts[0][1], k) + getattr(parts[1][1], k)) / P
        with torch.no_grad():
            want = getattr(p, k) - lr * g
        assert torch.equal(getattr(new, k), want), k
    assert bool((getattr(new, "tex_planar") != p.tex_planar).any())


@pytest.mark.parametrize("mode", ["early_exit", "no_grad"])
def test_remat_only_in_the_differentiated_fixed_trip(mode):
    scn, meta, cfg, cam, px, py = _setup("textures", 1)
    cfg = cfg.replace(early_exit=mode == "early_exit",
                      trainable_textures=True)
    key = threefry.prng_key(1)

    def refuse(*a, **kw):
        raise AssertionError("checkpointed")
    with mock.patch.object(integrator, "checkpoint", refuse), \
            free_bytes(NO_ROOM), torch.set_grad_enabled(mode == "early_exit"):
        got = integrator.render_pass(scn, meta, cfg, cam, px, py, 0, 1, key)
    with torch.no_grad():
        want = integrator.render_pass(scn, meta, cfg.replace(
            early_exit=False), cam, px, py, 0, 1, key)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
