"""pathtracer_tpu_torch's training state (diff/checkpoint.py), the
default mode of its train_demo, and the host leftovers of the JAX package
(io/canvas.py, geometry/ray.py, scene/bvh.py's group divide), on the CPU.

The checkpoint: params and Adam's state round-trip bit for bit (as
tests/test_grad.py's test_train_state_checkpoint_roundtrip holds the JAX
package's orbax state), the newest steps are kept, and an Adam run resumed
from a checkpoint equals the unbroken run bit for bit on the CPU (the
plain versions sum in a fixed order; on the card the gradient's gathers
add with atomics, so chip_smoke.py holds a resumed card run to the
unbroken one by the gradient rule instead). The host leftovers are held to
the tables of tests/test_io.py, tests/test_transforms.py and
tests/test_bvh.py, and against the JAX package's functions on the same
inputs."""
import os

import numpy as np
import pytest
import torch

import pathtracer_tpu.geometry as jg
from pathtracer_tpu.io.canvas import Canvas as JCanvas
from pathtracer_tpu.scene import bvh as jbvh
from pathtracer_tpu.scene import shapes as jshapes
from pathtracer_tpu_torch import geometry as g
from pathtracer_tpu_torch import train_demo
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.diff import (extract_params, loss_and_grads,
                                       restore_train_state,
                                       save_train_state)
from pathtracer_tpu_torch.io import Canvas
from pathtracer_tpu_torch.render import integrator, threefry
from pathtracer_tpu_torch.render.vec3 import Vec3
from pathtracer_tpu_torch.scene import bvh
from pathtracer_tpu_torch.scene.bounds import BoundingBox
from pathtracer_tpu_torch.scene.shapes import Group, Sphere
from pathtracer_tpu_torch.scenes import get_scene

torch.set_num_threads(2)

CPU = torch.device("cpu")
W, H, SPP = 8, 6, 2


@pytest.fixture(scope="module")
def setup():
    cfg = RenderConfig(width=W, height=H, samples=SPP, samples_per_pass=SPP)
    sc = get_scene("reference", cfg)
    arrays, meta = sc.pack(device=CPU)
    cam = sc.camera.pack(torch.float32, CPU)
    px, py = integrator.pixel_grid(W, 0, H, CPU)
    return cfg, arrays, meta, cam, px, py


def _adam_run(setup, steps, ckdir=None, start=None):
    """Adam on (color, emission) toward a black target, `steps` steps of
    its own key each; with `start`, resumed from ckdir's latest step."""
    cfg, arrays, meta, cam, px, py = setup
    p0 = extract_params(arrays)
    leaves = [p0.color.clone().requires_grad_(True),
              p0.emission.clone().requires_grad_(True)]
    opt = torch.optim.Adam(leaves, lr=0.05)
    first = 0
    if start is not None:
        first, p, state = restore_train_state(
            ckdir, p0._replace(color=leaves[0].detach(),
                               emission=leaves[1].detach()),
            opt.state_dict())
        with torch.no_grad():
            leaves[0].copy_(p.color)
            leaves[1].copy_(p.emission)
        opt.load_state_dict(state)
    target = Vec3.zeros((px.shape[0],), torch.float32, CPU)
    losses = []
    for i in range(first, steps):
        loss, gr = loss_and_grads(
            p0._replace(color=leaves[0], emission=leaves[1]), arrays, meta,
            cfg, cam, px, py, threefry.fold_in(threefry.prng_key(0), i),
            SPP, target)
        opt.zero_grad()
        leaves[0].grad, leaves[1].grad = gr.color, gr.emission
        opt.step()
        losses.append(float(loss))
        if ckdir is not None and start is None:
            save_train_state(ckdir, i + 1, p0._replace(
                color=leaves[0].detach(), emission=leaves[1].detach()),
                opt.state_dict(), max_to_keep=2)
    return [x.detach() for x in leaves], opt.state_dict(), losses


def _flat_state(state):
    out = []
    for k in sorted(state["state"]):
        for name, v in sorted(state["state"][k].items()):
            out.append((k, name, v))
    return out


def test_train_state_roundtrip_bit_for_bit(setup, tmp_path):
    (c, e), state, losses = _adam_run(setup, 2)
    assert losses[1] < losses[0]
    p0 = extract_params(setup[1])
    params = p0._replace(color=c, emission=e)
    ck = str(tmp_path / "ck")
    save_train_state(ck, 7, params, state)
    fresh = torch.optim.Adam([p0.color.clone().requires_grad_(True),
                              p0.emission.clone().requires_grad_(True)])
    step, p2, o2 = restore_train_state(ck, p0, fresh.state_dict())
    assert step == 7 and type(p2) is type(p0)
    for k in p0._fields:
        a, b = getattr(params, k), getattr(p2, k)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b)
    got, want = _flat_state(o2), _flat_state(state)
    assert [x[:2] for x in got] == [x[:2] for x in want] and got
    for (_, _, a), (_, _, b) in zip(got, want):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert o2["param_groups"] == state["param_groups"]
    # no optimizer state asked for: none returned
    assert restore_train_state(ck, p0)[2] is None


def test_train_state_keeps_newest_steps_and_refuses(setup, tmp_path):
    p0 = extract_params(setup[1])
    ck = str(tmp_path / "ck")
    with pytest.raises(FileNotFoundError):
        restore_train_state(ck, p0)
    for s in (1, 2, 3, 4):
        save_train_state(ck, s, p0._replace(color=p0.color + s),
                         max_to_keep=3)
    assert sorted(os.listdir(ck)) == ["2", "3", "4"]   # no temporaries
    step, p, _ = restore_train_state(ck, p0)
    assert step == 4 and torch.equal(p.color, p0.color + 4)
    step, p, _ = restore_train_state(ck, p0, step=2)
    assert step == 2 and torch.equal(p.color, p0.color + 2)
    with pytest.raises(FileNotFoundError):
        restore_train_state(ck, p0, step=1)
    with pytest.raises(ValueError, match="color"):
        restore_train_state(ck, p0._replace(color=p0.color[:2]))


def test_resumed_run_equals_unbroken_run(setup, tmp_path):
    full, full_state, full_losses = _adam_run(setup, 4)
    ck = str(tmp_path / "ck")
    _adam_run(setup, 2, ckdir=ck)
    got, got_state, losses = _adam_run(setup, 4, ckdir=ck, start=True)
    assert len(losses) == 2 and losses == full_losses[2:]
    for a, b in zip(got, full):
        assert torch.equal(a, b)
    for (_, _, a), (_, _, b) in zip(_flat_state(got_state),
                                    _flat_state(full_state)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_train_demo_default_mode(tmp_path, capsys):
    # tools/train_demo.py's default mode at a tiny size: the sphere-color
    # MAD falls, and a run stopped and resumed from its checkpoint ends
    # where the unbroken run ends
    out = str(tmp_path / "d.png")
    args = ["--device", "cpu", "--width", "12", "--height", "9", "--spp",
            "2", "--lr", "0.05", "--out", out]
    err0, err1 = train_demo.main_colors(
        train_demo.build_parser().parse_args(args + ["--steps", "6"]), CPU)
    assert err1 < err0 and os.path.exists(out)
    ck = str(tmp_path / "ck")
    assert train_demo.main(args + ["--steps", "3", "--checkpoint", ck]) == 0
    assert sorted(os.listdir(ck)) == ["1", "2", "3"]
    assert train_demo.main(args + ["--steps", "6", "--checkpoint", ck,
                                   "--resume"]) == 0
    text = capsys.readouterr().out
    assert "resumed from" in text and "at step 3" in text
    mad = [ln for ln in text.splitlines() if "color MAD" in ln][-1]
    assert mad.endswith(f"{err1:.4f}"), (mad, err1)
    # the default mode's refusals
    assert train_demo.main(["--scene", "teapot", "--device", "cpu"]) == 2
    assert train_demo.main(["--resume", "--device", "cpu"]) == 2
    assert train_demo.main(["--tri", "--checkpoint", ck]) == 2


def test_canvas_matches_the_jax_table():
    # tests/test_io.py test_canvas, on both packages
    for cls in (Canvas, JCanvas):
        c = cls(3, 2)
        c.write_pixel(2, 1, (0.1, 0.2, 0.3))
        c.write_pixel_mutex(0, 0, (1.0, 0.0, 0.0))
        np.testing.assert_allclose(c.pixel_at(2, 1), [0.1, 0.2, 0.3])
        np.testing.assert_allclose(c.pixel_at(0, 0), [1.0, 0.0, 0.0])
        c.blit(np.ones((2, 3, 3), dtype=np.float32))
        assert c.to_image().sum() == 18.0 and c.to_image().dtype == np.float32


@pytest.mark.parametrize("t", [0, 1, -1, 2.5])
def test_ray_position_matches_the_jax_table(t):
    r = g.Ray(g.point(2, 3, 4), g.vector(1, 0, 0))
    want = {0: (2, 3, 4), 1: (3, 3, 4), -1: (1, 3, 4), 2.5: (4.5, 3, 4)}[t]
    assert np.allclose(g.ray_position(r, t), g.point(*want))
    jr = jg.Ray(jg.point(2, 3, 4), jg.vector(1, 0, 0))
    assert np.array_equal(g.ray_position(r, t), jg.ray_position(jr, t))


def test_transform_ray_matches_the_jax_table():
    r = g.Ray(g.point(1, 2, 3), g.vector(0, 1, 0))
    r2 = g.transform_ray(g.translate(3, 4, 5), r)
    assert np.allclose(r2.origin, g.point(4, 6, 8))
    assert np.allclose(r2.direction, g.vector(0, 1, 0))
    r3 = g.transform_ray(g.scale(2, 3, 4), r)
    assert np.allclose(r3.origin, g.point(2, 6, 12))
    assert np.allclose(r3.direction, g.vector(0, 3, 0))
    jr3 = jg.transform_ray(jg.scale(2, 3, 4),
                           jg.Ray(jg.point(1, 2, 3), jg.vector(0, 1, 0)))
    assert np.array_equal(r3.origin, jr3.origin)
    assert np.array_equal(r3.direction, jr3.direction)


@pytest.mark.parametrize("box,left_max,right_min", [
    ((-1, -4, -5, 9, 6, 5), (4, 6, 5), (4, -4, -5)),      # dx largest
    ((-1, -2, -3, 3, 7, 3), (3, 2.5, 3), (-1, 2.5, -3)),  # dy largest
    ((-1, -2, -3, 3, 3, 7), (3, 3, 2), (-1, -2, 2)),      # dz largest
])
def test_split_bounds_matches_the_jax_table(box, left_max, right_min):
    left, right = bvh.split_bounds(BoundingBox.of_floats(*box))
    assert np.allclose(left.min[:3], box[:3])
    assert np.allclose(left.max[:3], left_max)
    assert np.allclose(right.min[:3], right_min)
    assert np.allclose(right.max[:3], box[3:])


def _spheres(mod, gmod, transforms):
    out = []
    for tr in transforms:
        s = mod.Sphere()
        if tr is not None:
            s.set_transform(getattr(gmod, tr[0])(*tr[1:]))
        out.append(s)
    return out


def _leaves(grp, mod):
    """(depth, sphere index) of every leaf, depth first."""
    out = []

    def walk(gr, depth):
        for c in gr.children:
            if isinstance(c, mod.Group):
                walk(c, depth + 1)
            else:
                out.append((depth, c.label))
    walk(grp, 0)
    return out


@pytest.mark.parametrize("transforms,threshold", [
    ([("translate", -2, 0, 0), ("translate", 2, 0, 0), None], None),
    ([("translate", -2, 0, 0), ("translate", 2, 0, 0)], 3),
    ([("translate", -2, -2, 0), ("translate", -2, 2, 0),
      ("scale", 4, 4, 4)], 1),
])
def test_divide_matches_the_jax_package(transforms, threshold):
    # tests/test_bvh.py's partition and divide cases, on both packages:
    # the same children end up in the same subgroups at the same depths
    trees = []
    for mod, gmod, part in ((jshapes, jg, jbvh), (None, g, bvh)):
        mod = mod or __import__("pathtracer_tpu_torch.scene.shapes",
                                fromlist=["Sphere"])
        sph = _spheres(mod, gmod, transforms)
        for i, s in enumerate(sph):
            s.label = str(i)
        gr = mod.Group()
        gr.add_children(*sph)
        if threshold is None:
            left, right = part.partition_children(gr)
            trees.append(([c.label for c in gr.children],
                          [c.label for c in left.children],
                          [c.label for c in right.children]))
        else:
            part.divide(gr, threshold)
            trees.append(_leaves(gr, mod))
    assert trees[0] == trees[1]
    if threshold is None:
        assert trees[1] == (["2"], ["0"], ["1"])
    elif threshold == 3:
        assert trees[1] == [(0, "0"), (0, "1")]
    else:
        assert (0, "2") in trees[1] and any(d > 0 for d, _ in trees[1])


def test_divide_keeps_every_child():
    s = [Sphere() for _ in range(4)]
    for i, x in enumerate((-3, -1, 1, 3)):
        s[i].set_transform(g.translate(x, 0, 0))
    gr = Group()
    gr.add_children(*s)
    bvh.divide(gr, 2)
    got = []

    def walk(grp):
        for c in grp.children:
            walk(c) if isinstance(c, Group) else got.append(c)
    walk(gr)
    assert sorted(map(id, got)) == sorted(map(id, s))
    assert any(isinstance(c, Group) for c in gr.children)
