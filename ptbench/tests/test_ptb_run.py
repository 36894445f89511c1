"""Whole runs of the cells, cut to a size the CPU runs (conftest.TINY),
with the program's plain versions in place of its kernels: the result
line, the check against the reference, the check's control and the
faults it has to catch, and the refusals."""
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT
from ptbench import harness

RENDER_CELLS = ["reference-render", "gopher16k-render"]
TRAIN_CELLS = ["reference-train-ad", "gopher16k-train-tri"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# what a CPU run reports: no device, so the readers of kernel time find
# nothing and stay silent
METRICS = {
    ("render", 0): {"render_msamples_s", "setup_s"},
    ("render", 1): {"pack_s", "frame_gap_ms", "device_idle_pct.render"},
    ("train", 0): {"train_msamples_s", "setup_s"},
    ("train", 1): {"pack_s", "device_idle_pct.train"},
}
CHECKS = {"render": {"gap_mean", "gap_max"},
          "train": {"loss_gap", "grad_gap", "change_gap"}}
CELL_CHECKS = {"gopher16k-train-tri": CHECKS["train"] | {"grad_dir_gap"}}


def kind(cell):
    return "render" if cell in RENDER_CELLS else "train"


@pytest.mark.parametrize("cell", RENDER_CELLS + TRAIN_CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(tiny, cell, trace):
    res, lines = tiny(cell, trace=trace)
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] >= 1, res["checks"]
    assert res["failed"] == 0
    want = METRICS[kind(cell), trace]
    if cell == "gopher16k-train-tri":
        want = ({"pack_s", "device_idle_pct.tri"} if trace else
                {"train_msamples_s.tri", "setup_s"}
                | ({"train_step_ms_p95"} if res["attempted"] > 1 else set()))
    assert set(res["metrics"]) == want
    for name, m in res["metrics"].items():
        assert m["value"] > 0 or name.startswith("device_idle_pct")
    assert set(res["checks"]) == CELL_CHECKS.get(cell, CHECKS[kind(cell)])
    # the numbers compared, each beside its limit, one line each
    assert lines[0].startswith(f"steps {res['attempted']}: seconds min ")
    assert len(lines) == 1 + len(res["checks"])
    for line, (name, ch) in zip(lines[1:], res["checks"].items()):
        assert line == f"check {name} = {ch['value']!r} (limit " \
                       f"{ch['limit']!r})"
        # the plain versions, bit for bit; Adam's update in another order
        assert ch["value"] == 0.0 or (kind(cell) == "train"
                                      and ch["value"] < 1e-6)
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _wrap_trace_tiles(monkeypatch, fn):
    from pathtracer_tpu_torch.render import megakernel as mk

    real = mk.trace_tiles

    def broken(*a, **kw):
        return fn(real, *a, **kw)
    monkeypatch.setattr(mk, "trace_tiles", broken)


def _stale(job):
    # every frame returns the warm-up frame's state
    warm = {}
    real = job.render

    def render(seed):
        if "img" not in warm:
            warm["img"] = real(seed)
        return warm["img"]
    job.render = render


def _half(monkeypatch):
    # half of each launch's samples left out, the mean over the rest
    def fn(real, *a, spp=1, **kw):
        half = max(kw.get("spp_pack", 1), spp // 2)
        return tuple(x * (spp / half) for x in real(*a, spp=half, **kw))
    _wrap_trace_tiles(monkeypatch, fn)


def _altered(monkeypatch):
    # every slot's sum altered where the kernel produces it
    def fn(real, *a, **kw):
        return tuple(x * (1.0 + 2.0 ** -10) for x in real(*a, **kw))
    _wrap_trace_tiles(monkeypatch, fn)


def _frozen_state(monkeypatch):
    # every optimizer step returns the state unchanged
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a: None)


def _half_batch(monkeypatch):
    # the loss over half of the pixels, the mean taken over the rest
    from pathtracer_tpu_torch.diff import grad as dgrad
    from pathtracer_tpu_torch.render.vec3 import Vec3

    real = dgrad.image_loss

    def half(params, scn, meta, cfg, cam, px, py, key, n, target, route=None):
        return real(params, scn, meta, cfg, cam, px[::2], py[::2], key, n,
                    Vec3(*(a[::2] for a in target)), route)
    monkeypatch.setattr(dgrad, "image_loss", half)


def _wrong_sign(monkeypatch):
    # every other gradient entry of the wrong sign, as the optimizer gets
    # it: its norm kept, its direction not
    real = torch.optim.Adam.step

    def step(self, *a):
        for group in self.param_groups:
            for q in group["params"]:
                if q.grad is not None:
                    q.grad.view(-1)[::2] *= -1.0
        return real(self, *a)
    monkeypatch.setattr(torch.optim.Adam, "step", step)


def _double_later(monkeypatch):
    # the update rule wrong from the second step on: that step taken twice
    real = torch.optim.Adam.step
    calls = {}

    def step(self, *a):
        n = calls[id(self)] = calls.get(id(self), 0) + 1
        real(self, *a)
        if n >= 2:
            real(self, *a)
    monkeypatch.setattr(torch.optim.Adam, "step", step)


def _half_slots(monkeypatch):
    # every other slot of the launch out of the loss, the mean over the
    # rest
    from pathtracer_tpu_torch.render import megakernel as mk

    real = mk.tile_pixel_layout

    def half(*a, **kw):
        xs, ys, pid = real(*a, **kw)
        pid = pid.copy()
        pid[1::2] = -1
        return xs, ys, pid
    monkeypatch.setattr(mk, "tile_pixel_layout", half)


FAULTS = [(c, f) for c in RENDER_CELLS for f in ("stale", "half", "altered")]
FAULTS += [("reference-train-ad", "frozen"),
           ("reference-train-ad", "half-batch"),
           ("gopher16k-train-tri", "frozen"),
           ("gopher16k-train-tri", "half-slots"),
           ("gopher16k-train-tri", "wrong-sign"),
           ("gopher16k-train-tri", "double-later")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_faults_fail_the_check(tiny, monkeypatch, cell, fault):
    patch = None
    if fault == "stale":
        patch = _stale
    else:
        {"half": _half, "altered": _altered, "frozen": _frozen_state,
         "half-batch": _half_batch, "half-slots": _half_slots,
         "wrong-sign": _wrong_sign, "double-later": _double_later}[fault](
            monkeypatch)
    res, _ = tiny(cell, patch=patch, seconds=1.5)
    assert res["correct"] is False
    assert any(ch["value"] > ch["limit"] for ch in res["checks"].values())


def _job(cell, seed):
    from conftest import shrink
    c = shrink(harness.cell(ROOT, cell))
    _, job = harness.make_job(ROOT, c, seed, torch.device("cpu"))
    mod = harness.load_module(c.dir / "jobs" / f"{c.traffic['job']}.py",
                              "job_under_test")
    return c, mod, job


@pytest.mark.parametrize("cell", RENDER_CELLS + TRAIN_CELLS)
def test_control_fails_the_check(cell):
    """The reference in bfloat16 put in the program's place."""
    c, mod, job = _job(cell, 11)
    if kind(cell) == "render":
        job.obj_text = mod.objtext.model_text(c.config["model"]) if (
            "model" in c.config) else ""
        pix = job.pixels()
        fs = harness.derived_seed(11, 0)
        got = mod.gaps(job.reference(fs, pix, dtype=torch.bfloat16),
                       job.reference(fs, pix))
    else:
        low = job.reference(dtype=torch.bfloat16)
        job.losses, job.grad1, job.change = low[0], low[1], low[2]
        if len(low) > 3:
            job.grad1_tri = low[3]
        got = job.compare(*job.reference())
    limits = c.checks["limits"]
    assert any(got[k] > limits[k] for k in limits), got


def _subprocess(code, cwd, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, **(env or {})})


def test_refuses_without_a_card():
    """On this CPU-only machine the command exits non-zero, no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "ptbench", "--workload",
                        "reference-render", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_refuses_in_a_tree_of_the_benchmark_alone(tmp_path):
    """A directory with BENCHMARK.json and ptbench/ only: no program."""
    import shutil
    shutil.copytree(ROOT / "ptbench", tmp_path / "ptbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys, time, torch\n"
            "sys.path.insert(0, '.')\n"
            "from ptbench import harness\n"
            "res = harness.run(['--workload', 'reference-render', '--seed',"
            " '1', '--seconds', '1'], time.perf_counter(),"
            " device=torch.device('cpu'))\n"
            "print(res)\n")
    p = _subprocess(code, tmp_path, env={"PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "pathtracer_tpu_torch" in p.stderr


def test_no_jax_after_a_run():
    """A tiny run leaves no module of JAX or the JAX package loaded, by
    top-level name (pathtracer_tpu_torch's name begins with
    pathtracer_tpu's)."""
    code = (
        "import sys, time, torch\n"
        "sys.path.insert(0, 'ptbench/tests')\n"
        "import conftest\n"
        "from ptbench import harness\n"
        "real = harness.cell\n"
        "harness.cell = lambda r, n: conftest.shrink(real(r, n))\n"
        "harness.run(['--workload', 'gopher16k-render', '--seed', '2',"
        " '--seconds', '0.2'], time.perf_counter(),"
        " device=torch.device('cpu'))\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & set(harness.FORBIDDEN)),"
        " 'pathtracer_tpu_torch' in tops)\n")
    p = _subprocess(code, ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[] True"


def test_jax_loaded_by_the_check_refuses_the_run(tiny, monkeypatch):
    """The look for JAX comes after the check and the metric readers,
    the last code to load modules: a check that loads a module named jax
    refuses the run (code 3), and main prints no result."""
    import types

    def patch(job):
        real = job.check

        def check():
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return real()
        job.check = check
    with pytest.raises(harness.Refused) as e:
        tiny("reference-render", patch=patch, seconds=0.2)
    assert e.value.code == 3 and "jax" in str(e.value)


def test_main_prints_no_result_when_refused(monkeypatch, capsys):
    def refused(argv, t0):
        raise harness.Refused("modules of JAX or the JAX package loaded: "
                              "jax", 3)
    monkeypatch.setattr(harness, "run", refused)
    assert harness.main(["--workload", "x", "--seed", "1", "--seconds",
                         "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def test_reference_imports_nothing_of_the_program():
    """Every module of ptbench/ref, and the roofline arithmetic."""
    mods = sorted(f"ptbench.ref.{p.stem}" for p in
                  (ROOT / "ptbench" / "ref").glob("*.py")
                  if p.stem != "__init__")
    assert {"ptbench.ref.wavefront", "ptbench.ref.tristep",
            "ptbench.ref.threefry"} <= set(mods)
    code = ("import sys\n"
            f"import {', '.join(mods)}, ptbench.roofline\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'pathtracer_tpu',"
            " 'pathtracer_tpu_torch'}))\n")
    p = _subprocess(code, ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"


def test_loaded_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pathtracer_tpu_torch_x", sys)
    assert "pathtracer_tpu" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.loaded_forbidden() == ["jax"]


@pytest.mark.parametrize("cell", RENDER_CELLS + TRAIN_CELLS)
def test_calibration_readings(tiny, monkeypatch, tmp_path, cell):
    """What ptbench.calibrate reads for a seed: the program's numbers
    (exact here: the plain versions on the CPU) and the control's."""
    monkeypatch.setenv("PT_ASSETS", str(tmp_path))
    c, mod, job = _job(cell, 12)
    job.setup()
    assert max(job.reading(False).values()) < 1e-6
    limits = c.checks["limits"]
    got = job.reading(True)
    assert any(got[k] > limits[k] for k in limits), got
