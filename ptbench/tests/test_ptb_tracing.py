"""The metric readers and the breakdown against a canned profiler trace:
a window of two frames, each with two forward launches and one copy."""
import json
from types import SimpleNamespace

import pytest

from conftest import ROOT
from ptbench import harness, tracing

US = 1e-6


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


K1 = ("void (anonymous namespace)::megakernel<false, false, false, false, "
      "false, 0, 0>(Params)")
GRAD = "void grad_megakernel<true, false, false, 0, 0>(Params)"
CANNED = [
    ev(tracing.WINDOW, "user_annotation", 0, 1000),
    ev(tracing.STEP, "user_annotation", 0, 500),
    ev(tracing.STEP, "user_annotation", 500, 500),
    ev(K1, "kernel", 100, 150),
    ev(K1, "kernel", 250, 150),
    ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 420, 30),
    ev(K1, "kernel", 600, 150),
    ev(K1, "kernel", 750, 150),
    ev(GRAD, "kernel", 2000, 10),      # outside the window
    ev("aten::copy_", "cpu_op", 400, 60),
    ev("cudaEventSynchronize", "cuda_runtime", 900, 80),
    ev("cudaLaunchKernel", "cuda_runtime", 20, 5),
]


@pytest.fixture
def ctx(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": CANNED}))
    tl = tracing.Timeline.load(str(path))
    steps = [SimpleNamespace(t0=0.0, t1=500 * US, work=1000),
             SimpleNamespace(t0=500 * US, t1=1000 * US, work=1000)]
    return SimpleNamespace(timeline=tl, steps=steps, window_s=1000 * US,
                           setup_s=7.5, spans={"pack": 0.25})


def read(metric, ctx, job):
    mod = harness.load_module(harness.reader_path(ROOT / "ptbench", metric),
                              f"reader_{metric}")
    return mod.read(ctx, job)


RENDER = SimpleNamespace(kind="render", frame_samples=1000)


def test_timeline(ctx):
    tl = ctx.timeline
    assert tl.window.t1 - tl.window.t0 == pytest.approx(1000 * US)
    assert len(tl.steps) == 2 and len(tl.ops(r"(?<!grad_)megakernel<")) == 4
    assert tl.busy_s() == pytest.approx(630 * US)
    ops = dict(tl.device_ops())
    assert ops["(anonymous namespace)::megakernel<false, false, false, "
               "false, false, 0, 0>"] == pytest.approx(600 * US)
    assert "grad_megakernel<true, false, false, 0, 0>" not in ops
    gaps = dict(tl.idle_gaps())
    # gaps [0, 100), [400, 420), [450, 600), [900, 1000), named at their
    # middles 50 (the step), 410 (aten::copy_), 525 (the step), 950
    assert gaps[tracing.STEP] == pytest.approx((100 + 150) * US)
    assert gaps["aten::copy_"] == pytest.approx(20 * US)
    assert gaps["cudaEventSynchronize"] == pytest.approx(100 * US)


def test_readers(ctx):
    assert read("setup_s", ctx, RENDER) == 7.5
    assert read("pack_s", ctx, RENDER) == 0.25
    assert read("render_msamples_s", ctx, RENDER) == pytest.approx(
        2000 / (1000 * US) / 1e6)
    # each frame 500 us of wall, 300 us of K1: 200 us of gap
    assert read("frame_gap_ms", ctx, RENDER) == pytest.approx(0.2)
    assert read("fwd_kernel_ps_per_sample", ctx, RENDER) == pytest.approx(
        600 * US / 2000 * 1e12)
    assert read("device_idle_pct.render", ctx, RENDER) == pytest.approx(37.0)


def test_roofline_reader(ctx):
    job = SimpleNamespace(kind="render", frame_samples=1000,
                          forward_bound_s=lambda n, f: (300 * US, "ops"))
    assert read("k1_roofline_pct", ctx, job) == pytest.approx(50.0)
    mesh = SimpleNamespace(kind="render", frame_samples=1000,
                           forward_bound_s=lambda n, f: None)
    assert read("k1_roofline_pct", ctx, mesh) is None


def test_readers_find_nothing_to_read(ctx):
    untraced = SimpleNamespace(**{**vars(ctx), "timeline": None})
    for m in ("frame_gap_ms", "fwd_kernel_ps_per_sample",
              "k1_roofline_pct", "device_idle_pct.render"):
        assert read(m, untraced, RENDER) is None
    other = SimpleNamespace()
    assert read("render_msamples_s", ctx, other) is None


def test_train_readers(ctx):
    train = SimpleNamespace(kind="train")
    # two steps: the first holds 2 kernels, the second 2 (the copy is no
    # kernel); the grad kernel lies outside the window's steps
    assert read("ad_kernels_per_step", ctx, train) == pytest.approx(2.0)
    assert read("device_idle_pct.train", ctx, train) == pytest.approx(37.0)
    assert read("train_msamples_s", ctx, train) == pytest.approx(2.0)
    for m in ("frame_gap_ms", "render_msamples_s", "k1_roofline_pct"):
        assert read(m, ctx, train) is None
    for m in ("ad_kernels_per_step", "train_msamples_s",
              "train_msamples_s.tri"):
        assert read(m, ctx, RENDER) is None


def test_a_metric_family_shares_its_reader():
    here = ROOT / "ptbench"
    for name in ("device_idle_pct.render", "device_idle_pct.train",
                 "device_idle_pct.tri", "device_idle_pct.serve"):
        assert harness.reader_path(here, name) == (
            here / "metrics" / "device_idle_pct.py")
    assert harness.reader_path(here, "train_msamples_s.tri") == (
        here / "metrics" / "train_msamples_s.py")
    # a metric's own file comes first
    assert harness.reader_path(here, "k1_roofline_pct") == (
        here / "metrics" / "k1_roofline_pct.py")


@pytest.mark.parametrize("name,short", [
    ("void megakernel<false, 0, 0>(Params)", "megakernel<false, 0, 0>"),
    ("void at::native::(anonymous namespace)::indexFuncLargeIndex<float, "
     "long>(at::cuda::detail::TensorInfo<float, unsigned int>, long)",
     "at::native::(anonymous namespace)::indexFuncLargeIndex<float, long>"),
    ("Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH"),
    ("sm90_xmma_gemm", "sm90_xmma_gemm"),
])
def test_kernel_names_shortened(name, short):
    assert tracing._short(name) == short
