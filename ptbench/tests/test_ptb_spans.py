"""The readers of the program's spans (ptbench/spans.py and the metrics
that use it) against canned profiler traces, and the spans in a real
traced run of the cells cut to CPU size."""
import json
import sys
from types import ModuleType, SimpleNamespace

import pytest

from conftest import ROOT
from ptbench import harness, spans, tracing

US = 1e-3      # a canned microsecond, in ms


def ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 7, "tid": tid, "args": args}


def kernel(ts, dur, corr):
    return ev(f"void k{corr}(float*)", "kernel", ts, dur, tid=99,
              correlation=corr)


def launch(ts, corr, tid=1, api="cudaLaunchKernel"):
    return ev(api, "cuda_runtime" if api.startswith("cuda") else
              "cuda_driver", ts, 5, tid=tid, correlation=corr)


def span(name, ts, dur, tid=1):
    return ev(name, "user_annotation", ts, dur, tid=tid)


def op(name, ts, dur, seq, fwd, tid=1):
    return ev(name, "cpu_op", ts, dur, tid=tid, **{
        "Sequence number": seq, "Fwd thread id": fwd})


BWD = "autograd::engine::evaluate_function: "

# two frames of the render driver
FRAMES = [
    span(tracing.WINDOW, 0, 2000), span(tracing.STEP, 0, 1000),
    span(tracing.STEP, 1000, 1000),
    span("pt.layout", 0, 20), span("pt.layout", 1000, 30),
    span("pt.segment", 20, 10), span("pt.stack", 25, 3),
    span("pt.wait", 100, 100), span("pt.wait", 1100, 50),
    span("pt.wait", 1200, 10),
    span("pt.fetch", 400, 20), span("pt.fetch", 1400, 40),
    span("pt.untile", 420, 70), span("pt.untile", 1500, 90),
    kernel(30, 60, 1), launch(22, 1),
]

# two steps of the wavefront autograd path: the forward on thread 1, the
# backward's ops on the engine's thread 2; step 2 holds one kernel
AD = [
    span(tracing.WINDOW, 0, 2000), span(tracing.STEP, 0, 1000),
    span(tracing.STEP, 1000, 1000),
    span("pt.ad.forward", 10, 390), span("pt.bounce", 20, 280),
    span("pt.bounce.intersect", 20, 40), launch(30, 1),
    launch(40, 2, api="cuLaunchKernel"),
    span("pt.bounce.attrs", 60, 60), op("aten::index_select", 70, 30, 7, 0),
    launch(80, 3),
    span("pt.bounce.shade", 120, 180), span("pt.rng", 130, 30),
    launch(140, 4), op("aten::mul", 170, 20, 8, 0), launch(175, 5),
    launch(350, 6),                                 # the forward's own
    span("pt.ad.backward", 400, 500),
    op(BWD + "IndexSelectBackward0", 450, 50, 7, 1, tid=2), launch(460, 7,
                                                                   tid=2),
    op(BWD + "MulBackward0", 500, 50, 8, 1, tid=2), launch(510, 8, tid=2),
    op(BWD + "LostBackward0", 560, 30, 99, 1, tid=2), launch(570, 9, tid=2),
    # a recomputed bounce's draw on the engine's thread, a forward op with
    # a sequence number of thread 1's (7): under its own span
    span("pt.rng", 600, 40, tid=2), op("aten::bits", 605, 20, 7, 0, tid=2),
    launch(610, 13, tid=2),
    launch(950, 10),                                # under the step only
    span("pt.bounce.shade", 1050, 150), launch(1100, 12),
]
AD += [kernel(ts, dur, c) for ts, dur, c in [
    (31, 10, 1), (45, 20, 2), (85, 30, 3), (150, 40, 4), (180, 50, 5),
    (360, 60, 6), (470, 70, 7), (520, 80, 8), (580, 90, 9), (955, 5, 10),
    (960, 7, 11), (620, 13, 13), (1500, 100, 12), (2500, 1000, 14)]]
# by group, a step: (10 + 20) / 2, (30 + 70) / 2, (40 + 13) / 2,
# (50 + 80 + 100) / 2; the rest (60 + 90 + 5 + 7) / 2
WANT = {"intersect": 15.0, "attrs": 50.0, "rng": 26.5, "shade": 115.0,
        "rest": 81.0}
CARD = SimpleNamespace(type="cuda")
RENDER = SimpleNamespace(kind="render")
TRAIN = SimpleNamespace(kind="train")


def make_ctx(tmp_path, events, cell="cell", device=CARD):
    path = tmp_path / "build" / "ptbench" / f"trace-{cell}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": events}))
    return SimpleNamespace(timeline=tracing.Timeline.load(str(path)),
                           device=device, root=tmp_path,
                           cell=SimpleNamespace(workload={"name": cell}))


def read(metric, ctx, job):
    mod = harness.load_module(harness.reader_path(ROOT / "ptbench", metric),
                              f"reader_{metric}")
    return mod.read(ctx, job)


def test_frame_readers_mean_over_the_frames(tmp_path):
    ctx = make_ctx(tmp_path, FRAMES)
    for metric, us in [("frame_layout_ms", 25.0), ("frame_wait_ms", 80.0),
                       ("frame_fetch_ms", 30.0),
                       ("frame_untile_ms", 80.0)]:
        assert read(metric, ctx, RENDER) == pytest.approx(us * US), metric


def test_ad_groups_by_correlation_and_sequence_number(tmp_path):
    ctx = make_ctx(tmp_path, AD)
    for group, us in WANT.items():
        if group != "rest":
            assert read(f"ad_{group}_ms", ctx, TRAIN) == pytest.approx(
                us * US), group
    tr = spans.trace_of(ctx, TRAIN, "train")
    # a backward op's kernels go to its forward op's span; one whose
    # forward op is not in the trace, to the rest
    assert tr.group_of(7) == "attrs" and tr.group_of(8) == "shade"
    assert tr.group_of(9) == "rest"
    # the recomputed draw's own span wins over the sequence number
    assert tr.group_of(13) == "rng"
    # a kernel launched by the driver's API; one with no launch at all
    assert tr.group_of(2) == "intersect" and tr.group_of(11) == "rest"


def test_groups_and_rest_sum_to_the_steps_device_time(tmp_path):
    ctx = make_ctx(tmp_path, AD)
    got = spans.trace_of(ctx, TRAIN, "train").group_s()
    assert {k: v * 1e6 for k, v in got.items()} == pytest.approx(WANT)
    tl = ctx.timeline
    busy = sum(e.t1 - e.t0 for s in tl.steps for e in tl.ops(None, s.t0,
                                                              s.t1))
    assert sum(got.values()) == pytest.approx(busy / len(tl.steps))


def test_readers_silent_where_nothing_applies(tmp_path):
    frames = ["frame_layout_ms", "frame_wait_ms", "frame_fetch_ms",
              "frame_untile_ms"]
    ad = ["ad_rng_ms", "ad_attrs_ms", "ad_intersect_ms", "ad_shade_ms"]
    ctx = make_ctx(tmp_path, FRAMES + AD[3:])
    # another job's kind
    for m in frames:
        assert read(m, ctx, TRAIN) is None
    for m in ad:
        assert read(m, ctx, RENDER) is None
    # untraced, off the card
    for c in (SimpleNamespace(**{**vars(ctx), "timeline": None}),
              SimpleNamespace(**{**vars(ctx), "device": SimpleNamespace(
                  type="cpu")})):
        assert all(read(m, c, RENDER) is None for m in frames)
        assert all(read(m, c, TRAIN) is None for m in ad)
    # a program older than the spans: only the benchmark's, and kernels
    old = make_ctx(tmp_path, [e for e in AD if not e["name"].startswith(
        "pt.")], cell="old")
    assert all(read(m, old, TRAIN) is None for m in ad)
    old = make_ctx(tmp_path, FRAMES[:3] + FRAMES[-2:], cell="old2")
    assert all(read(m, old, RENDER) is None for m in frames)
    # no file where the run should have left one
    gone = SimpleNamespace(**{**vars(ctx), "cell": SimpleNamespace(
        workload={"name": "missing"})})
    assert read("frame_layout_ms", gone, RENDER) is None


def test_trace_parsed_once_a_file(tmp_path):
    ctx = make_ctx(tmp_path, AD)
    a = spans.trace_of(ctx, TRAIN, "train")
    assert spans.trace_of(ctx, TRAIN, "train") is a
    ctx = make_ctx(tmp_path, FRAMES + [span("pt.layout", 2, 1)])
    assert spans.trace_of(ctx, RENDER, "render") is not a


def test_pack_readers(monkeypatch):
    ctx = SimpleNamespace(device=CARD)
    mod = ModuleType("pathtracer_tpu_torch.scene.pack")
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    # a program that keeps no count
    mod.pack_scene = lambda: None
    assert read("pack_octant_s", ctx, TRAIN) is None
    mod.pack_scene.seconds = {"bvh": 0.5, "octant": 0.25, "textures": 0.0,
                              "tables": 0.125, "device": 0.75}
    assert read("pack_octant_s", ctx, TRAIN) == 0.25
    assert read("pack_device_s", ctx, RENDER) == 0.75
    cpu = SimpleNamespace(device=SimpleNamespace(type="cpu"))
    assert read("pack_device_s", cpu, RENDER) is None


@pytest.mark.parametrize("cell,names", [
    ("reference-render", {"pt.layout", "pt.segment", "pt.stack",
                          "pt.accumulate", "pt.fetch", "pt.untile"}),
    ("reference-train-ad", {"pt.ad.forward", "pt.ad.backward", "pt.bounce",
                            "pt.rng", *spans.GROUPS})])
def test_a_traced_run_holds_the_programs_spans(tiny, tmp_path, cell, names):
    """A --trace 1 run at CPU size: its trace holds the program's spans in
    its frames or steps (the readers stay silent: no card)."""
    res, _ = tiny(cell, trace=1)
    assert res["correct"]
    tr = spans.load(tmp_path / "build" / "ptbench" / f"trace-{cell}.json")
    assert names <= {s.name for s in tr.spans}
    assert len(tr.steps) == res["attempted"]
    if cell == "reference-render":
        assert tr.frame_s("pt.untile") > 0.0
    assert not set(res["metrics"]) & {
        "frame_layout_ms", "frame_untile_ms", "ad_rng_ms", "pack_device_s"}
