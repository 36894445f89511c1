"""The benchmark's tests: `python -m pytest ptbench/tests -q` from the
root of the repository (CPU); the card's: `python -m pytest ptbench/tests
-m cuda -q` on a machine with one.

They import neither JAX nor the JAX package. Shared here: the cells cut
to a size the CPU runs in seconds."""
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from ptbench import harness  # noqa: E402

TINY = {"width": 32, "height": 24, "samples": 16, "train_samples": 2,
        "pixels": 64, "lat": 8, "lon": 16}


def shrink(c):
    """A cell cut to TINY: the same scene, camera and traffic."""
    c.config.update(width=TINY["width"], height=TINY["height"])
    if "model" in c.config:
        m = c.config["model"]
        m.update(lat=TINY["lat"], lon=TINY["lon"],
                 triangles=2 * TINY["lon"] * (TINY["lat"] - 1))
    if c.traffic["job"] == "render_frames":
        c.traffic["samples"] = TINY["samples"]
    else:
        c.traffic["samples"] = TINY["train_samples"]
    c.checks = dict(c.checks, pixels=TINY["pixels"])
    return c


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    """run(workload, seed, trace=0, patch=None) -> (result, lines): one
    run of a cell cut to TINY on the CPU, the look for a card skipped;
    the cell's check limits are its file's. Build outputs go under
    tmp_path."""
    import torch

    from pathtracer_tpu_torch.render import integrator
    from pathtracer_tpu_torch.render import megakernel as mk

    real = harness.cell
    monkeypatch.setattr(harness, "cell", lambda root, name: shrink(
        real(ROOT, name)))
    # the card's route of the wavefront's nearest hits (the intersect
    # kernel), by its plain version
    monkeypatch.setattr(integrator, "kernel_route_applies",
                        lambda *a: True)
    monkeypatch.setattr(mk, "intersect_batch", mk.intersect_batch_reference)

    def run(workload, seed=3000000001, trace=0, patch=None, seconds=0.5):
        return harness.run(
            ["--workload", workload, "--seed", str(seed), "--seconds",
             str(seconds), "--trace", str(trace)], time.perf_counter(),
            root=tmp_path, device=torch.device("cpu"), patch=patch)
    return run


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
