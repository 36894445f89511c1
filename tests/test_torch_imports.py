"""pathtracer_tpu_torch and its card scripts import no JAX and nothing of
pathtracer_tpu: the card's machine has neither. Every module of the
package is imported in a fresh interpreter where `import jax` fails, and
the scripts' imports are read from their source."""
import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("chip_smoke.py", "tools/cuda_megakernel_probe.py")

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import pathtracer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith(".__main__")]   # that one runs the CLI
for n in names:
    importlib.import_module(n)
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and (m == "jax" or m.startswith(("jax.", "pathtracer_tpu."))))
print(json.dumps({"modules": names, "foreign": loaded}))
"""


def test_package_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "pathtracer_tpu_torch.render.proctex" in res["modules"]
    assert {"pathtracer_tpu_torch.probes.op_rate",
            "pathtracer_tpu_torch.probes.leaf_bench"} <= set(res["modules"])
    # the wavefront's modules and the bench
    assert {f"pathtracer_tpu_torch.render.{m}" for m in (
        "vec3", "sampling", "uv", "camera", "intersect", "threefry",
        "integrator")} | {"pathtracer_tpu_torch.bench"} <= set(
            res["modules"])
    # the multi-GPU modules
    assert {f"pathtracer_tpu_torch.parallel.{m}" for m in (
        "mesh", "multihost", "render_dist")} <= set(res["modules"])
    assert len(res["modules"]) >= 35
    assert res["foreign"] == []


def _imported(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", SCRIPTS)
def test_card_scripts_import_no_jax(path):
    names = list(_imported(path))
    assert "pathtracer_tpu_torch.render" in " ".join(names)
    for n in names:
        root = n.split(".")[0]
        assert root not in ("jax", "jaxlib", "pathtracer_tpu"), n
