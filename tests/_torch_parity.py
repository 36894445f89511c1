"""Helpers that build the same scene in pathtracer_tpu (JAX) and
pathtracer_tpu_torch and hand both the same inputs."""
from __future__ import annotations

import numpy as np

import pathtracer_tpu.scenes as jscenes
import pathtracer_tpu_torch.scenes as tscenes
from _torch_scenes import cylinder_scene
from pathtracer_tpu import config as jconfig
from pathtracer_tpu.geometry import transforms as jgx
from pathtracer_tpu.scene import material as jmat
from pathtracer_tpu.scene import pack as jpack
from pathtracer_tpu.scene import shapes as jshapes
from pathtracer_tpu.scenes import cornell as jcornell
from pathtracer_tpu_torch import config as tconfig
from pathtracer_tpu_torch.geometry import transforms as tgx
from pathtracer_tpu_torch.scene import material as tmat
from pathtracer_tpu_torch.scene import pack as tpack
from pathtracer_tpu_torch.scene import shapes as tshapes
from pathtracer_tpu_torch.scenes import cornell as tcornell


def scene_pair(name: str, **cfg_kw):
    """(JAX scene, JAX cfg, torch scene, torch cfg) for a slice scene or
    the synthetic "cylinder" scene (closed cylinder + glass cube)."""
    jc = jconfig.RenderConfig(**cfg_kw)
    tc = tconfig.RenderConfig(**cfg_kw)
    if name == "cylinder":
        return (cylinder_scene(jc, jgx, jmat, jshapes, jpack, jcornell), jc,
                cylinder_scene(tc, tgx, tmat, tshapes, tpack, tcornell), tc)
    return (jscenes.get_scene(name, jc), jc, tscenes.get_scene(name, tc), tc)


def jax_fields_np(arrays) -> dict:
    """The JAX SceneArrays as a dict of numpy arrays."""
    return {k: np.asarray(v) for k, v in arrays._asdict().items()}
