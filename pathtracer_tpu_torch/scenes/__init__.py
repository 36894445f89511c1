"""Named scene registry (reference: cmd/pt/main.go:27-43 `sc` table).

Each factory takes a RenderConfig and returns a scene.Scene: the 15
reference scenes and the three file-texture extensions, as in the JAX
package.
"""
from __future__ import annotations

from typing import Callable, Dict

from ..config import RenderConfig
from ..scene.pack import Scene

_REGISTRY: Dict[str, Callable[[RenderConfig], Scene]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_scene(name: str, cfg: RenderConfig) -> Scene:
    if name not in _REGISTRY:
        raise KeyError(
            f"no scene named {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](cfg)


def list_scenes():
    return sorted(_REGISTRY)


# import for registration side effects
from . import cornell  # noqa: E402,F401
from . import gopher  # noqa: E402,F401
from . import models  # noqa: E402,F401
from . import transparency  # noqa: E402,F401
from . import textured  # noqa: E402,F401
