"""Training-state checkpoints: (step, params, optimizer state).

Counterpart of pathtracer_tpu.diff.checkpoint, which keeps the training
state with orbax; here one `torch.save` a step. Each step is a directory
`<path>/<step>` holding `state.pt` (the parameters as a mapping of field
name to tensor, and the optimizer's state_dict), written in a temporary
directory beside it and moved into place by os.replace, so a step is
either whole or absent. The newest `max_to_keep` steps stay, as orbax's
CheckpointManager keeps them; restore takes the latest by default.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Optional, Tuple

import torch

_STATE = "state.pt"


def _fields(params) -> dict:
    """A NamedTuple's (or a mapping's) non-None tensors by name."""
    d = params._asdict() if hasattr(params, "_asdict") else dict(params)
    return {k: v for k, v in d.items() if v is not None}


def _steps(path: str) -> list:
    """The committed steps under `path`, ascending."""
    if not os.path.isdir(path):
        return []
    return sorted(int(n) for n in os.listdir(path)
                  if n.isdigit() and os.path.isfile(os.path.join(path, n,
                                                                 _STATE)))


def save_train_state(path: str, step: int, params: Any,
                     opt_state: Any = None, max_to_keep: int = 3) -> None:
    """Save (params, opt_state) at `step` under `path`, atomically, and keep
    the newest `max_to_keep` steps. `params` is a SceneParams (or any
    NamedTuple or mapping of tensors); `opt_state` a torch.optim
    optimizer's state_dict() (or None). Tensors are saved as they are,
    device and all."""
    step = int(step)
    if step < 0:
        raise ValueError(f"step {step} < 0")
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{step}-", dir=path)
    try:
        torch.save({"step": step,
                    "params": {k: v.detach() for k, v in
                               _fields(params).items()},
                    "opt_state": opt_state},
                   os.path.join(tmp, _STATE))
        final = os.path.join(path, str(step))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for old in _steps(path)[:-max_to_keep] if max_to_keep > 0 else []:
        shutil.rmtree(os.path.join(path, str(old)), ignore_errors=True)


def restore_train_state(path: str, params_like: Any,
                        opt_state_like: Any = None,
                        step: Optional[int] = None
                        ) -> Tuple[int, Any, Any]:
    """Restore (step, params, opt_state) from `path`: `params_like` gives
    the structure (a SceneParams: the restored one has its type, each
    saved field on the device of params_like's, and its None fields stay
    None); the optimizer state is returned when `opt_state_like` is not
    None (an optimizer's state_dict: hand the result to load_state_dict).
    `step=None` restores the latest step."""
    path = os.path.abspath(path)
    steps = _steps(path)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoint steps under {path}")
        step = steps[-1]
    elif int(step) not in steps:
        raise FileNotFoundError(f"no checkpoint step {step} under {path}")
    state = torch.load(os.path.join(path, str(int(step)), _STATE),
                       map_location="cpu", weights_only=True)
    like = _fields(params_like)
    saved = state["params"]
    if set(saved) != set(like):
        raise ValueError(f"checkpoint fields {sorted(saved)} are not "
                         f"params_like's {sorted(like)}")
    for k, v in like.items():
        if saved[k].shape != v.shape or saved[k].dtype != v.dtype:
            raise ValueError(f"{k}: saved {tuple(saved[k].shape)} "
                             f"{saved[k].dtype}, params_like "
                             f"{tuple(v.shape)} {v.dtype}")
    moved = {k: saved[k].to(v.device) for k, v in like.items()}
    if hasattr(params_like, "_replace"):
        params = params_like._replace(**moved)
    else:
        params = type(params_like)(moved)
    opt = state["opt_state"] if opt_state_like is not None else None
    return int(state["step"]), params, opt
