"""Render configuration.

Counterpart of pathtracer_tpu.config: the same RenderConfig fields and
defaults, so a configuration means the same render in both packages
(reference: cmd/configuration.go:5-32, cmd/pt/main.go:48-56).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration.

    Mirrors the reference CLI flags --width --height --samples --aperture
    --focal-length (cmd/pt/main.go:48-56) plus the JAX package's knobs.
    Fields that select parts this package has not ported yet (dtype
    float64, the wavefront backend, debug_ray) are kept so configs stay
    interchangeable; the driver refuses them with a message.
    """

    width: int = 640
    height: int = 480
    samples: int = 1
    aperture: float = 0.0
    focal_length: float = 0.0

    # The megakernel computes in float32; "float64" selects the wavefront
    # path, which is not ported yet (ROADMAP queue 1, item 12).
    dtype: str = "float32"
    # Reference EPSILON=1e-4 (tracer.cl:4); works in f32 at unit scale.
    epsilon: float = 1e-4
    # Bounce budget (tracer.cl:2-3).
    max_bounces: int = 10
    max_effective_bounces: int = 4
    # Intersections beyond this distance are ignored (tracer.cl:728).
    t_max: float = 1024.0
    # The sample loop runs in chunks of this many samples.
    samples_per_pass: int = 8
    # Rows per call of the wavefront path (memory chunking); the megakernel
    # ignores it, as in the JAX package.
    rows_per_pass: int = 0
    # Base seed of the counter-hash random stream.
    seed: int = 0
    # Kept for interchangeability with the JAX config (its differentiable
    # wavefront path sets it False); the megakernel always exits early.
    early_exit: bool = True
    # "auto" and "pallas" run the megakernel; "wavefront" is not ported yet.
    backend: str = "auto"
    # Differentiable texture sampling (not ported yet).
    trainable_textures: bool = False
    # Next-event estimation in the megakernel: one shadow ray per light at
    # each bounce that hits a surface neither refracting nor a light (the
    # reference's experimental estimator, tracer.cl:786-829).
    nee: bool = False
    # Per-ray debug probe of the wavefront path (not ported yet).
    debug_ray: int = -1

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
