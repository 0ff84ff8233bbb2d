"""Render parameter configuration.

Analog of the reference's three-tier parameter system
(``src/state.rs:28-55`` StateParameters defaults, ``src/cli.rs`` CLI flags,
``src/gpu_resources/parameters.rs:55-83`` GPU uniform mirror).  Here a single
frozen dataclass is the whole story: parameters are hashable static config for
``jax.jit`` (bools/ints select traced branches at compile time) while the
*float* knobs that we want to sweep without recompiling travel as a small
jnp array (see :meth:`RenderParams.dynamic`).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass

import jax.numpy as jnp


class Interpolation(str, enum.Enum):
    """Volume sampling filter.

    The reference samples the density volume with wgpu's *default* sampler,
    which is nearest-neighbour (``src/gpu_resources/volume.rs:96-99`` uses
    ``SamplerDescriptor::default()``), and the importance volume with an
    explicit nearest sampler (``src/demos/simple/importance.rs:122-131``).
    ``TRILINEAR`` is the differentiable upgrade demanded by BASELINE.json
    config 2 (camera gradients require a filter that is continuous in the
    sample position).
    """

    NEAREST = "nearest"
    TRILINEAR = "trilinear"


@dataclass(frozen=True)
class RenderParams:
    """All tunable render parameters.

    Field-for-field superset of the reference's ``StateParameters``
    (``src/state.rs:28-55``; canonical names from the GPU uniform block
    ``src/gpu_resources/parameters.rs:57-66``).  Defaults match
    ``StateParameters::default()`` (``src/state.rs:41-55``).
    """

    density_threshold: float = 0.12
    use_cone_importance_check: bool = False
    use_importance_coloring: bool = False
    use_opacity: bool = True
    use_importance_rendering: bool = False
    use_gaussian_smoothing: bool = True
    importance_check_ahead_steps: int = 12
    raymarching_step_size: float = 0.010

    # --- extensions (no reference counterpart) ---
    interpolation: Interpolation = Interpolation.NEAREST
    #: Adaptive stepping (reference ``wgsl:243-269``): quarter step inside
    #: dense regions, x1.5 recovery.  Forward-only optimisation; the
    #: differentiable path uses fixed steps (SURVEY.md section 7).
    adaptive_stepping: bool = True
    #: Front-to-back early-out threshold (reference ``wgsl:250``).
    early_termination_alpha: float = 0.95
    #: Static upper bound on march iterations.  ``None`` derives the worst
    #: case from the step size (diagonal of the unit box / min step).
    max_steps: int | None = None
    #: Use Blinn-Phong shading (always on in the reference kernel
    #: ``wgsl:306-311``; toggleable here because the differentiable
    #: inverse-rendering objective usually wants the unshaded integral).
    use_shading: bool = True
    #: Subtexel precision of the slab-path VOLUME samplers, in fractional
    #: bits of the sample coordinate.  GPU texture units filter at
    #: fixed-point subtexel precision (D3D mandates exactly 8 fractional
    #: bits; Vulkan >= 4), so 8 reproduces what the reference's wgpu
    #: sampler actually computes.  The slab forward and its replay VJP
    #: quantize identically (straight-through for gradients) from the
    #: shared affine coordinates (``slab.ray_affine``).  The 1D TF
    #: coordinate is not snapped.  0 = full-f32 sample coordinates.  The
    #: t-step renderers ignore this (they keep f32 coordinates).
    subtexel_bits: int = 8

    def __post_init__(self):
        if not isinstance(self.interpolation, Interpolation):
            object.__setattr__(self, "interpolation", Interpolation(self.interpolation))
        if not 0 <= int(self.subtexel_bits) <= 8:
            # the snap (slab.snap) is exact in f32 only while
            # coord * 2^bits < 2^24, and 8 bits is the texture-unit
            # precision it models
            raise ValueError(
                f"subtexel_bits must be in [0, 8], got {self.subtexel_bits}"
            )

    # ------------------------------------------------------------------
    @property
    def min_step_size(self) -> float:
        """Reference ``wgsl:244``: min step is a quarter of the base step."""
        return self.raymarching_step_size * 0.25

    def resolved_max_steps(self) -> int:
        """Worst-case march iterations through the unit box.

        Every iteration advances ``t`` by at least the minimum step size
        (adaptive) or the base step (fixed), so the diagonal sqrt(3) bounds
        the trip count.
        """
        if self.max_steps is not None:
            return int(self.max_steps)
        step = self.min_step_size if self.adaptive_stepping else self.raymarching_step_size
        return int(math.sqrt(3.0) / step) + 2

    # ------------------------------------------------------------------
    # Split into jit-static and traced parts so float sweeps don't recompile.
    DYNAMIC_FIELDS = (
        "density_threshold",
        "raymarching_step_size",
        "early_termination_alpha",
        "importance_check_ahead_steps",
    )

    def dynamic(self) -> jnp.ndarray:
        """The float knobs as a traced vector (uniform-buffer analog)."""
        return jnp.array(
            [float(getattr(self, f)) for f in self.DYNAMIC_FIELDS],
            dtype=jnp.float32,
        )

    def split_dynamic(self) -> tuple["RenderParams", jnp.ndarray]:
        """(jit-static params, traced knob vector) — the per-frame uniform
        update (``src/gpu_resources/parameters.rs:68-83``): every float the
        reference GUI mutates live travels traced, so threshold / step-size
        / early-alpha / ahead-steps sweeps reuse ONE compilation per flag
        combination.  The static copy zeroes those fields; code holding it
        must take the values from the vector (``resolved_max_steps`` is not
        meaningful on the static copy unless ``max_steps`` is set)."""
        if self.importance_check_ahead_steps > 25:
            # the traced look-ahead probes a static 25-iteration cap
            # (render/golden.py AHEAD_CAP — the reference GUI slider max,
            # src/gui.rs:239) and masks unused probes; a larger traced
            # value would silently probe only the first 25/K of the range
            raise ValueError(
                "importance_check_ahead_steps > 25 cannot travel as a "
                "traced knob (AHEAD_CAP); use the static-params renderers"
            )
        static = self.replace(
            density_threshold=0.0,
            raymarching_step_size=0.0,
            early_termination_alpha=0.0,
            importance_check_ahead_steps=0,
        )
        return static, self.dynamic()

    def replace(self, **kw) -> "RenderParams":
        return dataclasses.replace(self, **kw)

    def slab_static(self) -> "RenderParams":
        """Canonical jit key for the slab renderers: fields the slab march
        never reads (t-step size, probe count, adaptive stepping, max
        steps) are zeroed so parameter sweeps over them reuse one
        compilation."""
        return self.replace(
            raymarching_step_size=0.0,
            importance_check_ahead_steps=0,
            adaptive_stepping=False,
            max_steps=None,
        )


#: Benchmark parameter preset (reference ``src/main.rs:180-190``).
BENCHMARK_PARAMS = RenderParams(
    density_threshold=0.15,
    use_opacity=True,
    use_cone_importance_check=False,
    use_importance_coloring=False,
    use_importance_rendering=False,
    use_gaussian_smoothing=False,
    importance_check_ahead_steps=15,
    raymarching_step_size=0.020,
)
