"""Transfer function: control points -> RGBA lookup table.

Analog of the reference's host TF (``src/transfer_function.rs``)
and its GPU bake (``src/gpu_resources/transfer_function.rs:31-107``).  The
reference builds the 256-entry LUT with per-element Rust loops; here the bake
is vectorised ``np.interp`` (identical piecewise-linear semantics: the Rust
loop interpolates with ``k = (x-start)/(end-start)`` over integer index
windows ``src/transfer_function.rs:80-125``, which is exactly linear
interpolation between integer grid points).

The LUT itself is the differentiable parameter: BASELINE.json requires
dL/dTF, so :func:`lut_sample` is written in jnp and the LUT rides the render
as a (N, 4) float array.  The reference's 8-bit quantisation on upload
(``transfer_function.rs GPU bake: (v*255) as u8``) is reproduced by
:func:`quantize_lut` for bit-parity experiments but not applied by default.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class ControlPoint:
    """Reference ``TransferControlPoint`` (``src/transfer_function.rs:5-9``)."""

    color: tuple[float, float, float, float]
    iso_value: float


@dataclass
class TransferFunction:
    """Separate RGB and alpha control point tracks over density in [0, 1]
    (reference ``src/transfer_function.rs:11-17``)."""

    max_density: int = 255
    rgb_points: list[ControlPoint] = field(default_factory=list)
    alpha_points: list[ControlPoint] = field(default_factory=list)

    # -- construction --------------------------------------------------
    @classmethod
    def default(cls) -> "TransferFunction":
        """Default green->cyan->yellow->magenta->red ramp, alpha 0->1 linear
        (reference ``src/transfer_function.rs:19-56``)."""
        tf = cls()
        tf.add_rgb(ControlPoint((0.0, 1.0, 0.0, 1.0), 0.0))
        tf.add_rgb(ControlPoint((0.0, 1.0, 1.0, 1.0), 0.2))
        tf.add_rgb(ControlPoint((1.0, 1.0, 0.0, 1.0), 0.4))
        tf.add_rgb(ControlPoint((1.0, 0.0, 1.0, 1.0), 0.6))
        tf.add_rgb(ControlPoint((1.0, 0.0, 0.0, 1.0), 1.0))
        tf.add_alpha(ControlPoint((0.0, 0.0, 0.0, 0.0), 0.0))
        tf.add_alpha(ControlPoint((0.0, 0.0, 0.0, 1.0), 1.0))
        return tf

    def add_rgb(self, p: ControlPoint) -> None:
        self.rgb_points.append(p)
        self.rgb_points.sort(key=lambda q: q.iso_value)

    def add_alpha(self, p: ControlPoint) -> None:
        self.alpha_points.append(p)
        self.alpha_points.sort(key=lambda q: q.iso_value)

    # -- LUT bake (reference build_linear, src/transfer_function.rs:80-125)
    def build_lut(self) -> np.ndarray:
        """(max_density+1, 4) float32 LUT.

        Control-point iso values are snapped to integer LUT indices with
        truncation, matching ``(iso_value * max_density) as u32``.
        Regions outside the control-point span keep their initial zeros,
        matching the Rust initialisation (``src/transfer_function.rs:64``).
        """
        n = self.max_density + 1
        lut = np.zeros((n, 4), dtype=np.float32)
        x = np.arange(n, dtype=np.float32)
        if len(self.rgb_points) >= 2:
            xp = np.array(
                [int(p.iso_value * self.max_density) for p in self.rgb_points], np.float32
            )
            lo, hi = int(xp[0]), int(xp[-1])
            sel = slice(lo, hi + 1)
            for c in range(3):
                fp = np.array([p.color[c] for p in self.rgb_points], np.float32)
                lut[sel, c] = np.interp(x[sel], xp, fp)
        if len(self.alpha_points) >= 2:
            xp = np.array(
                [int(p.iso_value * self.max_density) for p in self.alpha_points], np.float32
            )
            lo, hi = int(xp[0]), int(xp[-1])
            sel = slice(lo, hi + 1)
            fp = np.array([p.color[3] for p in self.alpha_points], np.float32)
            lut[sel, 3] = np.interp(x[sel], xp, fp)
        return lut

    def get(self, value: float) -> np.ndarray:
        """Host-side LUT lookup with linear interpolation
        (reference ``src/transfer_function.rs:127-144``)."""
        lut = self.build_lut()
        idx = np.clip(value * self.max_density, 0.0, float(self.max_density))
        i0 = int(np.floor(idx))
        i1 = min(i0 + 1, self.max_density)
        t = idx - i0
        return lut[i0] * (1.0 - t) + lut[i1] * t


def quantize_lut(lut: np.ndarray) -> np.ndarray:
    """8-bit quantisation as done on GPU upload: truncate ``v*255`` to u8
    (``src/gpu_resources/transfer_function.rs:60-69``), back to float."""
    return (np.clip(lut * 255.0, 0, 255).astype(np.uint8)).astype(np.float32) / 255.0


def lut_sample(lut, density):
    """Differentiable 1D-texture sample with linear filtering and
    clamp-to-edge addressing.

    Replicates ``textureSampleLevel(transfer_function_texture, ..., density)``
    (``wgsl:297-303``) with the linear sampler from
    ``src/gpu_resources/transfer_function.rs:96-106``: texel centres at
    ``(i + 0.5)/N``, so the sample coordinate maps to ``density*N - 0.5``.

    Args:
      lut: (N, 4) float array — the traced, differentiable TF parameter.
      density: (...,) densities in [0, 1].
    Returns:
      (..., 4) RGBA.
    """
    n = lut.shape[0]
    c = density * n - 0.5
    i0 = jnp.clip(jnp.floor(c), 0, n - 1).astype(jnp.int32)
    i1 = jnp.clip(i0 + 1, 0, n - 1)
    t = jnp.clip(c - i0, 0.0, 1.0)[..., None]
    return lut[i0] * (1.0 - t) + lut[i1] * t


def corrected_alpha(a, exponent):
    """Step-size opacity correction ``1 - (1 - a)^exponent`` (``wgsl:314``,
    exponent = step length x 100).

    An opaque sample (``a >= 1``) gives exactly 1 with a zero derivative.
    There the true derivative is infinite for exponents below 1 (steps
    under 0.01 in t), and it would turn every gradient through that
    sample into inf or NaN; the forward value is unchanged."""
    opaque = a >= 1.0
    base = jnp.where(opaque, 1.0, 1.0 - a)
    return jnp.where(opaque, 1.0, 1.0 - jnp.power(base, exponent))


def save_png(tf: TransferFunction, path) -> None:
    """Save the LUT as a 1-pixel-tall PNG strip
    (reference ``src/transfer_function.rs:146-159``)."""
    from volym.io import write_png

    lut = tf.build_lut()
    # Reference samples get(x / max_density) per pixel == the LUT rows.
    img = (np.clip(lut, 0, 1) * 255.0).astype(np.uint8)[None, :, :]
    write_png(path, img)
