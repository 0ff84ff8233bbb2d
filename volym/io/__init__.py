"""Image and checkpoint IO.

Analog of the reference's pixel-readback paths: screenshot-to-PNG
(``src/state.rs:161-220``) and TF-to-PNG (``src/transfer_function.rs:146-159``).
The device->host boundary is just ``jax.device_get`` (SURVEY.md 3d).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np


def to_uint8_image(img) -> np.ndarray:
    """(H, W, 4) float image -> uint8 RGBA, with the clamp+quantise the
    rgba8unorm output texture applies on ``textureStore`` (``wgsl:328``)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path, img) -> None:
    """Write an (H, W, 3|4) array as PNG."""
    from PIL import Image

    arr = to_uint8_image(img)
    if arr.ndim == 2:
        mode = "L"
    elif arr.shape[-1] == 4:
        mode = "RGBA"
    else:
        mode = "RGB"
    Image.fromarray(arr, mode=mode).save(str(path))


def save_screenshot(img, directory=".") -> Path:
    """Timestamped screenshot like the reference's P-key handler
    (``src/state.rs:94-112`` -> ``screenshot_{unix_ts}.png``)."""
    path = Path(directory) / f"screenshot_{int(time.time())}.png"
    write_png(path, np.asarray(img))
    return path


def save_checkpoint(path, params: dict) -> None:
    """Persist optimised scene parameters (voxels / TF / camera).

    The reference has no checkpointing (SURVEY.md section 5); this is the
    minimal np.savez equivalent for the differentiable mode."""
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def load_checkpoint(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
