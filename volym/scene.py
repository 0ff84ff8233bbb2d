"""Scene: the pytree of render inputs.

Analog of the reference's "extra bind group" (volume + transfer
function + importance textures wired together in
``src/demos/simple/mod.rs:36-110``).  Bind groups become a pytree of arrays;
"uploading" is just passing the pytree to a jitted function.  All three
members are differentiable parameters for the inverse-rendering mode
(BASELINE.json config 4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from volym import assets
from volym.transfer_function import TransferFunction


@dataclass
class Scene:
    """Render inputs.

    Attributes:
      volume:     (D, H, W) float32 densities in [0, 1] — analog of the
                  r8unorm 3D texture (``src/gpu_resources/volume.rs``).
      importance: (D, H, W) float32 in [0, 1] — analog of the importance
                  texture (``src/demos/simple/importance.rs``).
      tf_lut:     (N, 4) float32 RGBA LUT — analog of the 1D TF texture
                  (``src/gpu_resources/transfer_function.rs``).
    """

    volume: Any
    importance: Any
    tf_lut: Any

    def tree_flatten(self):
        return (self.volume, self.importance, self.tf_lut), None

    @classmethod
    def tree_unflatten(cls, _aux, children):
        return cls(*children)

    # ------------------------------------------------------------------
    @classmethod
    def from_uint8(
        cls,
        volume_u8: np.ndarray,
        importance_u8: np.ndarray | None = None,
        tf: TransferFunction | None = None,
    ) -> "Scene":
        vol = assets.normalize_volume(volume_u8)
        imp = (
            assets.normalize_volume(importance_u8)
            if importance_u8 is not None
            else np.zeros_like(vol)
        )
        lut = (tf or TransferFunction.default()).build_lut()
        return cls(volume=jnp.asarray(vol), importance=jnp.asarray(imp), tf_lut=jnp.asarray(lut))

    @classmethod
    def load(
        cls,
        volume_path,
        segments_raw_path=None,
        segments_json_path=None,
        flip: bool = True,
        side: int = assets.VOLUME_SIDE,
        tf: TransferFunction | None = None,
    ) -> "Scene":
        """File-based construction mirroring ``Simple::init``
        (``src/demos/simple/mod.rs:36-110``)."""
        vol = assets.load_raw_volume(volume_path, flip=flip, side=side)
        imp = None
        if segments_raw_path is not None and segments_json_path is not None:
            imp, _hist = assets.load_importance_volume(
                segments_raw_path, segments_json_path, flip=flip, side=side
            )
        return cls.from_uint8(vol, imp, tf)

    @classmethod
    def synthetic(cls, kind: str = "bonsai", side: int = 256, seed: int = 0) -> "Scene":
        if kind == "bonsai":
            return cls.from_uint8(assets.synthetic_bonsai(side, seed))
        if kind == "sphere":
            return cls.from_uint8(assets.synthetic_sphere(side))
        if kind == "teapot":
            vol, labels, infos = assets.synthetic_teapot_segments(side)
            imp = assets.map_segments_to_importance(labels, infos)
            return cls.from_uint8(vol, imp)
        raise ValueError(f"unknown synthetic scene kind: {kind}")


jax.tree_util.register_pytree_node(Scene, Scene.tree_flatten, Scene.tree_unflatten)
