"""volym — a differentiable importance-driven volume renderer in JAX.

A from-scratch JAX / shard_map framework with the capabilities of the
reference interactive renderer (druskus20/volym, Rust + WGSL): functional
core, static-shape masked marching, a slab-ordered march for the hot
forward/backward path, and ray-sharded multi-device rendering with
overlapped gradient reduction.  See SURVEY.md for the layer map and the
reference file:line citations used throughout the docstrings.
"""

from volym.camera import Camera, CameraController, camera_matrices
from volym.config import BENCHMARK_PARAMS, Interpolation, RenderParams
from volym.scene import Scene
from volym.transfer_function import ControlPoint, TransferFunction

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "CameraController",
    "camera_matrices",
    "RenderParams",
    "BENCHMARK_PARAMS",
    "Interpolation",
    "Scene",
    "TransferFunction",
    "ControlPoint",
    "__version__",
]
