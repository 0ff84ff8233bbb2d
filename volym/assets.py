"""Volume / segment asset loading and synthetic test volumes.

Analog of the reference's asset layer:

- raw uint8 volume load + pad/truncate to 256^3 + Y flip
  (``src/gpu_resources/volume.rs:35-101``, ``src/gpu_resources/mod.rs:70-88``)
- segments.raw + segments.json -> per-voxel importance grid
  (``src/demos/simple/importance.rs:45-158``)
- NRRD splitter (``volym_devtools/src/main.rs:15-95``) lives in
  :mod:`volym.devtools`.

The byte-crunching hot paths (pad/flip/label-map) are delegated to the native
C++ library :mod:`volym.native` when built, with vectorised NumPy
fallbacks (the reference's host components are native Rust; ours are C++).

Array convention: raw bytes with ``bytes_per_row=W, rows_per_image=H`` map
byte ``z*H*W + y*W + x`` to texel ``(x, y, z)`` — i.e. a C-order
``(D, H, W)`` array indexed ``vol[z, y, x]``.  Shader-space positions stay
``(x, y, z)`` like WGSL.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

VOLUME_SIDE = 256  # reference pads everything to 256^3 (volume.rs:41-60)


@dataclass(frozen=True)
class SegmentInfo:
    """Reference ``SegmentInfo`` (``src/demos/simple/importance.rs:13-20``)."""

    id: str
    name: str
    index: int
    label_value: int
    importance: int


def load_segment_infos(path) -> list[SegmentInfo]:
    with open(path) as f:
        raw = json.load(f)
    return [
        SegmentInfo(
            id=s["id"],
            name=s["name"],
            index=int(s["index"]),
            label_value=int(s["label_value"]),
            importance=int(s["importance"]),
        )
        for s in raw
    ]


def pad_to_cube(data: np.ndarray, side: int = VOLUME_SIDE) -> np.ndarray:
    """Pad with zeros / truncate the flat byte stream to ``side^3``
    (reference ``volume.rs:41-60``)."""
    data = np.asarray(data, dtype=np.uint8).ravel()
    want = side**3
    if data.size < want:
        data = np.concatenate([data, np.zeros(want - data.size, np.uint8)])
    else:
        data = data[:want]
    return data.reshape(side, side, side)  # (D=z, H=y, W=x)


def flip_y(vol: np.ndarray) -> np.ndarray:
    """Y flip of a (D, H, W) grid (reference ``flip_3d_texture_y``,
    ``src/gpu_resources/mod.rs:70-82``)."""
    return vol[:, ::-1, :].copy()


def load_raw_volume(path, flip: bool = True, side: int = VOLUME_SIDE) -> np.ndarray:
    """uint8 raw file -> (side, side, side) uint8 grid, optionally Y-flipped
    (reference ``GpuVolume::init``, ``volume.rs:35-101``; the Simple demo
    always uses ``FlipMode::Y``, ``src/demos/simple/mod.rs:45``)."""
    from volym import native

    if native.available():
        return native.load_volume(str(path), flip, side)
    data = np.fromfile(path, dtype=np.uint8)
    vol = pad_to_cube(data, side)
    return flip_y(vol) if flip else vol


def map_segments_to_importance(labels: np.ndarray, infos: list[SegmentInfo]) -> np.ndarray:
    """label byte -> importance byte; unknown labels -> 0
    (reference ``map_segments_to_importance``, ``importance.rs:148-158``).
    Vectorised as a 256-entry label LUT instead of a linear scan per voxel."""
    lut = np.zeros(256, dtype=np.uint8)
    for info in infos:
        lut[info.label_value] = info.importance
    return lut[labels]


def load_importance_volume(
    data_path, info_path, flip: bool = True, side: int = VOLUME_SIDE
) -> tuple[np.ndarray, dict[int, int]]:
    """segments.raw + segments.json -> (side^3 importance grid, histogram)
    (reference ``GpuImportances::init``, ``importance.rs:45-137``).

    Matches the reference's order of operations: map labels->importance
    first, then pad/truncate, then flip.  Returns the per-*importance-id*
    voxel histogram the reference logs at ``importance.rs:83-91``.
    """
    from volym import native

    infos = load_segment_infos(info_path)
    if native.available():
        lut = np.zeros(256, dtype=np.uint8)
        for info in infos:
            lut[info.label_value] = info.importance
        grid = native.load_importance(str(data_path), lut, flip, side)
    else:
        labels = np.fromfile(data_path, dtype=np.uint8)
        mapped = map_segments_to_importance(labels, infos)
        grid = pad_to_cube(mapped, side)
        if flip:
            grid = flip_y(grid)
    ids, counts = np.unique(grid, return_counts=True)
    histogram = {int(i): int(c) for i, c in zip(ids, counts) if c > 0}
    return grid, histogram


def normalize_volume(vol_u8: np.ndarray) -> np.ndarray:
    """uint8 grid -> float32 in [0, 1] (r8unorm texture semantics)."""
    return vol_u8.astype(np.float32) / 255.0


# ----------------------------------------------------------------------
# Synthetic volumes.  The reference's large .raw blobs are stripped from the
# mount (``/root/reference/.MISSING_LARGE_BLOBS``), so tests and benchmarks
# run on procedurally generated stand-ins with matched shapes/statistics.
# ----------------------------------------------------------------------


def synthetic_sphere(side: int = 64, radius: float = 0.35, soft: float = 0.05) -> np.ndarray:
    """Soft-edged sphere: uint8 density grid with analytic structure for
    golden-image tests (SURVEY.md section 4 item 5)."""
    c = (np.arange(side, dtype=np.float32) + 0.5) / side - 0.5
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    d = np.clip((radius - r) / soft + 0.5, 0.0, 1.0)
    return (d * 255).astype(np.uint8)


def synthetic_bonsai(side: int = 256, seed: int = 0) -> np.ndarray:
    """Bonsai-256^3 stand-in: a trunk + blobby canopy + ground plane with
    noise, tuned to have a similar occupancy profile to CT volumes
    (~20-30%% of voxels above the 0.15 benchmark threshold)."""
    rng = np.random.default_rng(seed)
    c = (np.arange(side, dtype=np.float32) + 0.5) / side
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    d = np.zeros((side, side, side), np.float32)
    # ground plane
    d += np.clip((0.08 - y) * 20.0, 0.0, 0.6)
    # trunk: vertical cone
    rt = np.sqrt((x - 0.5) ** 2 + (z - 0.5) ** 2)
    d += np.clip((0.06 * (1.2 - y) - rt) * 30.0, 0.0, 0.9) * (y < 0.55)
    # canopy: union of random blobs
    for _ in range(24):
        cx, cy, cz = rng.uniform(0.3, 0.7), rng.uniform(0.45, 0.8), rng.uniform(0.3, 0.7)
        rad = rng.uniform(0.05, 0.14)
        rr = np.sqrt((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2)
        d += np.clip((rad - rr) / 0.04, 0.0, 1.0) * 0.5
    # low-amplitude noise so thresholds are exercised
    d += rng.uniform(0.0, 0.05, size=d.shape).astype(np.float32)
    return (np.clip(d, 0.0, 1.0) * 255).astype(np.uint8)


def synthetic_teapot_segments(
    side: int = 64,
) -> tuple[np.ndarray, np.ndarray, list[SegmentInfo]]:
    """Teapot-like stand-in with a 3-segment label field mirroring the shipped
    ``boston_teapot_256x256x178_uint8_segments.json`` (Cup importance 0,
    Ground importance 0, Lobster importance 255)."""
    c = (np.arange(side, dtype=np.float32) + 0.5) / side
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    labels = np.zeros((side, side, side), np.uint8)
    density = np.zeros((side, side, side), np.float32)

    ground = y < 0.12
    labels[ground] = 4
    density += ground * 0.5

    # "cup": hollow sphere shell
    r = np.sqrt((x - 0.45) ** 2 + (y - 0.45) ** 2 + (z - 0.5) ** 2)
    cup = (r > 0.18) & (r < 0.28)
    labels[cup] = 3
    density += cup * 0.7

    # "lobster": small dense blob inside (the importance-255 segment)
    r2 = np.sqrt((x - 0.45) ** 2 + (y - 0.42) ** 2 + (z - 0.5) ** 2)
    lobster = r2 < 0.1
    labels[lobster] = 2
    density = np.where(lobster, 0.95, density)

    infos = [
        SegmentInfo("Segment_4", "Cup", 1, 3, 0),
        SegmentInfo("Segment_5", "Ground", 2, 4, 0),
        SegmentInfo("Segment_2", "Lobster", 0, 2, 255),
    ]
    vol = (np.clip(density, 0, 1) * 255).astype(np.uint8)
    return vol, labels, infos
