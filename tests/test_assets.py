"""Asset pipeline tests (reference volume.rs / importance.rs / mod.rs)."""

import json
from pathlib import Path

import numpy as np

from volym import assets


def _rust_flip_3d_texture_y(data, dims):
    """Literal transcription of flip_3d_texture_y (src/gpu_resources/mod.rs:70-82)."""
    x, y, z = dims
    data = data.copy()
    for k in range(z):
        for j in range(y // 2):
            top = k * x * y + j * x
            bot = k * x * y + (y - j - 1) * x
            tmp = data[top : top + x].copy()
            data[top : top + x] = data[bot : bot + x]
            data[bot : bot + x] = tmp
    return data


def test_flip_y_matches_rust(rng):
    side = 8
    flat = rng.integers(0, 256, side**3).astype(np.uint8)
    expect = _rust_flip_3d_texture_y(flat, (side, side, side)).reshape(side, side, side)
    got = assets.flip_y(flat.reshape(side, side, side))
    np.testing.assert_array_equal(got, expect)


def test_pad_to_cube_pads_and_truncates():
    short = np.arange(10, dtype=np.uint8)
    v = assets.pad_to_cube(short, side=4)
    assert v.shape == (4, 4, 4)
    assert v.ravel()[:10].tolist() == list(range(10))
    assert (v.ravel()[10:] == 0).all()
    long = np.arange(100, dtype=np.uint8)
    v = assets.pad_to_cube(long, side=4)
    assert v.size == 64 and v.ravel()[-1] == 63


def test_load_raw_volume_roundtrip(tmp_path, rng):
    data = rng.integers(0, 256, 6 * 8 * 8).astype(np.uint8)  # short volume like teapot z=178
    p = tmp_path / "vol.raw"
    data.tofile(p)
    vol = assets.load_raw_volume(p, flip=False, side=8)
    assert vol.shape == (8, 8, 8)
    np.testing.assert_array_equal(vol.ravel()[: data.size], data)
    flipped = assets.load_raw_volume(p, flip=True, side=8)
    np.testing.assert_array_equal(flipped, assets.flip_y(vol))


def test_map_segments_matches_rust_scan(rng):
    # importance.rs:148-158: per-voxel linear scan over segment infos.
    infos = [
        assets.SegmentInfo("a", "Cup", 1, 3, 0),
        assets.SegmentInfo("b", "Ground", 2, 4, 10),
        assets.SegmentInfo("c", "Lobster", 0, 2, 255),
    ]
    labels = rng.integers(0, 6, 1000).astype(np.uint8)
    got = assets.map_segments_to_importance(labels, infos)
    expect = np.array(
        [next((i.importance for i in infos if i.label_value == l), 0) for l in labels],
        np.uint8,
    )
    np.testing.assert_array_equal(got, expect)


def test_load_importance_volume(tmp_path):
    vol, labels, infos = assets.synthetic_teapot_segments(side=8)
    raw = tmp_path / "seg.raw"
    labels.tofile(raw)
    info = tmp_path / "seg.json"
    info.write_text(json.dumps([i.__dict__ for i in infos]))
    grid, hist = assets.load_importance_volume(raw, info, flip=False, side=8)
    assert grid.shape == (8, 8, 8)
    assert set(np.unique(grid)) <= {0, 255}
    assert sum(hist.values()) == 8**3


def test_segment_json_parses_reference_asset():
    # the three segments of the reference's teapot asset that matter here
    # (Cup 0, Ground label 4, Lobster 255; SURVEY.md section 2 row 24)
    infos = assets.load_segment_infos(
        Path(__file__).parent / "fixtures" / "teapot_segments.json"
    )
    by_name = {i.name: i for i in infos}
    assert by_name["Lobster"].importance == 255
    assert by_name["Cup"].importance == 0
    assert by_name["Ground"].label_value == 4


def test_synthetic_volumes_shapes():
    assert assets.synthetic_sphere(16).shape == (16, 16, 16)
    b = assets.synthetic_bonsai(32)
    assert b.shape == (32, 32, 32)
    occ = (b.astype(np.float32) / 255.0 >= 0.15).mean()
    assert 0.05 < occ < 0.6  # plausible CT-like occupancy
