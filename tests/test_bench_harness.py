"""Benchmark harness tests (reference src/main.rs:71-345)."""

import csv

import numpy as np

from volym.bench import harness
from volym.config import BENCHMARK_PARAMS, RenderParams


def test_trial_stats_match_reference_formulas():
    tr = harness.TrialResults()
    tr.add_trial(100, 2.0)
    tr.add_trial(120, 2.0)
    tr.add_trial(110, 2.0)
    s = tr.stats()
    assert s["avg_total_frames"] == 110.0
    assert s["avg_fps"] == (50 + 60 + 55) / 3
    # population stddev, like the reference's calculate_stats
    np.testing.assert_allclose(s["std_dev_total_frames"], np.std([100, 120, 110]))
    np.testing.assert_allclose(s["avg_frame_time_ms"], np.mean([20.0, 2000 / 120, 2000 / 110]))


def test_benchmark_preset_matches_reference():
    # src/main.rs:180-190
    assert BENCHMARK_PARAMS.density_threshold == 0.15
    assert BENCHMARK_PARAMS.use_opacity is True
    assert BENCHMARK_PARAMS.use_gaussian_smoothing is False
    assert BENCHMARK_PARAMS.importance_check_ahead_steps == 15
    assert BENCHMARK_PARAMS.raymarching_step_size == 0.020
    assert harness.STEP_SIZES == (0.003, 0.005, 0.01, 0.02)
    assert harness.IMPORTANCE_STEPS == (10, 15, 20)


def test_sweep_shape_and_csv(tmp_path):
    calls = []

    def render_factory(params: RenderParams):
        calls.append(params)
        return lambda: None

    rows = harness.benchmark_all(
        render_factory,
        step_sizes=(0.01, 0.02),
        importance_steps=(5,),
        num_trials=2,
        seconds=0.01,
        height=4,
        width=4,
        log=lambda *a: None,
    )
    # 2 base + 2x1 importance + 2x1 cone = 6 configs (sweep of src/main.rs:192-335)
    assert len(rows) == 6
    assert [r["algorithm"] for r in rows] == [
        "Base", "Base", "Importance", "Importance", "ImportanceCone", "ImportanceCone",
    ]
    assert all(r["rays_per_s"] > 0 for r in rows)
    assert calls[2].use_importance_rendering and not calls[2].use_cone_importance_check
    assert calls[4].use_cone_importance_check

    out = tmp_path / "bench.csv"
    harness.write_csv(rows, out)
    with open(out) as f:
        got = list(csv.DictReader(f))
    assert len(got) == 6
    assert set(harness.CSV_FIELDS) <= set(got[0])


def test_run_trial_counts():
    n = {"count": 0}

    def frame():
        n["count"] += 1

    frames, dur = harness.run_trial(frame, seconds=0.05, warmup=1)
    assert frames >= 1
    assert n["count"] == frames + 1  # warmup excluded from count
    assert dur >= 0.05
