"""Benchmark harness: the reference protocol, plus rays/s and scaling.

Replicates the reference's sweep exactly (``src/main.rs:178-345``): base
parameters from the benchmark preset (``src/main.rs:180-190``), step sizes
{0.003, 0.005, 0.010, 0.020}, look-ahead steps {10, 15, 20}, algorithms
{Base, Importance, ImportanceCone}, 3 trials x 2 s each, mean/stddev stats
(``TrialResults::calculate_stats``, ``src/main.rs:111-175``) and the same
CSV schema (``BenchmarkResult``, ``src/main.rs:71-85``).

Additions: rays/s (frames x H x W / s), forward+backward timing for the
differentiable mode, and multi-device scaling efficiency.
"""

from __future__ import annotations

import csv
import dataclasses
import time
from dataclasses import dataclass, field

import jax
import numpy as np

from volym.config import BENCHMARK_PARAMS, RenderParams

#: Reference sweep constants (src/main.rs:179,192-193; :66 secs; :357 window).
NUM_TRIALS = 3
SECS_PER_TRIAL = 2.0
STEP_SIZES = (0.0030, 0.0050, 0.0100, 0.0200)
IMPORTANCE_STEPS = (10, 15, 20)
BENCH_WIDTH, BENCH_HEIGHT = 1024, 768


@dataclass
class TrialResults:
    """Accumulates per-trial (frames, seconds) and computes the reference's
    stats tuple (``src/main.rs:87-176``)."""

    total_frames: list[int] = field(default_factory=list)
    total_times_ms: list[float] = field(default_factory=list)
    frame_times_ms: list[float] = field(default_factory=list)
    fps_values: list[float] = field(default_factory=list)

    def add_trial(self, frames: int, seconds: float) -> None:
        self.total_frames.append(frames)
        self.total_times_ms.append(seconds * 1000.0)
        self.frame_times_ms.append(seconds * 1000.0 / frames)
        self.fps_values.append(frames / seconds)

    def stats(self) -> dict:
        def mean(xs):
            return float(np.mean(xs))

        def std(xs):
            return float(np.std(xs))  # population std, like the reference

        return {
            "avg_total_frames": mean(self.total_frames),
            "avg_total_time_ms": mean(self.total_times_ms),
            "avg_frame_time_ms": mean(self.frame_times_ms),
            "avg_fps": mean(self.fps_values),
            "std_dev_total_frames": std(self.total_frames),
            "std_dev_total_time_ms": std(self.total_times_ms),
            "std_dev_frame_time_ms": std(self.frame_times_ms),
            "std_dev_fps": std(self.fps_values),
        }


CSV_FIELDS = [
    "algorithm",
    "step_size",
    "importance_steps",
    "use_cone",
    "avg_total_frames",
    "avg_total_time_ms",
    "avg_frame_time_ms",
    "avg_fps",
    "std_dev_total_frames",
    "std_dev_total_time_ms",
    "std_dev_frame_time_ms",
    "std_dev_fps",
]


def force_sync(out) -> None:
    """Block until every array in ``out`` is computed on the device.  JAX
    returns before the device finishes, so every timed region ends here;
    a leafless output (e.g. a side-effecting frame function returning
    None) is a no-op."""
    jax.block_until_ready(out)


def marginal_time(fn, *, iters: int = 25, warmup: int = 2) -> float:
    """Steady-state seconds per call of ``fn``: ``warmup`` fenced calls
    (compilation included), then ``iters`` calls dispatched back to back
    and fenced once at the end, which is how a production loop runs its
    steps."""
    for _ in range(warmup):
        force_sync(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn()
    force_sync(out)
    return (time.perf_counter() - t0) / iters


def run_trial(frame_fn, seconds: float = SECS_PER_TRIAL, warmup: int = 1):
    """Render ``frame_fn`` repeatedly for ``seconds``, each frame fenced
    (``force_sync``); returns (frames, elapsed) with every counted frame
    device-complete.  The analog of the reference's 2-second winit loop
    with a stop timer (``src/main.rs:347-384``); ``frame_fn`` returns the
    (possibly still in-flight) frame output."""
    for _ in range(warmup):
        force_sync(frame_fn())
    frames = 0
    start = time.perf_counter()
    while True:
        force_sync(frame_fn())
        frames += 1
        if time.perf_counter() - start >= seconds:
            return frames, time.perf_counter() - start


def bench_config(
    render,  # (params) -> blocking frame callable
    params: RenderParams,
    *,
    num_trials: int = NUM_TRIALS,
    seconds: float = SECS_PER_TRIAL,
) -> TrialResults:
    results = TrialResults()
    frame = render(params)
    for _ in range(num_trials):
        frames, dur = run_trial(frame, seconds=seconds)
        results.add_trial(frames, dur)
    return results


def benchmark_all(
    render,
    *,
    base_params: RenderParams = BENCHMARK_PARAMS,
    step_sizes=STEP_SIZES,
    importance_steps=IMPORTANCE_STEPS,
    num_trials: int = NUM_TRIALS,
    seconds: float = SECS_PER_TRIAL,
    height: int = BENCH_HEIGHT,
    width: int = BENCH_WIDTH,
    log=print,
) -> list[dict]:
    """The full reference sweep (``benchmark_all``, src/main.rs:178-345).

    ``render`` maps a RenderParams to a zero-arg blocking frame function.
    Returns CSV-schema rows, with rays/s appended.
    """
    rows = []

    def run(algorithm: str, params: RenderParams, imp_steps: int, use_cone: bool):
        log(f"benchmark {algorithm} step={params.raymarching_step_size} ahead={imp_steps}")
        tr = bench_config(render, params, num_trials=num_trials, seconds=seconds)
        stats = tr.stats()
        rows.append(
            {
                "algorithm": algorithm,
                "step_size": params.raymarching_step_size,
                "importance_steps": imp_steps,
                "use_cone": use_cone,
                **stats,
                "rays_per_s": stats["avg_fps"] * height * width,
            }
        )

    for step in step_sizes:
        run("Base", base_params.replace(raymarching_step_size=step), 0, False)
    for step in step_sizes:
        for ahead in importance_steps:
            run(
                "Importance",
                base_params.replace(
                    raymarching_step_size=step,
                    importance_check_ahead_steps=ahead,
                    use_importance_rendering=True,
                ),
                ahead,
                False,
            )
    for step in step_sizes:
        for ahead in importance_steps:
            run(
                "ImportanceCone",
                base_params.replace(
                    raymarching_step_size=step,
                    importance_check_ahead_steps=ahead,
                    use_importance_rendering=True,
                    use_cone_importance_check=True,
                ),
                ahead,
                True,
            )
    return rows


SCALING_CSV_FIELDS = [
    "devices",
    "avg_total_frames",
    "avg_total_time_ms",
    "avg_frame_time_ms",
    "avg_fps",
    "std_dev_total_frames",
    "std_dev_total_time_ms",
    "std_dev_frame_time_ms",
    "std_dev_fps",
    "rays_per_s",
    "scaling_efficiency",
]


def scaling_table(
    scene,
    camera_matrices,
    params: RenderParams,
    height: int,
    width: int,
    *,
    device_counts=None,
    backend: str = "ray",
    differentiable: bool = False,
    num_trials: int = NUM_TRIALS,
    seconds: float = SECS_PER_TRIAL,
    log=print,
) -> list[dict]:
    """rays/s vs device count (BASELINE scaling target), TrialResults stats.

    Runs the tile-sharded renderer on progressively larger sub-meshes of the
    available devices (virtual CPU devices count — the fixture SURVEY.md
    section 4 item 4 prescribes) and reports the per-row efficiency
    ``rays_per_s / (devices x rays_per_s_per_device_at_smallest)``.
    """
    from volym.parallel import mesh as pmesh

    devices = jax.devices()
    if device_counts is None:
        device_counts = [
            n for n in (1, 2, 4, 8, 16, 32, 64) if n <= len(devices)
        ]
    device_counts = [n for n in device_counts if (height * width) % n == 0]
    rows = []
    base_per_device = None
    for n in device_counts:
        mesh = pmesh.make_mesh(devices[:n])

        def frame():
            return pmesh.render_sharded(
                scene, camera_matrices, params, height, width, mesh,
                differentiable=differentiable, backend=backend,
            )

        tr = TrialResults()
        force_sync(frame())  # compile outside the timed region
        for _ in range(num_trials):
            frames, dur = run_trial(frame, seconds=seconds)
            tr.add_trial(frames, dur)
        stats = tr.stats()
        rate = stats["avg_fps"] * height * width
        if base_per_device is None:
            base_per_device = rate / n
        eff = rate / (base_per_device * n)
        rows.append(
            {
                "devices": n,
                **stats,
                "rays_per_s": rate,
                "scaling_efficiency": eff,
            }
        )
        log(
            f"scaling n={n}: {rate:,.0f} rays/s, efficiency {eff:.2f}, "
            f"fps {stats['avg_fps']:.2f} +- {stats['std_dev_fps']:.2f}"
        )
    return rows


def write_csv(rows: list[dict], path="benchmark_results.csv") -> None:
    """Reference CSV output (``src/main.rs:338-342``) + rays_per_s column."""
    if not rows:
        return
    fields = CSV_FIELDS + [k for k in rows[0] if k not in CSV_FIELDS]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)
