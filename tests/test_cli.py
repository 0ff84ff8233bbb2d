"""CLI argument-surface tests (reference src/cli.rs:35-56 analog)."""

from volym.cli import build_parser


def test_subcommands_exist():
    ap = build_parser()
    for cmd in ("run", "benchmark", "screenshot", "fit", "devtools"):
        args = ap.parse_args([cmd] if cmd != "devtools" else [cmd, "a", "b", "c"])
        assert args.command == cmd


def test_run_defaults_match_reference():
    # StateParameters defaults (src/state.rs:41-55)
    args = build_parser().parse_args(["run"])
    assert args.demo == "simple"
    assert args.threshold == 0.12
    assert args.step_size == 0.01
    assert args.ahead_steps == 12
    assert args.renderer == "ray"
    assert not args.no_shading
    assert args.gaussian  # reference default: smoothing ON (src/state.rs:46)
    assert not build_parser().parse_args(["run", "--no-gaussian"]).gaussian


def test_debug_flag_both_positions():
    ap = build_parser()
    assert ap.parse_args(["--debug", "run"]).debug
    assert ap.parse_args(["run", "--debug"]).debug


def test_renderer_and_shading_flags():
    args = build_parser().parse_args(
        ["screenshot", "--renderer", "slab", "--no-shading", "--interpolation", "trilinear"]
    )
    assert args.renderer == "slab"
    assert args.no_shading
    assert args.interpolation == "trilinear"


def test_benchmark_sweep_flags():
    args = build_parser().parse_args(
        ["benchmark", "--trials", "2", "--seconds", "0.5", "--sweep-steps", "0.01", "0.02"]
    )
    assert args.trials == 2
    assert args.sweep_steps == [0.01, 0.02]
