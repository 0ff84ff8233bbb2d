"""Command-line entry point.

The reference CLI (``src/cli.rs:35-56``): ``volym [run {simple} | benchmark]
[--debug]``.  Equivalents here — plus the offline subcommands the
interactive event loop becomes in a renderer without a window:

    python -m volym run [simple]     render a frame sweep, save PNG
    python -m volym benchmark        full reference sweep -> CSV
    python -m volym screenshot       single frame -> PNG
    python -m volym fit              inverse-rendering demo
    python -m volym devtools ...     NRRD -> segments.json + raw
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

log = logging.getLogger("volym")


def _setup_logging(debug: bool) -> None:
    # analog of setup_tracing (src/main.rs:451-463): --debug -> DEBUG level
    logging.basicConfig(
        level=logging.DEBUG if debug else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
        stream=sys.stderr,
    )


def _default_scene(args):
    from volym.scene import Scene

    if args.volume:
        return Scene.load(
            args.volume, args.segments_raw, args.segments_json, side=args.side
        )
    log.info("no --volume given; using the synthetic %s scene", args.scene)
    return Scene.synthetic(args.scene, side=args.side)


def _camera(args):
    from volym.camera import Camera

    return Camera(aspect=args.width / args.height, distance=args.distance).orbit(
        args.orbit_h, args.orbit_v, 0.0
    )


def _params(args):
    from volym.config import RenderParams

    return RenderParams(
        density_threshold=args.threshold,
        raymarching_step_size=args.step_size,
        use_gaussian_smoothing=args.gaussian,
        use_importance_rendering=args.importance,
        use_cone_importance_check=args.cone,
        use_importance_coloring=args.coloring,
        importance_check_ahead_steps=args.ahead_steps,
        interpolation=args.interpolation,
        use_shading=not args.no_shading,
        use_opacity=not getattr(args, "first_hit", False),
    )


def _backend(args):
    from volym.render.renderer import check_backend

    return check_backend(getattr(args, "renderer", "ray"))


import contextlib


@contextlib.contextmanager
def _maybe_profile(args):
    """jax.profiler capture around a timed region (SURVEY.md section 5:
    the tracing-layer analog of the reference's tracing spans)."""
    profile_dir = getattr(args, "profile", None)
    if not profile_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(profile_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log.info("wrote profiler trace to %s", profile_dir)


def cmd_run(args) -> int:
    """Offline analog of the interactive loop (``src/event_loop.rs:94-157``):
    render N frames along an orbit sweep, log FPS once per second
    (``src/event_loop.rs:138-144``), save the last frame."""
    import jax

    from volym import io as vio
    from volym.render.renderer import make_renderer

    scene = _default_scene(args)
    params = _params(args)
    render = make_renderer(scene, params, args.height, args.width, backend=_backend(args))

    cam = _camera(args)
    frames, t_last, n_last = 0, time.perf_counter(), 0
    img = None
    with _maybe_profile(args):
        for i in range(args.frames):
            cam = cam.orbit(2.0, 0.0, 0.0)  # orbit sweep stands in for mouse input
            if args.live_sweep and _backend(args) == "ray":
                # live parameter mutation (the egui-panel capability,
                # src/gui.rs:196-277): the traced-knob split means these float
                # changes re-render WITHOUT recompiling
                from volym.render import fast

                live = params.replace(
                    density_threshold=0.05 + 0.2 * (i % 10) / 10.0,
                    raymarching_step_size=params.raymarching_step_size
                    * (1.0 + 0.5 * (i % 7) / 7.0),
                )
                img = fast.render(scene, cam.matrices(), live, args.height, args.width)
            else:
                img = render(cam.matrices())
            from volym.bench.harness import force_sync

            force_sync(img)
            frames += 1
            now = time.perf_counter()
            if now - t_last >= 1.0:
                log.info("FPS: %.1f", (frames - n_last) / (now - t_last))
                t_last, n_last = now, frames
    path = vio.save_screenshot(img, ".")
    log.info("saved %s", path)
    return 0


def cmd_screenshot(args) -> int:
    from volym import io as vio
    from volym.render.renderer import make_renderer

    scene = _default_scene(args)
    render = make_renderer(
        scene, _params(args), args.height, args.width, backend=_backend(args)
    )
    img = render(_camera(args).matrices())
    out = args.output or f"screenshot_{int(time.time())}.png"
    vio.write_png(out, __import__("numpy").asarray(img))
    log.info("saved %s", out)
    return 0


def cmd_view(args) -> int:
    """Interactive live viewer (the event-loop + GUI analog, see
    :mod:`volym.viewer`): serves a browser page whose drags/wheel/panel
    drive renders on the device."""
    from volym import viewer

    scene = _default_scene(args)
    # CLI orbit/distance flags seed the page's initial camera via the
    # params payload only; the client owns camera state thereafter
    return viewer.serve(
        scene, _params(args), args.height, args.width,
        host=args.host, port=args.port, screenshot_dir=args.screenshot_dir,
    )


def cmd_benchmark(args) -> int:
    import jax

    from volym.bench import harness
    from volym.render.renderer import make_renderer

    scene = _default_scene(args)
    cam = _camera(args)
    m = cam.matrices()

    if args.scaling:
        rows = harness.scaling_table(
            scene, m, _params(args), args.height, args.width,
            backend=_backend(args), num_trials=args.trials,
            seconds=args.seconds, log=log.info,
        )
        out = args.output or "scaling_results.csv"
        harness.write_csv(rows, out)
        log.info("wrote %s (%d rows)", out, len(rows))
        return 0

    def render_factory(params):
        r = make_renderer(scene, params, args.height, args.width, backend=_backend(args))
        # run_trial fences every frame
        return lambda: r(m)

    if args.step_histogram:
        from volym.render import debug_vis

        edges, hist = debug_vis.step_count_histogram(
            scene, m, _params(args).replace(adaptive_stepping=True),
            args.height, args.width,
        )
        for lo, hi, n in zip(edges[:-1], edges[1:], hist):
            log.info("steps %4d-%4d: %d rays", int(lo), int(hi), int(n))

    with _maybe_profile(args):
        rows = harness.benchmark_all(
            render_factory,
            num_trials=args.trials,
            seconds=args.seconds,
            height=args.height,
            width=args.width,
            step_sizes=tuple(args.sweep_steps) if args.sweep_steps else harness.STEP_SIZES,
            log=log.info,
        )
    harness.write_csv(rows, args.output or "benchmark_results.csv")
    log.info("wrote %s (%d rows)", args.output or "benchmark_results.csv", len(rows))
    return 0


def cmd_fit(args) -> int:
    import jax.numpy as jnp
    import numpy as np

    from volym import io as vio
    from volym.optim import fit_scene
    from volym.render import golden
    from volym.scene import Scene

    target_scene = _default_scene(args)
    cam = _camera(args)
    params = _params(args).replace(adaptive_stepping=False)
    target = golden.render(target_scene, cam.matrices(), params, args.height, args.width)

    # init must clear the hard density threshold or the renderer masks every
    # sample and the fit has exactly-zero gradients (flat loss forever)
    init = Scene(
        volume=jnp.full_like(
            target_scene.volume, max(0.15, params.density_threshold + 0.03)
        ),
        importance=target_scene.importance,
        tf_lut=target_scene.tf_lut,
    )
    cb = lambda i, l: log.info("fit step %d loss %.6f", i, l) if i % 10 == 0 else None
    if args.distributed:
        from volym.parallel import launch

        fitted, losses = launch.fit_distributed(
            init, cam.matrices(), target, params, steps=args.frames,
            backend=_backend(args), callback=cb,
        )
        log.info("loss: %.6f -> %.6f", losses[0], losses[-1])
        if launch.is_coordinator():
            vio.save_checkpoint(args.output or "fitted_scene.npz", {
                "volume": fitted.volume,
                "tf_lut": fitted.tf_lut,
            })
        return 0
    res = fit_scene(
        init,
        cam.matrices(),
        target,
        params,
        steps=args.frames,
        callback=cb,
    )
    log.info("loss: %.6f -> %.6f", res.losses[0], res.losses[-1])
    vio.save_checkpoint(args.output or "fitted_scene.npz", {
        "volume": res.scene.volume,
        "tf_lut": res.scene.tf_lut,
    })
    return 0


def build_parser() -> argparse.ArgumentParser:
    from volym.render.renderer import BACKENDS

    ap = argparse.ArgumentParser(prog="volym")
    ap.add_argument("--debug", action="store_true", help="enable debug logging")
    sub = ap.add_subparsers(dest="command")

    def common(p):
        # SUPPRESS so a subcommand-position flag doesn't clobber a
        # top-level `--debug` with its False default
        p.add_argument(
            "--debug", action="store_true", default=argparse.SUPPRESS,
            help="enable debug logging",
        )
        p.add_argument("--volume", help="raw uint8 volume path")
        p.add_argument("--segments-raw", help="segments.raw path")
        p.add_argument("--segments-json", help="segments.json path")
        p.add_argument("--scene", default="bonsai", choices=["bonsai", "sphere", "teapot"])
        p.add_argument("--side", type=int, default=256)
        p.add_argument("--width", type=int, default=1024)
        p.add_argument("--height", type=int, default=768)
        p.add_argument("--distance", type=float, default=1.0)
        p.add_argument("--orbit-h", type=float, default=0.0)
        p.add_argument("--orbit-v", type=float, default=0.0)
        p.add_argument("--threshold", type=float, default=0.12)
        p.add_argument("--step-size", type=float, default=0.01)
        p.add_argument(
            "--gaussian", action=argparse.BooleanOptionalAction, default=True,
            help="Gaussian-smoothed sampling (reference default ON, "
            "src/state.rs:46); differentiable in every renderer",
        )
        p.add_argument(
            "--no-shading", action="store_true",
            help="disable Blinn-Phong shading",
        )
        p.add_argument(
            "--first-hit", action="store_true",
            help="first-hit-then-break instead of alpha compositing "
            "(the reference's use_opacity=false; wgsl:319-323)",
        )
        p.add_argument("--importance", action="store_true")
        p.add_argument("--cone", action="store_true")
        p.add_argument("--coloring", action="store_true")
        p.add_argument("--ahead-steps", type=int, default=12)
        p.add_argument("--interpolation", default="nearest", choices=["nearest", "trilinear"])
        p.add_argument(
            "--renderer", default="ray", choices=list(BACKENDS),
            help="ray = reference-parity t-step march; slab = slab-ordered "
            "march (one plane per step along the dominant axis)",
        )
        p.add_argument("--frames", type=int, default=100)
        p.add_argument("--output")
        p.add_argument(
            "--distributed", action="store_true",
            help="multi-host run: jax.distributed.initialize from VOLYM_* "
            "env vars (see volym/parallel/launch.py)",
        )
        p.add_argument(
            "--profile", metavar="DIR",
            help="capture a jax.profiler trace of the main loop into DIR "
            "(view with tensorboard/xprof)",
        )

    p_run = sub.add_parser("run", help="orbit-sweep render loop")
    p_run.add_argument("demo", nargs="?", default="simple", choices=["simple"])
    common(p_run)
    p_run.add_argument(
        "--live-sweep", action="store_true",
        help="mutate threshold/step size per frame (GUI-mutation analog; "
        "traced knobs -> no recompile)",
    )
    p_bench = sub.add_parser("benchmark", help="full reference sweep -> CSV")
    common(p_bench)
    p_bench.add_argument("--trials", type=int, default=3)
    p_bench.add_argument("--seconds", type=float, default=2.0)
    p_bench.add_argument("--sweep-steps", type=float, nargs="*")
    p_bench.add_argument(
        "--scaling", action="store_true",
        help="rays/s vs device count table instead of the parameter sweep",
    )
    p_bench.add_argument(
        "--step-histogram", action="store_true",
        help="print the per-ray march-length histogram before the sweep",
    )
    p_shot = sub.add_parser("screenshot", help="single frame -> PNG")
    common(p_shot)
    p_view = sub.add_parser(
        "view", help="interactive browser viewer (live orbit + panel)"
    )
    common(p_view)
    p_view.add_argument("--host", default="127.0.0.1")
    p_view.add_argument("--port", type=int, default=8000)
    p_view.add_argument("--screenshot-dir", default=".")
    p_fit = sub.add_parser("fit", help="inverse-rendering demo")
    common(p_fit)
    p_dev = sub.add_parser("devtools", help="NRRD -> segments.json + raw")
    p_dev.add_argument("input")
    p_dev.add_argument("json_out")
    p_dev.add_argument("raw_out")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _setup_logging(args.debug)
    # multi-host bootstrap must run before any other JAX device use
    from volym import compile_cache
    from volym.parallel import launch

    compile_cache.enable()
    launch.maybe_initialize(getattr(args, "distributed", False))
    if args.command == "devtools":
        from volym import devtools

        devtools.convert(args.input, args.json_out, args.raw_out)
        return 0
    cmd = {
        "run": cmd_run,
        "benchmark": cmd_benchmark,
        "screenshot": cmd_screenshot,
        "fit": cmd_fit,
        "view": cmd_view,
        None: cmd_run,
    }[args.command]
    if args.command is None:
        # reference default: `volym` == `volym run simple` (src/cli.rs:47-50)
        args = build_parser().parse_args(["run", *(argv or [])])
    return cmd(args)


if __name__ == "__main__":
    raise SystemExit(main())
