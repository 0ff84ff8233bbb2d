"""Runtime hygiene: where the compile cache lives, and ``chip_smoke.py``'s
arguments, checks and output contract (it refuses to run without a GPU)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from volym import compile_cache

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


def test_cache_dir_follows_env():
    assert compile_cache.cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) == "/x/y"


def test_cache_dir_default_is_fixed_repo_path():
    a = compile_cache.cache_dir({})
    assert a == str(REPO / ".jax_cache")
    assert a == compile_cache.cache_dir({}) and str(os.getpid()) not in a


def test_cache_dir_empty_env_falls_back():
    assert compile_cache.cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == str(REPO / ".jax_cache")


def test_enable_sets_jax_config(tmp_path):
    import jax

    old = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
        assert got == str(tmp_path) == jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_default_cache_is_gitignored():
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_smoke_args_default_one_card():
    a = chip_smoke.parse_args([])
    assert a.chips == 1 and a.trace is None


def test_smoke_args_four_cards_and_trace():
    a = chip_smoke.parse_args(["--chips", "4", "--trace", "out"])
    assert a.chips == 4 and a.trace == "out"


@pytest.mark.parametrize("bad", [["--chips", "2"], ["--chips", "8"], ["--bogus"]])
def test_smoke_args_rejected(bad):
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(bad)


def test_smoke_result_line_format():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line(Dev(), 4)
    assert json.loads(line) == {
        "ok": True, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}
    }
    assert "\n" not in line


def test_smoke_image_check_budget():
    ref = np.zeros((100, 100, 4), np.float32)
    got = ref.copy()
    got[0, :10] = 1.0  # 10 knife-edge pixels, budget 10
    chip_smoke.image_check("ok", got, ref, knife_share=1e-3)
    got[1, :1] = 1.0
    with pytest.raises(AssertionError):
        chip_smoke.image_check("over", got, ref, knife_share=1e-3)
    with pytest.raises(AssertionError):
        chip_smoke.image_check("nan", np.full_like(ref, np.nan), ref)


def test_smoke_grad_check():
    rng = np.random.default_rng(0)
    r = rng.normal(size=1000)
    chip_smoke.grad_check("close", r * (1 + 1e-4 * rng.normal(size=1000)), r)
    with pytest.raises(AssertionError):
        chip_smoke.grad_check("far", r + 0.1 * rng.normal(size=1000), r)
    with pytest.raises(AssertionError):
        chip_smoke.grad_check("zero", np.zeros(10), np.zeros(10))


def _run(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    env.update({"JAX_PLATFORMS": "cpu"}, **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=240,
    )


def test_smoke_refuses_cpu():
    r = _run(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "needs a GPU" in r.stderr


def test_smoke_refuses_outside_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "not importable" in r.stderr
