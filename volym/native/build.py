"""Build libvolym_io.so: ``python -m volym.native.build``."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).parent


def build(verbose: bool = True) -> Path:
    src = HERE / "volym_io.cpp"
    out = HERE / "libvolym_io.so"
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-shared",
        "-fPIC",
        "-std=c++17",
        "-o",
        str(out),
        str(src),
    ]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True)
    return out


if __name__ == "__main__":
    path = build()
    print(f"built {path}")
    sys.exit(0)
