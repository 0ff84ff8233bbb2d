"""ctypes bindings for the native C++ IO library (libvolym_io).

The reference's host runtime is native Rust; ours is native C++ for the
byte-level asset pipeline (raw volume load + pad + Y flip, label->importance
mapping, NRRD splitting — reference ``src/gpu_resources/volume.rs:35-101``,
``src/demos/simple/importance.rs:45-158``, ``volym_devtools/src/main.rs``).
Python/NumPy fallbacks exist for every entry point; the native path avoids
the extra NumPy staging copies on multi-GB volumes.

Build with ``python -m volym.native.build`` (uses g++, no external deps).
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

_LIB_PATH = Path(__file__).parent / "libvolym_io.so"
_lib = None
_load_failed = False


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not _LIB_PATH.exists() or os.environ.get("VOLYM_NO_NATIVE"):
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.volym_load_volume.restype = ctypes.c_int
        lib.volym_load_volume.argtypes = [
            ctypes.c_char_p,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.volym_load_importance.restype = ctypes.c_int
        lib.volym_load_importance.argtypes = [
            ctypes.c_char_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.volym_nrrd_split.restype = ctypes.c_longlong
        lib.volym_nrrd_split.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        _lib = lib
    except OSError:
        _load_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def load_volume(path: str, flip: bool, side: int) -> np.ndarray:
    lib = _load()
    out = np.empty((side, side, side), dtype=np.uint8)
    rc = lib.volym_load_volume(
        path.encode(), out.ctypes.data_as(ctypes.c_void_p), side, 1 if flip else 0
    )
    if rc != 0:
        raise IOError(f"native volume load failed ({rc}): {path}")
    return out


def load_importance(path: str, label_lut: np.ndarray, flip: bool, side: int) -> np.ndarray:
    lib = _load()
    lut = np.ascontiguousarray(label_lut, dtype=np.uint8)
    assert lut.size == 256
    out = np.empty((side, side, side), dtype=np.uint8)
    rc = lib.volym_load_importance(
        path.encode(),
        lut.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        side,
        1 if flip else 0,
    )
    if rc != 0:
        raise IOError(f"native importance load failed ({rc}): {path}")
    return out


def nrrd_raw_bytes(in_path: str, out_path: str) -> int:
    """Write the NRRD payload (text after the blank header line) to a raw
    file; returns bytes written (devtools ``read_volume_data_to_file``)."""
    lib = _load()
    n = lib.volym_nrrd_split(in_path.encode(), out_path.encode())
    if n < 0:
        raise IOError(f"native nrrd split failed ({n}): {in_path}")
    return int(n)
