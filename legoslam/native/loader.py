"""ctypes bindings for the native PNG decode + prefetch loader (loader.cpp).

Builds the shared library on first use (g++ + libpng, both present in the
target image); consumers fall back to cv2/PIL when the toolchain is missing
(pipeline/dataset.py probes `available()`)."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from legoslam.utils.logging import get_logger

log = get_logger("legoslam.native")

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libloader.so")
_SRC = os.path.join(_DIR, "loader.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++14", _SRC, "-o", _SO, "-lpng", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception as e:  # toolchain/libpng missing — callers fall back
        log.warning("native loader build failed: %s", e)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                _build_failed = True
                return None
        lib = ctypes.CDLL(_SO)
        lib.ls_loader_open.restype = ctypes.c_void_p
        lib.ls_loader_open.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 5
        lib.ls_loader_next.restype = ctypes.c_int
        lib.ls_loader_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.ls_loader_close.argtypes = [ctypes.c_void_p]
        lib.ls_decode_png.restype = ctypes.c_int
        lib.ls_decode_png.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_png(path: str, half: bool = False) -> Optional[np.ndarray]:
    """Decode one grayscale PNG to float32 (optionally half resolution)."""
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    # Probe size first (no buffer).
    if not lib.ls_decode_png(path.encode(), None, 0, ctypes.byref(w), ctypes.byref(h), int(half)):
        return None
    buf = np.empty(w.value * h.value, np.float32)
    ok = lib.ls_decode_png(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        buf.size,
        ctypes.byref(w),
        ctypes.byref(h),
        int(half),
    )
    return buf.reshape(h.value, w.value) if ok else None


class PrefetchLoader:
    """In-order prefetching reader over a KITTI image_0/image_1 directory pair."""

    def __init__(self, dataset_dir: str, start: int = 0, count: int = 1 << 20,
                 half: bool = True, workers: int = 4, prefetch: int = 8,
                 max_pixels: int = 4096 * 4096):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self._handle = lib.ls_loader_open(
            dataset_dir.encode(), start, count, int(half), workers, prefetch
        )
        self._cap = max_pixels
        self._left = np.empty(max_pixels, np.float32)
        self._right = np.empty(max_pixels, np.float32)

    def next(self) -> Optional[Tuple[int, np.ndarray, np.ndarray]]:
        idx = ctypes.c_int()
        w = ctypes.c_int()
        h = ctypes.c_int()
        ok = self._lib.ls_loader_next(
            self._handle,
            self._left.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._right.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(idx), ctypes.byref(w), ctypes.byref(h), self._cap,
        )
        if not ok:
            return None
        n = w.value * h.value
        shape = (h.value, w.value)
        return idx.value, self._left[:n].reshape(shape).copy(), self._right[:n].reshape(shape).copy()

    def close(self) -> None:
        if self._handle:
            self._lib.ls_loader_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
