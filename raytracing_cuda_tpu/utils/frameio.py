"""ctypes bindings for the native frame-output runtime (native/frameio).

The reference presents frames through native code (CUDA-GL interop + GLUT
swap, main.cpp:103-226); headless hosts present frames by writing them,
and this module keeps that OFF the render loop: libframeio.so encodes PNGs
at memcpy speed (stored-deflate) on a background thread behind a bounded
ring. Falls back to utils.images' numpy encoder when the library hasn't
been built (`make -C native`).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_native", "libframeio.so")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.fio_write_png.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.c_int]
    lib.fio_write_png.restype = ctypes.c_int
    lib.fio_writer_create.argtypes = [ctypes.c_int]
    lib.fio_writer_create.restype = ctypes.c_void_p
    lib.fio_writer_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.fio_writer_written.argtypes = [ctypes.c_void_p]
    lib.fio_writer_written.restype = ctypes.c_long
    try:
        lib.fio_writer_failed.argtypes = [ctypes.c_void_p]
        lib.fio_writer_failed.restype = ctypes.c_long
    except AttributeError:             # older .so without the counter
        pass
    try:
        lib.fio_set_png_level.argtypes = [ctypes.c_int]
        lib.fio_set_png_level.restype = ctypes.c_int
        lib.fio_get_png_level.restype = ctypes.c_int
        lib.fio_writer_create2.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.fio_writer_create2.restype = ctypes.c_void_p
    except AttributeError:             # older .so: stored-only, one worker
        pass
    lib.fio_writer_drain.argtypes = [ctypes.c_void_p]
    lib.fio_writer_destroy.argtypes = [ctypes.c_void_p]
    lib.fio_now_ns.restype = ctypes.c_longlong
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def build(quiet: bool = True) -> bool:
    """Compile libframeio.so in-tree (g++, no dependencies)."""
    import subprocess

    native = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native")
    try:
        r = subprocess.run(["make", "-C", native],
                           capture_output=quiet, text=True)
    except FileNotFoundError:          # no `make` on this host: numpy fallback
        return False
    global _lib
    _lib = None
    return r.returncode == 0 and available()


_fallback_png_level = 0   # numpy-fallback mirror of the native global


def set_png_level(level: int) -> int:
    """PNG encode level for all frameio writes: 0 = stored-deflate
    (memcpy-speed, default), 1-9 = Sub-filtered zlib compression (~4-6x
    smaller rendered frames; encode runs on writer threads). Returns the
    level actually in effect (0 on builds/fallbacks without zlib)."""
    global _fallback_png_level
    level = max(0, min(9, int(level)))
    _fallback_png_level = level
    lib = _load()
    if lib is not None:
        fn = getattr(lib, "fio_set_png_level", None)
        if fn is None:
            # older .so without the zlib entry point: every native write
            # encodes at its built-in level 0 — report 0 so callers know
            # compression is off (the CLI's clamp note fires and the
            # writer stays single-threaded)
            return 0
        return int(fn(level))
    return level   # the numpy fallback compresses at this level itself


def _as_rgb_bytes(img: np.ndarray):
    img = np.ascontiguousarray(img)
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(
            f"frameio needs (H, W, 3) uint8, got {img.shape} {img.dtype}")
    return img, img.ctypes.data_as(ctypes.c_char_p)


def write_png(img: np.ndarray, path: str) -> None:
    """Synchronous PNG write via the native encoder (numpy fallback)."""
    lib = _load()
    if lib is None:
        from raytracing_cuda_tpu.utils.images import save_png

        save_png(img, path, level=_fallback_png_level)
        return
    img, ptr = _as_rgb_bytes(img)
    rc = lib.fio_write_png(path.encode(), ptr, img.shape[1], img.shape[0])
    if rc != 0:
        raise OSError(f"fio_write_png({path}) failed: {rc}")


class AsyncFrameWriter:
    """Bounded-ring background PNG writer (native thread).

    submit() copies the frame into a ring slot and returns immediately; the
    worker encodes + writes. drain() blocks until the queue is empty.
    """

    def __init__(self, ring: int = 4, threads: int = 1):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "libframeio.so not built — run `make -C native` or "
                "frameio.build()")
        self._lib = lib
        create2 = getattr(lib, "fio_writer_create2", None)
        if threads > 1 and create2 is not None:
            self._h = create2(ring, threads)
        else:   # older .so without multi-worker support, or threads=1
            self._h = lib.fio_writer_create(ring)

    def _handle(self):
        if not self._h:
            raise RuntimeError("AsyncFrameWriter used after close()")
        return self._h

    def submit(self, img: np.ndarray, path: str) -> None:
        img, ptr = _as_rgb_bytes(img)
        self._lib.fio_writer_submit(self._handle(), path.encode(), ptr,
                                    img.shape[1], img.shape[0])

    @property
    def written(self) -> int:
        return int(self._lib.fio_writer_written(self._handle()))

    @property
    def failed(self) -> int:
        """Frames dropped by the worker (unwritable path / disk full)."""
        fn = getattr(self._lib, "fio_writer_failed", None)
        return int(fn(self._handle())) if fn is not None else 0

    def drain(self) -> None:
        self._lib.fio_writer_drain(self._handle())

    def close(self) -> None:
        if self._h:
            self._lib.fio_writer_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.drain()
        self.close()


def now_ns() -> int:
    """Monotonic clock (native when available)."""
    lib = _load()
    if lib is None:
        import time

        return time.monotonic_ns()
    return int(lib.fio_now_ns())
