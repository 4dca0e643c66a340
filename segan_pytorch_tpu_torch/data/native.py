"""ctypes binding of the C++ wav gather (``native/segan_io.cpp``): the counterpart of
``segan_pytorch_tpu/data/native.py``.

The library is built at first use from the repo's ``native/segan_io.cpp`` with
``native/Makefile``'s flags into ``build/torch_native/`` (``ops/kernels/build.py``
``build_host_library``) and loaded by path, so both packages decode, normalise,
pre-emphasise and slice wavs with the same code. ``get_lib`` returns None when it cannot
be built; the dataset then takes its Python path, which gives the same bytes.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

_LIB = None
_TRIED = False


def get_lib():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    from ..ops.kernels.build import build_host_library

    try:
        lib = ctypes.CDLL(str(build_host_library("segan_io")))
    except (OSError, RuntimeError) as e:
        print(f"[data] native/segan_io.cpp unavailable: {e}")
        return None
    lib.segan_io_create.restype = ctypes.c_void_p
    lib.segan_io_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.segan_io_destroy.argtypes = [ctypes.c_void_p]
    lib.segan_io_gather.restype = ctypes.c_int
    lib.segan_io_gather.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.segan_io_read.restype = ctypes.c_int64
    lib.segan_io_read.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    _LIB = lib
    return _LIB


class NativeAudioEngine:
    """Thread-pooled wav decode + normalize/preemph + slice gather."""

    def __init__(self, threads: int = 0, cache_cap: int = 512):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native segan_io library unavailable")
        self._lib = lib
        self._h = lib.segan_io_create(threads, cache_cap)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.segan_io_destroy(self._h)
        except Exception:
            pass

    def gather(self, paths: Sequence[str], begs: Sequence[int],
               ends: Sequence[int], slice_size: int, preemph: float
               ) -> np.ndarray:
        n = len(paths)
        out = np.empty((n, slice_size), np.float32)
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        c_begs = np.ascontiguousarray(begs, np.int64)
        c_ends = np.ascontiguousarray(ends, np.int64)
        failures = self._lib.segan_io_gather(
            self._h, c_paths,
            c_begs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            c_ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, slice_size, preemph,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if failures:
            raise IOError(f"native gather: {failures}/{n} decode failures")
        return out

    def read(self, path: str, preemph: float) -> np.ndarray:
        n = self._lib.segan_io_read(self._h, path.encode(), preemph, None, 0)
        if n < 0:
            raise IOError(f"native read failed: {path}")
        out = np.empty((n,), np.float32)
        got = self._lib.segan_io_read(
            self._h, path.encode(), preemph,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        assert got == n
        return out


def available() -> bool:
    return get_lib() is not None
