"""ctypes binding of the native C++ P.862 implementation (``native/pesq862.cpp``): a
copy of ``segan_pytorch_tpu/metrics/pesq_native.py`` that builds the library from the
repo's ``native/pesq862.cpp`` with ``native/Makefile``'s flags into
``build/torch_native/`` (``ops/kernels/build.py`` ``build_host_library``) and loads it by
path, so that both packages score with one yardstick. Callers fall back to other
backends when it is unavailable.

Its psychoacoustic tables are regenerated from published formulas, so values are NOT
ITU-certified.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

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
        lib = ctypes.CDLL(str(build_host_library("pesq862")))
    except (OSError, RuntimeError):
        return None
    lib.pesq862.restype = ctypes.c_double
    lib.pesq862.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
    ]
    lib.pesq862_provenance.restype = ctypes.c_char_p
    lib.pesq862_constants.restype = ctypes.c_int
    lib.pesq862_constants.argtypes = [ctypes.POINTER(ctypes.c_double),
                                      ctypes.c_int]
    lib.pesq862_tables.restype = ctypes.c_int
    lib.pesq862_tables.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double)]
    _LIB = lib
    return _LIB


def pesq_compiled_constants() -> Optional[dict]:
    """The scalar constants the COMPILED pipeline uses (P.862.1/.2 mappings,
    wideband input IIR, Sp/Sl, raw-score weights) — for asserting against the
    published ITU values (tests/test_pesq_crosspin.py)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = (ctypes.c_double * 23)()
    if lib.pesq862_constants(buf, 23) != 23:
        return None
    v = list(buf)
    return {
        "wb_map": {"offset": v[0], "span": v[1], "slope": v[2], "bias": v[3]},
        "nb_map": {"offset": v[4], "span": v[5], "slope": v[6], "bias": v[7]},
        "wb_iir_16k": v[8:13],
        "wb_iir_8k": v[13:18],
        "sp_16k": v[18], "sp_8k": v[19], "sl": v[20],
        "raw_d_weight": v[21], "raw_da_weight": v[22],
    }


def pesq_compiled_tables(fs: int) -> Optional[dict]:
    """The regenerated Bark tables as the compiled library built them — for
    cross-pinning against an independent regeneration."""
    lib = get_lib()
    if lib is None:
        return None
    MAXB = 64
    fb = (ctypes.c_int * MAXB)()
    bpb = (ctypes.c_int * MAXB)()
    cz = (ctypes.c_double * MAXB)()
    wz = (ctypes.c_double * MAXB)()
    az = (ctypes.c_double * MAXB)()
    nb = lib.pesq862_tables(int(fs), fb, bpb, cz, wz, az)
    if nb <= 0:
        return None
    return {"nb": nb,
            "first_bin": np.array(fb[:nb]),
            "bins_per_band": np.array(bpb[:nb]),
            "centre_hz": np.array(cz[:nb]),
            "width_bark": np.array(wz[:nb]),
            "abs_thresh": np.array(az[:nb])}


def pesq_native(ref_wav: np.ndarray, deg_wav: np.ndarray, sr: int = 16000,
                wb: bool = True, return_raw: bool = False):
    """MOS-LQO via the native P.862 pipeline, or None when unavailable/invalid."""
    lib = get_lib()
    if lib is None:
        return None
    ref = np.ascontiguousarray(np.asarray(ref_wav, np.float32).reshape(-1))
    deg = np.ascontiguousarray(np.asarray(deg_wav, np.float32).reshape(-1))
    raw = ctypes.c_double()
    v = lib.pesq862(
        ref.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(ref),
        deg.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(deg),
        int(sr), 1 if wb else 0, ctypes.byref(raw))
    if math.isnan(v):
        return None
    if return_raw:
        return float(v), float(raw.value)
    return float(v)
