"""Native host-kernel loader (ctypes).

Compiles famsa_native.cpp with g++ on first use into the package's
git-ignored build directory (famsa_tpu_torch/_build/).  Unlike the JAX
package's loader there is no silent NumPy fallback: the port's DP route
depends on the native `trace_path`, so a failed build raises."""

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "famsa_native.cpp"
BUILD_DIR = _DIR.parent / "_build"
_SO = BUILD_DIR / "libfamsa_native.so"

_lib = None
_lock = threading.Lock()


def _build():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name and rename: concurrent test workers may
    # build at the same time, and a reader must never see a partial .so
    tmp = BUILD_DIR / f".libfamsa_native.{os.getpid()}.so"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
           "-o", str(tmp), str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as err:
        raise RuntimeError(f"native build failed: {err}") from err
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("native build failed:\n" + proc.stderr)
    os.replace(tmp, _SO)


def get_lib():
    """The loaded native library; builds it on first use, raises
    RuntimeError when the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
                _build()
            lib = ctypes.CDLL(str(_SO))
            _configure(lib)
            _lib = lib
    return _lib


def _configure(lib):
    i64 = ctypes.c_int64
    p_i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_u64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")

    lib.dp_seq_seq.argtypes = [p_i8, p_i8, i64, i64, p_i64,
                               i64, i64, i64, i64, p_u8, p_i64]
    lib.dp_prof_prof.argtypes = [p_i64, p_i64, i64, i64,
                                 p_i64, p_i64, i64, i64,
                                 i64, i64, i64, i64,
                                 ctypes.c_void_p, p_u8, p_i64]
    lib.slink_update_row.argtypes = [i64, p_f64, p_u64, p_i64, p_f64, p_u64]
    lib.clarans_deltas.argtypes = [p_f32, i64, i64, i64, p_i64,
                                   p_f32, p_f32, p_i64, p_f32]
    lib.clarans_apply_swap.argtypes = [p_f32, i64, i64, i64, i64, p_i64,
                                       p_f32, p_f32, p_i64, p_i64,
                                       ctypes.c_float]
    lib.clarans_apply_swap.restype = ctypes.c_float
    lib.clarans_init.argtypes = [p_f32, i64, i64, p_i64, p_f32, p_f32,
                                 p_i64, p_i64]
    lib.clarans_init.restype = ctypes.c_float
    lib.lcs_batch.argtypes = [p_u64, i64, p_i8, i64, i64, p_i64]
    lib.apply_column_inserts_batch.argtypes = [p_u64, p_i64, i64,
                                               p_i64, p_i64, i64, i64]
    lib.trace_path.argtypes = [p_u8, i64, i64, i64, i64, i64, p_i64, p_i64]
    lib.trace_path.restype = i64
