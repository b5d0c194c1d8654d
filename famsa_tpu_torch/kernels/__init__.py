"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Each source is compiled with nvcc for sm_90a into a shared library with a
plain C interface, at first use, into the package's git-ignored build
directory (famsa_tpu_torch/_build/), and loaded with ctypes.  The library
name carries a hash of the source and of every csrc header it includes,
so an edited source or header is rebuilt.
Nothing here runs at import time: this module imports on machines with
no CUDA toolkit, where only the kernels' plain PyTorch versions run.

LAUNCHES counts kernel launches per kernel: each wrapper adds one where
it launches its kernel, and nowhere else (chip_smoke.py resets it before
driving the main path and reads it after; a chain chunk's CUDA graph
adds its launches at each replay); TRAFFIC counts the device DP route's
copies and sides, CHAIN the chain route's runs, merges, chunks and
copies, both reset with it."""

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
KERNELS = ("lcs", "dp_wide", "traceback", "stage0", "merged", "chain",
           "prim")

# one count per hand-written kernel variant: K1 rows and wave; K2 staged
# (a cluster of folds a merge, one column a thread: up to 8 folds, w2 <=
# 4095, and 9-16 folds, "dp_staged16", w2 <= 8191), stripes (16 folds of
# 2 or 4 columns a thread, w2 <= 32767) and spans (up to 4 clusters of 16
# folds of 4 columns a thread a merge, w2 <= 131071); K3 staged
# ("dp_wide", "dp_wide16") and stripes ("dp_wide_stripes") on the same
# widths; K4, the traceback; K5, stage 0; K6, the merged counters; K7,
# the chain's carry after a chunk's last step (K5's chain entry runs it
# before each step); K8, a Prim round after its LCS; K9, FAMSA's LCS
# layout for flagged references ("lcs_refmask"); and K10, one shard's
# column slice of a merge over every row ("dp_shard", either body)
LAUNCHES = {"lcs": 0, "lcs_wave": 0, "lcs_refmask": 0, "dp_staged": 0,
            "dp_staged16": 0, "dp_stripes": 0, "dp_spans": 0, "dp_wide": 0,
            "dp_wide16": 0, "dp_wide_stripes": 0, "traceback": 0,
            "stage0": 0, "merged": 0, "chain": 0, "prim_round": 0,
            "dp_shard": 0}
# the device DP route's traffic (ops/dp_resident.py): bytes copied to and
# from the device, and the launch sides that were resident on the device,
# ungapped leaves (their symbol bytes uploaded) or uploaded counters; and
# the column-sharded route's (parallel/dp_sharded.py) copies on the card:
# the column planes, row factors and edges copied to and between shards
# (bytes_shard) and the direction bytes and finals gathered to the lead
# (bytes_gather)
TRAFFIC = {"bytes_up": 0, "bytes_down": 0, "sides_resident": 0,
           "sides_leaf": 0, "sides_uploaded": 0, "bytes_shard": 0,
           "bytes_gather": 0}
# the chain route (ops/dp_chain.py, pipeline.py): caterpillar runs taken,
# their merges on the native host DP below the width floor (prefix) and
# in chunks (merges), chunks dispatched, overflows recovered, runs handed
# back to the other routes (aborts), CUDA graphs captured and replayed,
# and the bytes its chunks and seeds copied up and down
CHAIN = {"runs": 0, "prefix": 0, "merges": 0, "chunks": 0, "overflows": 0,
         "aborts": 0, "captures": 0, "replays": 0, "bytes_up": 0,
         "bytes_down": 0}
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

_libs = {}
_lock = threading.Lock()


def reset_launches():
    for counts in (LAUNCHES, TRAFFIC, CHAIN):
        for k in counts:
            counts[k] = 0


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources(path, seen=None):
    """path and every csrc file it includes with #include "...",
    transitively, in include order."""
    seen = [] if seen is None else seen
    seen.append(path)
    for inc in _INCLUDE.findall(path.read_bytes()):
        dep = path.parent / inc.decode()
        if dep not in seen:
            _sources(dep, seen)
    return seen


def _so_path(name):
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha1()
    for path in _sources(src):
        digest.update(path.read_bytes())
    return src, BUILD_DIR / f"libfamsa_{name}_{digest.hexdigest()[:12]}.so"


def _start_build(name):
    """Start nvcc for one source; returns (Popen, tmp, so) or None when the
    library is already built."""
    src, so = _so_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, so


def _finish_build(name, job):
    proc, tmp, so = job
    out, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}{err}")
    os.replace(tmp, so)


def build_all():
    """Compile every kernel source that is not built yet, one nvcc per
    source, all started together.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        jobs = {}
        try:
            for name in KERNELS:
                job = _start_build(name)
                if job is not None:
                    jobs[name] = job
        finally:
            # wait for every started compiler, even when a later start failed
            errors = []
            for name, job in jobs.items():
                try:
                    _finish_build(name, job)
                except RuntimeError as err:
                    errors.append(str(err))
            if errors:
                raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def _configure(name, lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "lcs":
        for fn in (lib.lcs_bitpar, lib.lcs_wave):
            fn.argtypes = [vp, vp, ci, ci, ci, ci, ci, vp, ci, vp]
            fn.restype = ci
        lib.lcs_refmask.argtypes = [vp, vp, ci, ci, ci, ci, ci, vp, ci, vp,
                                    vp, vp, vp]
        lib.lcs_refmask.restype = ci
    elif name == "traceback":
        lib.trace_paths.argtypes = [vp, vp, vp, ci, ci, vp, vp]
        lib.trace_paths.restype = ci
    elif name == "stage0":
        lib.stage0.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, vp, vp, vp]
        lib.stage0.restype = ci
        ll = ctypes.c_longlong
        lib.stage0_chain.argtypes = [vp, vp, vp, vp, ll, vp, vp, vp, vp, vp,
                                     ll, vp, ci, ci, vp, vp, vp, ci, ci, vp]
        lib.stage0_chain.restype = ci
    elif name == "chain":
        ll = ctypes.c_longlong
        lib.chain_carry.argtypes = [vp, vp, vp, vp, ll, vp, vp, vp, vp, vp,
                                    ll, ci, ci, ci, vp]
        lib.chain_carry.restype = ci
    elif name == "prim":
        lib.prim_round.argtypes = [vp, vp, vp, vp, ci, ci, vp, vp, vp, vp, vp,
                                   vp, ci, ci, ci, vp]
        lib.prim_round.restype = ci
        lib.prim_cluster_size.argtypes = [ci]
        lib.prim_cluster_size.restype = ci
    elif name == "merged":
        lib.merged_counters.argtypes = [vp, vp, vp, ci, ci, vp, vp]
        lib.merged_counters.restype = ci
    else:
        ll = ctypes.c_longlong
        for fn in (lib.dp_profile_wide, lib.dp_profile_wide_stripes):
            fn.argtypes = [vp, vp, ll, ll, ci, ci, ci, ci, ci, vp, vp, vp]
            fn.restype = ci
        lib.dp_profile_batched_staged.argtypes = [
            vp, vp, vp, ci, ll, ci, ci, ci, ci, ci, ci, vp, vp, vp]
        lib.dp_profile_batched_staged.restype = ci
        lib.dp_profile_batched_stripes.argtypes = [
            vp, vp, vp, ci, ll, ci, ci, ci, ci, ci, ci, ci, vp, vp, vp]
        lib.dp_profile_batched_stripes.restype = ci
        lib.dp_profile_batched_spans.argtypes = [
            vp, vp, vp, ci, ll, ci, ci, ci, ci, vp, vp, vp, vp, vp]
        lib.dp_profile_batched_spans.restype = ci
        lib.dp_profile_shard.argtypes = [vp, ll, ll, ci, ci, ci, ci, vp]
        lib.dp_profile_shard.restype = ci
        lib.dp_enable_peer.argtypes = [ci, ci]
        lib.dp_enable_peer.restype = ci
        lib.dp_wide_max_clusters.argtypes = [ci, ci, ci, ci]
        lib.dp_wide_max_clusters.restype = ci


def get(name):
    """The loaded ctypes library of kernel `name`, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all()
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_so_path(name)[1]))
            _configure(name, lib)
            _libs[name] = lib
    return _libs[name]


def check(err, what):
    """Raise when a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
