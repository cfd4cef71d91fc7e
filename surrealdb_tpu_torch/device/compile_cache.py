"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into its
own shared library with a plain C interface, and loaded with `ctypes`.
The build happens at first use, never at import, into
`<checkout>/build/torch_kernels/<hash>/`, where the hash covers the
sources and the compiler flags: a runner restart (or a second process)
loads the libraries a first one built. All sources are compiled in
parallel, one `nvcc` each. A failed build raises; nothing falls back.
`status()` reports the directory, whether this process built or found
the libraries, and the build seconds.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

from surrealdb_tpu_torch.device import kernelstats

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
SOURCES = ("distance.cu", "select.cu", "rank_rescore.cu", "csr_hop.cu",
           "rank_int8.cu", "ann_descent.cu", "mesh_merge.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict = {}
_STATUS = {"dir": None, "hits": 0, "misses": 0, "build_s": None}


def build_root() -> str:
    checkout = os.path.dirname(os.path.dirname(CSRC))
    return os.path.join(checkout, "build", "torch_kernels")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh", ".h")):
            h.update(name.encode())
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def build_dir() -> str:
    return os.path.join(build_root(), _source_hash())


def _build_all(out_dir: str) -> float:
    """Compile every source not yet built in `out_dir`, all at once.
    Returns the wall seconds spent (0.0 when everything was there)."""
    want = [s for s in SOURCES
            if not os.path.exists(os.path.join(out_dir, _lib_name(s)))]
    if not want:
        return 0.0
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in want:
        tmp = os.path.join(out_dir, _lib_name(src) + f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{src}: nvcc exited {p.returncode}\n"
                          f"{out.decode(errors='replace')[-4000:]}")
            continue
        os.replace(tmp, os.path.join(out_dir, _lib_name(src)))
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def _lib_name(src: str) -> str:
    return "lib" + src.rsplit(".", 1)[0] + ".so"


def ensure_built() -> dict:
    """Build (or find) every kernel library and load it. Idempotent."""
    with _LOCK:
        if len(_LIBS) == len(SOURCES):
            return status()
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        # another process (the runner beside a script) may be building
        # the same hash: serialise on a lock file in the build dir
        with open(os.path.join(out_dir, ".lock"), "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                secs = _build_all(out_dir)
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)
        for src in SOURCES:
            _LIBS[src] = ctypes.CDLL(os.path.join(out_dir, _lib_name(src)))
        _STATUS["dir"] = out_dir
        if secs > 0:
            _STATUS["misses"] += 1
            _STATUS["build_s"] = secs
            kernelstats.note_compile("cuda_library")
        else:
            _STATUS["hits"] += 1
            kernelstats.note_hit("cuda_library")
        return status()


def library(src: str):
    """The loaded ctypes library built from `csrc/<src>`."""
    lib = _LIBS.get(src)
    if lib is None:
        ensure_built()
        lib = _LIBS[src]
    return lib


def status() -> dict:
    out = dict(_STATUS)
    out["built"] = sorted(_LIBS)
    return out


def declare(lib, name: str, argtypes):
    """Bind one exported C function: every kernel entry returns its
    `cudaError_t` as an int."""
    fn = getattr(lib, name)
    if getattr(fn, "_declared", False):
        return fn
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    fn._declared = True
    return fn


def check(err: int, what: str):
    """Raise when a kernel entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError {err}")
