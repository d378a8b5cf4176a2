"""Build and load the port's CUDA kernels (csrc/*.cu) for Hopper.

Each source compiles with its own nvcc, all started together, and one
more nvcc links the objects into a shared library with a plain C
interface, which ctypes loads; nothing includes PyTorch's headers, so a
build takes seconds.  The library lands in the package's gitignored
`_build/` directory, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.  The first kernel launch
triggers the build; `build()` can also be called up front.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "need the CUDA toolkit"
        )
    return path


def build() -> tuple[str, str]:
    """Compile csrc/*.cu if no library for these sources exists yet.

    Returns (library path, nvcc's `-Xptxas -v` report)."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    stem = os.path.join(BUILD_DIR, f"libsz_kernels_{digest.hexdigest()[:16]}")
    lib, log = stem + ".so", stem + ".log"
    if os.path.exists(lib):
        with open(log) as f:
            return lib, f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp_dir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        jobs = []
        for src in sources:
            obj = os.path.join(tmp_dir, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )))
        reports = [(cmd, proc.communicate()[1], proc.returncode)
                   for cmd, _obj, proc in jobs]
        for cmd, err, rc in reports:
            if rc != 0:
                raise RuntimeError(f"CUDA build failed ({' '.join(cmd)}):\n{err}")
        tmp_lib = os.path.join(tmp_dir, "lib.so")
        cmd = [nvcc, "-shared", "-o", tmp_lib, *(obj for _c, obj, _p in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"CUDA link failed ({' '.join(cmd)}):\n{proc.stderr}")
        report = "".join(err for _cmd, err, _rc in reports)
        with open(log, "w") as f:
            f.write(report)
        os.replace(tmp_lib, lib)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return lib, report


_vp, _i64, _i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# The C interface of csrc/*.cu: each function's argument types; the return
# type is int but where _RESTYPES says otherwise.
SIGNATURES = {
    "sz_front_half": [_vp, _vp, _i64, _i32, _vp, _vp, _vp, _vp],
    "sz_front_half_tile_positions": [],
    "sz_class_tile_rows": [],
    "sz_class_scratch_bytes": [_i64],
    "sz_class_analysis": [_vp, _vp, _vp, _vp, _i64, _vp, _vp, _vp, _vp],
    "sz_poa_dp_tb": ([_vp] * 7 + [_i32] * 5 + [_vp, _vp, _i32] + [_vp] * 5
                     + [_i32, _vp] + [_i32] * 3
                     + [ctypes.POINTER(ctypes.c_float), _vp]),
    "sz_poa_chain_probe": [_i32, _i32, _vp, _vp],
    "sz_round_max_rounds": [],
    "sz_round_tile_rows": [],
    "sz_round_scratch_bytes": [_i64, _i32],
    "sz_round_append": [_vp, _vp, _vp, _i64, _i64, _i32, _i32, _i32, _i64] + [_vp] * 7,
    "sz_lcb_walk": [_vp] * 6 + [_i64, _i64, _i32, _i32] + [_i64] * 4 + [_i32, _vp],
    "sz_lcb_chain_probe": [_vp, _i32, _vp, _vp],
}
_RESTYPES = {"sz_class_scratch_bytes": _i64, "sz_round_scratch_bytes": _i64}


def bind(lib: ctypes.CDLL, names=None) -> ctypes.CDLL:
    """Give `lib`'s functions `names` (all of SIGNATURES by default) their
    argument and return types."""
    for name in names or SIGNATURES:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(build()[0]))
    return _lib
