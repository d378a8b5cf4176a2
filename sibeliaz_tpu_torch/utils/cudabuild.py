"""Build and load the port's CUDA kernels (csrc/*.cu) for Hopper.

Each source compiles with its own nvcc, all started together (the
headers, csrc/*.cuh, are included by the sources that share their device
code), and one
more nvcc links the objects into a shared library with a plain C
interface, which ctypes loads; nothing includes PyTorch's headers, so a
build takes seconds.  The library lands in the package's gitignored
`_build/` directory, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.  The first kernel launch
triggers the build; `build()` can also be called up front.  A build with
`defines` (K7's stamped build, `("SZ_STEP_STAMPS",)`, which only
chip_smoke.py --step asks for) adds a -D flag each, so it hashes to a
library of its own beside the default one.
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

_libs = {}


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


def build(defines=()) -> tuple[str, str]:
    """Compile csrc/*.cu (with the csrc/*.cuh they include), each macro of
    `defines` defined, if no library for these sources and flags exists
    yet.

    Returns (library path, nvcc's `-Xptxas -v` report)."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in sources + headers:
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
            cmd = [nvcc, *flags, "-c", "-o", obj, src]
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
    "sz_lcb_walk": [_vp] * 5 + [_i64, _i64, _i32, _i32] + [_i64] * 4 + [_i32, _vp],
    "sz_lcb_walk_blocks_per_sm": [_i32, _i32],
    "sz_lcb_chain_probe": [_vp, _i32, _vp, _vp],
    "sz_lcb_step_probe": [_vp, _i32, _vp, _vp],
    "sz_lcb_vote": ([_vp] * 6 + [_i32, _vp, _i64, _i64] + [_i32] * 4 + [_i64] * 3
                    + [_i32, _vp]),
    "sz_lcb_vote_workspace_words": [_i32, _i32, _i32],
    "sz_lcb_vote_blocks_per_sm": [_i32, _i32, _i32],
    "sz_lcb_vote_probe": [_vp, _i32, _vp, _vp],
    "sz_lcb_step": ([_vp] * 6 + [_i32, _i64, _i32, _i32, _i64, _i32] + [_i64] * 6
                    + [_i32, _i64, _i64, _i32, _vp, _vp]),
    "sz_lcb_step_blocks_per_sm": [_i32] * 5 + [_vp],
    "sz_lcb_step_result_rows": [],
    "sz_lcb_step_stamp_parts": [],
    "sz_lcb_step_workspace_words": [_i32] * 4,
    "sz_lcb_seed": [_vp, _vp, _i64, _i64, _i32, _i32, _vp, _vp, _vp],
    "sz_lcb_seed_outputs": [],
    "sz_lcb_seed_smem": [_i32],
}
_RESTYPES = {"sz_class_scratch_bytes": _i64, "sz_round_scratch_bytes": _i64,
             "sz_lcb_vote_workspace_words": _i64, "sz_lcb_step_workspace_words": _i64,
             "sz_lcb_seed_smem": _i64}


def bind(lib: ctypes.CDLL, names=None) -> ctypes.CDLL:
    """Give `lib`'s functions `names` (all of SIGNATURES by default) their
    argument and return types."""
    for name in names or SIGNATURES:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def load(defines=()) -> ctypes.CDLL:
    """The loaded kernel library (built with `defines`), built on first
    use."""
    defines = tuple(defines)
    if defines not in _libs:
        _libs[defines] = bind(ctypes.CDLL(build(defines)[0]))
    return _libs[defines]
