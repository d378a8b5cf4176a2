"""Build-and-cache helper for the native C++ engines (LCB and POA).

Compiles a .cpp on first use into the package's gitignored `_build/`
directory with g++ -O3 -fopenmp -march=native.  The library is named by a
hash of the source bytes and the compiler flags (`libszlcb.so` becomes
`libszlcb-<sha256[:16]>.so`), as utils/cudabuild.py names the kernels'
library: a library whose name matches was built from these bytes, so an
edited source rebuilds and an unchanged one is reused.  A failed build
raises with the compiler's stderr instead of a bare CalledProcessError.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

from sibeliaz_tpu_torch.utils.cudabuild import BUILD_DIR

GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-fopenmp", "-march=native"]


def build_native(src: str, libname: str) -> str:
    """Compile `src` into the build directory, named `libname` with the
    hash of its bytes and flags, unless that library exists; return its
    path."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(" ".join(["g++", *GXX_FLAGS]).encode())
        digest.update(f.read())
    stem, ext = os.path.splitext(libname)
    lib = os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}{ext}")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.NamedTemporaryFile(
        suffix=ext, dir=BUILD_DIR, delete=False
    ) as tmp:
        tmp_path = tmp.name
    cmd = ["g++", *GXX_FLAGS, src, "-o", tmp_path]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp_path)
        raise RuntimeError(
            f"native build failed ({' '.join(cmd)}):\n{proc.stderr}"
        )
    os.replace(tmp_path, lib)
    return lib
