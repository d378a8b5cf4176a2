"""Build-and-cache helper for the native C++ engines (LCB and POA).

Compiles a .cpp on first use into the package's gitignored `_build/`
directory, keyed by source mtime, with the same g++ recipe as the JAX
package (sibeliaz_tpu/utils/nativebuild.py); it surfaces the compiler's
stderr when g++ fails instead of a bare CalledProcessError.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

from sibeliaz_tpu_torch.utils.cudabuild import BUILD_DIR


def build_native(src: str, libname: str) -> str:
    """Compile `src` into the build directory as `libname` (if stale) and
    return the shared-object path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, libname)
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return lib
    with tempfile.NamedTemporaryFile(
        suffix=".so", dir=BUILD_DIR, delete=False
    ) as tmp:
        tmp_path = tmp.name
    cmd = [
        "g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-fopenmp",
        "-march=native", src, "-o", tmp_path,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp_path)
        raise RuntimeError(
            f"native build failed ({' '.join(cmd)}):\n{proc.stderr}"
        )
    os.replace(tmp_path, lib)
    return lib
