"""The port stands alone: a directory that holds only a copy of
sibeliaz_tpu_torch/ and the two example FASTAs runs the CLI on the CPU to
the golden GFF and MAF, building the native engines from the copy's own
sources into the copy's `_build/`; and the native build cache names each
library by the bytes it was built from."""

import ctypes
import glob
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")

_CHILD = """
import os, runpy, sys
sys.modules["jax"] = None
sys.modules["sibeliaz_tpu"] = None
sys.argv = ["sibeliaz_tpu_torch", *sys.argv[1:]]
try:
    runpy.run_module("sibeliaz_tpu_torch", run_name="__main__", alter_sys=True)
finally:
    import sibeliaz_tpu_torch
    here = os.path.join(os.getcwd(), "sibeliaz_tpu_torch", "__init__.py")
    assert os.path.samefile(sibeliaz_tpu_torch.__file__, here), sibeliaz_tpu_torch.__file__
    assert sys.modules["jax"] is None and sys.modules["sibeliaz_tpu"] is None
"""


def _drop_cmd(text):
    return [line for line in text.splitlines() if not line.startswith("# cmd=")]


@pytest.mark.parametrize("flags", [["-n"], []], ids=["noalign", "maf"])
def test_cli_runs_from_the_port_alone(tmp_path, flags):
    shutil.copytree(os.path.join(REPO, "sibeliaz_tpu_torch"),
                    tmp_path / "sibeliaz_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name in ("genome1.fa", "genome2.fa"):
        shutil.copy(os.path.join(EXAMPLES, name), tmp_path / name)
    assert sorted(os.listdir(tmp_path)) == ["genome1.fa", "genome2.fa", "sibeliaz_tpu_torch"]
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, "-k", "15", *flags, "--device", "cpu",
         "-o", "out", "genome1.fa", "genome2.fa"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = tmp_path / "out"
    golden = os.path.join(EXAMPLES, "sibeliaz_out")
    with open(os.path.join(golden, "blocks_coords.gff"), "rb") as f:
        assert (out / "blocks_coords.gff").read_bytes() == f.read()
    assert (out / "alignment.maf").exists() == (not flags)
    if not flags:
        with open(os.path.join(golden, "alignment.maf")) as f:
            assert _drop_cmd((out / "alignment.maf").read_text()) == _drop_cmd(f.read())
    build = tmp_path / "sibeliaz_tpu_torch" / "_build"
    assert len(glob.glob(str(build / "libszlcb-*.so"))) == 1
    assert len(glob.glob(str(build / "libszpoa-*.so"))) == (0 if flags else 1)


def test_native_build_is_named_by_its_bytes(tmp_path, monkeypatch):
    """An edited source builds a library of its own; the unedited bytes
    again find the first library without compiling."""
    from sibeliaz_tpu_torch.utils import nativebuild

    monkeypatch.setattr(nativebuild, "BUILD_DIR", str(tmp_path / "_build"))
    compiles = []
    real_run = subprocess.run

    def counting_run(cmd, *args, **kwargs):
        compiles.append(cmd)
        return real_run(cmd, *args, **kwargs)

    monkeypatch.setattr(nativebuild.subprocess, "run", counting_run)
    src = tmp_path / "tiny.cpp"
    first = 'extern "C" int sz_tiny() { return 1; }\n'
    src.write_text(first)
    lib1 = nativebuild.build_native(str(src), "libsztiny.so")
    src.write_text('extern "C" int sz_tiny() { return 2; }\n')
    lib2 = nativebuild.build_native(str(src), "libsztiny.so")
    assert lib1 != lib2 and len(compiles) == 2
    assert os.path.dirname(lib1) == str(tmp_path / "_build")
    assert os.path.basename(lib1).startswith("libsztiny-") and lib1.endswith(".so")
    mtime = os.path.getmtime(lib1)
    src.write_text(first)
    assert nativebuild.build_native(str(src), "libsztiny.so") == lib1
    assert len(compiles) == 2 and os.path.getmtime(lib1) == mtime
    assert ctypes.CDLL(lib1).sz_tiny() == 1 and ctypes.CDLL(lib2).sz_tiny() == 2
    src.unlink()
    with pytest.raises(FileNotFoundError):
        nativebuild.build_native(str(src), "libsztiny.so")
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="native build failed"):
        nativebuild.build_native(str(src), "libsztiny.so")
    assert sorted(os.listdir(tmp_path / "_build")) == sorted(
        os.path.basename(p) for p in (lib1, lib2))
