"""The port runs where JAX is absent: it imports neither jax nor the
sibeliaz_tpu package, and its CLI (native and oracle LCB engines)
reproduces the golden GFF and MAF (the tpu-fused and tpu engines the
native engine's GFF on a small input), its tools round-trip the golden MAF,
and its multi-device dry run passes every stage, in a process in which
both imports fail."""

import ast
import glob
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")

_CHILD = """
import sys
sys.modules["jax"] = None
sys.modules["sibeliaz_tpu"] = None
from sibeliaz_tpu_torch.cli import run
rc = run(sys.argv[1:])
assert sys.modules["jax"] is None and sys.modules["sibeliaz_tpu"] is None
sys.exit(rc)
"""


_TOOLS_CHILD = """
import contextlib, io, sys
sys.modules["jax"] = None
sys.modules["sibeliaz_tpu"] = None
from sibeliaz_tpu_torch.tools import main
maf, graph, *fastas = sys.argv[1:]
with contextlib.redirect_stdout(io.StringIO()) as out:
    assert main(["maf2gfa", maf, *fastas]) == 0
with open(graph, "w") as f:
    f.write(out.getvalue())
rc = main(["glue", graph])
assert sys.modules["jax"] is None and sys.modules["sibeliaz_tpu"] is None
sys.exit(rc)
"""


@pytest.mark.parametrize("flags", [["-n"], [], ["-n", "--lcb-engine", "oracle"]],
                         ids=["noalign", "maf", "oracle"])
def test_cli_runs_without_jax(tmp_path, flags):
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, "-k", "15", *flags, "--device", "cpu",
         "-o", str(out), os.path.join(EXAMPLES, "genome1.fa"),
         os.path.join(EXAMPLES, "genome2.fa")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    golden = os.path.join(EXAMPLES, "sibeliaz_out", "blocks_coords.gff")
    assert (out / "blocks_coords.gff").read_bytes() == open(golden, "rb").read()
    assert (out / "alignment.maf").exists() == (not flags)
    if not flags:
        golden = os.path.join(EXAMPLES, "sibeliaz_out", "alignment.maf")
        drop = lambda t: [l for l in t.splitlines() if not l.startswith("# cmd=")]  # noqa: E731
        assert drop((out / "alignment.maf").read_text()) == drop(open(golden).read())


@pytest.mark.parametrize("engine", ["tpu-fused", "tpu"])
def test_tpu_fused_runs_without_jax(tmp_path, engine):
    """`--lcb-engine tpu-fused` and `--lcb-engine tpu` with `--device cpu -n`
    in a process where jax and sibeliaz_tpu fail to import write the
    native engine's GFF."""
    import sys as _sys

    _sys.path.insert(0, os.path.join(REPO, "tests"))
    from sibeliaz_tpu_torch.io import fasta
    from torch_cases import related_genomes

    seqs, names = related_genomes(521, length=1200, mut=0.03, rearrange=True)
    fa = str(tmp_path / "genomes.fa")
    fasta.write_fasta(fa, [fasta.FastaRecord(n, s) for n, s in zip(names, seqs)])
    env = dict(os.environ, PYTHONPATH=REPO)
    for name in (engine, "native"):
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, "-k", "15", "-n", "--device", "cpu",
             "--lcb-engine", name, "-o", str(tmp_path / name), fa],
            cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode == 0, proc.stderr
    want = (tmp_path / "native" / "blocks_coords.gff").read_bytes()
    assert (tmp_path / engine / "blocks_coords.gff").read_bytes() == want
    assert want.count(b"\n") > 3


def test_tools_run_without_jax(tmp_path):
    """maf2gfa on the golden MAF and the FASTAs, then glue on the GFA that
    the port wrote, in a process where jax and sibeliaz_tpu fail to import:
    the glued genomes are the inputs."""
    fastas = [os.path.join(EXAMPLES, f"genome{g}.fa") for g in (1, 2)]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _TOOLS_CHILD,
         os.path.join(EXAMPLES, "sibeliaz_out", "alignment.maf"), str(tmp_path / "g.gfa"),
         *fastas],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "g.gfa").read_text().startswith("H\t")
    glued = dict(rec.split("\n", 1) for rec in proc.stdout[1:].rstrip("\n").split("\n>"))
    want = {}
    for path in fastas:
        for rec in open(path).read().split(">")[1:]:
            name, *lines = rec.split("\n")
            want[name.split()[0]] = "".join(lines).upper()
    assert glued == want


_DRYRUN_CHILD = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["sibeliaz_tpu"] = None
sys.argv = ["sibeliaz_tpu_torch.dryrun", *sys.argv[1:]]
try:
    runpy.run_module("sibeliaz_tpu_torch.dryrun", run_name="__main__")
finally:
    assert sys.modules["jax"] is None and sys.modules["sibeliaz_tpu"] is None
"""


def test_dryrun_runs_without_jax(tmp_path):
    """python -m sibeliaz_tpu_torch.dryrun --devices cpu,cpu where jax and
    sibeliaz_tpu fail to import: every stage passes (stage 2b, the fused
    lanes over 575 bundles, takes about a minute on the CPU)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _DRYRUN_CHILD, "--devices", "cpu,cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    for stage in ("stage1", "stage2", "stage2b", "stage3"):
        assert any(line.startswith(f"[dryrun] PASS {stage} ") for line in lines), proc.stdout
    assert not any("NOT PORTED" in line or "FAIL" in line for line in lines), proc.stdout


def test_chip_smoke_refuses_without_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_no_module_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(REPO, "sibeliaz_tpu_torch", "**", "*.py"),
                      recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    rel = {os.path.relpath(f, REPO) for f in files}
    for module in ("tools.py", "lcb/oracle.py", "lcb/device_bundles.py", "postprocess/maf.py",
                   "postprocess/gfa.py", "postprocess/xmfa.py", "postprocess/synteny.py",
                   "parallel/sharded.py", "parallel/multihost.py", "dryrun.py",
                   "lcb/batched_push_device.py", "lcb/resident.py", "lcb/fused.py",
                   "lcb/batched.py", "lcb/kernels.py"):
        assert os.path.join("sibeliaz_tpu_torch", module) in rel
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "sibeliaz_tpu"), (path, m)


# A path component "sibeliaz_tpu" (not "sibeliaz_tpu_torch"): the JAX
# package's directory.
_JAX_PACKAGE_PATH = re.compile(r"(^|[/\\])sibeliaz_tpu($|[/\\])")


def test_no_module_names_a_path_of_the_jax_package():
    """No .py file of the port, nor chip_smoke.py, names a file or directory
    under sibeliaz_tpu/: every string constant with a path component
    "sibeliaz_tpu" fails, be it an os.path.join part ("sibeliaz_tpu"), a
    path ("sibeliaz_tpu/lcb/native/engine.cpp") or an f-string's piece.
    Two kinds of strings may still name the JAX package's files, since they
    only point a reader at the counterpart: docstrings (comments are not in
    the AST), and the value of a "replaces" key in a dict literal
    (chip_smoke.py's kernels line, `"replaces": "file:line"`).  The port
    builds its own copies of the two native engines, byte-equal to the
    JAX package's below a header of comment lines."""
    files = glob.glob(os.path.join(REPO, "sibeliaz_tpu_torch", "**", "*.py"),
                      recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    labels = 0
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        allowed = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                first = node.body[0] if node.body else None
                if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                    allowed.add(id(first.value))
            elif isinstance(node, ast.Dict):
                for key, value in zip(node.keys, node.values):
                    if isinstance(key, ast.Constant) and key.value == "replaces":
                        allowed.add(id(value))
                        labels += isinstance(value, ast.Constant)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in allowed):
                assert not _JAX_PACKAGE_PATH.search(node.value), (path, node.lineno, node.value)
    assert labels >= 7  # the kernels line still names what each kernel replaces
    for copy, original in (("lcb/native/engine.cpp", "lcb/native/engine.cpp"),
                           ("align/native/poa.cpp", "align/native/poa.cpp")):
        with open(os.path.join(REPO, "sibeliaz_tpu_torch", copy), "rb") as f:
            ours = f.read()
        with open(os.path.join(REPO, "sibeliaz_tpu", original), "rb") as f:
            theirs = f.read()
        header = ours[:len(ours) - len(theirs)].splitlines()
        assert ours.endswith(theirs) and 1 <= len(header) <= 2, copy
        assert all(line.startswith(b"// ") for line in header), copy
