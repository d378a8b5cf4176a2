"""The port runs where JAX is absent: it imports neither jax nor the
sibeliaz_tpu package, and its CLI reproduces the golden GFF and MAF in a
process in which both imports fail."""

import ast
import glob
import os
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


@pytest.mark.parametrize("flags", [["-n"], []], ids=["noalign", "maf"])
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
