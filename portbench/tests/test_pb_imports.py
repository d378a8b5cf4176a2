"""Import guard: the benchmark loads neither JAX nor the JAX package, the
reference nothing of the program, and nothing reads the old benchmark.
Module names are compared by their top-level name, whole: the port's
package, sibeliaz_tpu_torch, begins with the JAX package's name."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PB = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "sibeliaz_tpu"}


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(PB, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    for path in sources():
        if os.path.basename(path) == "test_pb_imports.py":
            continue
        bad = set(top_imports(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        names = set(top_imports(path))
        assert not names & (FORBIDDEN | {"sibeliaz_tpu_torch", "torch"}), (path, names)


def code_strings(path):
    """String constants of a module that are not docstrings."""
    with open(path) as f:
        tree = ast.parse(f.read())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def test_nothing_reads_the_old_benchmark():
    for path in sources():
        if os.path.basename(path) == "test_pb_imports.py":
            continue
        for s in code_strings(path):
            assert "benchmarks" not in s and "bench.py" not in s, (path, s)
        assert {"bench", "benchmarks"}.isdisjoint(top_imports(path)), path


def test_a_run_loads_no_jax():
    """The harness, the program's entry and every module they load, in a
    fresh process: no top-level name of JAX or the JAX package."""
    code = ("import sys; sys.path.insert(0, %r); import portbench.run as r; "
            "from portbench.reference import check; import sibeliaz_tpu_torch.cli, "
            "sibeliaz_tpu_torch.pipeline; print(r.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, ROOT)
    import portbench.run as r

    saved = dict(sys.modules)
    try:
        sys.modules["sibeliaz_tpu_torch_x"] = sys
        assert "sibeliaz_tpu" not in r.forbidden_modules()
        sys.modules["sibeliaz_tpu.core"] = sys
        assert "sibeliaz_tpu" in r.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]
