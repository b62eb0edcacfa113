"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark.tests.bench_tiny import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "stark_tpu"}
BENCH = os.path.join(REPO, "benchmark")


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def _sources(sub: str = ""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        if "tests" in dirpath.split(os.sep) or ".cache" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_whole_word_rule():
    tops = {n.split(".")[0] for n in ("stark_tpu_torch.protocol.runner", "stark_tpu.ops")}
    assert tops & FORBIDDEN == {"stark_tpu"}


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources("ref"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN | {"stark_tpu_torch"}, (path, name)
            if top == "benchmark":
                assert name.startswith("benchmark.ref"), (path, name)


def test_a_run_loads_no_jax(tmp_path):
    """A tiny run in a fresh process: afterwards sys.modules holds none of
    the forbidden names (the harness itself refuses to print otherwise)."""
    from benchmark.tests.bench_tiny import make_root

    root = make_root(str(tmp_path))
    code = (
        "import sys; sys.path.insert(0, sys.argv[2])\n"
        "from benchmark.tests.bench_tiny import run_cell\n"
        "rc, line, err = run_cell(sys.argv[1], 'chain23-b2s-stream', seconds=1)\n"
        "assert rc == 0 and line is not None, err\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', "
        "'stark_tpu'}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code, root, REPO], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
