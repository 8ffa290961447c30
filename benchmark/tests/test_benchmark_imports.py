"""What the benchmark may import: never JAX or the package the port was
ported from, and in the reference nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark import harness as H

BENCH = os.path.join(H.ROOT, "benchmark")


def imported(path: str) -> set[str]:
    """The top-level names (before the first dot) a file imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(root: str) -> list[str]:
    return [os.path.join(d, f) for d, _, files in os.walk(root) for f in files
            if f.endswith(".py")]


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources(BENCH):
        bad = imported(path) & set(H.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in sources(os.path.join(BENCH, "reference")):
        got = imported(path)
        assert "mgnns_tpu_torch" not in got and not got & set(H.FORBIDDEN), path


def test_whole_names_are_compared(monkeypatch):
    """The port's name begins with the JAX package's: only whole top-level
    names count."""
    monkeypatch.setitem(sys.modules, "mgnns_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert not {"mgnns_tpu_torch_fake", "jaxlike"} & set(H.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in H.forbidden_modules()


def test_a_run_leaves_no_jax_in_sys_modules():
    """A whole CPU run of a small cell, then the check ``benchmark.run``
    makes once its window has closed."""
    code = ("import sys, time, torch; torch.set_num_threads(2)\n"
            "from benchmark.tests.tiny import tiny_cell\n"
            "from benchmark import harness as H\n"
            "cell = tiny_cell('textgcn-tumemo.serve-poisson')\n"
            "H.load_code('mixes', cell.params['mix']).run(cell, time.perf_counter())\n"
            "print(H.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=H.ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
