"""No run loads JAX or the JAX package, compared by whole top-level names,
and the plain references import nothing of the program under test."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark.core.cell import BENCH, ROOT
from benchmark.core.harness import FORBIDDEN

PORT = "rethink_acoustic_image_enhancement_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.module
            elif node.level == 1 and path.parent.name == "reference":
                yield f"benchmark.reference.{node.module}"
            else:
                yield f"benchmark.{node.module}"
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            yield "<dynamic>"


def test_reference_imports_only_torch_numpy_and_itself():
    for path in sorted((BENCH / "reference").glob("*.py")):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in ("__future__", "contextlib", "math", "numpy", "torch", "benchmark"), \
                (path.name, name)
            assert not name.startswith("benchmark.") or name.startswith("benchmark.reference"), \
                (path.name, name)


def test_forbidden_names_are_compared_whole():
    assert PORT.startswith(FORBIDDEN[-1])  # why the comparison is by whole names
    assert PORT.split(".")[0] not in FORBIDDEN


def test_cells_load_no_jax(tiny):
    """Every cell, tiny, in a fresh process: the harness itself raises where
    a forbidden module was loaded; the process also reports what it holds."""
    code = (
        "import sys, time, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.core import harness\n"
        "from pathlib import Path\n"
        "names = [w['name'] for w in json.load(open(Path(sys.argv[1]) / 'BENCHMARK.json'))['workloads']]\n"
        "for n in names:\n"
        "    res, _ = harness.run(n, 9, 0.1, False, 'cpu', time.perf_counter(), Path(sys.argv[1]),"
        " log=lambda *a: None)\n"
        "    assert res['correct'], n\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code, str(tiny)], capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": str(tiny)})
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PORT in tops and not tops & set(FORBIDDEN)
