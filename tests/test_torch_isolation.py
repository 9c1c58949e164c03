"""The port imports neither JAX, flax nor the JAX package."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "rethink_acoustic_image_enhancement_tpu_torch"
JAX_PACKAGE = "rethink_acoustic_image_enhancement_tpu"
FORBIDDEN_ROOTS = {"jax", "flax", "jaxlib", "optax", "orbax", JAX_PACKAGE}


def _port_modules():
    path = os.path.join(REPO, PORT)
    names = [PORT]
    for info in pkgutil.walk_packages([path], prefix=PORT + "."):
        names.append(info.name)
    return names


def test_every_port_module_imports_without_jax():
    modules = _port_modules()
    for name in ("ops.stage", "ops.layernorm", "ops.gdfn", "ops.block",
                 "eval.infer"):
        assert f"{PORT}.{name}" in modules, name
    code = "\n".join([
        "import importlib, sys",
        *[f"sys.modules[{name!r}] = None" for name in sorted(FORBIDDEN_ROOTS)],
        f"for m in {modules!r}:",
        "    importlib.import_module(m)",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _scanned_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, PORT)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _scanned_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import_in_source(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN_ROOTS, (path, name)
        # the exact JAX package name, not the port's own (same prefix)
        assert name != JAX_PACKAGE and not name.startswith(JAX_PACKAGE + "."), (
            path, name)
