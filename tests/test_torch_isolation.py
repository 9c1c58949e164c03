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
# the port reads orbax checkpoints with its own OCDBT, zarr and zstd code
FORBIDDEN_ROOTS = {"jax", "flax", "jaxlib", "optax", "orbax", "tensorstore",
                   "zstandard", "ml_dtypes", JAX_PACKAGE}


def _port_modules():
    path = os.path.join(REPO, PORT)
    names = [PORT]
    for info in pkgutil.walk_packages([path], prefix=PORT + "."):
        names.append(info.name)
    return names


def test_every_port_module_imports_without_jax():
    modules = _port_modules()
    for name in ("ops.stage", "ops.layernorm", "ops.gdfn", "ops.block",
                 "ops.resize", "models.kdlae_student", "models.asdqe",
                 "eval.infer", "eval.asdqe_eval", "cli", "utils.doctor",
                 "utils.png", "utils.image_io", "losses", "losses.pixel",
                 "metrics", "metrics.psnr_ssim", "data.pairing",
                 "data.transforms", "data.file_client", "data.datasets",
                 "data.loader", "train.schedules", "train.mixup",
                 "train.progressive", "train.config", "train.trainer",
                 "train.checkpoints", "train.loop", "utils.logging",
                 "utils.tracking", "utils.watchdog", "utils.native",
                 "train.distill", "train.asdqe_trainer", "train.device_corpus",
                 "utils.profiling", "parallel", "parallel.collectives",
                 "metrics.niqe", "metrics.fid", "metrics.inception",
                 "data.lmdb_codec", "data.lmdb_util", "data.video_datasets",
                 "eval.bundle_submissions", "models.arch_utils", "models.embeds",
                 "ops.warp", "utils.download_weights", "utils.face_restoration",
                 "utils.flow", "utils.matlab", "utils.zstd", "convert.ocdbt",
                 "convert.orbax"):
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
