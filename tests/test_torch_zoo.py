"""The port's zoo (``artifacts/torch_zoo/``, written by
``scripts/export_torch_zoo.py``): every committed ``.pth`` equals its orbax
source bit for bit (read through the JAX package's loader), the manifest's
sha256 values match the files, the script gives the same bytes twice, the
files load into the port's models with ``strict=True`` (the scorer's running
statistics included), and ``load_pth`` reads 'params_ema', a bare state dict
and a ``module.`` prefix."""

import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.convert import weights
from rethink_acoustic_image_enhancement_tpu_torch.models import (
    DenoiseRatePredictor,
    KDLAEStudent,
    flagship_teacher,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(REPO, "artifacts", "torch_zoo")
COMMITTED = ["teacher", "student-us", "student-fls", "asdqe"]


@pytest.fixture(scope="module")
def script():
    pytest.importorskip("orbax.checkpoint")
    spec = importlib.util.spec_from_file_location(
        "export_torch_zoo", os.path.join(REPO, "scripts", "export_torch_zoo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ZOO, "manifest.json")) as fh:
        return json.load(fh)


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _np_bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("name", COMMITTED)
def test_committed_pth_equals_the_orbax_source(script, manifest, name):
    ref = script.reference_state_dict(name)
    got = torch.load(os.path.join(ZOO, f"{name}.pth"), map_location="cpu",
                     weights_only=True)
    assert set(got) == {"params"}
    got = got["params"]
    assert set(got) == set(ref)
    for k, v in ref.items():
        t = got[k]
        assert tuple(t.shape) == v.shape, k
        assert str(t.dtype).replace("torch.", "") == v.dtype.name, k
        np.testing.assert_array_equal(_bits(t), _np_bits(np.asarray(v)), err_msg=k)
    # the script reproduces the committed bytes
    data = script.serialize(ref)
    assert hashlib.sha256(data).hexdigest() == manifest[name]["sha256"]


@pytest.mark.parametrize("name", COMMITTED)
def test_manifest_matches_the_files(manifest, name):
    entry = manifest[name]
    with open(os.path.join(ZOO, entry["file"]), "rb") as fh:
        data = fh.read()
    assert hashlib.sha256(data).hexdigest() == entry["sha256"]
    assert len(data) == entry["bytes"]
    assert entry["dtype"] == (["bfloat16"] if name == "teacher" else ["float32"])
    assert entry["parameters"] == {"teacher": 26_882_940, "asdqe": 3_432_737}.get(
        name, 294_449)


def test_committed_zoo_is_small():
    total = sum(os.path.getsize(os.path.join(ZOO, f"{n}.pth")) for n in COMMITTED)
    assert total <= 75e6, total


def test_script_is_deterministic(script, tmp_path):
    for out in ("a", "b"):
        assert script.main(["--out", str(tmp_path / out), "--only", "student-us",
                            "student-fls"]) == 0
    for name in ("student-us.pth", "student-fls.pth", "manifest.json"):
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
    assert ((tmp_path / "a" / "student-us.pth").read_bytes()
            == open(os.path.join(ZOO, "student-us.pth"), "rb").read())


def _model(name):
    if name == "teacher":
        return flagship_teacher(static="train")
    if name == "asdqe":
        return DenoiseRatePredictor()
    return KDLAEStudent(residual=True, hidden_channels=(16, 32, 64))


@pytest.mark.parametrize("name", COMMITTED)
def test_zoo_loads_strict_into_the_port(script, name):
    model = weights.load_pth(_model(name), os.path.join(ZOO, f"{name}.pth"))
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    want = script.reference_state_dict(name)
    sd = model.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():  # upcast exactly (bf16 -> fp32 is exact)
        v = np.asarray(v)
        ref = torch.from_numpy(v.astype(np.float32) if v.dtype.name == "bfloat16" else v)
        assert torch.equal(sd[k], ref.to(sd[k].dtype)), k
    if name == "asdqe":  # the running statistics are the trained ones
        assert any(k.endswith("running_var") and not torch.all(sd[k] == 1) for k in sd)


@pytest.mark.parametrize("layout", ["params_ema", "bare", "module_prefix"])
def test_load_pth_layouts(tmp_path, layout):
    torch.manual_seed(0)
    src = KDLAEStudent(residual=True, hidden_channels=(4, 8))
    sd = src.state_dict()
    path = str(tmp_path / "w.pth")
    if layout == "params_ema":
        torch.save({"params": {k: torch.zeros_like(v) for k, v in sd.items()},
                    "params_ema": sd}, path)
        key = "params_ema"
    elif layout == "bare":
        torch.save(sd, path)
        key = None
    else:
        torch.save({"params": {f"module.{k}": v for k, v in sd.items()}}, path)
        key = "params"
    got = weights.load_pth(KDLAEStudent(residual=True, hidden_channels=(4, 8)), path, key)
    for k, v in got.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(RuntimeError, match=r"Error\(s\) in loading"):
        weights.load_pth(KDLAEStudent(residual=True, hidden_channels=(4, 8, 16)), path, key)
