"""The port's device probe (``utils/doctor.py``) and its two callers in the
CLI: ``doctor --platform cpu`` answers within its timeout; a probe that
hangs past its timeout is reported as wedged, and ``doctor`` and ``serve``'s
preflight then exit with ``EXIT_BACKEND_DOWN``; without a GPU the default
probe reports an error."""

import json
import sys
import time

import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch import cli
from rethink_acoustic_image_enhancement_tpu_torch.utils import doctor


@pytest.fixture
def hanging_probe(monkeypatch):
    monkeypatch.setattr(doctor, "_child_argv", lambda *a: [
        sys.executable, "-c", "import time; time.sleep(60)"])


def test_cpu_probe_answers_within_its_timeout(capsys):
    t0 = time.monotonic()
    rc = cli.main(["doctor", "--platform", "cpu", "--probe-timeout", "120",
                   "--bandwidth-mb", "1", "--json"])
    assert time.monotonic() - t0 < 120
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    backend = report["backend"]
    assert backend["status"] == "ok" and backend["platform"] == "cpu", backend
    assert backend["n_devices"] == 1
    for key in ("first_call_s", "dispatch_ms", "h2d_mbps", "d2h_mbps"):
        assert backend[key] >= 0, key
    assert report["torch"] == torch.__version__


def test_hanging_probe_is_reported_as_wedged(hanging_probe, capsys):
    t0 = time.monotonic()
    probe = doctor._probe_backend(2.0, 1.0, "cpu")
    assert time.monotonic() - t0 < 30
    assert probe["status"] == "wedged", probe
    assert cli.main(["doctor", "--probe-timeout", "2"]) == doctor.EXIT_BACKEND_DOWN
    assert "device WEDGED" in capsys.readouterr().out


def test_serve_refuses_to_start_on_a_wedged_device(hanging_probe, tmp_path, capsys):
    rc = cli.main(["serve", "--weights", "teacher", "--watch", str(tmp_path),
                   "--output", str(tmp_path / "out"), "--once", "--device", "cpu",
                   "--preflight-timeout", "2"])
    assert rc == doctor.EXIT_BACKEND_DOWN
    assert "refusing to start" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


def test_gpu_probe_without_a_gpu_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    probe = doctor._probe_backend(120.0, 1.0, "")
    assert probe["status"] == "error" and "no CUDA device" in probe["detail"], probe
    report = doctor.run_doctor(120.0, 1.0, "")
    assert "device ERROR" in doctor.format_report(report)
