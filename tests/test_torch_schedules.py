"""The port's learning-rate schedules against the JAX package's, with and
without warmup, over every step of a run: within 1e-6 of the base rate
(the JAX schedules compute in float32, the port's in float64)."""

import pytest

from rethink_acoustic_image_enhancement_tpu.train import schedules as js
from rethink_acoustic_image_enhancement_tpu_torch.train import schedules as ts

BASE = 3e-4
STEPS = 130
CONFIGS = [
    {"type": "CosineAnnealingRestartCyclicLR", "periods": [40, 60, 30],
     "restart_weights": [1, 0.5, 1], "eta_mins": [3e-4, 1e-6, 0.0]},
    # KDLAET.yml's own (its eta_min above the base rate)
    {"type": "CosineAnnealingRestartCyclicLR", "periods": [90000, 8000],
     "restart_weights": [1, 1], "eta_mins": [3e-4, 1e-6]},
    {"type": "CosineAnnealingRestartLR", "periods": [50, 80],
     "restart_weights": [1, 0.7], "eta_min": 1e-6},
    {"type": "MultiStepLR", "milestones": [20, 60, 90], "gamma": 0.5},
    {"type": "MultiStepRestartLR", "milestones": [20, 60, 90, 110],
     "gamma": 0.3, "restarts": [0, 70], "restart_weights": [1, 0.5]},
    {"type": "LinearLR", "total_iter": STEPS},
    {"type": "VibrateLR", "total_iter": 1000},
    {"type": "TrueCosineAnnealingLR", "T_max": 100, "eta_min": 1e-7},
    {"type": "CosineAnnealingLR", "total_iter": 120},
]


@pytest.mark.parametrize("warmup", [-1, 25])
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["type"] + str(len(c)))
def test_schedule_matches_jax(cfg, warmup):
    want = js.build_schedule(BASE, cfg, warmup)
    got = ts.build_schedule(BASE, cfg, warmup)
    for step in range(STEPS):
        assert got(step) == pytest.approx(float(want(step)), abs=1e-6 * BASE,
                                          rel=1e-6), step


def test_names_match_and_unknown_fails():
    assert set(ts.SCHEDULERS) == {c["type"] for c in CONFIGS}
    with pytest.raises(KeyError, match="unknown scheduler"):
        ts.build_schedule(BASE, {"type": "StepLR"})
