"""Port teacher against the flax teacher, with flax parameters carried
across by the port's weight bridge (CPU, float32)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import rethink_acoustic_image_enhancement_tpu.ops.pallas.stage as jstage
from rethink_acoustic_image_enhancement_tpu.convert.torch_export import (
    export_teacher,
    save_pth,
)
from rethink_acoustic_image_enhancement_tpu.models import REGISTRY as JAX_REGISTRY
from rethink_acoustic_image_enhancement_tpu.models.kdlae_teacher import (
    KDLAETeacher as JaxTeacher,
)
from rethink_acoustic_image_enhancement_tpu.ops.pallas.gdfn import _pick_tiles
from rethink_acoustic_image_enhancement_tpu_torch.convert import weights
from rethink_acoustic_image_enhancement_tpu_torch.models import (
    REGISTRY,
    KDLAETeacher,
    build_network,
    flagship_teacher,
)
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage_gate

torch.set_num_threads(2)

NARROW = dict(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
              heads=(1, 2, 4, 8), layernorm_type="BiasFree", static="train",
              params="cat")


def _inputs(h=32, w=40, rate=0.6, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((1, h, w, 3)).astype(np.float32)
    img[:, : h // 4, : w // 3] = 0.0
    return img, np.full((1, h, w, 1), rate, np.float32)


def _flax_params(cfg, img, rate, seed=0):
    """Seeded flax init, with LN weights and temperatures moved off 1."""
    p = JaxTeacher(**cfg).init(jax.random.PRNGKey(seed),
                               {"img": jnp.asarray(img),
                                "denoise_rate": jnp.asarray(rate)})["params"]
    rng = np.random.default_rng(seed + 100)

    def perturb(path, a):
        a = np.array(a)
        name = jax.tree_util.keystr(path)
        if "temperature" in name or "norm" in name:
            a = a * rng.uniform(0.6, 1.4, size=a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, p)


def _run_port(model, img, rate):
    with torch.no_grad():
        out = model({"img": torch.from_numpy(img).permute(0, 3, 1, 2),
                     "denoise_rate": torch.from_numpy(rate).permute(0, 3, 1, 2)})
    return {k: None if v is None else v.permute(0, 2, 3, 1).numpy()
            for k, v in out.items()}


@pytest.mark.parametrize("static,params,dual", [
    ("train", "cat", False), ("test", "none", False), ("train", "none", True)])
def test_narrow_teacher_matches_flax(static, params, dual):
    cfg = {**NARROW, "static": static, "params": params, "dual_pixel_task": dual}
    img, rate = _inputs()
    p = _flax_params(cfg, img, rate)
    ref = JaxTeacher(**cfg).apply({"params": p},
                                  {"img": img, "denoise_rate": rate})
    got = _run_port(weights.load_teacher_params(KDLAETeacher(**cfg), p).eval(),
                    img, rate)
    for key in ("hq", "sr"):
        if ref[key] is None:
            assert got[key] is None
            continue
        np.testing.assert_allclose(got[key], np.asarray(ref[key]),
                                   rtol=0, atol=1e-4, err_msg=key)


def _tiling_exists(b, h, w, c, num_heads, bias_free, use_bias, expansion=2.66):
    c_pad = -(-c // 128) * 128
    f_pad = -(-int(c * expansion) // 128) * 128
    return bool(bias_free) and c % num_heads == 0 and _pick_tiles(
        h, w, c_pad, max(f_pad, 2 * c_pad)) is not None


def test_narrow_teacher_fused_matches_pallas(monkeypatch):
    """Every stage with a tiling runs the stage: the plain version in the
    port, the interpreted Pallas kernel in the JAX package."""
    monkeypatch.setattr(jstage, "stage_worthwhile", _tiling_exists)
    monkeypatch.setattr(stage_gate, "stage_worthwhile", _tiling_exists)
    calls = []
    plain = pstage.stage_plain
    monkeypatch.setattr(pstage, "stage_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    img, rate = _inputs(32, 32, rate=1.0, seed=1)
    p = _flax_params(NARROW, img, rate, seed=1)
    ref = JaxTeacher(**NARROW, fused=True).apply(
        {"params": p}, {"img": img, "denoise_rate": rate})
    model = weights.load_teacher_params(KDLAETeacher(**NARROW, fused=True), p)
    got = _run_port(model.eval(), img, rate)
    assert len(calls) == 9  # every stage but the 4x4 latent
    for key in ("hq", "sr"):
        r = np.asarray(ref[key])
        assert np.abs(got[key] - r).max() / np.abs(r).max() <= 3e-2, key


def test_bridge_equals_torch_export():
    img, rate = _inputs(16, 16)
    p = _flax_params(NARROW, img, rate, seed=2)
    ref = export_teacher(p)
    got = weights.teacher_state_dict(p)
    assert list(got) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # and the names and shapes are exactly the port model's
    model_sd = KDLAETeacher(**NARROW).state_dict()
    assert set(got) == set(model_sd)
    for k, v in model_sd.items():
        assert tuple(got[k].shape) == tuple(v.shape), k


def test_load_reference_pth(tmp_path):
    img, rate = _inputs(16, 16)
    p = _flax_params(NARROW, img, rate, seed=3)
    path = str(tmp_path / "teacher.pth")
    save_pth(path, p, "KDLAE_teacher")
    model = weights.load_pth(KDLAETeacher(**NARROW), path)
    for k, v in weights.teacher_state_dict(p).items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)


def test_bf16_params_upcast():
    img, rate = _inputs(16, 16)
    p = _flax_params(NARROW, img, rate, seed=4)
    p16 = jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), p)
    sd = weights.teacher_state_dict(p16)
    assert all(v.dtype == torch.float32 for v in sd.values())
    k = "encoder_level1.0.attn.qkv.weight"
    np.testing.assert_array_equal(
        sd[k].numpy(), export_teacher(p16)[k].astype(np.float32))


def test_registry_and_flagship():
    cfg = {"type": "KDLAE_teacher", "inp_channels": 3, "out_channels": 3,
           "dim": 48, "num_blocks": [4, 6, 6, 8], "num_refinement_blocks": 4,
           "heads": [1, 2, 4, 8], "ffn_expansion_factor": 2.66, "bias": False,
           "LayerNorm_type": "BiasFree", "dual_pixel_task": False,
           "static": "train", "params": "cat"}
    net = build_network(cfg)
    flag = flagship_teacher(static="train")
    assert list(net.state_dict()) == list(flag.state_dict())
    assert set(REGISTRY) == set(JAX_REGISTRY)
    for name, (_, keymap) in REGISTRY.items():
        assert set(keymap) == set(JAX_REGISTRY[name][1]), name
    assert build_network({**cfg, "fused_resample": True}).down1_2.fused
    with pytest.raises(KeyError):
        build_network({**cfg, "no_such_option": True})
    with pytest.raises(ValueError):
        KDLAETeacher(params="plus")
