"""The device-resident corpora and the step's extra mask on an NVIDIA GPU.

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:
    python -m pytest --noconftest -m cuda tests/test_torch_device_corpus_cuda.py
Every test here is marked ``cuda`` and skips where there is no GPU:

  * the step's extra mask draws its uniforms on the device from the step's
    generator, and copies nothing from the host;
  * a device-resident student step (the sampler, then ``Trainer.step``)
    makes no host-to-device copy larger than its ids and scalars (4 KiB);
  * each corpus's batches on the card equal its batches on the CPU given
    the same draws (within 1e-6 where Gaussian noise is added).
"""

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.ops.mask import mask_with_keep
from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
from rethink_acoustic_image_enhancement_tpu_torch.train import device_corpus as tdc
from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
from rethink_acoustic_image_enhancement_tpu_torch.train.progressive import stage_extra_mask
from rethink_acoustic_image_enhancement_tpu_torch.utils import profiling
from torch_train_corpus import (device_student_config, write_siqa_corpus, write_student_corpus,
                                write_teacher_corpus, write_yml)

MAX_UPLOAD = 4096  # bytes: a step's ids and scalars


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _uploads(tmp_path, fn):
    """The bytes of each host-to-device copy of fn(), as the dispatcher
    sees them; the trace of another call sees none larger."""
    fn()
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        fn()
        torch.cuda.synchronize()
    traced = profiling.h2d_copies(str(tmp_path))
    with profiling.uploads() as copies:
        fn()
        torch.cuda.synchronize()
    assert all(b is not None and b <= max(copies, default=0) for b in traced), (traced, copies)
    return copies


@pytest.mark.cuda
def test_extra_mask_draws_on_the_device(cuda, tmp_path):
    lq = torch.rand((4, 7, 64, 64), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    state = gen.get_state()
    got = stage_extra_mask(lq, gen, 0.05)
    want = mask_with_keep(lq, torch.rand(lq.shape, generator=torch.Generator(
        device=cuda).manual_seed(3), device=cuda) >= 0.05)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    gen.set_state(state)
    assert _uploads(tmp_path, lambda: stage_extra_mask(lq, gen, 0.05)) == []
    lq_dict = {"img": lq[:, :3], "denoise_rate": lq[:, :1]}
    out = stage_extra_mask(lq_dict, gen, 0.3)
    assert out["img"].device.type == "cuda" and out["denoise_rate"] is lq_dict["denoise_rate"]


@pytest.mark.cuda
def test_device_resident_step_uploads_ids_only(cuda, tmp_path):
    roots = write_student_corpus(str(tmp_path / "frames"), 16, 64, 64, seed=2)
    cfg = device_student_config(roots, 10)
    cfg["network_g"]["hidden_channels"] = [16, 32, 64]
    opt = tcfg.parse(write_yml(cfg, tmp_path / "opt.yml"), True, root_path=str(tmp_path))
    _, trainer = tloop.build_everything(opt, device=cuda)
    state = trainer.init_state()
    corpus = tdc.build_device_corpus(opt["datasets"]["train"], cuda)
    it = [0]

    def step():
        it[0] += 1
        gen = tdc.seeded_generator(cuda, 0, it[0])
        lq, gt = corpus.sample_batch(gen, np.array([3, 1]), gt_size=16)
        trainer.step(state, lq, gt, np.random.default_rng(it[0]), extra_prob=0.2, gen=gen)

    copies = _uploads(tmp_path / "trace", step)
    assert 0 < len(copies) and max(copies) <= MAX_UPLOAD, copies


def _to(draws, device):
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in draws.items()}


def _same(a, b, atol=0.0):
    if isinstance(a, dict):
        for k in a:
            _same(a[k], b[k], atol)
        return
    torch.testing.assert_close(a.cpu(), b, rtol=0, atol=atol)


@pytest.mark.cuda
def test_card_batches_equal_cpu_batches(cuda, tmp_path):
    cpu = torch.device("cpu")
    s_roots = write_student_corpus(str(tmp_path / "s"), 12, 40, 48, seed=1, blank=(0, 1, 2))
    s_opt = {"type": "Dataset_PairedMutiImage", "phase": "train", **s_roots,
             "num_pairs": 5, "stride_range": [1, 1], "prob": 0.1, "gt_size": 32,
             "geometric_augs": True}
    t_roots = write_teacher_corpus(str(tmp_path / "t"), 5, 36, 44, seed=2)
    t_opt = {"type": "Dataset_SuperRestoration_param", "phase": "train", **t_roots,
             "gt_size": 24, "geometric_augs": True}
    q_roots = write_siqa_corpus(str(tmp_path / "q"), 4, 40, 36, seed=3)
    q_opt = {"dataroot_lq": q_roots["dataroot_lq"], "dataroot_gt": q_roots["dataroot_gt"],
             "gt_size": 32, "geometric_augs": True}
    for cls, opt, ids, atol in ((tdc.StudentDeviceCorpus, s_opt, [0, 1, 2, 5, 7] * 2, 1e-6),
                                (tdc.TeacherDeviceCorpus, t_opt, [0, 1, 2, 3, 4] * 4, 1e-6),
                                (tdc.SIQADeviceCorpus, q_opt, [0, 1, 2, 3] * 3, 0.0)):
        on_cpu, on_card = cls(opt, device=cpu), cls(opt, device=cuda)
        draws = on_cpu.draw(tdc.seeded_generator(cpu, 5), on_cpu.ids(ids), None)
        want = on_cpu.apply(on_cpu.ids(ids), draws)
        got = on_card.apply(on_card.ids(ids), _to(draws, cuda))
        for g, w in zip(got, want):
            _same(g, w, atol)
        # the card's own draws stay on the card
        out = on_card.sample_batch(tdc.seeded_generator(cuda, 5), ids)
        assert all(t.device.type == "cuda" for t in torch.utils._pytree.tree_leaves(out))
