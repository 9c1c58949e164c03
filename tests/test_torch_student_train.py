"""The port's KDLAE-S student training against the JAX package's, on a
narrowed configs/KDLAES.yml (hidden [4, 8, 16]; 16-24 px frames; 5 frames):

  * one Trainer step: the L1-video loss, KDLAES's AdamW, the 0.01 clip and
    its schedule, with a stage crop on the last two axes of the stack and
    mixup of whole stacks (JAX's own draws fed to the port's deterministic
    cores); loss within 1e-5 relative, grad_norm within 5e-5, weights by
    the step rule (0.05 lr where the gradient exceeds 1e-6 of the largest,
    else 2 lr);
  * three steps of train_from_config against the JAX loop on the same
    corpus, weights and config (mixup off and one patch size, so that
    nothing is drawn on the device; the dataset's masks through the native
    masker); per-step loss, lr and grad_norm within 1e-5 relative, the final
    weights by the step rule;
  * frame-stack validation: PSNR and SSIM against JAX validate_model, each
    stack scored frame by frame and averaged (within 1e-4). Scoring a stack
    as one F-channel image, the loop's route before this repair, gives
    another number;
  * both KDLAES configs pass validate, KDLAES_FLS_ft.yml with its
    device-resident corpus (refused before the device corpora were ported);
    without it, and with the trained zoo student as its pretrained weights,
    it trains.
"""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from rethink_acoustic_image_enhancement_tpu.convert.torch_import import CONVERTERS
from rethink_acoustic_image_enhancement_tpu.data import datasets as jds
from rethink_acoustic_image_enhancement_tpu.data import loader as jld
from rethink_acoustic_image_enhancement_tpu.losses import build_loss as jax_loss
from rethink_acoustic_image_enhancement_tpu.metrics import get_metric
from rethink_acoustic_image_enhancement_tpu.models import build_network as jax_net
from rethink_acoustic_image_enhancement_tpu.parallel.mesh import make_mesh
from rethink_acoustic_image_enhancement_tpu.train import checkpoints as jckpt
from rethink_acoustic_image_enhancement_tpu.train import config as jcfg
from rethink_acoustic_image_enhancement_tpu.train import loop as jloop
from rethink_acoustic_image_enhancement_tpu.train import mixup as jmix
from rethink_acoustic_image_enhancement_tpu.train import progressive as jprog
from rethink_acoustic_image_enhancement_tpu.train import trainer as jtr
from rethink_acoustic_image_enhancement_tpu.train.schedules import (
    build_schedule as jax_schedule,
)
from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import (
    read_pth,
    student_state_dict,
)
from rethink_acoustic_image_enhancement_tpu_torch.data import datasets as tds
from rethink_acoustic_image_enhancement_tpu_torch.data import loader as tld
from rethink_acoustic_image_enhancement_tpu_torch.losses import build_loss
from rethink_acoustic_image_enhancement_tpu_torch.models import build_network
from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
from rethink_acoustic_image_enhancement_tpu_torch.train import mixup as tmix
from rethink_acoustic_image_enhancement_tpu_torch.train import progressive as tprog
from rethink_acoustic_image_enhancement_tpu_torch.train import trainer as ttr
from torch_train_corpus import REPO, write_student_corpus, write_yml

torch.set_num_threads(2)
KDLAES_YML = os.path.join(REPO, "configs", "KDLAES.yml")
FLS_YML = os.path.join(REPO, "configs", "KDLAES_FLS_ft.yml")
NARROW = [4, 8, 16]
LR = 1e-3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    return (write_student_corpus(str(root / "train"), 14, 24, 24, seed=1),
            write_student_corpus(str(root / "val"), 7, 20, 28, seed=2))


def student_config(train_roots, val_roots, hidden=NARROW, **train_ds):
    """configs/KDLAES.yml with the dataroots replaced, 5-frame stacks, a
    narrower network and the given training-set options; no TensorBoard."""
    with open(KDLAES_YML) as f:
        cfg = yaml.safe_load(f)
    cfg["datasets"]["train"].update(train_roots, num_pairs=5, **train_ds)
    if val_roots is None:
        del cfg["datasets"]["val"]
    else:
        cfg["datasets"]["val"].update(val_roots, num_pairs=5, stride_range=[1, 1])
    cfg["network_g"]["hidden_channels"] = list(hidden)
    cfg["logger"]["use_tb_logger"] = False
    return cfg


def _seeded_sd(cfg, seed=5):
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        return build_network(cfg["network_g"]).state_dict()


def _jax_params(sd):
    """A flax tree of copies (JAX on the CPU may alias numpy memory and
    write a donated step's results into it)."""
    return CONVERTERS["KDLAE_student"]({k: v.numpy().copy() for k, v in sd.items()})


def _step_rule(got, want, init, grads, lr, steps):
    tight, loose = 0.05 * lr * steps, 2 * lr * steps
    moved = 0
    for name, w in want.items():
        big = np.ones(w.shape, bool)
        for g in grads:
            gmax = max(np.abs(v).max() for v in g.values())
            big &= np.abs(g[name]) > 1e-6 * gmax
        diff = np.abs(got[name] - w)
        assert (diff <= np.where(big, tight, loose)).all(), (name, diff.max())
        moved += int((w != init[name]).sum())
    assert moved > 0.5 * sum(w.size for w in want.values())


def test_one_step_matches_jax():
    cfg = student_config({}, {})
    train_opt = cfg["train"]
    train_opt["optim_g"]["lr"] = LR
    train_opt["warmup_iter"] = -1  # KDLAES's 1000-step warm-up starts at lr 0
    sd = _seeded_sd(cfg)
    params = _jax_params(sd)
    rng = np.random.default_rng(0)
    lq = rng.random((3, 5, 24, 24), dtype=np.float32)
    gt = np.clip(lq + rng.normal(0, 0.05, lq.shape), 0, 1).astype(np.float32)

    # JAX: its trainer's step on the batch its own draws made
    key = jax.random.PRNGKey(3)
    k_crop, k_mix = jax.random.split(key)
    jlq, jgt = jprog.stage_crop(jnp.asarray(lq), jnp.asarray(gt), k_crop, 24, 16)
    jgt, jlq = jmix.mixing_augment(k_mix, jgt, jlq, 1.2, use_identity=False)
    schedule = jax_schedule(LR, train_opt["scheduler"], train_opt["warmup_iter"])
    mesh = make_mesh(n_data=1, devices=jax.devices()[:1])
    model = jax_net(cfg["network_g"])
    trainer = jtr.Trainer(apply_fn=jtr.make_student_apply(model),
                          loss_fn=jax_loss(train_opt["pixel_opt"]),
                          optimizer=jtr.build_optimizer(train_opt, schedule, params=params),
                          schedule=schedule, mesh=mesh)
    state = jax.device_put(trainer.init_state(params), NamedSharding(mesh, P()))
    state, jm = trainer.step(state, np.asarray(jlq), np.asarray(jgt), jax.random.PRNGKey(9))
    want = {k: v.numpy() for k, v in student_state_dict(state.params).items()}

    # the port: its cores on the same crop offsets and mixing draws
    ry, rx = jax.random.split(k_crop)
    y0, x0 = (int(jax.random.randint(r, (), 0, 8)) for r in (ry, rx))
    _, r_lam, r_perm = jax.random.split(k_mix, 3)
    lam = float(jax.random.beta(r_lam, 1.2, 1.2))
    perm = np.asarray(jax.random.permutation(r_perm, 3))
    tlq = tmix._mix_tree(tprog.crop_at(torch.from_numpy(lq), y0, x0, 16), lam, perm)
    tgt = tmix._mix_tree(tprog.crop_at(torch.from_numpy(gt), y0, x0, 16), lam, perm)
    assert tlq.shape == (3, 5, 16, 16)
    np.testing.assert_allclose(tlq.numpy(), np.asarray(jlq), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(jgt), rtol=0, atol=1e-6)

    net = build_network(cfg["network_g"])
    net.load_state_dict(sd)
    port = ttr.build_trainer_from_config(cfg, net, build_loss(train_opt["pixel_opt"]),
                                         device="cpu", mixup=False, gt_size=0)
    tstate = port.init_state()
    # the step itself on JAX's batch, so that the cores' last-ulp
    # differences stay out of the comparison
    tstate, tm = port.step(tstate, torch.from_numpy(np.array(jlq)),
                           torch.from_numpy(np.array(jgt)), np.random.default_rng(0))
    grads = [{n: p.grad.numpy() for n, p in tstate.model.named_parameters()}]
    got = {k: v.numpy() for k, v in tstate.model.state_dict().items()}
    assert float(tm["l_pix"]) == pytest.approx(float(jm["l_pix"]), rel=1e-5)
    # the L1 terms' gradient flips sign wherever prediction and target meet
    # within a rounding: grad_norm within 5e-5 (measured 1.2e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=5e-5)
    assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    _step_rule(got, want, {k: v.numpy() for k, v in sd.items()}, grads,
               float(jm["lr"]), 1)


def test_three_loop_steps_match_jax(corpus, tmp_path):
    steps = 3
    cfg = student_config(corpus[0], None, batch_size_per_gpu=2, gt_size=16,
                         gt_sizes=[16], iters=[steps], mini_batch_sizes=[2],
                         probs=[0.0], num_worker_per_gpu=2, stride_range=[1, 2])
    cfg["train"].update(total_iter=steps, warmup_iter=-1,
                        mixing_augs={"mixup": False})
    cfg["train"]["optim_g"]["lr"] = LR
    cfg["train"]["scheduler"].update(periods=[2, 10], restart_weights=[1, 1])
    cfg["logger"].update(print_freq=1, save_checkpoint_freq=steps)
    cfg["val"]["val_freq"] = 0
    pth = tmp_path / "w.pth"
    sd = _seeded_sd(cfg)
    torch.save({"params": sd}, pth)
    cfg["path"].update(pretrain_network_g=str(pth), strict_load_g=True)
    yml = write_yml(cfg, tmp_path / "opt.yml")

    j_opt = jcfg.parse(yml, True, root_path=str(tmp_path / "jax"))
    jloop.train_from_config(j_opt)
    grads = []
    step = ttr.Trainer.step

    def recording_step(self, state, *a, **kw):
        out = step(self, state, *a, **kw)
        grads.append({n: p.grad.numpy().copy()
                      for n, p in state.model.named_parameters()})
        return out

    t_opt = tcfg.parse(yml, True, root_path=str(tmp_path / "port"))
    ttr.Trainer.step = recording_step
    try:
        tloop.train_from_config(t_opt, device="cpu")
    finally:
        ttr.Trainer.step = step

    def metrics(opt):
        import json

        with open(os.path.join(opt["path"]["log"], "metrics.jsonl")) as f:
            return [r for r in map(json.loads, f) if r["kind"] == "train"]

    j_m, t_m = metrics(j_opt), metrics(t_opt)
    assert [r["iter"] for r in t_m] == [r["iter"] for r in j_m] == [1, 2, 3]
    for a, b in zip(t_m, j_m):
        for k in ("l_pix", "lr", "grad_norm"):
            assert a[k] == pytest.approx(b[k], rel=1e-5), (a["iter"], k)
    want = {k: v.numpy() for k, v in student_state_dict(jckpt.load_weights(
        os.path.join(j_opt["path"]["models"], f"net_g_{steps}"))).items()}
    got = {k: v.numpy() for k, v in read_pth(os.path.join(
        t_opt["path"]["models"], f"net_g_{steps}.pth")).items()}
    _step_rule(got, want, {k: v.numpy() for k, v in sd.items()}, grads, LR, steps)


def test_frame_stack_validation_matches_jax(corpus, tmp_path):
    """20x28 frames: padded to the window on both axes and cropped back."""
    cfg = student_config(corpus[0], corpus[1])
    cfg["val"]["metrics"]["ssim"] = {"type": "calculate_ssim"}
    opt = tcfg.parse(write_yml(cfg, tmp_path / "opt.yml"), False, root_path=str(tmp_path))
    sd = _seeded_sd(cfg)
    j_ds = jds.create_dataset(opt["datasets"]["val"])
    want = jloop.validate_model(
        jax_net(opt["network_g"]), _jax_params(sd),
        jld.BatchLoader(j_ds, 1, jld.EnlargedShuffleSampler(len(j_ds), shuffle=False)), opt)
    model = build_network(opt["network_g"])
    model.load_state_dict(sd)
    t_ds = tds.create_dataset(opt["datasets"]["val"])
    loader = tld.BatchLoader(t_ds, 1, tld.EnlargedShuffleSampler(len(t_ds), shuffle=False))
    save = tmp_path / "saved"
    got = tloop.validate_model(model, loader, opt, save_dir=str(save))
    assert set(got) == set(want) == {"psnr", "ssim"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-4), k
    names = sorted(os.listdir(save))
    assert len(names) == len(t_ds) == 3  # the middle frame of each stack

    # the old route: each stack scored as one F-channel image
    psnr = get_metric("calculate_psnr")
    old = []
    with torch.no_grad():
        for b in tld.BatchLoader(t_ds, 1, tld.EnlargedShuffleSampler(len(t_ds), shuffle=False)):
            x = torch.from_numpy(b["lq"])
            pad = torch.nn.functional.pad(x, (0, 4, 0, 4), mode="reflect")
            pred = model(pad)[..., :20, :28].clamp(0, 1)[0].numpy().transpose(1, 2, 0)
            old.append(psnr(pred, b["gt"][0].transpose(1, 2, 0), crop_border=0,
                            test_y_channel=False))
    assert abs(np.mean(old) - got["psnr"]) > 1e-3, (np.mean(old), got["psnr"])


def test_kdlaes_configs_validate(tmp_path):
    for path in (KDLAES_YML, FLS_YML):
        opt = tcfg.parse(path, True, root_path=str(tmp_path))
        assert bool(opt["datasets"]["train"].get("device_resident")) == (path == FLS_YML)
        tcfg.validate(opt)


def test_fls_finetune_from_the_zoo_student(corpus, tmp_path):
    """KDLAES_FLS_ft.yml at full width from artifacts/torch_zoo/student-us.pth
    (strict), without the device-resident corpus: two steps at 16 px."""
    with open(FLS_YML) as f:
        cfg = yaml.safe_load(f)
    ds = cfg["datasets"]["train"]
    del ds["device_resident"]
    ds.update(corpus[0], num_pairs=5, batch_size_per_gpu=2, gt_size=16,
              gt_sizes=[16, 16], iters=[1, 1], num_worker_per_gpu=2)
    cfg["datasets"]["val"].update(corpus[1], num_pairs=5)
    cfg["train"].update(total_iter=2, warmup_iter=-1)
    cfg["val"]["val_freq"] = 2
    cfg["logger"].update(print_freq=1, save_checkpoint_freq=2)
    cfg["path"]["pretrain_network_g"] = os.path.join(REPO, "artifacts", "torch_zoo",
                                                     "student-us.pth")
    opt = tcfg.parse(write_yml(cfg, tmp_path / "fls.yml"), True, root_path=str(tmp_path))
    state = tloop.train_from_config(opt, device="cpu")
    assert state.step == 2
    start = read_pth(cfg["path"]["pretrain_network_g"])
    end = read_pth(os.path.join(opt["path"]["models"], "net_g_2.pth"))
    assert set(start) == set(end)
    assert any(not torch.equal(start[k], end[k]) for k in start)
    with open(os.path.join(opt["path"]["log"], "metrics.jsonl")) as f:
        assert '"kind": "val"' in f.read()
