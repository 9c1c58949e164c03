"""``train.spatial_shard: 2`` on the CPU: two gloo ranks, each a process of
``tests/torch_parallel_ranks.py`` started with torchrun's env, each one row
band of every image (``parallel/spatial.py::RankBands``).

  * One step of the narrow KDLAE-T (L1-Shadow) on a batch of 2 at 32 px,
    and of the student (hidden (4, 8), L1) on (2, 3, 32, 32) stacks, H their
    axis 2: against the JAX package's Trainer on a 1x2 (data x spatial)
    mesh by its rule (loss 1e-5 relative, grad norm 1e-4, parameters 5e-3
    relative and 3 lr absolute; JAX tests/test_spatial_train.py:72-86), and
    against the port's one-process step by the same rule; the teacher's
    step in bf16 compute against one process in bf16;
  * the losses that are no sums over pixels (L1-Shadow, L2Dice, PSNR, the
    video frames' 'mix' reduction), three steps with the curriculum's
    draws (a crop, an extra mask, mixup) on the whole images before the
    bands are taken: against the port's one process;
  * the two ranks end bit for bit equal; ``RankBands`` counts the halo and
    partial bytes that ``LocalBands`` counts for the same forward, and its
    ``exchange_halo`` returns the zero-padded image's rows, and its
    backward the whole image's gradient;
  * the loop, ``raie-torch train --launcher pytorch`` with
    ``train.spatial_shard: 2`` (the narrow student from the host loader,
    and a device-resident corpus with its curriculum): the bands of one
    data index read the same items, and the ranks end within 2e-5 relative
    and 2e-6 absolute of one process on the same config (the bound of
    tests/test_torch_parallel_loop.py); rank 1 writes nothing.
"""

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.models.bands import network_bands
from rethink_acoustic_image_enhancement_tpu_torch.parallel.spatial import (
    LocalBands,
    split_rows,
)
from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
import torch_parallel_ranks as ranks
from test_torch_parallel_loop import _device_config, _frames, _launch_config
from test_torch_parallel_step import _ranks_equal, _step_rule
from torch_spatial_jax import assert_step_parity, jax_step
from torch_train_corpus import write_student_corpus, write_yml

torch.set_num_threads(1)
LAUNCH_S = 150
CASES = [n for n, c in ranks.SPATIAL_STEPS.items() if c[0] == 2]


@pytest.fixture(scope="module")
def spatial_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("spatial2") / "spatial")
    for rc, text in ranks.launch("spatial", out, timeout=LAUNCH_S):
        assert rc == 0, text[-3000:]
    return [ranks.load_rank(out, r) for r in range(2)]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", CASES)
def test_two_bands_equal_the_jax_spatial_step(spatial_ranks, name):
    _ranks_equal([r[name] for r in spatial_ranks])
    got = spatial_ranks[0][name]
    assert_step_parity(got, *jax_step(name))
    one = ranks.run_spatial_case(name, slice(0, ranks.SPATIAL_STEPS[name][3]))
    assert_step_parity(got, one["metrics"][0],
                       {n: p.numpy() for n, p in one["params"].items()})


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", ranks.SPATIAL_DRAWS)
def test_two_bands_equal_one_process_with_draws(spatial_ranks, name):
    results = [r[name] for r in spatial_ranks]
    _ranks_equal(results)
    one = ranks.run_loss_case(name, slice(0, ranks.BATCH))
    for a, b in zip(results[0]["metrics"], one["metrics"], strict=True):
        assert a["lr"] == b["lr"]
        assert a["l_pix"] == pytest.approx(b["l_pix"], rel=1e-5)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)
    grads = [{n: g.numpy() for n, g in step.items()} for step in one["grads"]]
    _step_rule({n: p.numpy() for n, p in results[0]["params"].items()},
               {n: p.numpy() for n, p in one["params"].items()}, grads,
               max(m["lr"] for m in one["metrics"]), ranks.STEPS)


def test_two_bands_in_bf16_compute(spatial_ranks):
    """``compute_dtype`` bfloat16 on bands (the bf16 copies of the float32
    parameters through ``torch.func.functional_call`` of the band forward):
    the narrow teacher's step against one process in bf16, by
    tests/test_torch_train_step.py's bf16 bounds (loss 4e-3 relative, grad
    norm 1e-2; the bands add their sums in another order)."""
    results = [r["teacher_1x2_bf16"] for r in spatial_ranks]
    _ranks_equal(results)
    _, _, kind, b, side = ranks.SPATIAL_STEPS["teacher_1x2"]
    one = ranks.run_step_case(slice(0, b), "cpu", ranks.spatial_batches(kind, b, side),
                              compute_dtype=torch.bfloat16)
    (got,), (want,) = results[0]["metrics"], one["metrics"]
    assert got["l_pix"] == pytest.approx(want["l_pix"], rel=4e-3)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-2)
    for n, p in one["params"].items():  # every weight moved by about lr, as one process's
        assert float((results[0]["params"][n] - p).abs().max()) <= 2 * want["lr"], n


def test_rank_bands_move_what_local_bands_move(spatial_ranks):
    """A step's forward on 2 ranks moves, by ``RankBands``' count, the
    bytes ``LocalBands`` counts for the same forward on 2 bands."""
    _, _, kind, b, side = ranks.SPATIAL_STEPS["teacher_1x2"]
    (lq, _), = ranks.spatial_batches(kind, b, side)
    lq = ranks.nchw(lq, "cpu")
    bands = LocalBands(["cpu"] * 2)
    model = ranks.seeded_model(ranks.TEACHER)
    parts = zip(*(split_rows(lq[k], bands.devices) for k in ("img", "denoise_rate")))
    with torch.no_grad():
        network_bands([model] * 2, [{"img": i, "denoise_rate": r} for i, r in parts], bands)
    assert bands.moved["halo"] > 0 and bands.moved["partials"] > 0
    for r in spatial_ranks:
        assert r["teacher_1x2"]["moved"] == bands.moved


def test_rank_bands_exchange_halo_and_its_backward(spatial_ranks):
    """``RankBands.exchange_halo`` gives each band its rows with 2 of its
    neighbours' above and below, zeros at the image's edges, and counts the
    halo bytes ``LocalBands`` counts; its backward hands each halo row's
    gradient to the band that owns the row: each band's gradient is the
    whole image's, where every band's exchanged rows are read from the
    zero-padded image."""
    res0 = spatial_ranks[0]["halo"]
    whole = res0["image"].clone().requires_grad_(True)
    padded = torch.nn.functional.pad(whole, (0, 0, 2, 2))
    local = LocalBands(["cpu"] * 2)
    local.exchange_halo(split_rows(whole.detach(), local.devices), 2)
    loss = sum((padded[..., r * 4:r * 4 + 8, :] * res0["weights"][r]).sum() for r in range(2))
    loss.backward()
    for r, res in enumerate(x["halo"] for x in spatial_ranks):
        assert torch.equal(res["exchanged"], padded[..., r * 4:r * 4 + 8, :].detach())
        assert res["moved"]["halo"] == local.moved["halo"]
        torch.testing.assert_close(res["grad"], whole.grad[..., r * 4:r * 4 + 4, :],
                                   rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    """The host-loader and device-resident configs with spatial_shard 2 on
    two ranks; the same configs without it in this process."""
    root = tmp_path_factory.mktemp("spatial_loop")
    _frames(root)
    dev_roots = write_student_corpus(str(root / "device"), 12, 20, 20, seed=3)
    cfgs = {"host": _launch_config(root, "sp_host", 3),
            "device": _device_config(dev_roots, 2, [2, 1])}
    cfgs["device"]["name"] = "sp_device"
    ymls = []
    for key, cfg in cfgs.items():
        cfg = {**cfg, "train": {**cfg["train"], "spatial_shard": 2}}
        ymls.append(write_yml(cfg, root / f"{key}.yml"))
    out = str(root / "loop")
    ports = [ranks.free_port() for _ in range(len(ymls) + 1)]
    results = ranks.launch("loop", out, [*ymls, *ports], cwd=str(root), timeout=LAUNCH_S)
    for rc, text in results:
        assert rc == 0, text[-4000:]
    one = {}
    for key, cfg in cfgs.items():
        cfg = {**cfg, "name": cfg["name"] + "_one"}
        opt = tcfg.parse(write_yml(cfg, root / f"{key}_one.yml"), True, root_path=str(root))
        state = tloop.train_from_config(opt, device="cpu")
        one[key] = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    return cfgs, [ranks.load_rank(out, r) for r in range(2)], one


@pytest.mark.timeout(300)
@pytest.mark.parametrize("key", ["host", "device"])
def test_loop_on_two_bands_equals_one_process(loop_runs, key):
    cfgs, results, one = loop_runs
    k = list(cfgs).index(key)
    finals = [r["finals"][k] for r in results]
    for n, p in finals[0].items():
        assert torch.equal(finals[1][n], p), n
    for n, want in one[key].items():
        np.testing.assert_allclose(finals[0][n].numpy(), want.numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=n)
    # rank 0 alone writes
    writes = [set(r["writes"]) for r in results]
    assert writes[0] and not writes[1], writes
