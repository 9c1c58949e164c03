"""A device-resident corpus across ranks (the JAX corpora's mesh placement,
``_mesh_place`` / ``_batch_out_shardings``): each rank draws the global
batch's values from the shared generator and applies them to its own rows
(``sample_batch(..., rows=)``). For the student's, the teacher's and the
scorer's corpora, the ranks' rows, concatenated, are the one-process batch
of N x b bit for bit, for N of 2 and 4, as are the step's extra masks drawn
over the global batch on the host and on the device; and the JAX package's
sampler stride and padding are the port's on uneven corpora."""

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu.data import loader as jld
from rethink_acoustic_image_enhancement_tpu.parallel import process_shard as jax_shard
from rethink_acoustic_image_enhancement_tpu_torch.data import loader as tld
from rethink_acoustic_image_enhancement_tpu_torch.parallel.collectives import process_shard
from rethink_acoustic_image_enhancement_tpu_torch.train import device_corpus as tdc
from rethink_acoustic_image_enhancement_tpu_torch.train import progressive as tprog
from torch_train_corpus import write_siqa_corpus, write_student_corpus, write_teacher_corpus

torch.set_num_threads(1)
CPU = torch.device("cpu")
B = 8  # the global batch


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_corpora")
    student = write_student_corpus(str(root / "student"), 14, 24, 28, seed=4)
    teacher = write_teacher_corpus(str(root / "teacher"), 5, 28, 32, seed=5)
    siqa = write_siqa_corpus(str(root / "siqa"), 4, 30, 26, seed=6)
    return {
        "student": tdc.StudentDeviceCorpus(
            {"type": "Dataset_PairedMutiImage", "phase": "train", "scale": 1, **student,
             "num_pairs": 3, "stride_range": [1, 2], "prob": 0.1, "gt_size": 16,
             "geometric_augs": True, "seed": 3}, CPU),
        "teacher": tdc.TeacherDeviceCorpus(
            {"type": "Dataset_SuperRestoration_param", "phase": "train", "scale": 1,
             **teacher, "gt_size": 16, "geometric_augs": True, "seed": 5}, CPU),
        "scorer": tdc.SIQADeviceCorpus(
            {"dataroot_lq": siqa["dataroot_lq"], "dataroot_gt": siqa["dataroot_gt"],
             "gt_size": 16, "geometric_augs": True}, CPU),
    }


def _leaves(batch):
    if isinstance(batch, dict):
        return [x for v in batch.values() for x in _leaves(v)]
    if isinstance(batch, (tuple, list)):
        return [x for v in batch for x in _leaves(v)]
    return [batch]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["student", "teacher", "scorer"])
def test_ranks_rows_are_the_one_process_batch(corpora, kind, world):
    corpus = corpora[kind]
    ids = np.random.default_rng(world).integers(0, len(corpus), B)
    whole = corpus.sample_batch(tdc.seeded_generator(CPU, 100, 7), ids, gt_size=12)
    k = B // world
    parts = [corpus.sample_batch(tdc.seeded_generator(CPU, 100, 7), ids, gt_size=12,
                                 rows=slice(r * k, (r + 1) * k)) for r in range(world)]
    for i, want in enumerate(_leaves(whole)):
        got = torch.cat([_leaves(p)[i] for p in parts])
        assert want.shape[0] == B and torch.equal(got, want), (kind, i)


@pytest.mark.parametrize("route", ["host", "device"])
def test_extra_mask_rows_are_the_one_process_mask(route):
    lq = {"img": torch.rand((4, 3, 8, 8)), "denoise_rate": torch.full((4, 1, 8, 8), 0.5)}

    def gen():
        return (np.random.default_rng(5) if route == "host"
                else torch.Generator().manual_seed(5))

    whole = tprog.stage_extra_mask(lq, gen(), 0.3)["img"]
    parts = [tprog.stage_extra_mask({k: v[r:r + 2] for k, v in lq.items()}, gen(), 0.3,
                                    rows=(r, 4))["img"] for r in (0, 2)]
    assert torch.equal(torch.cat(parts), whole)
    assert not torch.equal(parts[1], tprog.stage_extra_mask(
        {k: v[2:] for k, v in lq.items()}, gen(), 0.3)["img"])


@pytest.mark.parametrize("n,ratio,world", [(7, 1, 2), (10, 1, 3), (5, 2, 4), (13, 3, 2)])
def test_sampler_stride_and_padding_match_jax(n, ratio, world):
    """Rank r reads the JAX sampler's rank-r indices on an uneven corpus:
    the enlarged epoch padded up to a multiple of the world size, strided;
    every rank has as many batches."""
    for r in range(world):
        port = tld.EnlargedShuffleSampler(n, ratio=ratio, rank=r, world_size=world, seed=3)
        jax = jld.EnlargedShuffleSampler(n, ratio=ratio, rank=r, world_size=world, seed=3)
        assert port.total == jax.total
        for epoch in (0, 1):
            np.testing.assert_array_equal(port.epoch_indices(epoch), jax.epoch_indices(epoch))
        assert process_shard(range(n), r, world) == jax_shard(range(n), r, world)
    lens = {len(tld.BatchLoader(list(range(n)), 2, tld.EnlargedShuffleSampler(
        n, ratio=ratio, rank=r, world_size=world), drop_last=False)) for r in range(world)}
    assert len(lens) == 1
