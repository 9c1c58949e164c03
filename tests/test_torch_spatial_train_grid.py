"""``train.spatial_shard`` on four gloo ranks on the CPU (processes of
``tests/torch_parallel_ranks.py``), one step each, held to the JAX
package's Trainer on the same mesh by its rule (loss 1e-5 relative, grad
norm 1e-4, parameters 5e-3 relative and 3 lr absolute; JAX
tests/test_spatial_train.py:72-86) and to the port's one-process step by
the same rule:

  * batch 1 at 64 px on 4 bands (1 x 4: all parallelism spatial; JAX :109,
    the teacher's batch-1 curriculum stages that data parallelism cannot
    split);
  * a 2 x 2 grid of data indices and bands, a batch of 4 at 32 px (JAX
    :88's case on four ranks): each data index's two ranks hold the same
    two rows, one band each.

The four ranks end bit for bit equal.
"""

import pytest
import torch

import torch_parallel_ranks as ranks
from test_torch_parallel_step import _ranks_equal
from torch_spatial_jax import assert_step_parity, jax_step

torch.set_num_threads(1)
LAUNCH_S = 150
CASES = [n for n, c in ranks.SPATIAL_STEPS.items() if c[0] == 4]


@pytest.fixture(scope="module")
def grid_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("spatial4") / "spatial")
    for rc, text in ranks.launch("spatial", out, world=4, timeout=LAUNCH_S):
        assert rc == 0, text[-3000:]
    return [ranks.load_rank(out, r) for r in range(4)]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", CASES)
def test_four_ranks_equal_the_jax_spatial_step(grid_ranks, name):
    _ranks_equal([r[name] for r in grid_ranks])
    got = grid_ranks[0][name]
    assert_step_parity(got, *jax_step(name))
    one = ranks.run_spatial_case(name, slice(0, ranks.SPATIAL_STEPS[name][3]))
    assert_step_parity(got, one["metrics"][0],
                       {n: p.numpy() for n, p in one["params"].items()})
