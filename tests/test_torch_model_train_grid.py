"""``train.model_shard`` on four gloo ranks on the CPU (processes of
``tests/torch_parallel_ranks.py``), two steps of the narrow KDLAE-T with
EMA each (JAX tests/test_parallel.py:155's case), held to the JAX package's
Trainer on the same mesh by JAX test_parallel.py:225-235's rule with the
step rule on every weight (``torch_model_jax``), and to the port's one
process by the same rules held tighter:

  * 4 model shards of one data index (1 x 4: the level-2 stages' two heads
    and the level-1 stages' one head whole on every shard, the hidden
    channels 21 over 4 as 6, 5, 5, 5);
  * a 2 x 2 grid of data indices and model shards (JAX's 2 x 4 case on four
    ranks): each data index's two shards hold the same two rows, the split
    leaves reduced over the data subgroup, the whole leaves over the world.

The four ranks' whole leaves are bit-equal after every step, and their
gathered parameters and EMA bit-equal.
"""

import pytest
import torch

import torch_parallel_ranks as ranks
from test_torch_model_train_ranks import _host, assert_shards_agree
from torch_model_jax import assert_teacher_rule, jax_model_steps

torch.set_num_threads(1)
LAUNCH_S = 150
CASES = [n for n, c in ranks.MODEL_STEPS.items() if c[0] == 4]


@pytest.fixture(scope="module")
def grid_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("model4") / "model")
    for rc, text in ranks.launch("model", out, world=4, timeout=LAUNCH_S):
        assert rc == 0, text[-3000:]
    return [ranks.load_rank(out, r) for r in range(4)]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", CASES)
def test_four_ranks_agree_bit_for_bit(grid_ranks, name):
    assert_shards_agree([r[name] for r in grid_ranks])
    n_model = ranks.MODEL_STEPS[name][1]
    assert [r[name]["grid"] for r in grid_ranks] == [(r // n_model, r % n_model)
                                                      for r in range(4)]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", CASES)
def test_four_ranks_equal_the_jax_model_axis_step(grid_ranks, name):
    assert_teacher_rule(_host(grid_ranks[0][name]), *jax_model_steps(name))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", CASES)
def test_four_ranks_equal_one_process(grid_ranks, name):
    one = _host(ranks.run_model_case(name, slice(0, ranks.MODEL_STEPS[name][3])))
    assert_teacher_rule(_host(grid_ranks[0][name]), one["metrics"], one["params"], one["ema"],
                        one["grads"], tight=True)
