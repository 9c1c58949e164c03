"""The port's resume of a JAX training state (``torch_jax_state_runs.py``'s
live parity: the JAX loop writes ``ckpt_3`` and resumes it to 5, the port
resumes the same directory to 5) of the narrow student under
``freeze_except`` and ``use_grad_clip: false``: ``multi_transform`` over the
optimizer alone (a chain of one), the frozen parameters' moments optax's
``MaskedNode`` (no AdamW state in the port). Per iteration ``l_pix``,
``lr`` and ``grad_norm`` within 1e-5 relative, the final weights by
``test_loop_matches_jax``'s rule, the moments bit for bit through the JAX
package's ``export_student``; a config whose clip or freeze disagrees with
this tree is refused by the loop, naming the layout or the leaf."""

import pytest
import torch

from torch_jax_state_runs import (
    check_iterations,
    check_moments,
    check_step_rule,
    module_runs,
    refused_by_the_loop,
)

torch.set_num_threads(2)
HERE_CASES = ["student_freeze_except_no_clip"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return module_runs(tmp_path_factory)


@pytest.mark.parametrize("case", HERE_CASES)
def test_resumed_iterations_match_jax(case, runs):
    check_iterations(runs(case))


@pytest.mark.parametrize("case", HERE_CASES)
def test_resumed_weights_follow_the_step_rule(case, runs):
    check_step_rule(runs(case))


@pytest.mark.parametrize("case", HERE_CASES)
def test_adamw_state_is_optax_state(case, runs):
    check_moments(runs(case))


@pytest.mark.parametrize("case,train,tree_says", [
    ("student_freeze_except_no_clip", {"use_grad_clip": True},
     r"optimizer is multi_transform\(train: adamw, frozen: set_to_zero\), the config's .* "
     r"is multi_transform\(train: clip_by_global_norm \+ adamw, frozen: set_to_zero\)$"),
    ("student_freeze_except_no_clip", {"freeze_except": None},
     r"optimizer is multi_transform\(train: adamw, frozen: set_to_zero\), the config's .* "
     r"is adamw$"),
    ("student_freeze_except_no_clip", {"freeze_except": ["out_conv"]},
     r"adam's mu/\S+ \(\S+\) is present for a frozen parameter"),
])
def test_a_config_that_disagrees_with_the_tree_raises(case, train, tree_says, runs, tmp_path):
    """Through the loop: the run raises and never starts at step 0."""
    refused_by_the_loop(runs(case), tmp_path, tree_says, **train)
