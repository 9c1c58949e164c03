"""``convert/orbax.py::read_checkpoint`` on optax states, saved by orbax's
``StandardCheckpointer`` as the JAX package's ``train/checkpoints.py::
save_checkpoint`` saves them: ``clip_by_global_norm`` + ``adamw``, the same
under ``multi_transform`` (frozen leaves' moments are optax's
``MaskedNode``), ``adamw`` alone, and ``clip_by_global_norm`` + ``adam``.
Each empty leaf (orbax's value type ``'None'``, ``skip_deserialize``) comes
back as ``None`` in its place, and every array equals orbax's own restore;
an unknown value type still raises, naming the leaf. On each of these trees
``train/jax_state.py::optax_layout`` finds Adam's state and the schedule's
count by the tree's shape alone, and describes the chain as
``expected_layout`` describes the ``OptimizerSpec`` of the same config."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import orbax.checkpoint as ocp

from rethink_acoustic_image_enhancement_tpu_torch.convert import orbax
from rethink_acoustic_image_enhancement_tpu_torch.train import jax_state
from rethink_acoustic_image_enhancement_tpu_torch.train.trainer import OptimizerSpec

PARAMS = {"a": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)},
          "b": {"bias": np.linspace(-1, 1, 3, dtype=np.float32)}}


def _masked(tx):
    return optax.multi_transform({"train": tx, "frozen": optax.set_to_zero()},
                                 lambda t: {"a": {"kernel": "train"}, "b": {"bias": "frozen"}})


CHAINS = {
    "clip_adamw": lambda s: optax.chain(optax.clip_by_global_norm(0.01),
                                        optax.adamw(s, weight_decay=1e-4)),
    "masked_clip_adamw": lambda s: _masked(optax.chain(optax.clip_by_global_norm(0.01),
                                                       optax.adamw(s, weight_decay=1e-4))),
    "adamw": lambda s: optax.chain(optax.adamw(s, weight_decay=1e-4)),
    "clip_adam": lambda s: optax.chain(optax.clip_by_global_norm(0.01), optax.adam(s)),
}


def _saved(tmp_path, name):
    """A state after two updates, saved with step and epoch; (path, the
    metadata's leaves {key path: value type})."""
    tx = CHAINS[name](optax.linear_schedule(1e-3, 0.0, 10))
    params = jax.tree.map(jnp.asarray, PARAMS)
    state = tx.init(params)
    rng = np.random.default_rng(0)
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32),
                             params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    path = str(tmp_path / name)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, {"params": jax.device_get(params), "opt_state": jax.device_get(state),
                      "step": 2, "epoch": 1}, force=True)
    ckptr.wait_until_finished()
    with open(os.path.join(path, "_METADATA")) as fh:
        meta = json.load(fh)["tree_metadata"]
    kinds = {tuple(k["key"] for k in v["key_metadata"]): v["value_metadata"]["value_type"]
             for v in meta.values()}
    return path, kinds


def _leaf(tree, keys):
    for k in keys:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _paths(v, prefix + (str(k),))


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_optax_states_read_as_orbax_restores_them(tmp_path, name):
    path, kinds = _saved(tmp_path, name)
    got = orbax.read_checkpoint(path)
    want = ocp.StandardCheckpointer().restore(path)
    empty = {k for k, t in kinds.items() if t == "None"}
    assert empty, kinds  # every chain keeps at least one empty state
    got_leaves = dict(_paths(got))
    assert set(got_leaves) == set(kinds)
    for keys, t in kinds.items():
        leaf = got_leaves[keys]
        if t == "None":
            assert leaf is None, keys
            assert _leaf(want, keys) is None, keys
        elif t == "scalar":
            assert leaf == _leaf(want, keys), keys
        else:
            ref = np.asarray(_leaf(want, keys))
            assert leaf.dtype == ref.dtype and leaf.shape == ref.shape, keys
            np.testing.assert_array_equal(leaf, ref, err_msg=str(keys))
    # a sequence keeps its indices: Adam's state stays where optax put it
    tree = got["opt_state"]
    if name.startswith("masked"):
        assert tree["inner_states"]["frozen"] == {"inner_state": None}
        tree = tree["inner_states"]["train"]["inner_state"]
        assert tree[1][0]["mu"]["b"]["bias"] is None
        assert tree[1][0]["nu"]["b"]["bias"] is None
    adam = tree[1][0] if name != "adamw" else tree[0][0]
    assert set(adam) == {"count", "mu", "nu"} and int(adam["count"]) == 2
    assert orbax.payload_keys(path) == ["epoch", "opt_state", "params", "step"]


SPECS = {  # each chain's config, as the port's trainer reads it
    "clip_adamw": OptimizerSpec("AdamW"),
    "masked_clip_adamw": OptimizerSpec("AdamW", freeze_except=("a",)),
    "adamw": OptimizerSpec("AdamW", clip_norm=None),
    "clip_adam": OptimizerSpec("Adam"),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_adam_state_is_found_by_the_tree_shape(tmp_path, name):
    path, _ = _saved(tmp_path, name)
    got = orbax.read_checkpoint(path)
    layout = jax_state.optax_layout(got["opt_state"])
    assert layout.describe() == jax_state.expected_layout(SPECS[name])
    assert (layout.kind, layout.clip, layout.masked) == (
        "Adam" if name == "clip_adam" else "AdamW", name != "adamw", name.startswith("masked"))
    assert int(layout.adam["count"]) == int(layout.lr_count) == 2
    for m in ("mu", "nu"):
        assert layout.adam[m]["a"]["kernel"].shape == (2, 3)
        assert (layout.adam[m]["b"]["bias"] is None) == name.startswith("masked")
    others = [v for k, v in SPECS.items() if k != name]
    assert all(jax_state.expected_layout(o) != layout.describe() for o in others)


def test_an_unknown_value_type_still_raises(tmp_path):
    path, _ = _saved(tmp_path, "clip_adamw")
    meta_path = os.path.join(path, "_METADATA")
    with open(meta_path) as fh:
        meta = json.load(fh)
    key = next(k for k, v in meta["tree_metadata"].items()
               if v["value_metadata"]["value_type"] == "None")
    meta["tree_metadata"][key]["value_metadata"]["value_type"] = "custom.Thing"
    with open(meta_path, "w") as fh:
        json.dump(meta, fh)
    with pytest.raises(orbax.CheckpointError, match=r"value type 'custom.Thing'") as err:
        orbax.read_checkpoint(path)
    assert key in str(err.value)
    # 'None' without skip_deserialize is no empty leaf either
    meta["tree_metadata"][key]["value_metadata"].update(value_type="None",
                                                       skip_deserialize=False)
    with open(meta_path, "w") as fh:
        json.dump(meta, fh)
    with pytest.raises(orbax.CheckpointError, match="value type 'None'"):
        orbax.read_checkpoint(path)
