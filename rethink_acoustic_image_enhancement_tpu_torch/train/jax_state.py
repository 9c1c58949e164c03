"""A JAX training state as the port's ``TrainState``: the orbax directory
``training_states/ckpt_<iter>`` that the JAX package's
``train/checkpoints.py::save_checkpoint`` writes, read without JAX
(``convert/orbax.py``) and loaded into a state in the reference (whole)
layout, as ``Trainer.whole_state`` gives it.

The payload holds ``params``, ``opt_state``, ``step``, ``epoch`` and, where
present, ``params_ema`` and ``extra_variables``. ``params`` and
``params_ema`` go through the flax -> torch maps of the port's weights
(``convert/weights.py::reference_state_dict``: the teacher's and the
Restormer's, the student's), and load with ``strict=True``. The JAX loop's
networks keep no batch statistics, so its states hold no
``extra_variables``; a state that holds some is refused.

The optimizer (the JAX package's ``train/trainer.py::build_optimizer``) is
``optax.chain([clip_by_global_norm,] adamw | adam)``, wrapped in
``multi_transform({'train', 'frozen'})`` under ``freeze`` /
``freeze_except``. Restored, its state has one of these shapes (``None``
where optax keeps an empty state; ``adam`` is ``{count, mu, nu}``, ``lr``
the schedule's ``{count}``)::

    [None, [adam, None, lr]]    clip_by_global_norm + adamw
    [[adam, None, lr]]          adamw alone (a chain of one)
    [None, [adam, lr]]          clip_by_global_norm + adam
    [[adam, lr]]                adam alone
    {inner_states: {frozen: {inner_state: None},
                    train: {inner_state: <one of the above>}}}
                                under multi_transform, where the frozen
                                parameters' mu and nu are None (MaskedNode)

``optax_layout`` finds Adam's state by that shape and the state is refused
where the config's ``OptimizerSpec`` describes another chain. ``mu`` and
``nu`` have the parameters' structure and go through the same map as the
parameters into each trainable parameter's ``exp_avg`` and ``exp_avg_sq``;
Adam's ``count`` becomes each one's ``step`` (a float32 tensor on the CPU,
as ``torch.optim.AdamW`` keeps it: optax's count and torch's step both
count the updates made, and both correct the bias with the count after the
increment). A map may only rearrange values (transpose, reshape, rename):
``rearrangement`` proves it on the parameters' shapes before any moment
goes through it, since a map that computed anything would be wrong for
``nu``. Frozen parameters get no optimizer state, as in the port's trainer.

Every check raises ``JaxStateError`` naming the leaf or the layout: Adam's
and the schedule's counts equal to ``step``, every trainable parameter's
moments present with its shape, frozen ones absent, the EMA present exactly
where ``train.ema_decay`` asks for it. A state that does not load is never
replaced by a fresh optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..convert.orbax import read_checkpoint
from ..convert.weights import arch_of, reference_state_dict

PAYLOAD = ("params", "opt_state", "step", "epoch", "params_ema", "extra_variables")


class JaxStateError(ValueError):
    """A JAX training state the port cannot resume exactly."""


@dataclasses.dataclass
class OptaxLayout:
    """Where Adam's state sits in a restored optax state."""

    kind: str  # 'AdamW' or 'Adam'
    clip: bool  # clip_by_global_norm first
    masked: bool  # under multi_transform({'train', 'frozen'})
    adam: dict  # {'count', 'mu', 'nu'}
    lr_count: Any  # the schedule's count

    def describe(self) -> str:
        return describe(self.kind, self.clip, self.masked)


def describe(kind: str, clip: bool, masked: bool) -> str:
    chain = ("clip_by_global_norm + " if clip else "") + kind.lower()
    return f"multi_transform(train: {chain}, frozen: set_to_zero)" if masked else chain


def expected_layout(spec) -> str:
    """The chain the JAX package builds for the config's ``OptimizerSpec``."""
    return describe(spec.kind, spec.clip_norm is not None,
                    spec.freeze_except is not None or bool(spec.freeze))


def _skeleton(node, depth=4):
    """A short picture of a tree's shape for error messages."""
    if isinstance(node, dict):
        if depth == 0:
            return "{...}"
        return {k: _skeleton(v, depth - 1) for k, v in node.items()}
    if isinstance(node, list):
        return [_skeleton(v, depth - 1) for v in node] if depth else "[...]"
    return None if node is None else "array"


def _is_adam(node) -> bool:
    return isinstance(node, dict) and set(node) == {"count", "mu", "nu"}


def _is_count(node) -> bool:
    return isinstance(node, dict) and set(node) == {"count"}


def optax_layout(opt_state) -> OptaxLayout:
    """Adam's state and the schedule's count in ``opt_state`` (a restored
    optax state), found by the tree's shape (module docstring)."""
    def refuse(why):
        return JaxStateError(f"opt_state {_skeleton(opt_state)}: {why}; known chains are "
                             "[clip_by_global_norm +] adamw | adam, optionally under "
                             "multi_transform({'train', 'frozen'})")

    node, masked = opt_state, False
    if isinstance(node, dict) and set(node) == {"inner_states"}:
        inner = node["inner_states"]
        if not (isinstance(inner, dict) and set(inner) == {"train", "frozen"}
                and inner["frozen"] == {"inner_state": None}
                and isinstance(inner["train"], dict) and set(inner["train"]) == {"inner_state"}):
            raise refuse("a multi_transform without the 'train' and 'frozen' "
                         "(set_to_zero) groups")
        node, masked = inner["train"]["inner_state"], True
    if isinstance(node, list) and len(node) == 2 and node[0] is None \
            and isinstance(node[1], list):
        clip, tx = True, node[1]
    elif isinstance(node, list) and len(node) == 1 and isinstance(node[0], list):
        clip, tx = False, node[0]
    else:
        raise refuse("not a chain of [clip_by_global_norm,] and one optimizer")
    if not (tx and _is_adam(tx[0]) and _is_count(tx[-1])):
        raise refuse("the optimizer is not scale_by_adam ... scale_by_learning_rate")
    if len(tx) == 3 and tx[1] is None:
        kind = "AdamW"
    elif len(tx) == 2:
        kind = "Adam"
    else:
        raise refuse(f"an optimizer chain of {len(tx)} states")
    return OptaxLayout(kind=kind, clip=clip, masked=masked, adam=tx[0],
                       lr_count=tx[-1]["count"])


# ------------------------------------------------------------------ maps --

def _flat(tree, prefix=()) -> dict[tuple, Any]:
    """{key path: leaf} of nested dicts; None leaves kept."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (str(k),)))
    return out


def _nest(flat: dict[tuple, Any]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _name(path: tuple) -> str:
    return "/".join(path)


def rearrangement(params: dict, arch: str) -> dict[str, tuple]:
    """{torch name: flax path} of ``arch``'s map over ``params``' shapes,
    proven a pure rearrangement: each leaf numbered with distinct integers,
    every torch tensor must hold exactly one leaf's numbers, each leaf used
    once. A map that computes anything from the values (a scale, a sum, a
    cast) fails here, and with it the moments' route."""
    leaves = _flat(params)
    ids, starts, offset = {}, [], 0
    for path, leaf in leaves.items():
        shape = np.shape(leaf)
        size = int(np.prod(shape, dtype=np.int64))
        ids[path] = np.arange(offset, offset + size, dtype=np.int64).reshape(shape)
        starts.append((offset, size, path))
        offset += size
    firsts = np.array([s for s, _, _ in starts], dtype=np.int64)
    out, used = {}, set()
    for name, t in reference_state_dict(_nest(ids), arch).items():
        v = t.numpy().ravel()
        if t.dtype != torch.int64 or v.size == 0:
            raise JaxStateError(f"{arch}'s map gives {name} as {t.dtype} of {v.size} "
                                "values from numbered leaves: not a rearrangement")
        start, size, path = starts[int(np.searchsorted(firsts, v.min(), side="right")) - 1]
        if v.size != size or not np.array_equal(np.sort(v), np.arange(start, start + size)):
            raise JaxStateError(f"{arch}'s map computes {name} from {_name(path)} "
                                "(not a rearrangement of it): it cannot carry Adam's nu")
        if path in used:
            raise JaxStateError(f"{arch}'s map uses {_name(path)} twice")
        used.add(path)
        out[name] = path
    missing = set(leaves) - used
    if missing:
        raise JaxStateError(f"{arch}'s map drops {sorted(map(_name, missing))[:5]}")
    return out


# ------------------------------------------------------------------- load --

def _count(value, what: str, step: int) -> None:
    n = int(np.asarray(value))
    if n != step:
        raise JaxStateError(f"{what} is {n}, the state's step {step}: the "
                            "optimizer's bias correction and rate would not be step's")


def _moments(layout: OptaxLayout, params: dict, names: dict[str, tuple],
             trainable: list[str], arch: str) -> dict[str, dict[str, torch.Tensor]]:
    """{torch name: {'exp_avg', 'exp_avg_sq'}} of the trainable parameters,
    through the parameters' map; a frozen parameter must have None."""
    p_leaves = _flat(params)
    out: dict[str, dict] = {n: {} for n in trainable}
    for opt_key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        tree = layout.adam[opt_key]
        leaves = _flat(tree) if isinstance(tree, dict) else {}
        if set(leaves) != set(p_leaves):
            odd = sorted(map(_name, set(leaves) ^ set(p_leaves)))
            raise JaxStateError(f"adam's {opt_key} and params differ at {odd[:5]}")
        filled = {}
        for path, leaf in leaves.items():
            shape = np.shape(p_leaves[path])
            if leaf is not None and np.shape(leaf) != shape:
                raise JaxStateError(f"adam's {opt_key}/{_name(path)} has shape "
                                    f"{np.shape(leaf)}, its parameter {shape}")
            filled[path] = (np.zeros(shape, np.asarray(p_leaves[path]).dtype)
                            if leaf is None else leaf)
        mapped = reference_state_dict(_nest(filled), arch)
        for name, path in names.items():
            held = leaves[path] is not None
            if held != (name in out):
                raise JaxStateError(
                    f"adam's {opt_key}/{_name(path)} ({name}) is "
                    + ("present for a frozen parameter" if held else
                       "missing (None) for a trainable parameter")
                    + ": the config's freeze / freeze_except and the state disagree")
            if held:
                out[name][torch_key] = mapped[name]
    return out


def load_jax_state(path: str, state, spec):
    """Load the JAX training state ``path`` into ``state`` (a ``TrainState``
    in the reference layout, its optimizer built by ``spec``, an
    ``OptimizerSpec``), in place. Returns (state, epoch)."""
    payload = read_checkpoint(path)
    unknown = sorted(set(payload) - set(PAYLOAD))
    missing = [k for k in ("params", "opt_state", "step") if k not in payload]
    if unknown or missing:
        raise JaxStateError(f"{path}: payload keys {sorted(payload)} (missing {missing}, "
                            f"unknown {unknown}): not a JAX training state")
    arch = arch_of(state.model)
    extra = payload.get("extra_variables") or {}
    if extra:  # the JAX loop's networks have no batch statistics
        raise JaxStateError(f"{path}: extra_variables {sorted(extra)}, which the port's "
                            f"{arch} has no place for")
    step = int(payload["step"])
    layout = optax_layout(payload["opt_state"])
    want = expected_layout(spec)
    if layout.describe() != want:
        raise JaxStateError(f"{path}: the state's optimizer is {layout.describe()}, the "
                            f"config's (train.use_grad_clip, optim_g.type, freeze, "
                            f"freeze_except) is {want}")
    _count(layout.adam["count"], "adam's count", step)
    _count(layout.lr_count, "the schedule's count", step)
    names = rearrangement(payload["params"], arch)

    model = state.model
    in_opt = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    trainable = [n for n, p in model.named_parameters() if id(p) in in_opt]
    moments = _moments(layout, payload["params"], names, trainable, arch)

    if (state.ema is None) != ("params_ema" not in payload):
        raise JaxStateError(f"{path}: " + (
            "params_ema is in the state but train.ema_decay is 0" if state.ema is None
            else "train.ema_decay asks for an EMA, and the state holds no params_ema"))
    model.load_state_dict(reference_state_dict(payload["params"], arch), strict=True)
    if state.ema is not None:
        state.ema.load_state_dict(reference_state_dict(payload["params_ema"], arch),
                                  strict=True)
    sd = state.optimizer.state_dict()
    sd["state"] = {i: {"step": torch.tensor(float(step), dtype=torch.float32),
                       **moments[n]} for i, n in enumerate(trainable)}
    state.optimizer.load_state_dict(sd)
    state.step = step
    return state, int(payload.get("epoch", 0))
