"""Mixup (the reference's Mixing_Augment, image_restoration_model.py:25-73).

A Beta(beta, beta)-weighted convex combination of the batch with a
permuted copy of itself; the same lam and permutation apply to every
tensor of the lq and gt dicts. ``use_identity`` adds the reference's 50%
no-op branch (random.randint(0, 1) over [mixup, identity]). The draws come
from an explicit numpy generator on the host; ``_mix_tree`` is the
deterministic core on the device.

With several ranks (``rows``) the permutation is over the global batch, as
in the JAX package's one program: a rank's rows mix with partners that may
live on any rank, so the rank gathers the global batch
(``parallel/collectives.py::gather_rows``) and keeps its own rows of the
mix. Every rank draws the same lam and permutation from the same generator.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.loader import leaves, tree_map
from ..parallel.collectives import gather_rows


def _mix_tree(tree, lam: float, perm):
    perm = torch.tensor(np.asarray(perm, dtype=np.int64))

    def mix(x):
        return lam * x + (1 - lam) * x[perm.to(x.device)]

    return tree_map(mix, tree, torch.Tensor)


def _mix_rows(tree, glob, lam: float, partners):
    """This rank's rows of the mix: ``lam * x + (1 - lam) * glob[partners]``
    leaf by leaf, ``glob`` the global batch of ``tree``."""
    if isinstance(tree, dict):
        return {k: _mix_rows(v, glob[k], lam, partners) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    idx = torch.tensor(np.asarray(partners, dtype=np.int64)).to(tree.device)
    return lam * tree + (1 - lam) * glob[idx]


def mixing_augment(rng: np.random.Generator, gt, lq, mixup_beta: float = 1.2,
                   use_identity: bool = True, rows: tuple[int, int] | None = None):
    """(gt', lq'): the argument order (target, input) of the reference's
    ``__call__``. ``rows`` (first, total): gt and lq are rows [first,
    first + b) of a global batch of ``total`` held across the ranks."""
    batch = leaves(gt)[0].shape[0] if rows is None else rows[1]
    if use_identity and int(rng.integers(0, 2)) != 0:
        return gt, lq
    lam = float(rng.beta(mixup_beta, mixup_beta))
    perm = rng.permutation(batch)
    if rows is None:
        return _mix_tree(gt, lam, perm), _mix_tree(lq, lam, perm)
    first, b = rows[0], leaves(gt)[0].shape[0]
    partners = perm[first:first + b]
    return (_mix_rows(gt, gather_rows(gt), lam, partners),
            _mix_rows(lq, gather_rows(lq), lam, partners))

