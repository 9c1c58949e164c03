"""Mixup (the reference's Mixing_Augment, image_restoration_model.py:25-73).

A Beta(beta, beta)-weighted convex combination of the batch with a
permuted copy of itself; the same lam and permutation apply to every
tensor of the lq and gt dicts. ``use_identity`` adds the reference's 50%
no-op branch (random.randint(0, 1) over [mixup, identity]). The draws come
from an explicit numpy generator on the host; ``_mix_tree`` is the
deterministic core on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.loader import leaves, tree_map


def _mix_tree(tree, lam: float, perm):
    perm = torch.tensor(np.asarray(perm, dtype=np.int64))

    def mix(x):
        return lam * x + (1 - lam) * x[perm.to(x.device)]

    return tree_map(mix, tree, torch.Tensor)


def mixing_augment(rng: np.random.Generator, gt, lq, mixup_beta: float = 1.2,
                   use_identity: bool = True):
    """(gt', lq'): the argument order (target, input) of the reference's
    ``__call__``."""
    batch = leaves(gt)[0].shape[0]
    if use_identity and int(rng.integers(0, 2)) != 0:
        return gt, lq
    lam = float(rng.beta(mixup_beta, mixup_beta))
    perm = rng.permutation(batch)
    return _mix_tree(gt, lam, perm), _mix_tree(lq, lam, perm)

