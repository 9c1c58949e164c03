"""Every random draw of a run derives from ``--seed`` and a purpose key, so
that the same seed gives the same weights, inputs, orders and samples."""

from __future__ import annotations

import numpy as np

# purpose keys
WEIGHTS = 1
INPUTS = 2
ORDER = 3
SAMPLE = 4
STEP = 5


def subseed(seed: int, *key: int) -> int:
    """A 63-bit integer from ``seed`` (any whole number) and ``key``."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, *[int(k) for k in key]]
                                   ).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def np_rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(subseed(seed, *key))


def generator(device, seed: int, *key: int):
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` and ``key``."""
    import torch

    return torch.Generator(device=device).manual_seed(subseed(seed, *key))


class Reservoir:
    """A uniform sample of at most ``k`` of the items offered, whatever
    their number (Algorithm R), drawn from ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def slot(self) -> int | None:
        """Count one more item; the index it takes in ``items``, or None
        where it is not kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.k else None

    def put(self, slot: int, item) -> None:
        self.items[slot] = item

    def offer(self, item) -> None:
        slot = self.slot()
        if slot is not None:
            self.put(slot, item)
