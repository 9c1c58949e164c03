"""Model shards: one model split over the devices of a mesh's ``model`` axis
(the JAX package shards every conv's output channels over ``model`` and lets
XLA's partitioner insert the collectives; ``models/shards.py`` says how the
port splits each TransformerBlock instead).

``LocalShards`` holds all N shards in one process, as JAX's single
controller drives every device of the mesh, shard j on ``devices[j]``
(devices may repeat: shards can share a card). Its ``sum_across`` adds the
shards' partial sums in shard order on every shard's device
(``parallel/spatial.py::sum_in_order``, the rule of ``LocalBands``), so every
shard gets the same bits, and counts the bytes one shard hands another in
``moved`` and the sums in ``sums``. It is differentiable through autograd,
as ``LocalBands`` is: the copies between devices and the additions carry
gradients back to every part.

``RankShards`` (training, ``train.model_shard``) is one shard a rank, the
ranks of one data index's model subgroup (``parallel.init_grid``), as
``parallel/spatial.py::RankBands`` is one band a rank: its ``sum_across``
is ``parallel/collectives.py::placed_sum`` of the rank's part in its slot
over the model subgroup, the slots then added in shard order, so every
shard gets ``LocalShards``' bits. Its backward is the same sum of the
shards' upstream gradients: each part gets N times the gradient of one
copy of the loss (``parallel/collectives.py::reduce_shard_gradients`` says
what the trainer does with that).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .collectives import placed_sum
from .spatial import partial_bytes, sum_in_order


def shard_range(width: int, n: int, j: int) -> range:
    """Shard j's channels of ``width`` split over ``n`` shards in order: the
    first ``width % n`` shards take one more (255 over 2: 128 and 127)."""
    if not 0 <= j < n:
        raise ValueError(f"shard {j} of {n}")
    base, extra = divmod(width, n)
    start = j * base + min(j, extra)
    return range(start, start + base + (j < extra))


def heads_split(heads: int, n: int) -> bool:
    """Whether ``n`` shards split ``heads`` attention heads evenly (else
    every shard holds the whole attention)."""
    return heads % n == 0


class LocalShards:
    """All N shards of a model in this process, shard j on ``devices[j]``.
    ``sum_across`` takes and returns one tensor per shard this process holds
    (``held``), in shard order."""

    def __init__(self, devices: Sequence[str | torch.device]):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("LocalShards needs at least one device")
        self.moved = {"partials": 0}
        self.sums = 0

    @property
    def n(self) -> int:
        """Shards of the model."""
        return len(self.devices)

    @property
    def held(self) -> list[int]:
        """Indices of the shards this process holds: all of them."""
        return list(range(self.n))

    def sum_across(self, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The shards' partial sums added in shard order on every shard's
        device: every shard gets the same bits."""
        self.sums += 1
        self.moved["partials"] += partial_bytes(parts)
        return sum_in_order(parts)


class RankShards:
    """This rank's model shard alone, one shard a rank of its data index's
    model subgroup (``parallel.init_grid``; the module docstring).
    ``sum_across`` takes and returns a list of one tensor, as
    ``LocalShards``' does for ``held``, differentiably; ``moved`` and
    ``sums`` count what ``LocalShards`` counts for the whole model (forward
    only)."""

    def __init__(self):
        from . import model_group, n_model, shard_index

        self.n, self.index, self.group = n_model(), shard_index(), model_group()
        self.moved = {"partials": 0}
        self.sums = 0

    @property
    def held(self) -> list[int]:
        """Indices of the shards this rank holds: its own."""
        return [self.index]

    def sum_across(self, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """``LocalShards.sum_across`` for this rank's part: the shards'
        parts from their slots, added in shard order (the same bits on
        every shard)."""
        (p,) = parts
        self.sums += 1
        self.moved["partials"] += (self.n - 1) * self.n * p.numel() * p.element_size()
        slots = placed_sum(p.unsqueeze(0), self.index, self.n, 0, self.group, True)
        acc = slots[0]
        for j in range(1, self.n):
            acc = acc + slots[j]
        return [acc]
