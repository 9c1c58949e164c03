"""Row bands: one image split by rows over the devices of a mesh's spatial
axis (the JAX package shards H over ``spatial`` and lets XLA's partitioner
insert the halo exchanges and the MDTA's pixel-axis sums).

Band i of N holds rows [i h, (i + 1) h) of an image of N h rows. Two rules
make a layer exact on bands (``models/bands.py`` applies them layer by
layer):

  * a conv whose taps reach ``r`` rows up and down reads ``r`` halo rows
    from each neighbour, zeros at the image's top and bottom edge, where
    the unsplit conv zero-pads (``exchange_halo``);
  * a sum over all pixels (the MDTA's Gram and q/k norms) is each band's
    partial sum added across bands in band order (``sum_across``).

Two forms give ``exchange_halo`` and ``sum_across`` and count the same bytes
(``moved``):

  * ``LocalBands`` (serving, ``TeacherPredictor(mesh=...)``): one process
    drives every band, as JAX's single controller drives every device of
    the mesh, band i on ``devices[i]``, exchanged by copies. A copy between
    two cards is a ``non_blocking`` copy ordered by events on each device's
    current stream: the destination's stream waits for what was queued on
    the source's before the copy. ``fill_halo`` fills halo rows in place
    (the stage kernel's band form, ``ops/stage.py``);
  * ``RankBands`` (training, ``train.spatial_shard``): one band per rank,
    the ranks of one data index's spatial subgroup (``parallel.init_grid``),
    which also ``take`` their band of a batch and ``join`` the bands of an
    output. Every exchange is ``parallel/collectives.py::placed_sum``, an
    ``all_reduce`` of a zeroed buffer in which each band wrote its own slot
    (gloo moves CUDA tensors for ``all_reduce`` and ``broadcast`` alone);
    adding zeros is exact, and the partial sums are then added in band
    order from the slots, so every rank gets ``LocalBands``' bits.

Both are differentiable through autograd: the halo rows are copies into
views of a buffer (``LocalBands``: from the neighbour's band; ``RankBands``:
from the slots, whose backward is the same ``all_reduce`` of the slots'
gradients), so each halo row's gradient goes back to the band that owns the
row and adds to that band's edge rows (zeros at the image's edges take
none); the sum's backward hands each band the sum of the bands' upstream
gradients.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .collectives import map_tensors, placed_sum


def split_rows(x: torch.Tensor, devices: Sequence[torch.device], dim: int = -2
               ) -> list[torch.Tensor]:
    """``x`` cut into ``len(devices)`` equal bands along ``dim``, band i on
    ``devices[i]``."""
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} rows do not split into {n} equal bands")
    return [_to(band, torch.device(d)) for band, d in zip(x.chunk(n, dim), devices)]


def join_rows(bands: Sequence[torch.Tensor], device: torch.device, dim: int = -2
              ) -> torch.Tensor:
    """The bands put back together along ``dim`` on ``device``."""
    return torch.cat([_to(b, torch.device(device)) for b in bands], dim)


def _copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst[...] = src without waiting on the host; from another card, after
    an event that ends what the source's current stream had queued."""
    if src.device != dst.device and src.device.type == dst.device.type == "cuda":
        event = torch.cuda.current_stream(src.device).record_event()
        torch.cuda.current_stream(dst.device).wait_event(event)
    dst.copy_(src, non_blocking=True)


def _empty_as(x: torch.Tensor, shape) -> torch.Tensor:
    """An empty tensor of ``shape`` in x's memory layout: a channels-last
    x (the NHWC upload seen as NCHW) gives channels-last, as the whole
    image's convs see it (cuDNN picks its algorithm, and so its rounding, by
    layout)."""
    last = x.dim() == 4 and x.shape[1] > 1 and x.stride(1) == 1 and not x.is_contiguous()
    return torch.empty(shape, dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last if last else torch.contiguous_format)


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device`` (itself where it lies there already)."""
    if t.device == device:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    _copy_into(out, t)
    return out


def sum_in_order(parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The parts added in their order on every part's device: every device
    gets the same bits (the rule of ``LocalBands.sum_across`` and of
    ``parallel/tensor.py::LocalShards.sum_across``)."""
    out = []
    for d in (p.device for p in parts):
        acc = _to(parts[0], d)
        for p in parts[1:]:
            acc = acc + _to(p, d)
        out.append(acc)
    return out


def partial_bytes(parts: Sequence[torch.Tensor]) -> int:
    """The bytes ``sum_in_order`` hands between parts: each part reaches
    every other part's device."""
    return (len(parts) - 1) * sum(p.numel() * p.element_size() for p in parts)


class LocalBands:
    """All N bands of an image in this process, band i on ``devices[i]``
    (devices may repeat: bands can share a card). Each method takes and
    returns one tensor per band this process holds (``held``), in band
    order. ``moved`` counts the bytes one band hands another: halo rows,
    and partial sums (another band's part reaching a band's device)."""

    def __init__(self, devices: Sequence[str | torch.device]):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("LocalBands needs at least one device")
        self.moved = {"halo": 0, "partials": 0}

    @property
    def n(self) -> int:
        """Bands of the image."""
        return len(self.devices)

    @property
    def held(self) -> list[int]:
        """Indices of the bands this process holds: all of them."""
        return list(range(self.n))

    def fill_halo(self, bufs: Sequence[torch.Tensor], rows: int, dim: int = -2) -> None:
        """In place: each band's buffer holds its own rows with ``rows``
        halo rows above and below them along ``dim``; the halo rows get
        the neighbours' nearest own rows, zeros at the image's edges."""
        own = bufs[0].shape[dim] - 2 * rows
        if own < rows:
            raise ValueError(f"a band of {own} rows cannot give {rows} halo rows")
        for i, buf in enumerate(bufs):
            top, bottom = buf.narrow(dim, 0, rows), buf.narrow(dim, rows + own, rows)
            if i > 0:
                _copy_into(top, bufs[i - 1].narrow(dim, own, rows))
            else:
                top.zero_()
            if i < len(bufs) - 1:
                _copy_into(bottom, bufs[i + 1].narrow(dim, rows, rows))
            else:
                bottom.zero_()
        self.moved["halo"] += 2 * (len(bufs) - 1) * top.numel() * top.element_size()

    def exchange_halo(self, bands: Sequence[torch.Tensor], rows: int, dim: int = -2
                      ) -> list[torch.Tensor]:
        """Each band with ``rows`` rows of its neighbours above and below
        it along ``dim`` (zeros at the image's edges), in the band's memory
        layout: what a conv that reaches ``rows`` rows reads."""
        bufs = []
        for x in bands:
            shape = list(x.shape)
            shape[dim] += 2 * rows
            buf = _empty_as(x, shape)
            buf.narrow(dim, rows, x.shape[dim]).copy_(x)
            bufs.append(buf)
        self.fill_halo(bufs, rows, dim)
        return bufs

    def sum_across(self, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The bands' partial sums added in band order on every band's
        device: every band gets the same bits."""
        self.moved["partials"] += partial_bytes(parts)
        return sum_in_order(parts)


class RankBands:
    """This rank's band alone, one band per rank of its data index's spatial
    subgroup (``parallel.init_grid``; the module docstring).
    ``exchange_halo`` and ``sum_across`` take and return a list of one
    tensor, as ``LocalBands``' do for ``held``; ``moved`` counts what
    ``LocalBands`` counts for the whole image (the bytes one band hands
    another, forward only)."""

    def __init__(self):
        from . import band_index, n_spatial, spatial_group

        self.n, self.index, self.group = n_spatial(), band_index(), spatial_group()
        self.moved = {"halo": 0, "partials": 0}

    @property
    def held(self) -> list[int]:
        """Indices of the bands this rank holds: its own."""
        return [self.index]

    def take(self, tree, dim: int = -2):
        """This rank's band of every leaf of ``tree`` (a tensor or a dict of
        them) along ``dim``: rows [i h, (i + 1) h) of N h."""

        def band(x: torch.Tensor) -> torch.Tensor:
            if x.shape[dim] % self.n:
                raise ValueError(f"{x.shape[dim]} rows do not split into {self.n} "
                                 "equal bands")
            h = x.shape[dim] // self.n
            return x.narrow(dim, self.index * h, h)

        return map_tensors(band, tree)

    def join(self, tree, dim: int = -2):
        """The whole images of which this rank holds a band of every leaf
        along ``dim``, on every band, differentiably (its backward hands
        each band the sum of the bands' upstream gradients over its rows).
        Every band must hold as many rows."""
        return placed_sum(tree, self.index, self.n, dim, self.group, True)

    def exchange_halo(self, bands: Sequence[torch.Tensor], rows: int, dim: int = -2
                      ) -> list[torch.Tensor]:
        """``LocalBands.exchange_halo`` for this rank's band, differentiably:
        every band's first and last rows in its slot, summed over the
        spatial subgroup, then the neighbours' read into the halo rows."""
        (x,) = bands
        dim = dim % x.dim()
        own = x.shape[dim]
        if own < rows:
            raise ValueError(f"a band of {own} rows cannot give {rows} halo rows")
        edges = torch.stack([x.narrow(dim, 0, rows), x.narrow(dim, own - rows, rows)])
        slots = placed_sum(edges.unsqueeze(0), self.index, self.n, 0, self.group, True)
        shape = list(x.shape)
        shape[dim] += 2 * rows
        buf = _empty_as(x, shape)
        buf.narrow(dim, rows, own).copy_(x)
        # the top halo is band i - 1's last rows, the bottom band i + 1's first
        for at, j, edge in ((0, self.index - 1, 1), (rows + own, self.index + 1, 0)):
            if 0 <= j < self.n:
                buf.narrow(dim, at, rows).copy_(slots[j, edge])
            else:
                buf.narrow(dim, at, rows).zero_()
        self.moved["halo"] += 2 * (self.n - 1) * edges[0].numel() * x.element_size()
        return [buf]

    def sum_across(self, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """``LocalBands.sum_across`` for this rank's part, differentiably:
        the bands' parts from their slots, added in band order (the same
        bits on every band)."""
        (p,) = parts
        self.moved["partials"] += (self.n - 1) * self.n * p.numel() * p.element_size()
        slots = placed_sum(p.unsqueeze(0), self.index, self.n, 0, self.group, True)
        acc = slots[0]
        for j in range(1, self.n):
            acc = acc + slots[j]
        return [acc]
