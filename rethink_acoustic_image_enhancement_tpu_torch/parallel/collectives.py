"""The collectives of a data-parallel training step (the data-axis half of
the JAX package's ``parallel/mesh.py``: ``process_shard`` :118-127 and the
global batch that ``shard_batch_pytree`` :64-79 assembles over the mesh).

The JAX step is one program over the global batch. Here each rank holds
``b`` rows of it, rank r rows [r b, (r + 1) b), and these functions give a
rank what that program would see:

  * ``gather_rows``: the global batch on every rank, as an ``all_reduce``
    of a zeroed global buffer into which each rank wrote its rows (adding
    zeros is exact, so every rank gets the rows bit for bit). The
    differentiable form (an all-reduce whose backward is an all-reduce, the
    rule of ``torch.distributed.nn.functional.all_reduce``, which is
    deprecated) carries gradients back: its backward sums the N ranks' identical
    upstream gradients, so each rank's rows get N times theirs, and
    ``reduce_gradients`` divides the sum by N;
  * ``reduce_gradients``: the gradients summed over the ranks in flat
    buckets and divided by N, identical on every rank afterwards;
  * ``broadcast_module``: rank 0's parameters and buffers to every rank;
  * ``agree``: every rank holds the same integer (the checkpoint it resumes).

On a grid of data indices and bands (``train.spatial_shard``,
``parallel.init_grid``) the rows are a data index's, not a rank's: the
bands of one data index hold the same rows and ``gather_rows`` sums over the
data subgroup. ``placed_sum``, the zeroed-buffer sum itself, is also every
exchange of ``parallel/spatial.py::RankBands`` within a spatial subgroup
(halo rows, partial sums, and the join of the bands before the loss).
``reduce_gradients`` sums over the whole world, bands and data alike, and
divides by the world's size: each rank's gradient then carries
n_spatial x n_data times its share, as above.

On a grid of data indices and model shards (``train.model_shard``) the
shards of one data index hold the same rows, as bands do, and their
partial sums are ``placed_sum`` over the model subgroup
(``parallel/tensor.py::RankShards``). That sum's backward is the same sum
of the shards' upstream gradients, the exact adjoint of N copies of the
loss, so after the backward:

  * a split leaf (its slice on one shard: heads or hidden channels of a
    block, a split ``temperature``, the bias shard 0 alone holds) carries
    N times its slice's gradient;
  * a whole leaf (every shard holds it: the LayerNorms, a whole MDTA, the
    layers outside the blocks) carries a different piece on each shard,
    the pieces adding up to N times its gradient.

``reduce_shard_gradients`` therefore sums the whole leaves over the world
and the split leaves over their data subgroup only (the ranks that hold the
same slice), and divides both by the world's size: every rank then holds
the one-process gradient, the whole leaves bit-equal on every rank.
``sum_over_shards_`` adds tensors over the model subgroup: the clip's norm
(each split leaf counted once) and ``models/shards.py::gather_shards``.

Only ``all_reduce`` and ``broadcast`` are used: gloo moves CUDA tensors for
those two alone, and two ranks that share one card must use gloo.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch
import torch.distributed as dist

from . import data_group, data_index, model_group, n_data, n_model, rank, world_size

BUCKET_BYTES = 32 * 2 ** 20


def process_shard(items: Sequence, process_index: int | None = None,
                  process_count: int | None = None) -> list:
    """Data-index-strided host-side sharding (the EnlargedSampler's stride,
    data_sampler.py:40): the bands of one data index get the same items."""
    pi = data_index() if process_index is None else process_index
    pc = n_data() if process_count is None else process_count
    return list(items)[pi::pc]


def local_rows(b: int) -> tuple[int, int]:
    """(first global row, global batch) of this data index's ``b`` rows."""
    return data_index() * b, n_data() * b


def agree(value: int, device, what: str) -> None:
    """Raise on every rank unless every rank holds the same ``value``."""
    if world_size() == 1:
        return
    t = torch.tensor([value, -value], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if int(t[0]) != -int(t[1]):
        raise RuntimeError(f"the ranks disagree on {what}: from {-int(t[1])} "
                           f"to {int(t[0])} (rank {rank()} has {value})")


def map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks of ``group`` (None: the world) whose backward is
    the same sum of the upstream gradients
    (``torch.distributed.nn.functional.all_reduce``'s rule)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def placed_sum(x, i: int, n: int, dim: int, group, differentiable: bool):
    """Each leaf of ``x`` (a tensor or a dict of them, None leaves kept) as
    slot i of n along ``dim``, the other slots zeros, summed over ``group``
    (None: the world): every rank gets every slot bit for bit."""

    def gather(t: torch.Tensor) -> torch.Tensor:
        if not t.is_floating_point():
            raise TypeError(f"a gather sums floats; got {t.dtype}")
        d = dim % t.dim()
        size = t.shape[d]
        shape = list(t.shape)
        if differentiable:
            shape[d] = i * size
            before = t.new_zeros(shape)
            shape[d] = (n - 1 - i) * size
            after = t.new_zeros(shape)
            return _AllReduceSum.apply(torch.cat([before, t, after], d), group)
        shape[d] = n * size
        buf = t.new_zeros(shape)
        buf.narrow(d, i * size, size).copy_(t)
        dist.all_reduce(buf, group=group)
        return buf

    return map_tensors(gather, x)


def gather_rows(x, differentiable: bool = False):
    """The global batch of a tensor (or a dict of them, None leaves kept)
    of which this data index holds its rows; ``x`` itself where there is
    one data index. Every rank must hold the same number of rows."""
    if n_data() == 1:
        return x
    return placed_sum(x, data_index(), n_data(), 0, data_group(), differentiable)


def _buckets(tensors: list[torch.Tensor], limit: int) -> list[list[torch.Tensor]]:
    """Consecutive runs of one dtype and device, each under ``limit``
    bytes (a single larger tensor is a bucket of its own)."""
    out: list[list[torch.Tensor]] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if not out or size + nbytes > limit or (t.dtype, t.device) != (
                out[-1][0].dtype, out[-1][0].device):
            out.append([])
            size = 0
        out[-1].append(t)
        size += nbytes
    return out


def _zero_filled(params: Iterable[torch.nn.Parameter]) -> list[torch.Tensor]:
    """The parameters' gradients, a missing one set to zeros."""
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    return grads


def _all_reduce_(tensors: list[torch.Tensor], group, divisor: int = 1) -> None:
    """Each tensor summed over ``group`` (None: the world) and divided by
    ``divisor``, in place, in flat buckets: each bucket flattened, reduced
    once and copied back."""
    for bucket in _buckets(tensors, BUCKET_BYTES):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        if divisor != 1:
            flat.div_(divisor)
        torch._foreach_copy_(bucket, [v.view_as(g) for v, g in zip(
            flat.split([g.numel() for g in bucket]), bucket)])


def reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum every parameter's gradient over the ranks and divide by the
    number of ranks, in place (a missing gradient counts as zeros and is
    set)."""
    n = world_size()
    if n == 1:
        return
    _all_reduce_(_zero_filled(params), None, n)


def reduce_shard_gradients(whole: Iterable[torch.nn.Parameter],
                           split: Iterable[torch.nn.Parameter]) -> None:
    """On model shards (module docstring): the ``whole`` leaves' gradients
    summed over the world, the ``split`` leaves' over the data subgroup,
    both divided by the world's size, in place (a missing gradient counts
    as zeros and is set). Every rank passes its leaves in the whole
    model's order."""
    n = world_size()
    whole, split = _zero_filled(whole), _zero_filled(split)
    if n == 1:
        return
    _all_reduce_(whole, None, n)
    if n_data() > 1:
        _all_reduce_(split, data_group(), n)
    elif split:
        torch._foreach_div_(split, n)


def sum_over_shards_(tensors: list[torch.Tensor]) -> None:
    """Each tensor summed over this data index's model shards, in place
    (nothing without shards)."""
    if n_model() > 1 and tensors:
        _all_reduce_(tensors, model_group())


def broadcast_module(*modules: torch.nn.Module | None) -> None:
    """Rank 0's parameters and buffers into every rank's copy of each module
    (None skipped), in flat buckets."""
    if world_size() == 1:
        return

    tensors = [t.data for m in modules if m is not None
               for t in [*m.parameters(), *m.buffers()]]
    for bucket in _buckets(tensors, BUCKET_BYTES):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.broadcast(flat, 0)
        torch._foreach_copy_(bucket, [v.view_as(t) for v, t in zip(
            flat.split([t.numel() for t in bucket]), bucket)])
