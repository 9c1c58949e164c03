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

Only ``all_reduce`` and ``broadcast`` are used: gloo moves CUDA tensors for
those two alone, and two ranks that share one card must use gloo.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch
import torch.distributed as dist

from . import rank, world_size

BUCKET_BYTES = 32 * 2 ** 20


def process_shard(items: Sequence, process_index: int | None = None,
                  process_count: int | None = None) -> list:
    """Rank-strided host-side sharding (the EnlargedSampler's stride,
    data_sampler.py:40)."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    return list(items)[pi::pc]


def local_rows(b: int) -> tuple[int, int]:
    """(first global row, global batch) of this rank's ``b`` rows."""
    return rank() * b, world_size() * b


def agree(value: int, device, what: str) -> None:
    """Raise on every rank unless every rank holds the same ``value``."""
    if world_size() == 1:
        return
    t = torch.tensor([value, -value], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if int(t[0]) != -int(t[1]):
        raise RuntimeError(f"the ranks disagree on {what}: from {-int(t[1])} "
                           f"to {int(t[0])} (rank {rank()} has {value})")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose backward is the same sum of the upstream
    gradients (``torch.distributed.nn.functional.all_reduce``'s rule)."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def gather_rows(x, differentiable: bool = False):
    """The global batch of a tensor (or a dict of them, None leaves kept)
    of which this rank holds its rows; ``x`` itself in a single process.
    Every rank must hold the same number of rows."""
    n = world_size()
    if n == 1:
        return x
    r = rank()

    def gather(t: torch.Tensor) -> torch.Tensor:
        if not t.is_floating_point():
            raise TypeError(f"gather_rows sums floats; got {t.dtype}")
        b = t.shape[0]
        if differentiable:
            before = t.new_zeros((r * b, *t.shape[1:]))
            after = t.new_zeros(((n - 1 - r) * b, *t.shape[1:]))
            return _AllReduceSum.apply(torch.cat([before, t, after]))
        buf = t.new_zeros((n * b, *t.shape[1:]))
        buf[r * b:(r + 1) * b] = t
        dist.all_reduce(buf)
        return buf

    return _tree_map(gather, x)


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


def reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum every parameter's gradient over the ranks and divide by the
    number of ranks, in place (a missing gradient counts as zeros and is
    set). Each bucket is flattened, reduced once and copied back."""
    n = world_size()
    if n == 1:
        return

    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    for bucket in _buckets(grads, BUCKET_BYTES):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat)
        flat.div_(n)
        torch._foreach_copy_(bucket, [v.view_as(g) for v, g in zip(
            flat.split([g.numel() for g in bucket]), bucket)])


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
