"""Batch loader and device prefetch (the reference's DataLoader,
EnlargedSampler and CUDAPrefetcher: Train/basicsr/data/__init__.py:56-127,
data_sampler.py, prefetch_dataloader.py:79-126).

  * ``EnlargedShuffleSampler``: one epoch's indices, deterministic in
    (seed, epoch), enlarged by ``ratio`` and strided by rank.
  * ``BatchLoader``: samples fetched on a thread pool, stacked by
    ``default_collate`` into HWC numpy batches (the JAX package's, item for
    item); ``set_epoch(epoch, skip)`` starts an epoch at a later batch, so
    a resumed run reads what an uninterrupted one would.
  * ``BatchUploader``: host batches to the device as NCHW tensors, the one
    place where the layout changes (frame stacks keep theirs: the
    dataset's ``frame_stacks`` says which it gives). Uploads go from pinned
    memory on a side stream, from any thread, ordered against the compute stream by an event
    (``eval/infer.py::Transfers``); ``ready`` makes a batch safe to use.
  * ``DevicePrefetcher``: a background thread that pulls host batches and
    hands them to ``put`` (the loop's subsample and upload) ahead of the
    step that needs them.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from ..eval.infer import Transfers


class EnlargedShuffleSampler:
    """data_sampler.py:6-49: indices for one epoch, deterministic in
    (seed, epoch), optionally enlarged by ``ratio`` and rank-strided."""

    def __init__(self, num_samples: int, ratio: int = 1, rank: int = 0,
                 world_size: int = 1, shuffle: bool = True, seed: int = 0):
        self.num_samples = num_samples
        self.total = int(np.ceil(num_samples * ratio / world_size)) * world_size
        self.rank = rank
        self.world_size = world_size
        self.shuffle = shuffle
        self.seed = seed

    def epoch_indices(self, epoch: int) -> np.ndarray:
        if self.shuffle:
            idx = np.random.default_rng(self.seed + epoch).permutation(self.total)
        else:
            idx = np.arange(self.total)
        idx = idx % self.num_samples
        return idx[self.rank::self.world_size]


def default_collate(samples: list[Any]):
    """Stack a list of (possibly nested dict) samples into batched arrays;
    non-array leaves (paths) are collected into lists."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (str, bytes)):
        return list(samples)
    if isinstance(first, np.ndarray) or np.isscalar(first):
        return np.stack([np.asarray(s) for s in samples])
    return list(samples)


class BatchLoader:
    """Iterate one epoch's batches of a map-style dataset."""

    def __init__(self, dataset, batch_size: int, sampler: EnlargedShuffleSampler,
                 num_workers: int = 4, drop_last: bool = True,
                 collate: Callable = default_collate):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.collate = collate
        self._epoch = 0
        self._skip = 0

    def set_epoch(self, epoch: int, skip: int = 0) -> None:
        """Select the epoch; its first ``skip`` batches are not read."""
        self._epoch = epoch
        self._skip = skip
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler.epoch_indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        indices = self.sampler.epoch_indices(self._epoch)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            # submit batch i+1 while collating batch i
            futures = None
            for b in range(self._skip, len(self)):
                chunk = indices[b * self.batch_size:(b + 1) * self.batch_size]
                next_futures = [pool.submit(self.dataset.__getitem__, int(i))
                                for i in chunk]
                if futures is not None:
                    yield self.collate([f.result() for f in futures])
                futures = next_futures
            if futures is not None:
                yield self.collate([f.result() for f in futures])


def tree_map(fn: Callable, tree, leaf=(np.ndarray, torch.Tensor)):
    """``fn`` over the array leaves of nested dicts; other leaves (paths)
    pass through."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, leaf) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, leaf) else tree


def leaves(tree) -> list:
    """The array leaves of nested dicts, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree] if isinstance(tree, (np.ndarray, torch.Tensor)) else []


def _nchw(t: torch.Tensor, frame_stacks: bool) -> torch.Tensor:
    if t.ndim != 4 or frame_stacks:
        return t
    return t.permute(0, 3, 1, 2).contiguous()


class BatchUploader:
    """HWC host batches -> NCHW device tensors (see the module docstring).
    ``frame_stacks`` (the dataset's) says whether its 4-D arrays are
    (B, F, H, W) stacks, which keep their layout, or NHWC batches (a
    6-channel dual-pixel batch among them)."""

    def __init__(self, device: torch.device, frame_stacks: bool):
        self.device = device
        self.frame_stacks = frame_stacks
        self._transfers = Transfers(device)

    def upload(self, batch: dict) -> tuple[dict, Any]:
        """(the batch with its arrays on the device, still HWC; the event
        that ends their copies). Safe from any thread."""
        dev, event = self._transfers.upload(
            *[torch.from_numpy(np.ascontiguousarray(a)) for a in leaves(batch)])
        it = iter(dev)
        return tree_map(lambda _: next(it), batch), event

    def ready(self, pending: tuple[dict, Any]) -> dict:
        """The uploaded batch, NCHW, ordered after its copies on the
        current stream."""
        batch, event = pending
        self._transfers.on_current(leaves(batch), event)
        return tree_map(lambda t: _nchw(t, self.frame_stacks), batch, torch.Tensor)

    def __call__(self, batch: dict) -> dict:
        return self.ready(self.upload(batch))


class DevicePrefetcher:
    """A background thread pulls host batches through ``put`` into a queue
    of ``depth``, ahead of the consumer. An error in the thread is raised
    to the consumer."""

    def __init__(self, batches: Iterable, put: Callable[[Any], Any],
                 depth: int = 2):
        self._iter = iter(batches)
        self._put = put
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for batch in self._iter:
                if self._stop.is_set():
                    return
                self._q.put((self._put(batch), None))
        except Exception as exc:  # handed to the consumer, which raises it
            self._q.put((None, exc))
        finally:
            close = getattr(self._iter, "close", None)
            if close is not None:  # a generator's pool shuts down here
                close()
            self._q.put((self._done, None))

    def __iter__(self):
        return self

    def __next__(self):
        item, exc = self._q.get()
        if exc is not None:
            raise exc
        if item is self._done:
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the thread: drain the queue until it has ended."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
            self._thread.join(timeout=0.01)
