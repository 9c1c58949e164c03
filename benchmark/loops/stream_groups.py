"""Recorded sequences served in groups: each item is one call of the
program's streaming pipeline (``cli.py::_stream_groups``: decode on the
calling thread, dispatch on an upload worker, fetch and write on two fetch
workers, groups dispatched ahead) over a sequence of the pool's frames in a
seeded order, read from and written to memory. A unit is an image.

Traffic keys beside teacher_serving's: ``sequence`` (frames a call),
``group`` (the group size), ``warmup_sequence`` (frames a warm-up call)."""

from __future__ import annotations

from ..core.loop import port
from .teacher_serving import TeacherServing


class Loop(TeacherServing):
    def setup(self) -> None:
        self.cli = port("cli")
        self.calls = 0
        self.n = int(self.traffic["warmup_sequence"])  # the warm-up's calls: full groups, fewer
        super().setup()
        self.n = int(self.traffic["sequence"])

    def item(self) -> int:
        n = self.n
        order = self.order.permutation(len(self.frames))[:n]
        keys = [(self.calls, j, int(i)) for j, i in enumerate(order)]
        self.calls += 1
        written: dict = {}

        def write(key, out):
            written[key] = out

        self.cli._stream_groups(self.pred, keys, int(self.traffic["group"]), None, self.rate,
                                write, read=lambda key: self.frames[key[2]])
        for key in keys:  # in order: the sample does not hang on the workers' timing
            if key in written:
                self.offer(key[2], written[key])
        self.attempted += n
        self.failed += sum(key not in written for key in keys)
        return n
