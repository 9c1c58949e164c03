"""One client in a closed loop: each item is one ``TeacherPredictor``
request on the next frame of the pool (a seeded order, drawn anew each
pass), sent when the previous reply has returned. A unit is a request; its
host-clock time is its latency."""

from __future__ import annotations

from .teacher_serving import TeacherServing


class Loop(TeacherServing):
    def setup(self) -> None:
        self._queue: list[int] = []
        super().setup()

    def item(self) -> int:
        if not self._queue:
            self._queue = [int(i) for i in self.order.permutation(len(self.frames))]
        idx = self._queue.pop()
        self.attempted += 1
        out = self.pred(self.frames[idx], self.rate)
        if "hq" not in out:
            self.failed += 1
        self.offer(idx, out)
        return 1
