"""Stall watchdog for unattended training.

A wedged device can leave the training process with its main
thread blocked inside a native call: no Python-level check in the loop
runs again, and the process neither progresses nor exits. The reference
has no analog (its failures, CUDA OOM and NCCL aborts, raise).

``StallWatchdog`` is a daemon thread that hard-exits the process with a
distinctive code when no heartbeat arrives for ``timeout_s``. A
supervising runner relaunches, and ``path.resume_state: auto`` continues
from the last checkpoint. ``os._exit`` is deliberate: a blocked native
call cannot be unwound with an exception.
"""

from __future__ import annotations

import os
import sys
import threading
import time

STALL_EXIT_CODE = 17


class StallWatchdog:
    """Hard-exit the process when ``beat()`` goes quiet for timeout_s.

    The timeout must exceed the longest legitimate gap between beats:
    the first step at a new curriculum shape, validation, and checkpoint
    writes. Beats are
    placed after each of those in the training loop.
    """

    def __init__(self, timeout_s: float, on_stall=None,
                 exit_code: int = STALL_EXIT_CODE, poll_s: float | None = None):
        self.timeout_s = float(timeout_s)
        self.exit_code = exit_code
        self._on_stall = on_stall
        self._poll_s = poll_s or min(max(self.timeout_s / 10.0, 0.05), 30.0)
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def beat(self) -> None:
        self._last = time.monotonic()

    def start(self) -> "StallWatchdog":
        self.beat()
        self._thread = threading.Thread(
            target=self._run, name="raie-stall-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            quiet = time.monotonic() - self._last
            if quiet > self.timeout_s:
                if self._on_stall is not None:
                    self._on_stall(quiet)
                    return
                print(
                    f"[raie] stall watchdog: no progress for {quiet:.0f}s "
                    f"(> {self.timeout_s:.0f}s) — exiting {self.exit_code} "
                    "for the supervisor to relaunch (auto-resume will "
                    "continue from the last checkpoint)",
                    file=sys.stderr, flush=True)
                sys.stderr.flush()
                os._exit(self.exit_code)
