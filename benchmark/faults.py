"""Faults planted in the program under test, to show that a cell's check
fails them: each a context manager that breaks the timed path underneath
the harness and restores it on leaving.

  altered    every uint8 answer raised by 3 levels where the device
             produces it (a token or an answer altered where produced);
  misrouted  each served group's answers handed back in reverse order (an
             answer written for another frame);
  half_batch half of the batch left out: the student serves the first half
             of a batch's stacks and repeats them; a training step takes
             its loss, the mean, over the first half of the batch;
  frozen     a training step that leaves its state unchanged (AdamW's
             update skipped).
"""

from __future__ import annotations

import contextlib

from benchmark.core.loop import port


@contextlib.contextmanager
def _patched(module: str, owner: str | None, name: str, make):
    mod = port(module)
    target = getattr(mod, owner) if owner else mod
    orig = getattr(target, name)
    setattr(target, name, make(orig))
    try:
        yield
    finally:
        setattr(target, name, orig)


def altered():
    def make(orig):
        def to_ubyte(x):
            y = orig(x)
            return (y.int() + 3).clamp(0, 255).to(y.dtype)
        return to_ubyte
    return _patched("eval.infer", None, "_to_ubyte_device", make)


def misrouted():
    def make(orig):
        def fetch_group(self, handle, zero_mask=True):
            return orig(self, handle, zero_mask)[::-1]
        return fetch_group
    return _patched("eval.infer", "TeacherPredictor", "fetch_group", make)


@contextlib.contextmanager
def half_batch():
    def serve(orig):
        def forward_device(self, stack, model):
            n = max(stack.shape[0] // 2, 1)
            out = orig(self, stack[:n], model)
            return out.repeat((-(-stack.shape[0] // n),) + (1,) * (out.ndim - 1))[:stack.shape[0]]
        return forward_device

    def train(orig):
        def forward_loss(self, model, lq, gt, rng):
            n = max(lq.shape[0] // 2, 1)
            return orig(self, model, lq[:n], gt[:n], rng)
        return forward_loss

    with _patched("eval.infer", "StudentPredictor", "_forward_device", serve), \
            _patched("train.trainer", "Trainer", "_forward_loss", train):
        yield


@contextlib.contextmanager
def frozen():
    import torch

    orig = torch.optim.AdamW.step
    torch.optim.AdamW.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.AdamW.step = orig


FAULTS = {"altered": altered, "misrouted": misrouted, "half_batch": half_batch,
          "frozen": frozen}

# the faults each kind of cell can have, by its traffic's loop
BY_LOOP = {"stream_groups": ("altered", "misrouted"), "request": ("altered",),
             "student_batch": ("altered", "half_batch"),
             "train_student": ("half_batch", "frozen")}
