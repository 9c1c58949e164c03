"""What the harness asks of a traffic mix's loop.

A loop builds the program under test and the cell's inputs from the seed
(``setup``, warm-up included), runs one item of work to completion
(``item``: a request, a sequence, a batch or a step; it returns the units
of work the item completed), releases the program's state (``release``)
and then compares what the program produced with the plain reference
(``check``: each compared number by name). ``control`` gives the same
numbers with the reference in a lower precision put in the program's place
(for setting limits; the benchmark's runs never call it)."""

from __future__ import annotations

import importlib
import sys

import torch

PORT = "rethink_acoustic_image_enhancement_tpu_torch"


def port(module: str):
    """A module of the program under test, imported when a loop sets up."""
    return importlib.import_module(f"{PORT}.{module}")


class Loop:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.config, self.traffic = cell.config, cell.traffic
        self.attempted = 0
        self.failed = 0
        self._hooks: list = []

    # -- set-up and the window
    def setup(self) -> None:
        raise NotImplementedError

    def item(self) -> int:
        raise NotImplementedError

    def after_window(self) -> None:
        """Work of the check that runs on the program's state as the window
        left it, once the window has closed (none by default)."""

    def finish(self) -> None:
        """Wait until every item handed back so far is complete on the
        device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def flops_per_unit(self) -> float:
        raise NotImplementedError

    def counters(self) -> dict[str, int]:
        """The program's own counters, read before and after a window: every
        integer ``launches`` of a callable in a loaded module of the
        program (its kernel wrappers count their launches so), by the
        callable's own name, ``<module>.<name>``."""
        out = {}
        for mod_name, mod in list(sys.modules.items()):
            if mod is None or not (mod_name == PORT or mod_name.startswith(PORT + ".")):
                continue
            for name, obj in list(vars(mod).items()):
                n = getattr(obj, "launches", None)
                if callable(obj) and isinstance(n, int) and not isinstance(n, bool):
                    own = getattr(obj, "__module__", None) or mod_name
                    out[f"{own[len(PORT) + 1:] or own}.{getattr(obj, '__name__', name)}"] = n
        return out

    def spans(self, on: bool) -> None:
        """Open the benchmark's spans around the program's layers (the
        traced window), or remove them."""
        for h in self._hooks:
            h.remove()
        self._hooks = self.span_hooks() if on else []

    def span_hooks(self) -> list:
        return []

    # -- after the window
    def release(self) -> None:
        raise NotImplementedError

    def check(self) -> dict[str, float]:
        raise NotImplementedError

    def control(self) -> dict[str, float]:
        raise NotImplementedError
