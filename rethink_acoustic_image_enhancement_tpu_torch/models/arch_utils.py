"""Stock architecture helpers (Train/basicsr/models/archs/arch_util.py);
the acoustic models use none of them: a residual block without batch
norm, a layer stacker and the scaled initialisation of residual branches.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


def scaled_lecun_init(scale: float = 0.1) -> Callable:
    """default_init_weights' residual scaling (arch_util.py:19-41): an
    in-place initialiser drawing flax's ``lecun_normal`` (a normal of
    variance 1/fan_in truncated at two standard deviations) times
    ``scale``. Returns ``init(weight, generator=None)``."""
    # the standard deviation of a unit normal truncated to [-2, 2]
    trunc_std = 0.87962566103423978

    def init(weight: torch.Tensor, generator: torch.Generator | None = None):
        fan_in = weight[0].numel()
        std = math.sqrt(1.0 / fan_in) / trunc_std
        with torch.no_grad():
            nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            weight.mul_(scale)
        return weight

    return init


class ResidualBlockNoBN(nn.Module):
    """conv3x3 - ReLU - conv3x3 plus the identity (arch_util.py
    ResidualBlockNoBN), the second conv initialised at 0.1 scale, the
    branch times ``res_scale``."""

    def __init__(self, num_feat: int = 64, res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv2 = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        scaled_lecun_init(1.0)(self.conv1.weight)
        scaled_lecun_init(0.1)(self.conv2.weight)
        nn.init.zeros_(self.conv1.bias)
        nn.init.zeros_(self.conv2.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(x))) * self.res_scale


def make_layer(block: Callable[..., nn.Module], num_blocks: int,
               **kwargs) -> nn.Sequential:
    """``num_blocks`` of ``block(**kwargs)`` in sequence (arch_util.py
    make_layer); children named '0', '1', ..."""
    return nn.Sequential(*[block(**kwargs) for _ in range(num_blocks)])
