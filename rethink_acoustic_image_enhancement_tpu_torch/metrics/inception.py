"""InceptionV3 pool3 features for literature-comparable FID.

The reference's FID means torchvision InceptionV3 features
(Train/basicsr/metrics/fid.py:7-19; the ``archs/inception.py`` it imports
is not shipped). ``InceptionV3`` is that network as ``nn.Module``s whose
``state_dict`` names are the torchvision / pytorch-fid names one for one, so
a user's ``.pth`` of either family loads strictly once the ``AuxLogits``,
``fc.`` and ``num_batches_tracked`` keys are dropped (``load_inception_pth``):
pytorch-fid's ``pt_inception-2015-12-05-6726825d.pth`` or torchvision's
ImageNet ``inception_v3``. No weights ship with the repo, and none are
downloaded; without a weights file FID takes the ASDQE feature space
(``metrics/fid.py``).

``fid_variant`` switches the two families' behaviour: the FID network
averages without the padding inside its blocks (``count_include_pad=False``)
and max-pools Mixed_7c's ``branch_pool`` (pytorch-fid's FIDInceptionA/C/E
patches); torchvision counts the padding and average-pools everywhere.

Input: NHWC floats on [0, 1], resized to 299x299 (bilinear,
``align_corners=False``, no antialiasing: ``jax.image.resize(...,
antialias=False)``), scaled to [-1, 1]; the feature is the global mean of
the last 2048-channel map.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_BN_EPS = 1e-3


class _BatchNorm(nn.Module):
    """Inference BatchNorm with the running statistics and no
    ``num_batches_tracked`` (the features never train)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, eps=_BN_EPS)


class BasicConv2d(nn.Module):
    """Bias-free conv, BatchNorm (eps 1e-3, running statistics), ReLU."""

    def __init__(self, cin: int, cout: int, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride,
                              padding=padding, bias=False)
        self.bn = _BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _pool3(x, kind: str, count_include_pad: bool):
    """The blocks' 3x3 stride-1 pad-1 ``branch_pool`` pooling."""
    if kind == "max":
        return F.max_pool2d(x, 3, stride=1, padding=1)
    return F.avg_pool2d(x, 3, stride=1, padding=1,
                        count_include_pad=count_include_pad)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool: int, cip: bool):
        super().__init__()
        self.cip = cip
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_pool3(x, "avg", self.cip))
        return torch.cat([self.branch1x1(x), b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, cip: bool):
        super().__init__()
        self.cip = cip
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_pool3(x, "avg", self.cip))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_kind: str, cip: bool):
        super().__init__()
        self.pool_kind, self.cip = pool_kind, cip
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = self.branch_pool(_pool3(x, self.pool_kind, self.cip))
        return torch.cat([self.branch1x1(x), b3, bd, bp], 1)


_MIXED = ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
          "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c")


class InceptionV3(nn.Module):
    """InceptionV3 up to pool3: (N, 3, 299, 299) on [-1, 1] -> (N, 2048)."""

    def __init__(self, fid_variant: bool = True):
        super().__init__()
        cip = not fid_variant  # torch counts the padding; the FID network not
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, cip)
        self.Mixed_5c = InceptionA(256, 64, cip)
        self.Mixed_5d = InceptionA(288, 64, cip)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, cip)
        self.Mixed_6c = InceptionC(768, 160, cip)
        self.Mixed_6d = InceptionC(768, 160, cip)
        self.Mixed_6e = InceptionC(768, 192, cip)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg", cip)
        # the FID network max-pools Mixed_7c's branch_pool (FIDInceptionE_2)
        self.Mixed_7c = InceptionE(2048, "max" if fid_variant else "avg", cip)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in _MIXED:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def pool3_input(x: torch.Tensor, resize: bool = True) -> torch.Tensor:
    """(N, H, W, 3) on [0, 1] -> the network's (N, 3, 299, 299) on [-1, 1]."""
    x = x.permute(0, 3, 1, 2)
    if resize:
        x = F.interpolate(x, size=(299, 299), mode="bilinear",
                          align_corners=False, antialias=False)
    return x * 2.0 - 1.0


def inception_state_dict(state_dict) -> dict[str, torch.Tensor]:
    """A torchvision / pytorch-fid state dict without what the features do
    not use: the auxiliary classifier, ``fc`` and ``num_batches_tracked``."""
    if isinstance(state_dict, dict) and "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    return {k: v.float() for k, v in state_dict.items()
            if not k.startswith(("AuxLogits", "fc."))
            and not k.endswith("num_batches_tracked")}


def load_inception_pth(path: str, fid_variant: bool = True) -> InceptionV3:
    """An ``InceptionV3`` holding a user's torchvision / pytorch-fid
    ``.pth`` (loaded strictly)."""
    model = InceptionV3(fid_variant=fid_variant)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(inception_state_dict(sd), strict=True)
    return model.eval()


def init_weights_(model: InceptionV3, generator: torch.Generator) -> InceptionV3:
    """Seeded random weights and running statistics (no weights ship with
    the repo): He-normal convolutions, BatchNorm weights 1 + N(0, 0.1),
    biases and running means N(0, 0.1), running variances in [1, 1.3)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                std = (2.0 / m.weight[0].numel()) ** 0.5
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
            elif isinstance(m, _BatchNorm):
                c = m.weight.shape
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=generator))
                m.bias.copy_(0.1 * torch.randn(c, generator=generator))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=generator))
                m.running_var.copy_(1 + 0.3 * torch.rand(c, generator=generator))
    return model


def make_inception_feature_fn(weights_path: str, fid_variant: bool = True,
                              batch: int = 8, device=None):
    """``feature_fn`` for ``fid.extract_features``: InceptionV3 pool3
    (2048-d) from a user's ``.pth``, ``batch`` images a forward, on the card
    (``device``: another device) in float32 with TF32 off."""
    from ..eval.infer import highest_precision, resolve_device

    dev = resolve_device(device)
    model = load_inception_pth(weights_path, fid_variant).to(dev)

    @torch.inference_mode()
    def feature_fn(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if x.ndim == 3:
            x = x[None]
        out = []
        with highest_precision():
            for i in range(0, len(x), batch):
                t = torch.from_numpy(x[i:i + batch]).to(dev)
                out.append(model(pool3_input(t)).cpu().numpy())
        return np.concatenate(out, axis=0)

    feature_fn.feature_space = (
        f"inception-pool3({'fid' if fid_variant else 'torchvision'}:"
        f"{weights_path})")
    return feature_fn
