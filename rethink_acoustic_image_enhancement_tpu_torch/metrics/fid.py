"""FID (Train/basicsr/metrics/fid.py's math) with a pluggable feature space.

The Frechet distance between Gaussians fitted to two feature sets, and the
feature extraction around it. The reference takes torchvision InceptionV3
features; no pretrained weights are assumed here, so the extractor is an
argument: any (N, H, W, 3) [0, 1] -> (N, D) callable. The default is the
trained ASDQE scorer's pooled embedding (``make_asdqe_feature_fn``);
``metrics/inception.py`` gives InceptionV3 pool3 from a user's weights.
"""

from __future__ import annotations

import copy
import os
from typing import Callable, Iterable

import numpy as np
import torch
from scipy import linalg

ZOO_SCORER = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "artifacts", "torch_zoo", "asdqe.pth")


def calculate_stats(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of an (N, D) feature matrix."""
    features = np.asarray(features, np.float64)
    return features.mean(axis=0), np.cov(features, rowvar=False)


def extract_features(batches: Iterable[np.ndarray],
                     feature_fn: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    return np.concatenate([np.asarray(feature_fn(b)) for b in batches], axis=0)


def calculate_fid(mu1: np.ndarray, sigma1: np.ndarray,
                  mu2: np.ndarray, sigma2: np.ndarray,
                  eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)), the TTUR
    implementation: the square root again with ``eps`` on the diagonals
    where it is not finite, and a ValueError where its diagonal keeps an
    imaginary part above 1e-3."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"mismatched statistics: {mu1.shape} / {mu2.shape}, "
                         f"{sigma1.shape} / {sigma2.shape}")
    diff = mu1 - mu2
    # no ``disp=False``: deprecated, and in SciPy 1.17 it returns one value
    # for a 1x1 matrix, which the JAX package then fails to unpack
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def fid_between_feature_sets(f1: np.ndarray, f2: np.ndarray) -> float:
    return calculate_fid(*calculate_stats(f1), *calculate_stats(f2))


def make_asdqe_feature_fn(model=None, seed: int = 0, device=None):
    """The default FID feature extractor: the ASDQE scorer's pooled
    embedding before its MLP ((N, H, W, 3) [0, 1] -> (N, 48)), with
    lq = gt = the batch, so the difference branch is silent; on the card
    (``device``: another device), float32 with TF32 off.

    ``model`` is a ``DenoiseRatePredictor`` of the user's. Without one the
    trained scorer ``artifacts/torch_zoo/asdqe.pth`` is used (the JAX
    package's default, ``artifacts/asdqe_full50ep``, exported), and where
    that file is absent a scorer with seeded random weights
    (``models/asdqe.py::init_weights_``), whose features are a known valid
    substitute and comparable across runs. Which space was taken is printed
    and kept as ``feature_fn.feature_space``."""
    from ..convert.weights import load_pth
    from ..eval.infer import highest_precision, resolve_device
    from ..models.asdqe import DenoiseRatePredictor, init_weights_

    feature_space = "asdqe-user-params"
    if model is None:
        if os.path.isfile(ZOO_SCORER):
            model = load_pth(DenoiseRatePredictor(), ZOO_SCORER)
            feature_space = f"asdqe-trained({ZOO_SCORER})"
        else:
            model = init_weights_(DenoiseRatePredictor(),
                                  torch.Generator().manual_seed(seed))
            feature_space = f"asdqe-seeded-random(seed={seed})"
        # whether FID values compare across checkouts hangs on this
        print(f"[fid] feature space: {feature_space}")
    dev = resolve_device(device)
    model = copy.deepcopy(model).to(dev).eval()  # the caller's stays as it is

    @torch.inference_mode()
    def feature_fn(batch: np.ndarray) -> np.ndarray:
        x = np.asarray(batch, np.float32)
        if x.ndim == 3:
            x = x[None]
        t = torch.from_numpy(x).to(dev).permute(0, 3, 1, 2)
        with highest_precision():
            return model(t, t, return_features=True).float().cpu().numpy()

    feature_fn.feature_space = feature_space
    return feature_fn


def fid_between_folders(dir1: str, dir2: str, feature_fn=None,
                        inception_weights: str | None = None) -> float:
    """FID between two image folders, one image a forward (the global
    pooling makes the embedding size-independent): in ``feature_fn``'s
    space, else InceptionV3 pool3 from ``inception_weights`` (a user's
    torchvision / pytorch-fid ``.pth``), else the default ASDQE space."""
    from ..utils.image_io import imread_rgb, list_images

    if feature_fn is None and inception_weights:
        from .inception import make_inception_feature_fn

        feature_fn = make_inception_feature_fn(inception_weights)
    feature_fn = feature_fn or make_asdqe_feature_fn()

    def feats(folder):
        paths = list_images(folder)
        if len(paths) < 2:
            raise ValueError(f"need >=2 images in {folder} to fit stats")
        return extract_features((imread_rgb(p)[None] for p in paths), feature_fn)

    return fid_between_feature_sets(feats(dir1), feats(dir2))
