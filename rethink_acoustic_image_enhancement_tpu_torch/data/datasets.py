"""Map-style datasets returning HWC float32 numpy items.

The port's copy of the JAX package's datasets (the reference's
Train/basicsr/data/paired_image_dataset.py and single_image_dataset.py;
the video and face sets are in ``video_datasets.py``), item for item the
same:

  * HWC float32 numpy out; the teacher's items are
    ``{'lq': {'img', 'denoise_rate'}, 'gt': {'hq', 'sr'}}`` as in the
    reference, channels last. The loader's upload turns batches to NCHW.
    The student's items are (F, H, W) frame stacks, which stay as they are.
  * every random draw comes from a generator seeded by
    ``SeedSequence([seed, epoch, index])``: deterministic, safe across
    worker threads and re-rolled per epoch (``set_epoch``).

Every read goes through a ``FileClient`` (``io_backend``: disk, lmdb or
memcached) and decodes with ``utils/image_io.py`` (cv2, else PIL, else the
numpy PNG decoder); the dual-pixel set's 16-bit PNGs need cv2.
``Dataset_PairedImage``, ``Dataset_GaussianDenoising`` and
``Dataset_SingleImage`` read LMDB shards (``data/lmdb_util.py``); the
datasets that pair several folders by name refuse them, as the reference's
do.
"""

from __future__ import annotations

import json
import os.path as osp
from typing import Any

import numpy as np

from ..ops.mask import input_mask_np
from ..utils import native
from ..utils.image_io import imfrombytes_bgr, imfrombytes_gray
from .lmdb_util import paths_from_lmdb
from .pairing import (
    paired_multipaths_from_folder,
    paired_paths_from_folder,
    paired_paths_from_folder_param,
    paired_paths_from_lmdb,
    paired_paths_from_meta_info_file,
    scan_files,
)
from .transforms import (
    add_gaussian_noise,
    add_random_noise,
    pad_image_center,
    pad_to_min_size,
    paired_random_crop,
    random_augmentation,
    sync_augment_multi_scale,
)


def imfrombytes_16bit(buf: bytes) -> np.ndarray:
    """Encoded 8- or 16-bit image bytes -> float32 [0, 1] in the file's
    layout, BGR for colour (img_util.imfrombytesDP: IMREAD_UNCHANGED, then
    /65535 for 16 bits and /255 for 8)."""
    import cv2

    img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError("failed to decode image bytes")
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32) / 255.0


def _reflect101_pad_to(img: np.ndarray, target: int) -> np.ndarray:
    """cv2.BORDER_REFLECT_101 bottom/right pad to a minimum size
    (paired_image_dataset.py:1019-1029)."""
    h, w = img.shape[:2]
    hp, wp = max(0, target - h), max(0, target - w)
    if hp == 0 and wp == 0:
        return img
    spec = [(0, hp), (0, wp)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, spec, mode="reflect")


class _SeededDataset:
    """Per-(epoch, index) generator and an optional decode cache.
    ``frame_stacks`` is True where the items are (F, H, W) frame stacks,
    False where their images are HWC.

    ``cache_decoded: true`` in the dataset options keeps decoded images in
    RAM by path (the reference decodes the whole source image for every
    crop); opt-in, because it holds the decoded corpus in host memory."""

    frame_stacks = False

    def __init__(self, seed: int = 0, cache_decoded: bool = False,
                 io_opt: dict | None = None):
        self._seed = seed
        self._epoch = 0
        self._decode_cache: dict[tuple, np.ndarray] | None = (
            {} if cache_decoded else None)
        self._io_opt = dict(io_opt or {"type": "disk"})
        self._file_client = None  # built lazily, like the reference's

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _client(self):
        if self._file_client is None:
            from .file_client import FileClient

            kwargs = {k: v for k, v in self._io_opt.items() if k != "type"}
            self._file_client = FileClient(self._io_opt.get("type", "disk"),
                                           **kwargs)
        return self._file_client

    def _read(self, path: str, key: str = "default",
              decode=imfrombytes_bgr) -> np.ndarray:
        """``decode`` of the bytes the file client gives for ``path`` (a
        file path on disk, a record key in LMDB) under client ``key``: BGR
        float32 [0, 1] HWC by default, ``imfrombytes_gray`` for HW
        grayscale. Through the cache; a private copy (corruption and
        augmentation must not write cached memory)."""
        cache_key = (key, decode.__name__, path)
        img = None if self._decode_cache is None else self._decode_cache.get(cache_key)
        if img is None:
            buf = self._client().get(path, key)
            if buf is None:
                raise IOError(f"{self._io_opt.get('type', 'disk')} backend has "
                              f"no entry for {path!r} (client {key!r})")
            img = decode(buf)
            if self._decode_cache is None:
                return img
            self._decode_cache[cache_key] = img
        return img.copy()

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self._seed, self._epoch, index]))


def _io_opt_no_lmdb(opt: dict, name: str) -> dict:
    """``io_backend`` of a dataset that pairs several folders by name: LMDB
    is refused, as the reference's such datasets refuse it
    (paired_image_dataset.py:451-453)."""
    io_opt = dict(opt.get("io_backend") or {"type": "disk"})
    if io_opt.get("type") == "lmdb":
        raise NotImplementedError(
            f"{name} does not support the lmdb backend (multi-modality "
            "folder pairing; matches the reference behavior) — use "
            "Dataset_PairedImage for lmdb corpora")
    return io_opt


def _io_opt_lmdb(opt: dict, folders: list[str], keys: list[str]) -> dict:
    """``io_backend`` with one LMDB client per modality: the dataroots are
    the shards (paired_image_dataset.py:343-346)."""
    io_opt = dict(opt.get("io_backend") or {"type": "disk"})
    if io_opt.get("type") == "lmdb":
        io_opt.setdefault("db_paths", folders)
        io_opt.setdefault("client_keys", keys)
    return io_opt


def _single_folder_paths(opt: dict, root: str, io_opt: dict) -> list[str]:
    """One folder's images: a shard's keys, the meta-info file's names or
    the folder's files."""
    if io_opt.get("type") == "lmdb":
        return paths_from_lmdb(root)
    if opt.get("meta_info_file"):
        with open(opt["meta_info_file"]) as f:
            return [osp.join(root, line.split(" ")[0].strip())
                    for line in f if line.strip()]
    return [osp.join(root, f) for f in scan_files(root)]


class PairedImageDataset(_SeededDataset):
    """Generic LQ/GT pairs (Dataset_PairedImage,
    paired_image_dataset.py:299-421): pad, random crop, degenerate-input
    noise, 8-way geometric augmentation; BGR files flipped to RGB. With
    ``io_backend: {type: lmdb}`` the two dataroots are shards and the pairs
    their shared keys."""

    def __init__(self, opt: dict):
        folders = [opt["dataroot_lq"], opt["dataroot_gt"]]
        io_opt = _io_opt_lmdb(opt, folders, ["lq", "gt"])
        super().__init__(opt.get("seed", 0), opt.get("cache_decoded", False),
                         io_opt)
        self.opt = opt
        self.phase = opt.get("phase", "train")
        self.scale = opt.get("scale", 1)
        tmpl = opt.get("filename_tmpl", "{}")
        if io_opt.get("type") == "lmdb":
            self.paths = paired_paths_from_lmdb(folders, ["lq", "gt"])
        elif opt.get("meta_info_file"):
            self.paths = paired_paths_from_meta_info_file(
                folders, ["lq", "gt"], opt["meta_info_file"], tmpl)
        else:
            self.paths = paired_paths_from_folder(folders, ["lq", "gt"], tmpl)
        self.geometric_augs = opt.get("geometric_augs", False)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = self._rng(index)
        p = self.paths[index % len(self.paths)]
        img_gt = self._read(p["gt_path"], "gt")
        img_lq = self._read(p["lq_path"], "lq")

        if self.phase == "train":
            gt_size = self.opt["gt_size"]
            img_lq, img_gt = pad_to_min_size(img_lq, img_gt, gt_size)
            img_gt, img_lq = paired_random_crop(img_gt, img_lq, gt_size,
                                                self.scale, rng)
            # anti-degenerate noise (paired_image_dataset.py:394-398)
            zero_ratio = max(np.mean(img_lq == 0), np.mean(img_lq == 1))
            if zero_ratio > 0.20:
                img_lq = add_random_noise(img_lq, rng)
            if self.geometric_augs:
                img_gt, img_lq = random_augmentation(img_gt, img_lq, rng=rng)

        return {"lq": np.ascontiguousarray(img_lq[..., ::-1]),
                "gt": np.ascontiguousarray(img_gt[..., ::-1]),
                "lq_path": p["lq_path"], "gt_path": p["gt_path"]}


class SuperRestorationParamDataset(_SeededDataset):
    """The teacher's dataset (Dataset_SuperRestoration_param,
    paired_image_dataset.py:857-1105): lq/gt/sr/param paired by basename,
    a per-image JSON 'denoise_rate', joint pad and crop with the SR image at
    2x coordinates, 10% gaussian noise on LQ, synchronised flip/rotation,
    the zero-input epsilon guard, the rate tiled to an (H, W, 1) plane."""

    SR_SCALE = 2
    _KEYS = ("lq", "gt", "sr", "param")

    def __init__(self, opt: dict):
        super().__init__(opt.get("seed", 0), opt.get("cache_decoded", False),
                         _io_opt_no_lmdb(opt, type(self).__name__))
        self.opt = opt
        self.phase = opt.get("phase", "train")
        self.scale = opt.get("scale", 1)
        self.gt_size = opt.get("gt_size", 256)
        self.sr_size = self.gt_size * self.SR_SCALE
        self.geometric_augs = opt.get("geometric_augs", False)
        self.use_denoise_rate = opt.get("denoise_rate", True)
        self.paths = paired_paths_from_folder_param(
            [opt[f"dataroot_{k}"] for k in self._KEYS], list(self._KEYS))

    def __len__(self) -> int:
        return len(self.paths)

    def _denoise_rate(self, p: dict) -> float:
        with open(p["param_path"]) as f:
            dr = json.load(f).get("denoise_rate")
        if not self.use_denoise_rate:
            return 1.0
        return 1.0 if dr is None else float(dr)

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = self._rng(index)
        p = self.paths[index % len(self.paths)]
        img_gt = self._read(p["gt_path"], "gt")
        img_lq = self._read(p["lq_path"], "lq")
        img_sr = self._read(p["sr_path"], "sr")
        denoise_rate = self._denoise_rate(p)

        if self.phase == "train":
            h_gt, w_gt = img_gt.shape[:2]
            h_sr, w_sr = img_sr.shape[:2]
            if h_sr != h_gt * self.SR_SCALE or w_sr != w_gt * self.SR_SCALE:
                raise ValueError(
                    f"SR size mismatch: GT={h_gt}x{w_gt} SR={h_sr}x{w_sr} "
                    f"({p['gt_path']})")
            # reflect101 pad (:1019-1029) to size+2, so that the reference's
            # randint(1, h-1-gt_size) crop window exists
            img_gt = _reflect101_pad_to(img_gt, self.gt_size + 2)
            img_lq = _reflect101_pad_to(img_lq, self.gt_size + 2)
            img_sr = _reflect101_pad_to(img_sr, self.sr_size + 4)
            # joint crop (:1035-1054): offsets in [1, h-1-size]
            h, w = img_gt.shape[:2]
            top = int(rng.integers(1, max(h - 1 - self.gt_size, 1) + 1))
            left = int(rng.integers(1, max(w - 1 - self.gt_size, 1) + 1))
            img_gt = img_gt[top:top + self.gt_size, left:left + self.gt_size]
            img_lq = img_lq[top:top + self.gt_size, left:left + self.gt_size]
            st, sl = top * self.SR_SCALE, left * self.SR_SCALE
            img_sr = img_sr[st:st + self.sr_size, sl:sl + self.sr_size]

            if rng.uniform() < 0.1:  # 10% gaussian noise on LQ (:933-935)
                img_lq = add_gaussian_noise(img_lq, rng)
            if self.geometric_augs:
                img_gt, img_lq, img_sr = sync_augment_multi_scale(
                    [img_gt, img_lq, img_sr], rng)
            # zero-input epsilon guard (:941-944)
            zero_ratio = max(np.mean(img_lq == 0), np.mean(img_lq == 1))
            if zero_ratio > 0.10:
                img_lq = img_lq + 1e-14

        rate_plane = np.full((*img_lq.shape[:2], 1), denoise_rate, np.float32)
        to_rgb = lambda x: np.ascontiguousarray(x[..., ::-1].astype(np.float32))
        return {
            "lq": {"img": to_rgb(img_lq), "denoise_rate": rate_plane},
            "gt": {"hq": to_rgb(img_gt), "sr": to_rgb(img_sr)},
            "lq_path": p["lq_path"], "gt_path": p["gt_path"],
        }


class SuperRestorationDataset(SuperRestorationParamDataset):
    """The lq/gt/sr variant with no JSON folder (Dataset_SuperRestoration,
    paired_image_dataset.py:423-640): the same pad, crop and augmentation,
    denoise_rate fixed at 1."""

    _KEYS = ("lq", "gt", "sr")

    def __init__(self, opt: dict):
        super().__init__({**opt, "denoise_rate": False})

    def _denoise_rate(self, p: dict) -> float:
        return 1.0


class PairedMultiImageDataset(_SeededDataset):
    """The student's dataset (Dataset_PairedMutiImage,
    paired_image_dataset.py:109-297): temporal groups of ``num_pairs``
    grayscale frames with a random stride, centre-padded to the group's
    largest frame and stacked; in training, masked-denoising corruption
    (64%: per-frame Bernoulli masks, 36% of frames at prob + 0.5; else a
    simulated frame interpolation), the degenerate-input guard and 8-way
    augmentation. The 'test1' and 'interpolation' phases apply fixed
    corruptions at evaluation. Items are (F, H, W) float32 stacks."""

    frame_stacks = True

    def __init__(self, opt: dict):
        super().__init__(opt.get("seed", 0), opt.get("cache_decoded", False),
                         _io_opt_no_lmdb(opt, type(self).__name__))
        self.opt = opt
        self.phase = opt.get("phase", "train")
        self.scale = opt.get("scale", 1)
        self.num_pairs = opt.get("num_pairs", 3)
        self.stride_range = tuple(opt.get("stride_range", (1, 5)))
        self.prob = opt.get("prob", 0.0)
        self.geometric_augs = opt.get("geometric_augs", False)
        self._folders = [opt["dataroot_lq"], opt["dataroot_gt"]]
        self.regroup(opt.get("seed", 0))

    def regroup(self, seed: int) -> None:
        """Re-draw the groups' random strides (the reference groups once,
        at construction; here once per epoch)."""
        self.paths = paired_multipaths_from_folder(
            self._folders, ["lq", "gt"], self.num_pairs, self.stride_range,
            seed=seed)

    def set_epoch(self, epoch: int) -> None:
        super().set_epoch(epoch)
        if self.stride_range[0] != self.stride_range[1]:
            self.regroup(self._seed + epoch)

    def __len__(self) -> int:
        return len(self.paths)

    def _corrupt_train(self, lq: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """lq: (H, W, F) (paired_image_dataset.py:219-241); the per-frame
        masks through the host frame masker (``utils/native.py``)."""
        f = lq.shape[2]
        if rng.random() < 0.64:
            probs = np.where(rng.random(f) > 0.64, self.prob + 0.5,
                             self.prob).astype(np.float32)
        else:  # simulated frame interpolation
            if f % 2 != 1:
                raise ValueError(f"frame interpolation needs an odd frame "
                                 f"count, got {f}")
            for i in range(1, f, 2):
                lq[:, :, i] = 0.5 * (lq[:, :, i - 1] + lq[:, :, i + 1])
            probs = np.where(np.arange(f) % 2 == 1, self.prob + 0.5,
                             self.prob).astype(np.float32)
        stack = np.ascontiguousarray(lq.transpose(2, 0, 1))
        masked = native.mask_frames(stack, probs, seed=int(rng.integers(2**62)))
        return np.ascontiguousarray(masked.transpose(1, 2, 0))

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = self._rng(index)
        group = self.paths[index % len(self.paths)]
        gt_frames = [self._read(g["gt_path"], "gt", imfrombytes_gray) for g in group]
        lq_frames = [self._read(g["lq_path"], "lq", imfrombytes_gray) for g in group]
        th = max(img.shape[0] for img in gt_frames)
        tw = max(img.shape[1] for img in gt_frames)
        gt = np.stack([pad_image_center(x, th, tw) for x in gt_frames], axis=-1)
        lq = np.stack([pad_image_center(x, th, tw) for x in lq_frames], axis=-1)

        if self.phase == "train":
            gt_size = self.opt["gt_size"]
            lq, gt = pad_to_min_size(lq, gt, gt_size)
            gt, lq = paired_random_crop(gt, lq, gt_size, self.scale, rng)
            lq = self._corrupt_train(np.ascontiguousarray(lq), rng)
            zero_ratio = max(np.mean(lq == 0), np.mean(lq == 1))
            if zero_ratio > 0.64:
                lq = add_random_noise(lq, rng)
            if self.geometric_augs:
                gt, lq = random_augmentation(gt, lq, rng=rng)
        elif self.phase == "test1":  # fixed corruption (:253-258)
            for i in range(lq.shape[2]):
                boost = 0.6 if rng.random() < 0.2 else 0.0
                lq[:, :, i] = input_mask_np(lq[:, :, i], rng, self.prob + boost)
        elif self.phase == "interpolation":  # (:260-272)
            for i in range(lq.shape[2]):
                if i % 2 == 1:
                    mean_img = 0.5 * (lq[:, :, i - 1] + lq[:, :, i + 1])
                    lq[:, :, i] = input_mask_np(mean_img, rng, self.prob + 0.5)
                else:
                    lq[:, :, i] = input_mask_np(lq[:, :, i], rng, self.prob)

        return {"lq": np.ascontiguousarray(lq.transpose(2, 0, 1)).astype(np.float32),
                "gt": np.ascontiguousarray(gt.transpose(2, 0, 1)).astype(np.float32),
                "lq_path": group[-1]["lq_path"], "gt_path": group[-1]["gt_path"]}


class SIQADataset(_SeededDataset):
    """The scorer's dataset (Dataset_S_IQA, paired_image_dataset.py:643-855):
    lq/gt/param triples, the score read from the JSON file; in training a
    reflect101 pad to ``gt_size + 2``, a joint crop at offsets in
    [1, h-1-size] and synchronised flip/flip/rotation. Items are
    ``{'lq': {'img', 'score'}, 'gt': {'hq'}}``, RGB HWC."""

    def __init__(self, opt: dict):
        super().__init__(opt.get("seed", 0), opt.get("cache_decoded", False),
                         _io_opt_no_lmdb(opt, type(self).__name__))
        self.opt = opt
        self.phase = opt.get("phase", "train")
        self.gt_size = opt.get("gt_size", None)
        self.geometric_augs = opt.get("geometric_augs", False)
        self.paths = paired_paths_from_folder_param(
            [opt["dataroot_lq"], opt["dataroot_gt"], opt["dataroot_param"]],
            ["lq", "gt", "param"])

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = self._rng(index)
        p = self.paths[index % len(self.paths)]
        img_gt = self._read(p["gt_path"], "gt")
        img_lq = self._read(p["lq_path"], "lq")
        with open(p["param_path"]) as f:
            score = float(json.load(f)["score"])

        if self.phase == "train" and self.gt_size:
            img_gt = _reflect101_pad_to(img_gt, self.gt_size + 2)
            img_lq = _reflect101_pad_to(img_lq, self.gt_size + 2)
            h, w = img_gt.shape[:2]
            top = int(rng.integers(1, max(h - 1 - self.gt_size, 1) + 1))
            left = int(rng.integers(1, max(w - 1 - self.gt_size, 1) + 1))
            img_gt = img_gt[top:top + self.gt_size, left:left + self.gt_size]
            img_lq = img_lq[top:top + self.gt_size, left:left + self.gt_size]
            if self.geometric_augs:
                img_gt, img_lq = sync_augment_multi_scale([img_gt, img_lq], rng)

        to_rgb = lambda x: np.ascontiguousarray(x[..., ::-1].astype(np.float32))
        return {"lq": {"img": to_rgb(img_lq), "score": np.float32(score)},
                "gt": {"hq": to_rgb(img_gt)},
                "lq_path": p["lq_path"], "gt_path": p["gt_path"]}


class GaussianDenoisingDataset(_SeededDataset):
    """Synthetic gaussian noise on clean images (Dataset_GaussianDenoising,
    paired_image_dataset.py:1107-1247): in training a pad, crop and
    augmentation, then noise of sigma 'constant', 'random' (uniform in
    sigma_range) or 'choice' (one of sigma_range); in evaluation noise at
    sigma_test from ``default_rng(0)`` for every item (the reference seeds
    numpy with 0 per item). ``in_ch`` 3 reads RGB, 1 grayscale (H, W, 1).
    With ``io_backend: {type: lmdb}`` the dataroot is a shard."""

    def __init__(self, opt: dict):
        root = opt["dataroot_gt"]
        io_opt = _io_opt_lmdb(opt, [root], ["gt"])
        super().__init__(opt.get("seed", 0), opt.get("cache_decoded", False),
                         io_opt)
        self.opt = opt
        self.phase = opt.get("phase", "train")
        self.scale = opt.get("scale", 1)
        self.in_ch = opt.get("in_ch", 3)
        self.geometric_augs = opt.get("geometric_augs", False)
        if self.phase == "train":
            self.sigma_type = opt["sigma_type"]
            self.sigma_range = opt["sigma_range"]
            if self.sigma_type not in ("constant", "random", "choice"):
                raise ValueError(f"sigma_type {self.sigma_type!r}: expected "
                                 "'constant', 'random' or 'choice'")
        else:
            self.sigma_test = opt["sigma_test"]
        self.paths = _single_folder_paths(opt, root, io_opt)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = self._rng(index)
        path = self.paths[index % len(self.paths)]
        if self.in_ch == 3:
            img_gt = np.ascontiguousarray(self._read(path, "gt")[..., ::-1])
        else:
            img_gt = self._read(path, "gt", imfrombytes_gray)[..., None]
        img_lq = img_gt.copy()

        if self.phase == "train":
            gt_size = self.opt["gt_size"]
            img_lq, img_gt = pad_to_min_size(img_lq, img_gt, gt_size)
            img_gt, img_lq = paired_random_crop(img_gt, img_lq, gt_size,
                                                self.scale, rng)
            if self.geometric_augs:
                img_gt, img_lq = random_augmentation(img_gt, img_lq, rng=rng)
            if self.sigma_type == "constant":
                sigma = float(self.sigma_range)
            elif self.sigma_type == "random":
                sigma = float(rng.uniform(*self.sigma_range))
            else:
                sigma = float(rng.choice(self.sigma_range))
            img_lq = img_lq + rng.standard_normal(img_lq.shape) * (sigma / 255.0)
        else:
            img_lq = img_lq + np.random.default_rng(0).normal(
                0, self.sigma_test / 255.0, img_lq.shape)

        return {"lq": np.ascontiguousarray(img_lq.astype(np.float32)),
                "gt": np.ascontiguousarray(img_gt.astype(np.float32)),
                "lq_path": path, "gt_path": path}


class SingleImageDataset(_SeededDataset):
    """LQ images alone, for inference (Dataset_SingleImage,
    single_image_dataset.py): one folder, a meta-info list or an LMDB
    shard; items are ``{'lq': RGB HWC, 'lq_path'}``."""

    def __init__(self, opt: dict):
        root = opt["dataroot_lq"]
        io_opt = _io_opt_lmdb(opt, [root], ["lq"])
        super().__init__(opt.get("seed", 0), opt.get("cache_decoded", False),
                         io_opt)
        self.opt = opt
        self.paths = _single_folder_paths(opt, root, io_opt)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> dict[str, Any]:
        path = self.paths[index % len(self.paths)]
        img = np.ascontiguousarray(self._read(path, "lq")[..., ::-1])
        return {"lq": img.astype(np.float32), "lq_path": path}


class DefocusDeblurDualPixel16Dataset(_SeededDataset):
    """Dual-pixel defocus deblurring (Dataset_DefocusDeblur_DualPixel_16bit,
    paired_image_dataset.py:1249-1336): 16-bit lqL / lqR / gt triples, one
    crop window and one augmentation for all three, ``lq`` the left and
    right views concatenated on channels (6); for a network with
    ``dual_pixel_task: true, inp_channels: 6``. Needs cv2."""

    def __init__(self, opt: dict):
        super().__init__(opt.get("seed", 0), opt.get("cache_decoded", False),
                         _io_opt_no_lmdb(opt, type(self).__name__))
        self.opt = opt
        self.phase = opt.get("phase", "train")
        self.scale = opt.get("scale", 1)
        self.geometric_augs = opt.get("geometric_augs", False)
        self.paths = paired_paths_from_folder(
            [opt["dataroot_lqL"], opt["dataroot_lqR"], opt["dataroot_gt"]],
            ["lqL", "lqR", "gt"], opt.get("filename_tmpl", "{}"))

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = self._rng(index)
        p = self.paths[index % len(self.paths)]
        img_gt = self._read(p["gt_path"], "gt", imfrombytes_16bit)
        img_lql = self._read(p["lqL_path"], "lqL", imfrombytes_16bit)
        img_lqr = self._read(p["lqR_path"], "lqR", imfrombytes_16bit)

        if self.phase == "train":
            gt_size = self.opt["gt_size"]
            img_lql, img_gt = pad_to_min_size(img_lql, img_gt, gt_size)
            img_lqr, _ = pad_to_min_size(img_lqr, img_lqr, gt_size)
            # one crop window for all three (paired_random_crop_DP)
            gts, lqs = paired_random_crop([img_gt], [img_lql, img_lqr],
                                          gt_size, self.scale, rng)
            img_gt, (img_lql, img_lqr) = gts[0], lqs
            if self.geometric_augs:
                img_lql, img_lqr, img_gt = random_augmentation(
                    img_lql, img_lqr, img_gt, rng=rng)

        to_rgb = lambda x: np.ascontiguousarray(x[..., ::-1].astype(np.float32))
        lq = np.concatenate([to_rgb(img_lql), to_rgb(img_lqr)], axis=-1)
        return {"lq": lq, "gt": to_rgb(img_gt),
                "lq_path": p["lqL_path"], "gt_path": p["gt_path"]}


def _video_datasets():
    from .video_datasets import (
        FFHQDataset,
        REDSDataset,
        VideoTestDataset,
        Vimeo90KDataset,
    )

    return {
        "REDSDataset": REDSDataset,
        "Vimeo90KDataset": Vimeo90KDataset,
        "VideoTestDataset": VideoTestDataset,
        "FFHQDataset": FFHQDataset,
    }


DATASETS = {
    "Dataset_PairedImage": PairedImageDataset,
    "Dataset_SuperRestoration_param": SuperRestorationParamDataset,
    "Dataset_SuperRestoration": SuperRestorationDataset,
    "Dataset_PairedMutiImage": PairedMultiImageDataset,
    "Dataset_S_IQA": SIQADataset,
    "Dataset_GaussianDenoising": GaussianDenoisingDataset,
    "Dataset_SingleImage": SingleImageDataset,
    "Dataset_DefocusDeblur_DualPixel_16bit": DefocusDeblurDualPixel16Dataset,
}
DATASETS.update(_video_datasets())

# Every dataset option key any dataset or the loader layer consumes (the
# JAX package's set). Config validation rejects keys outside it, so a
# misspelled or dead key fails fast instead of being silently ignored.
KNOWN_DATASET_KEYS = frozenset({
    # identity / injected by config parsing
    "type", "name", "phase", "scale",
    # storage + decode
    "io_backend", "cache_decoded", "filename_tmpl", "meta_info_file",
    "dataroot_lq", "dataroot_gt", "dataroot_sr", "dataroot_param",
    "dataroot_lqL", "dataroot_lqR", "dataroot_flow",
    # sampling / loader (data/__init__.py:56-119 analog)
    "use_shuffle", "num_worker_per_gpu", "batch_size_per_gpu",
    "dataset_enlarge_ratio", "drop_last", "pin_memory", "prefetch_mode",
    "seed", "device_resident",
    # crops / aug
    "gt_size", "geometric_augs", "mean", "std", "use_hflip", "use_rot",
    # progressive curriculum (train.py:246-252)
    "mini_batch_sizes", "iters", "gt_sizes", "prob", "probs",
    # teacher / student specifics
    "denoise_rate", "num_pairs", "stride_range",
    # gaussian-denoising specifics
    "in_ch", "sigma_type", "sigma_range", "sigma_test",
    # video datasets
    "num_frame", "interval_list", "random_reverse", "center_frame_idx",
    "frames_per_clip", "padding", "cache_data", "val_partition",
})


def check_dataset_type(t: str | None) -> None:
    """Raise for an unknown dataset type."""
    if t not in DATASETS:
        raise KeyError(f"unknown dataset type {t!r}; known: {sorted(DATASETS)}")


def validate_dataset_opt(opt: dict, where: str = "datasets") -> None:
    """Fail fast on unknown or ignored dataset keys."""
    unknown = set(opt) - KNOWN_DATASET_KEYS
    if unknown:
        raise KeyError(
            f"{where}: unknown dataset option key(s) {sorted(unknown)} — "
            "these would be silently ignored; remove or fix them "
            f"(known keys: {sorted(KNOWN_DATASET_KEYS)})")


def create_dataset(opt: dict):
    """Reference-style registry (data/__init__.py:29-54)."""
    check_dataset_type(opt["type"])
    return DATASETS[opt["type"]](opt)
