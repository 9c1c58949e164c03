"""Stock video and face datasets of the reference's BasicSR half
(Train/basicsr/data/{reds_dataset.py, vimeo90k_dataset.py,
video_test_dataset.py, ffhq_dataset.py}); the acoustic models use none of
them.

The port's copy of the JAX package's: HWC float32 numpy items (an LQ window
is (F, H, W, 3)), RGB, every draw from the dataset's per-(epoch, index)
generator. The REDS optical-flow side channel is not carried over (neither
package has a flow consumer); the temporal sampling, the interval
augmentation and the paired crop are. Frames are read from disk with
``utils/image_io.py::imread_bgr``.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any

import numpy as np

from ..utils.image_io import imread_bgr
from .datasets import _SeededDataset
from .pairing import scan_files
from .transforms import paired_random_crop, random_augmentation


def generate_frame_indices(center: int, max_frame: int, num_frames: int,
                           padding: str = "reflection") -> list[int]:
    """Neighbor indices with border padding (data_util.generate_frame_indices
    semantics): padding in {'replicate', 'reflection', 'reflection_circle',
    'circle'}."""
    assert num_frames % 2 == 1
    half = num_frames // 2
    out = []
    for i in range(center - half, center + half + 1):
        if i < 0:
            if padding == "replicate":
                j = 0
            elif padding == "reflection":
                j = -i
            elif padding == "reflection_circle":
                j = center + half - i
            else:  # circle
                j = num_frames + i
        elif i > max_frame:
            if padding == "replicate":
                j = max_frame
            elif padding == "reflection":
                j = max_frame * 2 - i
            elif padding == "reflection_circle":
                j = (center - half) - (i - max_frame)
            else:
                j = i - num_frames
        else:
            j = i
        out.append(j)
    return out


class REDSDataset(_SeededDataset):
    """REDS video-SR training dataset (reds_dataset.py:12-238): clips of
    100 frames; sample = center GT frame + num_frame LQ neighbors with a
    random interval from interval_list and optional random reverse;
    synchronized crop/aug; returns lq (F, H, W, 3) + gt (H*scale, ...)."""

    def __init__(self, opt: dict):
        super().__init__(opt.get("seed", 0))
        self.opt = opt
        self.gt_root = opt["dataroot_gt"]
        self.lq_root = opt["dataroot_lq"]
        self.num_frame = opt.get("num_frame", 5)
        self.num_half = self.num_frame // 2
        self.interval_list = opt.get("interval_list", [1])
        self.random_reverse = opt.get("random_reverse", False)
        self.frames_per_clip = opt.get("frames_per_clip", 100)
        if opt.get("meta_info_file"):
            with open(opt["meta_info_file"]) as f:
                self.keys = []
                for line in f:
                    if not line.strip():
                        continue
                    clip, nf = line.split(" ")[:2]
                    self.keys.extend(f"{clip}/{i:08d}" for i in range(int(nf)))
        else:
            self.keys = []
            for clip in sorted(os.listdir(self.gt_root)):
                n = len(scan_files(osp.join(self.gt_root, clip)))
                self.keys.extend(f"{clip}/{i:08d}" for i in range(n))

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = self._rng(index)
        scale = self.opt.get("scale", 4)
        gt_size = self.opt.get("gt_size", 256)
        clip, frame_name = self.keys[index % len(self.keys)].split("/")
        center = int(frame_name)
        max_frame = self.frames_per_clip - 1

        interval = int(rng.choice(self.interval_list))
        start = center - self.num_half * interval
        end = center + self.num_half * interval
        while start < 0 or end > max_frame:
            center = int(rng.integers(0, max_frame + 1))
            start = center - self.num_half * interval
            end = center + self.num_half * interval
        neighbors = list(range(start, end + 1, interval))
        if self.random_reverse and rng.random() < 0.5:
            neighbors.reverse()

        to_rgb = lambda x: np.ascontiguousarray(x[..., ::-1])
        img_gt = to_rgb(imread_bgr(
            osp.join(self.gt_root, clip, f"{center:08d}.png")))
        img_lqs = [to_rgb(imread_bgr(
            osp.join(self.lq_root, clip, f"{n:08d}.png"))) for n in neighbors]

        gt_cropped, lqs = paired_random_crop(
            [img_gt], img_lqs, gt_size // scale, scale, rng)
        arrs = random_augmentation(*(lqs + gt_cropped), rng=rng)
        lqs, img_gt = arrs[:-1], arrs[-1]
        return {"lq": np.stack(lqs).astype(np.float32),
                "gt": img_gt.astype(np.float32),
                "key": f"{clip}/{frame_name}"}


class Vimeo90KDataset(_SeededDataset):
    """Vimeo90K septuplet training dataset (vimeo90k_dataset.py): keys from
    a meta-info file (one 'a/b' per line), 7 LQ frames (im1..im7) + the
    center GT frame (im4); optional random reverse; paired crop/aug."""

    def __init__(self, opt: dict):
        super().__init__(opt.get("seed", 0))
        self.opt = opt
        self.gt_root = opt["dataroot_gt"]
        self.lq_root = opt["dataroot_lq"]
        self.num_frame = opt.get("num_frame", 7)
        self.random_reverse = opt.get("random_reverse", False)
        frame_list = range(1, 8)
        center = opt.get("center_frame_idx", 4)
        self.neighbor_list = [i for i in frame_list][:self.num_frame]
        self.center_frame = center
        with open(opt["meta_info_file"]) as f:
            self.keys = [line.split(" ")[0].strip() for line in f if line.strip()]

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = self._rng(index)
        scale = self.opt.get("scale", 4)
        gt_size = self.opt.get("gt_size", 256)
        key = self.keys[index % len(self.keys)]

        neighbors = list(self.neighbor_list)
        if self.random_reverse and rng.random() < 0.5:
            neighbors.reverse()

        to_rgb = lambda x: np.ascontiguousarray(x[..., ::-1])
        img_gt = to_rgb(imread_bgr(
            osp.join(self.gt_root, key, f"im{self.center_frame}.png")))
        img_lqs = [to_rgb(imread_bgr(
            osp.join(self.lq_root, key, f"im{n}.png"))) for n in neighbors]

        gt_cropped, lqs = paired_random_crop(
            [img_gt], img_lqs, gt_size // scale, scale, rng)
        arrs = random_augmentation(*(lqs + gt_cropped), rng=rng)
        lqs, img_gt = arrs[:-1], arrs[-1]
        return {"lq": np.stack(lqs).astype(np.float32),
                "gt": img_gt.astype(np.float32), "key": key}


class VideoTestDataset(_SeededDataset):
    """Video test dataset (video_test_dataset.py): iterate every frame of
    every clip; each item is the frame's LQ neighbor window (border
    ``padding`` strategy) + its GT frame."""

    def __init__(self, opt: dict):
        super().__init__(opt.get("seed", 0))
        self.opt = opt
        self.gt_root = opt["dataroot_gt"]
        self.lq_root = opt["dataroot_lq"]
        self.num_frame = opt.get("num_frame", 5)
        self.padding = opt.get("padding", "reflection")
        self.items = []  # (clip, idx, n_frames)
        for clip in sorted(os.listdir(self.lq_root)):
            frames = scan_files(osp.join(self.lq_root, clip))
            for i in range(len(frames)):
                self.items.append((clip, i, len(frames), frames))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int) -> dict[str, Any]:
        clip, i, n, frames = self.items[index % len(self.items)]
        idxs = generate_frame_indices(i, n - 1, self.num_frame, self.padding)
        to_rgb = lambda x: np.ascontiguousarray(x[..., ::-1])
        lqs = [to_rgb(imread_bgr(osp.join(self.lq_root, clip, frames[j])))
               for j in idxs]
        img_gt = to_rgb(imread_bgr(osp.join(self.gt_root, clip, frames[i])))
        return {"lq": np.stack(lqs).astype(np.float32),
                "gt": img_gt.astype(np.float32),
                "folder": clip, "idx": f"{i}/{n}",
                "border": int(i < self.num_frame // 2
                              or i > n - 1 - self.num_frame // 2)}


class FFHQDataset(_SeededDataset):
    """FFHQ single-folder face dataset (ffhq_dataset.py:9-66): gt images
    with optional horizontal flip and mean/std normalization."""

    def __init__(self, opt: dict):
        super().__init__(opt.get("seed", 0))
        self.opt = opt
        self.gt_root = opt["dataroot_gt"]
        self.mean = opt.get("mean")
        self.std = opt.get("std")
        self.use_hflip = opt.get("use_hflip", False)
        self.paths = [osp.join(self.gt_root, f) for f in scan_files(self.gt_root)]

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = self._rng(index)
        path = self.paths[index % len(self.paths)]
        img = np.ascontiguousarray(imread_bgr(path)[..., ::-1])
        if self.use_hflip and rng.random() < 0.5:
            img = np.ascontiguousarray(img[:, ::-1])
        if self.mean is not None:
            img = img - np.asarray(self.mean, np.float32)
        if self.std is not None:
            img = img / np.asarray(self.std, np.float32)
        return {"gt": img.astype(np.float32), "gt_path": path}
