"""Device-resident training corpora (the JAX package's
``train/device_corpus.py``): the decoded corpus is uploaded to device memory
once, and every training batch is cut, corrupted and augmented there. A
step then uploads only its group or image ids.

  * ``StudentDeviceCorpus`` (Dataset_PairedMutiImage): frames reflect-padded
    to one square canvas, the (G, F) group table of the host dataset
    (rebuilt on ``set_epoch``); a batch is a crop, the masked-denoising
    corruption (64%: per-frame Bernoulli masks, 36% of frames at prob + 0.5;
    else simulated frame interpolation), the rescue noise where 64% of the
    pixels are 0 or 1, and the shared 8-way flip/rotation.
  * ``TeacherDeviceCorpus`` (Dataset_SuperRestoration[_param]): lq and gt on
    a canvas, sr at exactly twice it, a denoise rate per image; a crop at
    offsets in [1, eff - 1 - gt_size] of each image's own padded extent (sr
    at doubled coordinates), 10% Gaussian noise with sigma ~ U(1, 30) / 255,
    synchronised hflip / vflip / rot90, the epsilon guard, the rate plane.
  * ``SIQADeviceCorpus`` (the scorer's sources): (origin, denoised) pairs
    as uint8; each candidate is ``rint((lam * dn + (1 - lam) * lq) * 255)``
    with lam ~ U[0, 1], and the batch is ``(lq, candidate, lam)``.

Layout: NCHW, and (B, F, H, W) for frame stacks, as the host loader uploads
them. Each sampler keeps its draws apart from their use:
``draw(gen, ids, gt_size)`` returns the batch's random values, drawn from a
``torch.Generator`` on the corpus's device, and ``apply(ids, draws)`` is a
function of the corpus and those values alone (the tests feed it the values
the JAX sampler draws from a key). Crops and flips are gathers over index
grids, so no offset or mode crosses to the host.

With several ranks (the JAX corpora's mesh placement, ``_mesh_place`` and
``_batch_out_shardings``: each device generates its shard of one global
sample) every rank draws the global batch's values from the same generator
and applies them to its own rows only: ``sample_batch(..., rows=slice)``.
The ranks' rows, concatenated, are the batch one process samples.
"""

from __future__ import annotations

import functools
import os.path as osp
import time

import numpy as np
import torch

from ..data.datasets import (PairedMultiImageDataset, SuperRestorationDataset,
                             SuperRestorationParamDataset, _reflect101_pad_to)
from ..data.pairing import _numeric_prefix_key, paired_paths_from_folder, scan_files
from ..eval.infer import resolve_device
from ..ops.mask import frame_interpolation_core, mask_with_keep, prob_thresholds, same_device
from ..utils.image_io import imfrombytes_gray, imread_bgr


def seeded_generator(device, *key: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from integers (e.g.
    ``(manual_seed, iteration)``) through numpy's ``SeedSequence``."""
    state = np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0] >> np.uint64(1)))


def _rand(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def _randint(gen: torch.Generator, low: int, high, n: int) -> torch.Tensor:
    """n integers in [low, high): ``high`` an int or an (n,) int64 tensor."""
    if isinstance(high, int):
        return torch.randint(low, high, (n,), generator=gen, device=gen.device)
    r = torch.randint(0, 2 ** 62, (n,), generator=gen, device=gen.device)
    return low + r % (high - low)


def _crop(planes: torch.Tensor, pids: torch.Tensor, top: torch.Tensor,
          left: torch.Tensor, size: int) -> torch.Tensor:
    """(B, K, size, size): ``planes[pids[b, k], top[b] + i, left[b] + j]``."""
    ar = torch.arange(size, device=planes.device)
    rows = (top[:, None] + ar)[:, None, :, None]
    cols = (left[:, None] + ar)[:, None, None, :]
    return planes[pids[:, :, None, None], rows, cols]


def _permute(x: torch.Tensor, table: torch.Tensor, mode: torch.Tensor) -> torch.Tensor:
    """Item b of (B, K, H, W) ``x`` rearranged by the flat index map
    ``table[mode[b]]``."""
    b, k, h, w = x.shape
    idx = table[mode][:, None, :].expand(b, k, h * w)
    return x.reshape(b, k, h * w).gather(2, idx).reshape(b, k, h, w)


def augment8(x: torch.Tensor, mode: int) -> torch.Tensor:
    """The host pipeline's 8 flip/rot90 modes (data/transforms.py
    ``data_augmentation``) on the last two axes: ``mode // 2`` quarter
    turns, then a flip of the rows where ``mode`` is odd."""
    x = torch.rot90(x, mode // 2, dims=(-2, -1))
    return torch.flip(x, dims=(-2,)) if mode % 2 else x


def sync_augment(x: torch.Tensor, hflip: bool, vflip: bool, rot: int) -> torch.Tensor:
    """``sync_augment_multi_scale``'s transform on the last two axes: an
    hflip, a vflip, then ``rot`` quarter turns."""
    if hflip:
        x = torch.flip(x, dims=(-1,))
    if vflip:
        x = torch.flip(x, dims=(-2,))
    return torch.rot90(x, rot, dims=(-2, -1))


@functools.lru_cache(maxsize=None)
def _aug8_table(size: int, device: torch.device) -> torch.Tensor:
    base = torch.arange(size * size, device=device).reshape(size, size)
    return torch.stack([augment8(base, m).reshape(-1) for m in range(8)])


@functools.lru_cache(maxsize=None)
def _sync_table(size: int, device: torch.device) -> torch.Tensor:
    """Row ``8 * hflip + 4 * vflip + rot`` is that transform's index map."""
    base = torch.arange(size * size, device=device).reshape(size, size)
    return torch.stack([sync_augment(base, bool(m & 8), bool(m & 4), m & 3).reshape(-1)
                        for m in range(16)])


def _sync_mode(draws: dict) -> torch.Tensor:
    return draws["hflip"].long() * 8 + draws["vflip"].long() * 4 + draws["rot"]


def _extreme_share(x: torch.Tensor) -> torch.Tensor:
    """Per item, the larger of the shares of elements equal to 0 and to 1."""
    dims = tuple(range(1, x.ndim))
    return torch.maximum((x == 0).float().mean(dims), (x == 1).float().mean(dims))


def _per_item(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, *([1] * (like.ndim - 1)))


class _Corpus:
    """Shared plumbing: the device, the upload and its cost, ids."""

    def __init__(self, device):
        self.device = resolve_device(device)
        self.upload_s = 0.0
        self.nbytes = 0

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        t0 = time.perf_counter()
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        self.upload_s += time.perf_counter() - t0
        self.nbytes += t.numel() * t.element_size()
        return t

    def ids(self, ids) -> torch.Tensor:
        """int64 ids on the corpus's device: the only per-batch upload, from
        pinned memory and asynchronous, so that the host does not wait for
        the device's queue to drain."""
        if isinstance(ids, torch.Tensor):
            return ids.to(self.device, torch.int64)
        host = torch.from_numpy(np.asarray(ids, np.int64))
        if self.device.type != "cuda":
            return host.to(self.device)
        return host.pin_memory().to(self.device, non_blocking=True)

    def _check(self, gen: torch.Generator) -> None:
        if not same_device(gen.device, self.device):
            raise ValueError(f"the generator is on {gen.device}, the corpus on "
                             f"{self.device}")

    def set_epoch(self, epoch: int) -> None:
        del epoch

    def sample_batch(self, gen: torch.Generator, ids, gt_size: int | None = None,
                     rows: slice | None = None, **kw):
        """``apply(ids, draw(gen, ids, gt_size))``; with ``rows``, the draw
        is for all of ``ids`` and the apply for those rows only."""
        ids = self.ids(ids)
        draws = self.draw(gen, ids, gt_size)
        if rows is not None:
            n = len(ids)
            ids, draws = ids[rows], {k: v[rows] if isinstance(v, torch.Tensor)
                                     and v.ndim and v.shape[0] == n else v
                                     for k, v in draws.items()}
        return self.apply(ids, draws, **kw)


def _canvas(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """reflect101 pad to the larger side, then reflect to (th, tw) (the
    JAX corpora's ``to_canvas``)."""
    img = _reflect101_pad_to(img, max(th, tw))
    hp, wp = th - img.shape[0], tw - img.shape[1]
    if hp or wp:
        img = np.pad(img, ((0, max(hp, 0)), (0, max(wp, 0)), (0, 0)), mode="reflect")
    return img[:th, :tw]


def _chw(img: np.ndarray) -> np.ndarray:
    return img.transpose(2, 0, 1)


class StudentDeviceCorpus(_Corpus):
    """The lq / gt frames in device memory, each padded (reflect, bottom and
    right) to one square canvas; batches (B, F, g, g) cut on the device."""

    def __init__(self, opt: dict, device=None):
        super().__init__(device)
        self.num_pairs = opt.get("num_pairs", 7)
        self.base_prob = float(opt.get("prob", 0.0))
        self.geometric_augs = bool(opt.get("geometric_augs", False))
        self.gt_size = int(opt["gt_size"])
        # the host dataset decides which frames train together
        self._ds = PairedMultiImageDataset(dict(opt))
        # every paired frame, in numeric-prefix order: an epoch's regrouping
        # may reach frames no earlier group touched
        lq_files = sorted(scan_files(opt["dataroot_lq"]), key=_numeric_prefix_key)
        gt_files = sorted(scan_files(opt["dataroot_gt"]), key=_numeric_prefix_key)
        paths = [(osp.join(opt["dataroot_lq"], a), osp.join(opt["dataroot_gt"], b))
                 for a, b in zip(lq_files, gt_files)]
        if not paths or not self._ds.paths:
            raise ValueError(
                f"empty corpus: no frame groups fit num_pairs={self.num_pairs} "
                f"with stride_range={opt.get('stride_range')} over the given folders")
        self._frame_index = {key: i for i, key in enumerate(paths)}
        lq = [self._ds._read(p, "lq", imfrombytes_gray) for p, _ in paths]
        gt = [self._ds._read(p, "gt", imfrombytes_gray) for _, p in paths]
        side = max(self.gt_size, max(f.shape[0] for f in gt),
                   max(f.shape[1] for f in gt))

        def pad(img):
            hp, wp = side - img.shape[0], side - img.shape[1]
            return np.pad(img, ((0, hp), (0, wp)), mode="reflect") if (hp or wp) else img

        self.frame_hw = (side, side)
        self.lq = self._upload(np.stack([pad(f) for f in lq]))  # (N, H, W)
        self.gt = self._upload(np.stack([pad(f) for f in gt]))
        self._table = None
        self._set_groups()

    def _set_groups(self) -> None:
        table = np.asarray(
            [[self._frame_index[(g["lq_path"], g["gt_path"])] for g in group]
             for group in self._ds.paths], np.int64)
        if self._table is None or not np.array_equal(table, self._table):
            self._table = table
            self.groups = torch.as_tensor(table, device=self.device)  # (G, F)

    def set_epoch(self, epoch: int) -> None:
        """The host dataset's per-epoch stride reroll."""
        self._ds.set_epoch(epoch)
        self._set_groups()

    def __len__(self) -> int:
        return int(self.groups.shape[0])

    def describe(self) -> str:
        return (f"{int(self.lq.shape[0])} frames at {self.frame_hw}, {len(self)} "
                f"groups in device memory ({self.nbytes / 2 ** 20:.1f} MiB)")

    def draw(self, gen: torch.Generator, ids: torch.Tensor, gt_size: int | None = None) -> dict:
        """Per item: crop offsets, the corruption mode, each frame's boost,
        the uniforms of the per-frame masks and of the interpolation's two
        masks, the rescue noise and the aug mode."""
        self._check(gen)
        g = int(gt_size or self.gt_size)
        b, f = len(ids), int(self.groups.shape[1])
        h, w = self.frame_hw
        return {
            "top": _randint(gen, 0, h - g + 1, b),
            "left": _randint(gen, 0, w - g + 1, b),
            "mask_mode": _rand(gen, b) < 0.64,
            "boost": _rand(gen, b, f) > 0.64,
            "u_mask": _rand(gen, b, f, g, g),
            "u_even": _rand(gen, b, f, g, g),
            "u_odd": _rand(gen, b, f, g, g),
            "noise": torch.randn((b, f, g, g), generator=gen, device=gen.device),
            "aug": (_randint(gen, 0, 8, b) if self.geometric_augs
                    else torch.zeros(b, dtype=torch.int64, device=gen.device)),
        }

    def apply(self, ids: torch.Tensor, draws: dict, prob=None):
        """(lq, gt), each (B, F, g, g) float32; ``prob`` (the dataset's
        ``prob`` where None) is the masks' base rate."""
        g = draws["u_mask"].shape[-1]
        fids = self.groups[ids]
        lq = _crop(self.lq, fids, draws["top"], draws["left"], g)
        gt = _crop(self.gt, fids, draws["top"], draws["left"], g)
        # 64%: per-frame Bernoulli masks, 36% of frames at prob + 0.5
        # (paired_image_dataset.py:219-230); else frame interpolation (:231-241)
        p = self.base_prob if prob is None else prob
        low, high = prob_thresholds(p)
        probs = torch.where(draws["boost"], high, low)[:, :, None, None]
        masked = mask_with_keep(lq, draws["u_mask"] >= probs)
        interp = frame_interpolation_core(lq, draws["u_even"], draws["u_odd"], p)
        lq = torch.where(_per_item(draws["mask_mode"], lq), masked, interp)
        # the degenerate-input rescue noise (:243-246)
        noisy = (lq + 0.3 + 0.7 * draws["noise"]).clamp(0.0, 1.0)
        lq = torch.where(_per_item(_extreme_share(lq) > 0.64, lq), noisy, lq)
        if self.geometric_augs:
            table = _aug8_table(g, self.device)
            lq, gt = _permute(lq, table, draws["aug"]), _permute(gt, table, draws["aug"])
        return lq, gt


class TeacherDeviceCorpus(_Corpus):
    """lq / gt on a common canvas, sr at exactly twice it, per image its
    denoise rate and its own padded extent; batches cut on the device."""

    def __init__(self, opt: dict, device=None):
        super().__init__(device)
        dstype = opt.get("type", "Dataset_SuperRestoration_param")
        cls = (SuperRestorationParamDataset if dstype == "Dataset_SuperRestoration_param"
               else SuperRestorationDataset)
        ds = self._ds = cls(dict(opt))
        self.gt_size = int(ds.gt_size)
        self.sr_scale = int(ds.SR_SCALE)
        self.geometric_augs = bool(ds.geometric_augs)
        if not ds.paths:
            raise ValueError("empty teacher corpus: no paired modalities under "
                             f"{opt.get('dataroot_gt')}")
        lq_imgs, gt_imgs, sr_imgs, rates = [], [], [], []
        s = self.sr_scale
        for p in ds.paths:
            img_gt = ds._read(p["gt_path"], "gt")
            img_sr = ds._read(p["sr_path"], "sr")
            h, w = img_gt.shape[:2]
            if img_sr.shape[:2] != (h * s, w * s):
                raise ValueError(f"SR size mismatch: GT={h}x{w} "
                                 f"SR={img_sr.shape[0]}x{img_sr.shape[1]} ({p['gt_path']})")
            gt_imgs.append(img_gt)
            lq_imgs.append(ds._read(p["lq_path"], "lq"))
            sr_imgs.append(img_sr)
            rates.append(ds._denoise_rate(p))
        # the host pads each image to gt_size + 2 so that the reference's
        # randint(1, h-1-gt_size) window exists; the canvas is their largest
        min_hw = self.gt_size + 2
        eff_h = [max(i.shape[0], min_hw) for i in gt_imgs]
        eff_w = [max(i.shape[1], min_hw) for i in gt_imgs]
        th, tw = max(eff_h), max(eff_w)
        self.frame_hw = (th, tw)

        def planes(imgs, t_h, t_w):  # RGB float32, (N * 3, t_h, t_w)
            rgb = [np.ascontiguousarray(i[..., ::-1].astype(np.float32)) for i in imgs]
            return self._upload(np.concatenate([_chw(_canvas(i, t_h, t_w)) for i in rgb]))

        self.lq = planes(lq_imgs, th, tw)
        self.gt = planes(gt_imgs, th, tw)
        self.sr = planes(sr_imgs, th * s, tw * s)
        self.rates = self._upload(np.asarray(rates, np.float32))
        self.eff_h = self._upload(np.asarray(eff_h, np.int64))
        self.eff_w = self._upload(np.asarray(eff_w, np.int64))

    def __len__(self) -> int:
        return int(self.rates.shape[0])

    def describe(self) -> str:
        return (f"{len(self)} images at {self.frame_hw} (+{self.sr_scale}x sr) in device "
                f"memory ({self.nbytes / 2 ** 20:.1f} MiB)")

    def draw(self, gen: torch.Generator, ids: torch.Tensor, gt_size: int | None = None) -> dict:
        """Per item: crop offsets within its own extent, the noise gate,
        sigma and field, the two flips and the quarter turns."""
        self._check(gen)
        g = int(gt_size or self.gt_size)
        b = len(ids)
        hi_t = (self.eff_h[ids] - 1 - g).clamp(min=1)
        hi_l = (self.eff_w[ids] - 1 - g).clamp(min=1)
        augs = self.geometric_augs
        return {
            "top": _randint(gen, 1, hi_t + 1, b),
            "left": _randint(gen, 1, hi_l + 1, b),
            "gate": _rand(gen, b) < 0.1,
            "sigma": 1.0 + 29.0 * _rand(gen, b),
            "noise": torch.randn((b, 3, g, g), generator=gen, device=gen.device),
            "hflip": _rand(gen, b) < 0.5 if augs else torch.zeros(b, dtype=torch.bool,
                                                                  device=gen.device),
            "vflip": _rand(gen, b) < 0.5 if augs else torch.zeros(b, dtype=torch.bool,
                                                                  device=gen.device),
            "rot": (_randint(gen, 0, 4, b) if augs
                    else torch.zeros(b, dtype=torch.int64, device=gen.device)),
        }

    def apply(self, ids: torch.Tensor, draws: dict):
        """({'img', 'denoise_rate'}, {'hq', 'sr'}) NCHW float32, sr at twice
        the patch."""
        g, s = draws["noise"].shape[-1], self.sr_scale
        pids = ids[:, None] * 3 + torch.arange(3, device=self.device)
        top, left = draws["top"], draws["left"]
        lq = _crop(self.lq, pids, top, left, g)
        gt = _crop(self.gt, pids, top, left, g)
        sr = _crop(self.sr, pids, top * s, left * s, g * s)
        # 10% gaussian noise on lq (:933-935)
        noisy = (lq + draws["noise"] * _per_item(draws["sigma"] / 255.0, lq)).clamp(0.0, 1.0)
        lq = torch.where(_per_item(draws["gate"], lq), noisy, lq)
        if self.geometric_augs:  # synchronised at both scales (:1056-1082)
            mode = _sync_mode(draws)
            lq = _permute(lq, _sync_table(g, self.device), mode)
            gt = _permute(gt, _sync_table(g, self.device), mode)
            sr = _permute(sr, _sync_table(g * s, self.device), mode)
        # the zero-input epsilon guard (:941-944)
        lq = torch.where(_per_item(_extreme_share(lq) > 0.10, lq), lq + 1e-14, lq)
        plane = _per_item(self.rates[ids], lq).expand(len(ids), 1, g, g).contiguous()
        return {"img": lq, "denoise_rate": plane}, {"hq": gt, "sr": sr}


class SIQADeviceCorpus(_Corpus):
    """The scorer's (origin, denoised) sources as uint8 on a common canvas;
    graded candidates mixed on the device."""

    def __init__(self, opt: dict, device=None):
        super().__init__(device)
        self.gt_size = int(opt.get("gt_size") or 512)
        self.geometric_augs = bool(opt.get("geometric_augs", False))
        paths = paired_paths_from_folder([opt["dataroot_lq"], opt["dataroot_gt"]],
                                         ["lq", "gt"], opt.get("filename_tmpl", "{}"))
        if not paths:
            raise ValueError("empty SIQA corpus: no (origin, denoised) pairs under "
                             f"{opt.get('dataroot_lq')}")
        lq_imgs, dn_imgs = [], []
        for p in paths:
            lq, dn = imread_bgr(p["lq_path"]), imread_bgr(p["gt_path"])
            if dn.shape != lq.shape:
                raise ValueError(f"size mismatch: {p['lq_path']} {lq.shape} vs "
                                 f"{p['gt_path']} {dn.shape}")
            lq_imgs.append(lq)
            dn_imgs.append(dn)
        min_hw = self.gt_size + 2
        eff_h = [max(i.shape[0], min_hw) for i in lq_imgs]
        eff_w = [max(i.shape[1], min_hw) for i in lq_imgs]
        th, tw = max(eff_h), max(eff_w)
        self.frame_hw = (th, tw)

        def planes(imgs):  # RGB uint8 (lossless: the sources are uint8), (N * 3, th, tw)
            u8 = [np.rint(i[..., ::-1].astype(np.float32) * 255.0).astype(np.uint8)
                  for i in imgs]
            return self._upload(np.concatenate([_chw(_canvas(i, th, tw)) for i in u8]))

        self.lq = planes(lq_imgs)
        self.dn = planes(dn_imgs)
        self.eff_h = self._upload(np.asarray(eff_h, np.int64))
        self.eff_w = self._upload(np.asarray(eff_w, np.int64))

    def __len__(self) -> int:
        return int(self.eff_h.shape[0])

    def describe(self) -> str:
        return (f"{len(self)} source pairs at {self.frame_hw} in device memory "
                f"({self.nbytes / 2 ** 20:.1f} MiB)")

    def draw(self, gen: torch.Generator, ids: torch.Tensor, gt_size: int | None = None) -> dict:
        """Per item: crop offsets within its own extent, lam, the two flips
        and the quarter turns."""
        self._check(gen)
        g = int(gt_size or self.gt_size)
        b = len(ids)
        hi_t = (self.eff_h[ids] - 1 - g).clamp(min=1)
        hi_l = (self.eff_w[ids] - 1 - g).clamp(min=1)
        augs = self.geometric_augs
        off = torch.zeros(b, dtype=torch.bool, device=gen.device)
        return {
            "size": g,
            "top": _randint(gen, 1, hi_t + 1, b),
            "left": _randint(gen, 1, hi_l + 1, b),
            "lam": _rand(gen, b),
            "hflip": _rand(gen, b) < 0.5 if augs else off,
            "vflip": _rand(gen, b) < 0.5 if augs else off,
            "rot": _randint(gen, 0, 4, b) if augs else off.long(),
        }

    def apply(self, ids: torch.Tensor, draws: dict):
        """(lq, candidate, lam): two (B, 3, g, g) uint8 batches and (B,)."""
        g = int(draws["size"])
        pids = ids[:, None] * 3 + torch.arange(3, device=self.device)
        lq = _crop(self.lq, pids, draws["top"], draws["left"], g)
        dn = _crop(self.dn, pids, draws["top"], draws["left"], g)
        # mixed in float32, stored as uint8: what the disk corpus holds
        lam = _per_item(draws["lam"], lq)
        cand = torch.round((lam * (dn.float() / 255.0) + (1.0 - lam) * (lq.float() / 255.0))
                           * 255.0).to(torch.uint8)
        if self.geometric_augs:
            mode, table = _sync_mode(draws), _sync_table(g, self.device)
            lq, cand = _permute(lq, table, mode), _permute(cand, table, mode)
        return lq, cand, draws["lam"]


def build_device_corpus(ds_opt: dict, device=None):
    """The corpus of a ``datasets.train`` section with ``device_resident``."""
    dstype = ds_opt.get("type")
    if dstype == "Dataset_PairedMutiImage":
        return StudentDeviceCorpus(ds_opt, device)
    if dstype in ("Dataset_SuperRestoration_param", "Dataset_SuperRestoration"):
        return TeacherDeviceCorpus(ds_opt, device)
    raise NotImplementedError("device_resident supports Dataset_PairedMutiImage and "
                              f"Dataset_SuperRestoration[_param]; got {dstype!r}")
