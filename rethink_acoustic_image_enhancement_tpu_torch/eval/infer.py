"""KDLAE-T serving (KDLAE_T.ipynb cell 5 as an API): whole images, and
large frames as batches of tiles.

Whole image: reflect-pad on the host to a multiple of 8 (or
``shape_bucket``), uint8 in (divided by 255 in float32, then cast to the
serving dtype), a scalar denoise rate broadcast to a (B, 1, H, W) plane,
forward, clamp and round-half-to-even to uint8 on the device, crop, and the
fan-beam zero mask on ``hq`` and the 2x ``sr``. ``denoise_tiled`` cuts each
image into tiles, forwards ``tile_batch`` of them per call across images
and puts the interiors back together.

Runs on ``cuda`` unless the caller asks for another device; with no GPU
and no device named it raises rather than fall back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models import KDLAETeacher
from ..ops.mask import apply_zero_mask, zero_mask_from_input
from ..utils.image_io import imread_rgb_ubyte, to_ubyte


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_reflect_np(x: np.ndarray, ph: int, pw: int) -> np.ndarray:
    if ph == 0 and pw == 0:
        return x
    return np.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the GPU, and raises where there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: TeacherPredictor runs on the GPU by "
                "default; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _to_ubyte_device(x: torch.Tensor) -> torch.Tensor:
    """Clamp, float32, *255, round half to even, uint8 (on the device)."""
    return torch.round(x.clamp(0.0, 1.0).float() * 255.0).to(torch.uint8)


_MAX_IN_FLIGHT = 16  # tile chunks dispatched before the oldest is fetched


class TeacherPredictor:
    """KDLAE-T denoiser with the notebook's pre/postprocessing.

    ``model`` carries its weights; ``fused`` routes gate-admitted stages
    through the stage kernel. ``shape_bucket`` rounds padded sizes up to a
    coarser grid (MDTA statistics are global over the padded pixels, so
    bucketed outputs deviate slightly from multiple-of-8 padding)."""

    def __init__(self, model: KDLAETeacher | None = None, multiple_of: int = 8,
                 shape_bucket: int | None = None,
                 dtype: torch.dtype = torch.float32, fused: bool = False,
                 device: str | torch.device | None = None):
        if shape_bucket and shape_bucket % multiple_of:
            raise ValueError(
                f"shape_bucket={shape_bucket} must be a multiple of "
                f"multiple_of={multiple_of}")
        self.device = resolve_device(device)
        if model is None:
            model = KDLAETeacher(layernorm_type="BiasFree", static="train",
                                 params="cat")
        self.model: nn.Module = model.to(device=self.device, dtype=dtype).eval()
        self.model.set_fused(fused)
        self.multiple_of = multiple_of
        self.shape_bucket = shape_bucket
        self.dtype = dtype

    def _forward(self, x: np.ndarray, denoise_rate: float):
        img = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return self._forward_device(img, denoise_rate)

    @torch.inference_mode()
    def _forward_device(self, img: torch.Tensor, denoise_rate: float):
        """(B, H, W, 3) uint8 or float on the device -> uint8 NHWC 'hq' and
        'sr' (or None) on the device."""
        if img.dtype == torch.uint8:
            # divide in float32 first, then cast: the model input equals
            # the host reader's float values in every serving dtype
            img = (img.float() / 255.0).to(self.dtype)
        else:
            img = img.to(self.dtype)
        img = img.permute(0, 3, 1, 2)
        rate = torch.full((img.shape[0], 1, img.shape[2], img.shape[3]),
                          denoise_rate, dtype=self.dtype, device=self.device)
        out = self.model({"img": img, "denoise_rate": rate})
        hq = _to_ubyte_device(out["hq"]).permute(0, 2, 3, 1)
        sr = (None if out["sr"] is None
              else _to_ubyte_device(out["sr"]).permute(0, 2, 3, 1))
        return hq, sr

    def __call__(self, img_rgb: np.ndarray, denoise_rate: float = 1.0,
                 zero_mask: bool = True) -> dict:
        """img_rgb: (H, W, 3) float [0,1] or uint8. Returns 'hq' (H, W, 3)
        and, with the SR head, 'sr' (2H, 2W, 3), both uint8."""
        h, w, _ = img_rgb.shape
        m = self.shape_bucket or self.multiple_of
        ph, pw = _round_up(h, m) - h, _round_up(w, m) - w
        x = _pad_reflect_np(img_rgb[None], ph, pw)
        if x.dtype != np.uint8:
            x = x.astype(np.float32)
        hq, sr = self._forward(x, denoise_rate)
        hq = hq[0, :h, :w].cpu().numpy()
        out = {}
        if zero_mask:
            mask = zero_mask_from_input(
                img_rgb if img_rgb.dtype == np.uint8 else to_ubyte(img_rgb))
            hq = apply_zero_mask(hq, mask)
        out["hq"] = hq
        if sr is not None:
            sr_img = sr[0, :2 * h, :2 * w].cpu().numpy()
            if zero_mask:
                sr_img = apply_zero_mask(sr_img, mask, scale=2)
            out["sr"] = sr_img
        return out

    def denoise_file(self, path: str, denoise_rate: float = 1.0, **kw) -> dict:
        return self(imread_rgb_ubyte(path), denoise_rate, **kw)

    # ------------------------------------------------------------ tiled --
    def denoise_tiled(self, imgs_rgb: list[np.ndarray],
                      denoise_rate: float = 1.0, zero_mask: bool = True,
                      tile: int | tuple[int, int] = 256,
                      halo: int | tuple[int, int] = 0,
                      tile_batch: int = 8) -> list[dict]:
        """Tiled batched serving for large frames.

        Each image is cut into a grid of ``tile``-sized interiors, each
        forwarded with a ``halo``-pixel ring of context (from a
        reflect-padded canvas), ``tile_batch`` tiles per call ACROSS images
        (the last chunk repeats its last tile, so every call has one batch
        shape), and put back together from the interiors. Same serving
        contract as ``__call__`` (pad / clamp / crop / uint8 / zero mask),
        but NOT the same output: the MDTA statistics are taken per tile,
        and receptive fields end at the halo. ``tile`` and ``halo`` take
        (rows, cols) for rectangular modes such as full-width strips,
        ``tile=(256, 512), halo=(8, 0)``. An image smaller than a tile
        along an axis goes through the whole-image path.

        On the GPU the chunks' uploads and fetches go through pinned host
        buffers on a side stream, so chunk k+1's upload and chunk k-1's
        fetch overlap chunk k's forward; at most 16 chunks are in flight.
        """
        if not imgs_rgb:
            return []
        t_h, t_w = (tile, tile) if isinstance(tile, int) else tile
        h_h, h_w = (halo, halo) if isinstance(halo, int) else halo
        T_h, T_w = t_h + 2 * h_h, t_w + 2 * h_w
        if any(v % self.multiple_of for v in (t_h, t_w, T_h, T_w)):
            raise ValueError(
                f"tile ({t_h}x{t_w}) and tile+2*halo ({T_h}x{T_w}) must "
                f"be multiples of {self.multiple_of}")
        # ---- host prep: grid-pad + halo-pad each image, slice tiles ----
        metas = []   # (idx, h, w, gh, gw) per tiled image
        tiles = []   # image-major, row-major
        small = {}   # index -> whole-image result (reflect needs pad < dim)
        for idx, im in enumerate(imgs_rgb):
            h, w = im.shape[:2]
            gh, gw = -(-h // t_h), -(-w // t_w)
            ph, pw = gh * t_h - h, gw * t_w - w
            if ph + h_h >= h or pw + h_w >= w:
                small[idx] = self(im, denoise_rate, zero_mask=zero_mask)
                continue
            canvas = np.pad(im, ((h_h, ph + h_h), (h_w, pw + h_w), (0, 0)),
                            mode="reflect")
            metas.append((idx, h, w, gh, gw))
            for i in range(gh):
                for j in range(gw):
                    tiles.append(canvas[i * t_h:i * t_h + T_h,
                                        j * t_w:j * t_w + T_w])
        if not tiles:
            return [small[i] for i in range(len(imgs_rgb))]
        if any(t.dtype != np.uint8 for t in tiles):
            tiles = [t.astype(np.float32) / 255.0 if t.dtype == np.uint8
                     else t.astype(np.float32) for t in tiles]

        hq_tiles, sr_tiles = self._forward_tiles(tiles, tile_batch,
                                                 denoise_rate)

        # ---- reassemble interiors ----
        results, k = dict(small), 0
        for idx, h, w, gh, gw in metas:
            im = imgs_rgb[idx]
            out_hq = np.empty((gh * t_h, gw * t_w, 3), np.uint8)
            out_sr = (np.empty((2 * gh * t_h, 2 * gw * t_w, 3), np.uint8)
                      if sr_tiles else None)
            for i in range(gh):
                for j in range(gw):
                    out_hq[i * t_h:(i + 1) * t_h, j * t_w:(j + 1) * t_w] = \
                        hq_tiles[k][h_h:h_h + t_h, h_w:h_w + t_w]
                    if out_sr is not None:
                        out_sr[2 * i * t_h:2 * (i + 1) * t_h,
                               2 * j * t_w:2 * (j + 1) * t_w] = \
                            sr_tiles[k][2 * h_h:2 * (h_h + t_h),
                                        2 * h_w:2 * (h_w + t_w)]
                    k += 1
            hq = out_hq[:h, :w]
            out = {}
            if zero_mask:
                mask = zero_mask_from_input(
                    im if im.dtype == np.uint8 else to_ubyte(im))
                hq = apply_zero_mask(hq, mask)
            out["hq"] = hq
            if out_sr is not None:
                sr_img = out_sr[:2 * h, :2 * w]
                if zero_mask:
                    sr_img = apply_zero_mask(sr_img, mask, scale=2)
                out["sr"] = sr_img
            results[idx] = out
        return [results[i] for i in range(len(imgs_rgb))]

    def _forward_tiles(self, tiles: list[np.ndarray], tile_batch: int,
                       denoise_rate: float):
        """Forward same-shape tiles ``tile_batch`` at a time; returns the
        lists of uint8 'hq' tiles and 'sr' tiles (empty without the SR
        head) in order.

        On the GPU each chunk has a slot of pinned host buffers, reused once
        its chunk has been fetched. Uploads and fetches are non-blocking
        copies on a side stream, ordered against the forward passes on the
        current stream by events; a chunk is read on the host only after
        its fetch event."""
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        slots: list[dict] = []     # pinned buffers, one set per chunk in flight
        pending: list = []         # (n, hq_host, sr_host, fetched event)
        hq_tiles: list[np.ndarray] = []
        sr_tiles: list[np.ndarray] = []

        def drain_one():
            n, hq, sr, fetched = pending.pop(0)
            if fetched is not None:
                fetched.synchronize()
            hq_tiles.extend(hq[:n].numpy().copy())
            if sr is not None:
                sr_tiles.extend(sr[:n].numpy().copy())

        for k, b in enumerate(range(0, len(tiles), tile_batch)):
            chunk = tiles[b:b + tile_batch]
            n = len(chunk)
            if n < tile_batch:  # keep one batch shape
                chunk = chunk + [chunk[-1]] * (tile_batch - n)
            x = torch.from_numpy(np.stack(chunk))
            if not cuda:
                hq, sr = self._forward_device(x, denoise_rate)
                pending.append((n, hq, sr, None))
            else:
                if k < _MAX_IN_FLIGHT:
                    slots.append({"x": torch.empty_like(x).pin_memory()})
                slot = slots[k % _MAX_IN_FLIGHT]
                slot["x"].copy_(x)
                main = torch.cuda.current_stream(self.device)
                with torch.cuda.stream(side):
                    dev = slot["x"].to(self.device, non_blocking=True)
                    main.wait_event(side.record_event())
                dev.record_stream(main)
                hq, sr = self._forward_device(dev, denoise_rate)
                side.wait_event(main.record_event())
                with torch.cuda.stream(side):
                    outs = []
                    for key, val in (("hq", hq), ("sr", sr)):
                        if val is None:
                            outs.append(None)
                            continue
                        if key not in slot:
                            slot[key] = torch.empty(
                                val.shape, dtype=val.dtype).pin_memory()
                        slot[key].copy_(val, non_blocking=True)
                        val.record_stream(side)
                        outs.append(slot[key])
                    fetched = side.record_event()
                pending.append((n, outs[0], outs[1], fetched))
            if len(pending) >= _MAX_IN_FLIGHT:
                drain_one()
        while pending:
            drain_one()
        return hq_tiles, sr_tiles
