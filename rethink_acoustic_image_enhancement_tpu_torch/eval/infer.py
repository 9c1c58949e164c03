"""Serving predictors (the reference notebooks' serving paths as an API).

TeacherPredictor  KDLAE_T.ipynb cell 5: reflect-pad on the host to a
                  multiple of 8 (or ``shape_bucket``), uint8 in (divided by
                  255 in float32, then cast to the serving dtype), a scalar
                  denoise rate broadcast to a (B, 1, H, W) plane, forward,
                  clamp and round-half-to-even to uint8 on the device, crop,
                  and the fan-beam zero mask on ``hq`` and the 2x ``sr``.
                  ``denoise_group`` serves same-shape images in groups with
                  the next group's upload under the current one's compute;
                  ``denoise_tiled`` cuts large frames into batches of tiles.
StudentPredictor  KDLAE-S.ipynb cell 3: 7-frame grayscale stacks
                  (resized to the first frame), reflect-pad to a multiple
                  of 32, forward, clamp, crop; many stacks per call.
ASDQEScorer       ASDQE_test.py:87-104: pairwise quality scores.

Each predictor serves its own copy of the model it is given (on its device,
with its own flags), so the caller's module and other predictors built on it
are never changed. The weights' dtype sets the compute dtype and ``dtype``
only the input boundary, as in the JAX package, whose flax modules have
``dtype=None``: float32 weights with a bfloat16 ``dtype`` round the input to
bfloat16 and compute in float32; cast the model to bfloat16 to compute in
bfloat16. Every forward that computes in float32 runs with TF32 off
(``highest_precision``), as the JAX package pins
``jax.default_matmul_precision("highest")``.

Runs on ``cuda`` unless the caller asks for another device; with no GPU
and no device named it raises rather than fall back to the CPU.

Data-parallel serving (the JAX predictors' ``mesh`` with a ``data`` axis):
``devices=[...]`` in place of ``device`` puts one copy of the model, with
its own transfer streams, on each entry (an entry may repeat: two copies
can share a card). The batch paths split their batch into one contiguous
part per copy (padded to an even split by repeating the last item, the
padding sliced off): ``TeacherPredictor.denoise_tiled`` (each chunk's
tiles; ``tile_batch`` must divide), ``StudentPredictor.denoise_batch`` and
``ASDQEScorer.upload`` / ``dispatch`` / ``__call__``. The calling thread
enqueues every copy's part in turn, each with its copy's device current, on
that device's current stream, and waits for none of them before the last
is enqueued (the scorer's scores are gathered onto ``devices[0]`` without a
host sync), so that copies on several cards run at once. Everything else (the teacher's
``__call__`` and ``denoise_group``) runs ``devices[0]``'s copy. A part's
batch is smaller than the whole, so outputs may differ from one device by
rounding (uint8 within 1 level), as in the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from ..models import DenoiseRatePredictor, KDLAEStudent, KDLAETeacher
from ..ops.mask import apply_zero_mask, zero_mask_from_input
from ..utils.image_io import (imread_gray, imread_rgb_ubyte, list_images,
                              resize_area, to_ubyte)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_reflect_np(x: np.ndarray, ph: int, pw: int, axes=(1, 2)) -> np.ndarray:
    if ph == 0 and pw == 0:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axes[0]] = (0, ph)
    pad[axes[1]] = (0, pw)
    return np.pad(x, pad, mode="reflect")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the GPU (in a process group, this rank's card:
    ``parallel.local_device``), and raises where there is none."""
    if device is None:
        from ..parallel import local_device

        return local_device()
    return torch.device(device)


class _Precision:
    """The process-wide TF32 flags held off while any thread is inside
    ``highest_precision`` (entries counted under a lock)."""
    lock = threading.Lock()
    depth = 0
    saved: tuple[bool, bool] = (True, True)


@contextlib.contextmanager
def highest_precision():
    """Full float32 products inside: TF32 off for cuDNN convolutions and
    cuBLAS matmuls, both flags restored when the last thread inside leaves,
    exceptions included (the counterpart of
    ``jax.default_matmul_precision("highest")``; PyTorch allows TF32 in
    cuDNN by default). The flags are process-wide, so threads that serve
    at once share one entry rather than restore them under each other."""
    with _Precision.lock:
        if _Precision.depth == 0:
            _Precision.saved = (torch.backends.cudnn.allow_tf32,
                                torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _Precision.depth += 1
    try:
        yield
    finally:
        with _Precision.lock:
            _Precision.depth -= 1
            if _Precision.depth == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _Precision.saved


def _to_ubyte_device(x: torch.Tensor) -> torch.Tensor:
    """Clamp, float32, *255, round half to even, uint8 (on the device)."""
    return torch.round(x.clamp(0.0, 1.0).float() * 255.0).to(torch.uint8)


class Transfers:
    """Host <-> device copies beside the compute: uploads on one side
    stream (from any thread), fetches on another, each ordered against the
    current stream by events. On the CPU they are plain tensors."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.up = torch.cuda.Stream(device)
            self.down = torch.cuda.Stream(device)

    def upload(self, *tensors: torch.Tensor):
        """Host tensors -> (device tensors, event after the copies)."""
        if not self.cuda:
            return tensors, None
        with torch.cuda.stream(self.up):
            dev = tuple(t.pin_memory().to(self.device, non_blocking=True)
                        for t in tensors)
            return dev, self.up.record_event()

    def on_current(self, tensors, event):
        """Make uploaded tensors safe to use on the current stream."""
        if event is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(event)
            for t in tensors:
                t.record_stream(main)
        return tensors

    def fetch(self, *tensors):
        """Device tensors (or None) -> (host tensors, event to wait for)."""
        if not self.cuda:
            return tensors, None
        self.down.wait_event(torch.cuda.current_stream(self.device).record_event())
        with torch.cuda.stream(self.down):
            host = []
            for t in tensors:
                if t is None:
                    host.append(None)
                    continue
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                t.record_stream(self.down)
                host.append(buf)
            return tuple(host), self.down.record_event()


_MAX_IN_FLIGHT = 16  # tile chunks dispatched before the oldest is fetched


def _serving_devices(device, devices) -> list[torch.device] | None:
    """``devices`` as a list of devices (None without it); ``device`` beside
    it, or an empty list, raises."""
    if devices is None:
        return None
    if device is not None:
        raise ValueError(f"pass device= or devices=, not both (device={device}, "
                         f"devices={list(devices)})")
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("devices= needs at least one device")
    return devices


class _Copy(NamedTuple):
    """One data-parallel copy: its model on its device and its transfer
    streams."""
    model: nn.Module
    device: torch.device
    transfers: Transfers

    def context(self):
        """The copy's device current (nothing on the CPU)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()


def _make_copies(model: nn.Module, devices: list[torch.device] | None,
                 transfers: Transfers | None = None) -> list[_Copy] | None:
    """``devices``' copies: ``model`` (already on ``devices[0]``) with
    ``transfers`` (new ones if None) first, then an ``_own_copy`` of it on
    each other entry; None without ``devices``."""
    if devices is None:
        return None
    return [_Copy(model, devices[0], transfers or Transfers(devices[0]))] + [
        _Copy(_own_copy(model, d), d, Transfers(d)) for d in devices[1:]]


def _even_split(x: np.ndarray, n: int) -> list[np.ndarray]:
    """``x`` padded along axis 0 to a multiple of ``n`` by repeating its
    last item, cut into ``n`` equal contiguous parts."""
    if len(x) % n:
        x = np.concatenate([x, np.repeat(x[-1:], n - len(x) % n, axis=0)])
    return np.split(x, n)


class TeacherPredictor:
    """KDLAE-T denoiser with the notebook's pre/postprocessing.

    ``model`` carries its weights (the predictor serves a copy), whose dtype
    is the compute dtype; ``dtype`` is the input's; ``fused`` routes
    gate-admitted stages through the stage kernel; ``fused_resample`` folds the resamplers'
    pixel-(un)shuffle into their convs. ``shape_bucket`` rounds padded
    sizes up to a coarser grid (MDTA statistics are global over the padded
    pixels, so bucketed outputs deviate slightly from multiple-of-8
    padding). ``devices`` serves tiles data-parallel (module docstring)."""

    def __init__(self, model: KDLAETeacher | None = None, multiple_of: int = 8,
                 shape_bucket: int | None = None,
                 dtype: torch.dtype = torch.float32, fused: bool = False,
                 fused_resample: bool = False,
                 device: str | torch.device | None = None,
                 devices: Sequence[str | torch.device] | None = None):
        if shape_bucket and shape_bucket % multiple_of:
            raise ValueError(
                f"shape_bucket={shape_bucket} must be a multiple of "
                f"multiple_of={multiple_of}")
        devices = _serving_devices(device, devices)
        self.device = devices[0] if devices else resolve_device(device)
        if model is None:
            model = KDLAETeacher(layernorm_type="BiasFree", static="train",
                                 params="cat")
        self.model: nn.Module = _own_copy(model, self.device)
        # float32 compute (float32 weights, or a float32 input) pins TF32 off
        self._fp32 = torch.promote_types(
            dtype, next(self.model.parameters()).dtype) == torch.float32
        self.model.set_fused(fused)
        self.model.set_fused_resample(fused_resample)
        self.multiple_of = multiple_of
        self.shape_bucket = shape_bucket
        self.dtype = dtype
        self._transfers = Transfers(self.device)
        self._copies = _make_copies(self.model, devices, self._transfers)

    @property
    def models(self) -> list[nn.Module]:
        """The model of each copy (``[self.model]`` without ``devices``)."""
        return [self.model] if self._copies is None else [cp.model for cp in self._copies]

    def _forward(self, x: np.ndarray, denoise_rate: float):
        img = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return self._forward_device(img, denoise_rate)

    @torch.inference_mode()
    def _forward_device(self, img: torch.Tensor, rate: float | torch.Tensor,
                        model: nn.Module | None = None):
        """(B, H, W, 3) uint8 or float on the device, and the denoise rate
        (a float, or a 0-d tensor of the serving dtype on the device) ->
        uint8 NHWC 'hq' and 'sr' (or None) on the device, through ``model``
        (a copy on img's device; ``self.model`` by default)."""
        if img.dtype == torch.uint8:
            # divide in float32 first, then cast: the model input equals
            # the host reader's float values in every serving dtype
            img = (img.float() / 255.0).to(self.dtype)
        else:
            img = img.to(self.dtype)
        img = img.permute(0, 3, 1, 2)
        if not isinstance(rate, torch.Tensor):
            rate = torch.full((), rate, dtype=self.dtype, device=img.device)
        plane = rate.reshape(1, 1, 1, 1).expand(img.shape[0], 1, img.shape[2],
                                               img.shape[3])
        with highest_precision() if self._fp32 else contextlib.nullcontext():
            out = (self.model if model is None else model)(
                {"img": img, "denoise_rate": plane})
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
        return _postprocess(img_rgb, hq[0].cpu().numpy(),
                            None if sr is None else sr[0].cpu().numpy(),
                            zero_mask)

    def denoise_file(self, path: str, denoise_rate: float = 1.0, **kw) -> dict:
        return self(imread_rgb_ubyte(path), denoise_rate, **kw)

    # ------------------------------------------------------------ group --
    def denoise_group(self, imgs_rgb: list[np.ndarray],
                      denoise_rate: float = 1.0, zero_mask: bool = True,
                      group_size: int = 8) -> list[dict]:
        """Throughput serving: same-shape images in groups of
        ``group_size``, each image of a group through the same forward as
        ``__call__`` (as ``lax.scan`` runs the JAX package's group), so the
        outputs are bit-identical to per-image calls. A one-slot worker
        thread pads, stacks and uploads group k+1 while group k computes
        and group k-1 is fetched and post-processed. With ``shape_bucket``
        images whose bucketed padded size matches group together (each
        cropped back to its own size); other mixed shapes are served per
        image, and so is a tail shorter than a group. With ``devices`` every
        image goes through ``__call__`` (as the JAX package serves a mesh per
        image)."""
        if not imgs_rgb:
            return []
        if self._copies is not None:
            return [self(im, denoise_rate, zero_mask=zero_mask) for im in imgs_rgb]
        shape0 = imgs_rgb[0].shape
        if any(im.shape != shape0 for im in imgs_rgb):
            m_b = self.shape_bucket
            targets = {(_round_up(im.shape[0], m_b), _round_up(im.shape[1], m_b))
                       for im in imgs_rgb} if m_b else None
            if not (m_b and len(targets) == 1):
                return [self(im, denoise_rate, zero_mask=zero_mask)
                        for im in imgs_rgb]

        full_end = (len(imgs_rgb) // group_size) * group_size
        groups = [imgs_rgb[b:b + group_size]
                  for b in range(0, full_end, group_size)]
        tail = imgs_rgb[full_end:]

        results: list[dict] = []
        pending = None
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = (ex.submit(self._prep_and_upload, groups[0], denoise_rate)
                   if groups else None)
            for i in range(len(groups)):
                uploaded = fut.result()
                fut = (ex.submit(self._prep_and_upload, groups[i + 1],
                                 denoise_rate)
                       if i + 1 < len(groups) else None)
                handle = self._dispatch_uploaded(uploaded)
                # group i-1's fetch and post-processing overlap group i
                if pending is not None:
                    results.extend(self.fetch_group(pending, zero_mask=zero_mask))
                pending = handle
        if pending is not None:
            results.extend(self.fetch_group(pending, zero_mask=zero_mask))
        results.extend(self(im, denoise_rate, zero_mask=zero_mask)
                       for im in tail)
        return results

    def scan_eligible(self, imgs: list[np.ndarray], group_size: int) -> bool:
        """True when ``imgs`` can run as one group (a full group of one raw
        shape, or of one bucketed shape)."""
        if len(imgs) != group_size:
            return False
        shape0 = imgs[0].shape
        if all(im.shape == shape0 for im in imgs):
            return True
        m_b = self.shape_bucket
        if not m_b:
            return False
        targets = {(_round_up(im.shape[0], m_b), _round_up(im.shape[1], m_b))
                   for im in imgs}
        return len(targets) == 1

    def _prep_and_upload(self, chunk: list[np.ndarray], denoise_rate: float):
        """Pad and stack one group on the host and upload it with its
        per-image rates (thread-safe: the group pipeline's worker runs it).
        Returns the (dtype-normalized) chunk, the device inputs and the
        event that ends their upload."""
        m = self.shape_bucket or self.multiple_of
        target_h = max(_round_up(im.shape[0], m) for im in chunk)
        target_w = max(_round_up(im.shape[1], m) for im in chunk)
        if any(im.dtype != np.uint8 for im in chunk):
            # mixed dtypes must not stack raw: uint8 goes to the float boundary
            chunk = [im.astype(np.float32) / 255.0 if im.dtype == np.uint8
                     else im for im in chunk]
        x = np.concatenate([
            _pad_reflect_np(im[None], target_h - im.shape[0],
                            target_w - im.shape[1])
            for im in chunk])
        if x.dtype != np.uint8:  # uint8 groups ship 1 byte/px
            x = x.astype(np.float32)
        rates = torch.full((len(chunk),), denoise_rate, dtype=self.dtype)
        dev, event = self._transfers.upload(torch.from_numpy(x), rates)
        return (chunk, *dev, event)

    def _dispatch_uploaded(self, uploaded):
        """Run one uploaded group image by image and queue its fetch."""
        chunk, x, rates, event = uploaded
        x, rates = self._transfers.on_current((x, rates), event)
        outs = [self._forward_device(x[k:k + 1], rates[k])
                for k in range(x.shape[0])]
        hq = torch.cat([o[0] for o in outs])
        sr = None if outs[0][1] is None else torch.cat([o[1] for o in outs])
        (hq, sr), fetched = self._transfers.fetch(hq, sr)
        return chunk, hq, sr, fetched

    def dispatch_group(self, chunk: list[np.ndarray],
                       denoise_rate: float = 1.0):
        """Dispatch one group (the caller checks ``scan_eligible``); returns
        a handle for ``fetch_group``."""
        return self._dispatch_uploaded(self._prep_and_upload(chunk, denoise_rate))

    def fetch_group(self, handle, zero_mask: bool = True) -> list[dict]:
        """Wait for a dispatched group's fetch and post-process it."""
        chunk, hqs, srs, fetched = handle
        if fetched is not None:
            fetched.synchronize()
        return [_postprocess(im, hqs[j].numpy(),
                             None if srs is None else srs[j].numpy(), zero_mask)
                for j, im in enumerate(chunk)]

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
        buffers on side streams, so chunk k+1's upload and chunk k-1's
        fetch overlap chunk k's forward; at most 16 chunks are in flight.
        With ``devices`` each chunk's tiles split evenly over the copies
        (``tile_batch`` must divide by their number).
        """
        if not imgs_rgb:
            return []
        if self._copies is not None and tile_batch % len(self._copies):
            raise ValueError(
                f"tile_batch ({tile_batch}) must be divisible by the number "
                f"of devices ({len(self._copies)})")
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
            results[idx] = _postprocess(im, out_hq, out_sr, zero_mask)
        return [results[i] for i in range(len(imgs_rgb))]

    def _forward_tiles(self, tiles: list[np.ndarray], tile_batch: int,
                       denoise_rate: float):
        """Forward same-shape tiles ``tile_batch`` at a time (the last chunk
        repeats its last tile, so every call has one batch shape); returns
        the lists of uint8 'hq' tiles and 'sr' tiles (empty without the SR
        head) in order. With ``devices`` each chunk is cut into one
        contiguous part per copy and the parts put back in order."""
        chunks = []
        for b in range(0, len(tiles), tile_batch):
            chunk = tiles[b:b + tile_batch]
            chunks.append((len(chunk), chunk + [chunk[-1]] * (tile_batch - len(chunk))))
        copies = self._copies or [_Copy(self.model, self.device, self._transfers)]
        outs = self._serve_chunks(copies, [c for _, c in chunks], denoise_rate)
        hq_tiles: list[np.ndarray] = []
        sr_tiles: list[np.ndarray] = []
        for (n, _), (hq, sr) in zip(chunks, outs):
            hq_tiles.extend(hq[:n])
            if sr is not None:
                sr_tiles.extend(sr[:n])
        return hq_tiles, sr_tiles

    def _serve_chunks(self, copies: list[_Copy],
                      chunks: list[list[np.ndarray]],
                      denoise_rate: float) -> list[tuple]:
        """(hq, sr or None) uint8 host arrays of each chunk of tiles, each
        chunk cut into one contiguous part per copy, every part enqueued
        from this thread through its copy's model and ``transfers``. On the
        GPU uploads and fetches are non-blocking copies through pinned
        buffers on side streams; a chunk is read on the host only after its
        parts' fetch events, and at most ``_MAX_IN_FLIGHT`` are in flight."""
        per = len(chunks[0]) // len(copies)
        pending: list = []         # per chunk: (hq_host, sr_host, fetched) a copy
        outs: list[tuple] = []

        def drain_one():
            parts = pending.pop(0)
            for _, _, fetched in parts:
                if fetched is not None:
                    fetched.synchronize()
            outs.append(tuple(
                None if parts[0][j] is None else
                np.concatenate([p[j].numpy() for p in parts]) for j in range(2)))

        for chunk in chunks:
            parts = []
            for k, cp in enumerate(copies):
                with cp.context():
                    x, event = cp.transfers.upload(
                        torch.from_numpy(np.stack(chunk[k * per:(k + 1) * per])))
                    x, = cp.transfers.on_current(x, event)
                    (hq, sr), fetched = cp.transfers.fetch(
                        *self._forward_device(x, denoise_rate, cp.model))
                parts.append((hq, sr, fetched))
            pending.append(parts)
            if len(pending) >= _MAX_IN_FLIGHT:
                drain_one()
        while pending:
            drain_one()
        return outs


def _own_copy(model: nn.Module, device: torch.device) -> nn.Module:
    """A copy of ``model`` on ``device`` in eval mode; ``model`` is left as
    it was (the JAX predictors clone their flax module, never the params)."""
    return copy.deepcopy(model).to(device).eval()


def _postprocess(im: np.ndarray, hq: np.ndarray, sr: np.ndarray | None,
                 zero_mask: bool) -> dict:
    """Crop the padded uint8 outputs of one image to its size and apply the
    fan-beam zero mask."""
    h, w = im.shape[:2]
    hq = hq[:h, :w]
    out = {}
    if zero_mask:
        mask = zero_mask_from_input(im if im.dtype == np.uint8 else to_ubyte(im))
        hq = apply_zero_mask(hq, mask)
    out["hq"] = hq
    if sr is not None:
        sr = sr[:2 * h, :2 * w]
        if zero_mask:
            sr = apply_zero_mask(sr, mask, scale=2)
        out["sr"] = sr
    return out


class StudentPredictor:
    """Multi-frame KDLAE-S denoiser (the temporal stack serving path).

    With float32 weights (the zoo's) the model computes in float32 whatever
    ``dtype`` is: bfloat16 serving rounds the input stack (uint8 / 255 in
    float32, then bfloat16), as the JAX predictor's flax module does.
    ``devices`` serves ``denoise_batch`` data-parallel (module docstring)."""

    def __init__(self, model: KDLAEStudent | None = None, multiple_of: int = 32,
                 num_frames: int = 7, dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = None,
                 devices: Sequence[str | torch.device] | None = None):
        devices = _serving_devices(device, devices)
        self.device = devices[0] if devices else resolve_device(device)
        if model is None:
            model = KDLAEStudent(residual=True, hidden_channels=(16, 32, 64))
        self.model: nn.Module = _own_copy(model, self.device)
        self.multiple_of = multiple_of
        self.num_frames = num_frames
        self.dtype = dtype
        self._copies = _make_copies(self.model, devices)

    def _forward(self, x: np.ndarray) -> torch.Tensor:
        """(B, F, H, W) uint8 or float32 on the host -> uint8 on the device."""
        return self._forward_device(
            torch.from_numpy(np.ascontiguousarray(x)).to(self.device), self.model)

    @torch.inference_mode()
    def _forward_device(self, stack: torch.Tensor, model: nn.Module) -> torch.Tensor:
        if stack.dtype == torch.uint8:
            stack = stack.float() / 255.0
        with highest_precision():
            return _to_ubyte_device(model(stack.to(self.dtype)))

    def _dispatch_part(self, cp: _Copy, x: np.ndarray):
        """Enqueue one copy's part of a batch: upload, forward, fetch;
        returns (the host output, the event that ends its fetch)."""
        with cp.context():
            (stack,), event = cp.transfers.upload(torch.from_numpy(x))
            stack, = cp.transfers.on_current((stack,), event)
            (out,), fetched = cp.transfers.fetch(self._forward_device(stack, cp.model))
        return out, fetched

    def _padded(self, stacks: np.ndarray) -> np.ndarray:
        h, w = stacks.shape[2:]
        m = self.multiple_of
        x = _pad_reflect_np(stacks, _round_up(h, m) - h, _round_up(w, m) - w,
                            axes=(2, 3))
        return x if x.dtype == np.uint8 else x.astype(np.float32)

    def __call__(self, stack: np.ndarray) -> np.ndarray:
        """stack: (F, H, W) float32 [0,1] or uint8. Returns (F, H, W) uint8."""
        _, h, w = stack.shape
        return self._forward(self._padded(stack[None]))[0, :, :h, :w].cpu().numpy()

    def denoise_batch(self, stacks: np.ndarray) -> np.ndarray:
        """(B, F, H, W) stacks in one forward: the 3-D conv student has no
        coupling across stacks, so batching is exact. With ``devices`` the
        batch is padded to an even split, one part per copy."""
        b = stacks.shape[0]
        h, w = stacks.shape[2:]
        x = self._padded(stacks)
        if self._copies is not None:
            parts = _even_split(np.ascontiguousarray(x), len(self._copies))
            handles = [self._dispatch_part(cp, part)
                       for cp, part in zip(self._copies, parts)]
            outs = []
            for out, fetched in handles:
                if fetched is not None:
                    fetched.synchronize()
                outs.append(out.numpy())
            return np.concatenate(outs)[:b, :, :h, :w]
        return self._forward(x)[:, :, :h, :w].cpu().numpy()

    def load_stack(self, folder: str, start: int = 0) -> np.ndarray:
        """``num_frames`` consecutive grayscale frames, resized to the first
        frame's size (KDLAE-S.ipynb cell 3 loader); uint8 when no frame was
        resized (the decoded floats are then exact uint8 / 255)."""
        files = list_images(folder)
        if len(files) < self.num_frames:
            raise ValueError(
                f"need {self.num_frames} frames, found {len(files)} in {folder}")
        frames, target, resized = [], None, False
        for p in files[start:start + self.num_frames]:
            img = imread_gray(p)
            if target is None:
                target = (img.shape[1], img.shape[0])
            elif (img.shape[1], img.shape[0]) != target:
                img = resize_area(img, *target)
                resized = True
            frames.append(img)
        stack = np.stack(frames, axis=0)
        if not resized:
            stack = np.rint(stack * 255.0).astype(np.uint8)
        return stack

    def denoise_folder(self, folder: str, start: int = 0) -> np.ndarray:
        return self(self.load_stack(folder, start))

    def denoise_all_frames(self, folder: str,
                           stack_batch: int = 18) -> np.ndarray:
        """Denoise every frame of a folder: consecutive ``num_frames``
        stacks, the last one overlapping backwards so the tail is covered;
        each frame's output comes from the first stack that holds it.
        Returns (N, H, W) uint8 in ``list_images`` order. Uniform-size
        folders decode once and run ``stack_batch`` stacks per forward;
        mixed-size ones go stack by stack (each resized to its first
        frame) and come out resized to frame 0's size."""
        files = list_images(folder)
        n = len(files)
        if n < self.num_frames:
            raise ValueError(
                f"need {self.num_frames} frames, found {n} in {folder}")
        starts, start = [], 0
        while start < n:
            s = min(start, n - self.num_frames)
            starts.append(s)
            start = s + self.num_frames
        imgs = [imread_gray(p) for p in files]
        frames: dict[int, np.ndarray] = {}
        if len({im.shape for im in imgs}) == 1 and stack_batch > 1:
            u8 = np.stack([np.rint(im * 255.0).astype(np.uint8) for im in imgs])
            stacks = np.stack([u8[s:s + self.num_frames] for s in starts])
            outs = np.concatenate(
                [self.denoise_batch(stacks[b:b + stack_batch])
                 for b in range(0, len(stacks), stack_batch)])
            for k, s in enumerate(starts):
                for j in range(self.num_frames):
                    frames.setdefault(s + j, outs[k, j])
            return np.stack([frames[i] for i in range(n)])
        for s in starts:
            out = self.denoise_folder(folder, start=s)
            for j in range(out.shape[0]):
                frames.setdefault(s + j, out[j])
        shape0 = frames[0].shape
        if any(f.shape != shape0 for f in frames.values()):
            frames = {i: resize_area(f, shape0[1], shape0[0])
                      if f.shape != shape0 else f for i, f in frames.items()}
        return np.stack([frames[i] for i in range(n)])


class ASDQEScorer:
    """Pairwise quality scorer (ASDQE_test.py infer loop). With float32
    weights the model computes in float32 with TF32 off whatever ``dtype``
    is; bfloat16 rounds the images (and their difference, taken before the
    convs). ``devices`` scores batches data-parallel (module docstring)."""

    def __init__(self, model: DenoiseRatePredictor | None = None,
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = None,
                 devices: Sequence[str | torch.device] | None = None):
        devices = _serving_devices(device, devices)
        self.device = devices[0] if devices else resolve_device(device)
        if model is None:
            model = DenoiseRatePredictor()
        self.model: nn.Module = _own_copy(model, self.device)
        self.dtype = dtype
        self._transfers = Transfers(self.device)
        self._copies = _make_copies(self.model, devices, self._transfers)

    @torch.inference_mode()
    def _forward(self, lq: torch.Tensor, gt: torch.Tensor,
                 model: nn.Module | None = None) -> torch.Tensor:
        def prep(x):
            if x.dtype == torch.uint8:  # f32 / 255 first, as the teacher
                x = x.float() / 255.0
            return x.to(self.dtype).permute(0, 3, 1, 2)

        with highest_precision():
            return (self.model if model is None else model)(
                prep(lq), prep(gt)).reshape(-1).float()

    def upload(self, lq: np.ndarray, gt: np.ndarray):
        """Upload one pair, (H, W, 3) or (B, H, W, 3), uint8 as it is and
        floats in the serving dtype. Thread-safe: the score pipeline
        uploads pair k+1 from a worker while pair k computes. With
        ``devices`` the batch is padded to an even split (a batch of 1 too,
        as the JAX package pads it for a mesh) and each copy gets its part."""
        if lq.ndim == 3:
            lq, gt = lq[None], gt[None]

        def ship(x):
            t = torch.from_numpy(np.ascontiguousarray(x))
            return t if t.dtype == torch.uint8 else t.to(self.dtype)

        if self._copies is not None:
            n = len(self._copies)
            return [cp.transfers.upload(ship(a), ship(b)) for cp, a, b in
                    zip(self._copies, _even_split(lq, n), _even_split(gt, n))]
        dev, event = self._transfers.upload(ship(lq), ship(gt))
        return (*dev, event)

    def dispatch(self, uploaded) -> torch.Tensor:
        """Score an ``upload``-ed pair: a (B,) float32 tensor on the device
        (``.cpu()`` is the fetch). With ``devices`` each copy scores its part
        on its device's current stream, and the parts are gathered onto
        ``devices[0]`` with non-blocking copies: (B padded to the even
        split,), the real scores first."""
        if self._copies is not None:
            scores = []
            for cp, ((lq, gt), event) in zip(self._copies, uploaded):
                with cp.context():
                    lq, gt = cp.transfers.on_current((lq, gt), event)
                    scores.append(self._forward(lq, gt, cp.model).to(
                        self.device, non_blocking=True))
            return torch.cat(scores)
        lq, gt, event = uploaded
        lq, gt = self._transfers.on_current((lq, gt), event)
        return self._forward(lq, gt)

    def __call__(self, lq: np.ndarray, gt: np.ndarray) -> np.ndarray:
        """lq / gt: (H, W, 3) or (B, H, W, 3), float [0,1] or uint8;
        returns (B,) float32 scores."""
        b = 1 if lq.ndim == 3 else lq.shape[0]
        return self.dispatch(self.upload(lq, gt)).cpu().numpy()[:b]
