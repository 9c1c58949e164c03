"""The Hopper kernel (C) at C = 96 (``csrc/stage_sm90.cu``) from the host's
side, on the CPU: which launches take it (by width alone: never another
width; a model shard's block at C = 96 takes stage_sm90_wide.cu's shard
kernels, tests/test_torch_gdfn_sm90.py), the operand layout its weights are
packed in,
and its persistent schedule: every output pixel written exactly once, each
by a tile whose 8 x 32 halo box holds the pixel's 3 x 3 neighbourhood and
reads v exactly where the image (not a band's edge) has it. Pure Python over
stubs: no GPU, no compiler."""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.ops import block as pblock
from rethink_acoustic_image_enhancement_tpu_torch.ops import gdfn as pgdfn


@pytest.mark.parametrize("c,shard,route", [
    (96, False, "wgmma"), (96, True, "wgmma"), (48, False, "mma_sync"),
    (192, False, "wgmma"), (384, False, "wgmma"), (384, True, "wgmma")])
def test_route_is_by_width_and_never_on_a_shard(c, shard, route):
    assert pblock.apply_route(c, shard) == route


def _weights(n, c, cq, f, seed=0, heads=1):
    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return torch.randn(*shape, generator=g)

    return dict(ln1_w=t(n, c), w_qkv=t(n, 1, 1, c, 3 * cq), dw_qkv=t(n, 3, 3, 1, 3 * cq),
                temperature=t(n, heads), w_proj=t(n, 1, 1, cq, c), ln2_w=t(n, c),
                w_in=t(n, 1, 1, c, 2 * f), w_dw=t(n, 3, 3, 1, 2 * f), w_out=t(n, 1, 1, f, c))


@pytest.mark.parametrize("c,cq,packed", [(96, 96, True), (96, 48, True), (192, 192, True),
                                         (48, 48, False)])
def test_only_the_hopper_route_packs_its_operands(c, cq, packed):
    heads = c // 48 if c > 96 else 1  # the teacher's 48 channels a head at C = 192
    p = pblock.pack_blocks("cpu", **_weights(2, c, cq, int(2.66 * c), heads=heads),
                           shard=cq < c)
    assert all((k in p) == packed for k in ("wqkv_wg", "qtaps_wg", "wproj_wg", "win_wg",
                                            "wtaps_wg", "wout_wg"))


@pytest.mark.parametrize("k,n", [(96, 96), (96, 64), (32, 96), (16, 8)])
def test_b_operand_is_k_major_core_matrices(k, n):
    """Element (k, n) at plane k // 8, core matrix n // 8, row n % 8, column
    k % 8: 16 bytes a row, 128 a core matrix, n * 16 a plane."""
    w = torch.arange(k * n).reshape(k, n)
    flat = pblock.b_operand(w[None])[0]
    kk, nn = np.meshgrid(np.arange(k), np.arange(n), indexing="ij")
    at = (kk // 8) * (n * 8) + (nn // 8) * 64 + (nn % 8) * 8 + kk % 8
    assert torch.equal(flat[torch.from_numpy(at)], w)
    assert sorted(at.ravel().tolist()) == list(range(k * n))


def test_hopper_operands_hold_every_chunk_of_the_weights():
    """Kernel (C)'s chunks: W_in's columns of both halves as a B operand,
    each channel's two side by side, and their taps [tap][f][half] in fp32;
    W_out's rows of the chunk; W_proj."""
    c, f = 96, 255
    w = _weights(3, c, c, f, seed=1)
    p = pblock.pack_blocks("cpu", **w)
    # csrc/gdfn.cu's layout of the same weights (the hidden width padded)
    ffn = pgdfn.pack_ffn(w["w_in"].reshape(3, c, -1), w["w_dw"].reshape(3, 9, -1),
                         w["w_out"].reshape(3, -1, c), c, "cpu")
    fp, fc = p["fp"], pblock.WGMMA_FC
    assert fp == ffn["fp"] and "win" not in p
    nch = fp // fc
    assert p["win_wg"].shape[:2] == p["wtaps_wg"].shape[:2] == p["wout_wg"].shape[:2] == (3, nch)
    kk, nn = np.meshgrid(np.arange(c), np.arange(2 * fc), indexing="ij")
    at = torch.from_numpy((kk // 8) * (2 * fc * 8) + (nn // 8) * 64 + (nn % 8) * 8 + kk % 8)
    ko, no = np.meshgrid(np.arange(fc), np.arange(c), indexing="ij")
    at_out = torch.from_numpy((ko // 8) * (c * 8) + (no // 8) * 64 + (no % 8) * 8 + ko % 8)
    for i in range(3):
        for j in range(nch):
            ch = torch.arange(j * fc, (j + 1) * fc)
            cols = torch.stack([ch, fp + ch], 1).reshape(-1)  # [f][half]
            assert torch.equal(p["win_wg"][i, j].reshape(-1)[at], ffn["win"][i][:, cols])
            assert torch.equal(p["wtaps_wg"][i, j].reshape(9, 2 * fc), ffn["wdw"][i][:, cols])
            assert torch.equal(p["wout_wg"][i, j].reshape(-1)[at_out],
                               ffn["wout"][i, j * fc:(j + 1) * fc])
        assert torch.equal(pblock.b_operand(p["wproj"][i][None])[0], p["wproj_wg"][i])


def test_hopper_qkv_chunks_hold_w_qkv_and_its_taps():
    """Kernel (A)'s six chunks: 48 columns of W_qkv as a B operand (N = 48,
    K = C), and their depthwise taps [tap][48] in fp32."""
    c, qch = 96, pblock.WGMMA_QCH
    p = pblock.pack_blocks("cpu", **_weights(2, c, c, 255, seed=2))
    assert p["wqkv_wg"].shape[:2] == p["qtaps_wg"].shape[:2] == (2, 3 * c // qch)
    kk, nn = np.meshgrid(np.arange(c), np.arange(qch), indexing="ij")
    at = torch.from_numpy((kk // 8) * (qch * 8) + (nn // 8) * 64 + (nn % 8) * 8 + kk % 8)
    for i in range(2):
        for j in range(3 * c // qch):
            cols = slice(j * qch, (j + 1) * qch)
            assert torch.equal(p["wqkv_wg"][i, j].reshape(-1)[at], p["wqkv"][i][:, cols])
            assert torch.equal(p["qtaps_wg"][i, j].reshape(9, qch), p["dwqkv"][i][:, cols])


@pytest.mark.parametrize("h,halo,y_img,h_img,rows", [
    (512, 0, 0, 512, (0, 512)), (256, 1, 0, 512, (0, 257)), (256, 1, 256, 512, (-1, 256)),
    (128, 1, 128, 512, (-1, 129)), (126, 1, 0, 252, (0, 127))])
def test_readable_rows_stop_at_the_image_not_the_band(h, halo, y_img, h_img, rows):
    assert pblock.readable_rows(h, halo, y_img, h_img) == rows


def _check_schedule(batch, h, w, grid, halo=0, y_img=0, h_img=None):
    th, tw = pblock.WGMMA_TILE
    lo, hi = pblock.readable_rows(h, halo, y_img, h_img)
    written = np.zeros((batch, h, w), dtype=np.int64)
    blocks = pblock.wgmma_tiles(batch, h, w, grid, halo, y_img, h_img)
    assert len(blocks) == grid
    n_tiles = sum(len(t) for t in blocks)
    assert n_tiles == batch * -(-h // th) * -(-w // tw)
    assert max(len(t) for t in blocks) - min(len(t) for t in blocks) <= 1  # a fair walk
    for tiles in blocks:
        for t in tiles:
            y0, x0 = t["y0"], t["x0"]
            assert t["rows"] == tuple(range(y0, y0 + th)) + (y0 - 1, y0 + th)
            assert t["cols"] == tuple(range(x0 - 1, x0 + tw + 1))
            assert t["read"].shape == (th + 2, tw + 2) and t["out"].shape == (th, tw)
            ys = np.arange(y0 - 1, y0 + th + 1)[:, None]
            xs = np.arange(x0 - 1, x0 + tw + 1)[None, :]
            assert np.array_equal(t["read"], (ys >= lo) & (ys < hi) & (xs >= 0) & (xs < w))
            # outputs inside the band and the image, each with its 3 x 3
            # neighbourhood in the box (rows y0-1..y0+6, columns x0-1..x0+30)
            assert np.array_equal(t["out"], ((ys >= 0) & (ys < h) & (xs >= 0) & (xs < w))[1:-1, 1:-1])
            assert set(t["rows"]) == set(range(y0 - 1, y0 + th + 1))
            ii, jj = np.nonzero(t["out"])
            np.add.at(written[t["b"]], (y0 + ii, x0 + jj), 1)
    assert (written == 1).all()


@pytest.mark.parametrize("batch,h,w", [(1, 512, 512), (1, 256, 256), (1, 504, 384),
                                       (1, 252, 192), (8, 256, 256), (2, 13, 9)])
def test_schedule_writes_every_pixel_once(batch, h, w):
    grid = pblock.wgmma_grid(batch, h, w, 132)
    _check_schedule(batch, h, w, grid)


@pytest.mark.parametrize("n_bands", [2, 4])
@pytest.mark.parametrize("h_img,w", [(512, 512), (504, 384), (256, 256)])
def test_schedule_on_row_bands(n_bands, h_img, w):
    hb = h_img // n_bands
    for j in range(n_bands):
        _check_schedule(1, hb, w, pblock.wgmma_grid(1, hb, w, 132), 1, j * hb, h_img)


def test_grid_is_one_block_an_sm_and_no_more_than_the_tiles():
    assert pblock.wgmma_grid(1, 512, 512, 132) == 132
    assert pblock.wgmma_grid(1, 13, 9, 132) == 3
    assert pblock.wgmma_grid(8, 256, 256, 264) == 264


# ---- BlockRunner's launches, over stub libraries ---------------------------

class _Stage:
    """Answers as csrc/stage.cu does for any layout, and records launches."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.endswith("smem_bytes"):
            return lambda *a: 100_000
        if name.endswith("blocks_per_sm"):
            return lambda *a: 2
        if name.endswith("error_string"):
            return lambda code: b"stub"
        return lambda *a: self.calls.append(name) or 0


@pytest.fixture
def no_card(monkeypatch):
    """BlockRunner on CPU tensors: the device guard and queries answer as a
    132-SM card would; nothing is launched (the libraries are stubs)."""
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: SimpleNamespace(cuda_stream=0))


@pytest.mark.parametrize("c,cq,heads,route,entries", [
    (96, None, 1, "wgmma", ["raie_stage_gram_wgmma", "raie_stage_apply_wgmma"]),
    (96, None, 6, "wgmma", ["raie_stage_gram_wgmma", "raie_stage_apply_wgmma"]),
    (96, None, 4, "wgmma", ["raie_stage_gram_wgmma", "raie_stage_apply_wgmma"]),
    (192, None, 4, "wgmma", ["raie_stage_wide_gram", "raie_stage_wide_project",
                             "raie_stage_wide_ffn"]),
    (48, None, 3, "mma_sync", ["raie_stage_gram", "raie_stage_apply"]),
    (96, 48, 1, "wgmma", ["raie_stage_wide_gram", "raie_stage_wide_project"]),
    (96, 96, 2, "wgmma", ["raie_stage_gram_wgmma", "raie_stage_wide_project"])])
def test_runner_launches_the_route_of_its_width(no_card, c, cq, heads, route, entries):
    stage, wg = _Stage(), _Stage()
    x = torch.zeros(1, 20, 28, c)
    p = pblock.pack_blocks("cpu", **_weights(1, c, c if cq is None else cq, int(2.66 * c),
                                             heads=heads), shard=cq is not None)
    run = pblock.BlockRunner(x, heads, p["fp"], stage, cq=cq, wg_library=wg)
    assert run.route == route
    fns = (pblock.gram_wgmma, pblock.apply_wgmma, pblock.gram_wide, pblock.proj_wide,
           pblock.ffn_wide)
    counts = [fn.launches for fn in fns]
    run.gram(x, p, 0, 1e-5)
    if cq is None:
        run.apply(x, torch.empty_like(x), p, 0, 1e-5)
    else:
        run.project(x, torch.empty_like(x), p, 0)
    assert (stage.calls if route == "mma_sync" else wg.calls) == entries
    assert (wg.calls if route == "mma_sync" else stage.calls) == []
    counted = [fn.launches - n for fn, n in zip(fns, counts)]
    by_entry = ["raie_stage_gram_wgmma", "raie_stage_apply_wgmma", "raie_stage_wide_gram",
                "raie_stage_wide_project", "raie_stage_wide_ffn"]
    assert counted == ([0] * 5 if route == "mma_sync" else
                       [int(name in entries) for name in by_entry])
    if route == "wgmma":
        plan, tile = run.plan, pblock.WIDE_TILE.get(c, pblock.WGMMA_TILE)
        assert plan.apply_tile == plan.gram_tile == tile
        # 4 x 1 tiles of 20 x 28 at C = 96, 5 x 1 at 192
        assert plan.fc == pblock.WGMMA_FC and run.groups == -(-20 // tile[0])
        assert run.apply_grid == pblock.wgmma_grid(1, 20, 28, 132 * 2, tile)
        assert run.part.shape[1] == run.groups
