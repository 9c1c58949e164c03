"""The Hopper kernels (A), (P) and (F) at C = 192 and 384
(``csrc/stage_sm90_wide.cu``) from the host's side, on the CPU: which
launches take them (by width, 48 channels a head; on a model shard see
tests/test_torch_gdfn_sm90.py),
the chunked operand layout their weights are packed in (every weight and tap
exactly once), and their schedules (every output pixel written exactly once,
whole-image and on row bands; kernel (P)'s r on every readable row). Pure
Python over stubs: no GPU, no compiler. And the plain stage at these widths
against the JAX Pallas stage in interpret mode."""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu.ops.pallas import stage as jstage
from rethink_acoustic_image_enhancement_tpu_torch.ops import block as pblock
from rethink_acoustic_image_enhancement_tpu_torch.ops import gdfn as pgdfn
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage

from test_torch_stage import _block_params, _rel

torch.set_num_threads(2)


@pytest.mark.parametrize("c,shard,heads,route", [
    (192, False, None, "wgmma"), (192, False, 4, "wgmma"), (192, True, 4, "wgmma"),
    (384, False, None, "wgmma"), (384, False, 8, "wgmma"), (384, True, 8, "wgmma"),
    (192, False, 2, "mma_sync"), (384, False, 4, "mma_sync"), (96, False, 2, "wgmma"),
    (48, False, 1, "mma_sync"), (128, False, None, "mma_sync")])
def test_route_by_width_and_head_width_never_on_a_shard(c, shard, heads, route):
    assert pblock.apply_route(c, shard, heads) == route


def _packed_operands(n, c, fp):
    """pack_blocks' kernel operands as distinct integers (n blocks)."""
    sizes = dict(wqkv=(c, 3 * c), dwqkv=(9, 3 * c), wproj=(c, c), win=(c, 2 * fp),
                 wdw=(9, 2 * fp), wout=(fp, c))
    out, at = {}, 0
    for k, (a, b) in sizes.items():
        out[k] = torch.arange(at, at + n * a * b).reshape(n, a, b)
        at += n * a * b
    return out


def _b_at(k, n):
    """Flat index of B element (k, n) of a K x N operand in the kernels'
    layout: plane k // 8, core matrix n // 8, row n % 8, column k % 8."""
    kk, nn = np.meshgrid(np.arange(k), np.arange(n), indexing="ij")
    return torch.from_numpy((kk // 8) * (n * 8) + (nn // 8) * 64 + (nn % 8) * 8 + kk % 8)


@pytest.mark.parametrize("c", [192, 384])
def test_chunked_operands_hold_every_weight_and_tap_exactly_once(c):
    n, fp, fc, hc = 2, 64 * -(-int(2.66 * c) // 64), pblock.WGMMA_FC, pblock.WIDE_HC
    w = _packed_operands(n, c, fp)
    p = dict(pblock.pack_wgmma(w["wqkv"], w["dwqkv"], w["wproj"]),
             **pgdfn.ffn_chunks(w["win"], w["wdw"], w["wout"], fp))
    packed = torch.cat([p[k].reshape(-1) for k in ("wqkv_wg", "qtaps_wg", "wproj_wg", "win_wg",
                                                    "wtaps_wg", "wout_wg")])
    every = torch.cat([t.reshape(-1) for t in w.values()])
    assert torch.equal(packed.sort().values, every.sort().values)  # each exactly once
    heads, order = c // hc, pblock.qkv_chunk_order(c)
    # (A): q_0, k_0, q_1, k_1, ..., then v_0, v_1, ...: head h's q and k follow each other
    assert order == [t * heads + h for h in range(heads) for t in (0, 1)] + [
        2 * heads + h for h in range(heads)]
    at = _b_at(c, hc)
    for i in range(n):
        for j, src in enumerate(order):
            cols = slice(src * hc, (src + 1) * hc)
            assert torch.equal(p["wqkv_wg"][i, j].reshape(-1)[at], w["wqkv"][i][:, cols])
            assert torch.equal(p["qtaps_wg"][i, j].reshape(9, hc), w["dwqkv"][i][:, cols])
        # (P): W_proj's rows of head h lie together, a B operand of K = 48
        wp = p["wproj_wg"][i].reshape(heads, hc * c)
        for h in range(heads):
            assert torch.equal(wp[h][_b_at(hc, c)], w["wproj"][i][h * hc:(h + 1) * hc])
        # (F): W_in's chunk as [f][half] columns, its taps, W_out's rows
        for j in range(fp // fc):
            ch = torch.arange(j * fc, (j + 1) * fc)
            cols = torch.stack([ch, fp + ch], 1).reshape(-1)
            assert torch.equal(p["win_wg"][i, j].reshape(-1)[_b_at(c, 2 * fc)], w["win"][i][:, cols])
            assert torch.equal(p["wtaps_wg"][i, j].reshape(9, 2 * fc), w["wdw"][i][:, cols])
            assert torch.equal(p["wout_wg"][i, j].reshape(-1)[_b_at(fc, c)],
                               w["wout"][i][j * fc:(j + 1) * fc])


def _check_schedule(c, batch, h, w, halo=0, y_img=0, h_img=None):
    """Kernel (F)'s tiles (and (A)'s, the same tiles in groups) write every
    own pixel exactly once, each with its 3 x 3 neighbourhood in the halo
    box; kernel (P)'s tiles give r on every readable pixel exactly once."""
    tile = pblock.WIDE_TILE[c]
    th, tw = tile
    lo, hi = pblock.readable_rows(h, halo, y_img, h_img)
    grid = pblock.wgmma_grid(batch, h, w, 132, tile)
    blocks = pblock.wgmma_tiles(batch, h, w, grid, halo, y_img, h_img, tile)
    assert len(blocks) == grid and max(map(len, blocks)) - min(map(len, blocks)) <= 1
    written = np.zeros((batch, h, w), dtype=np.int64)
    for t in (t for tiles in blocks for t in tiles):
        y0, x0 = t["y0"], t["x0"]
        assert t["rows"] == tuple(range(y0, y0 + th)) + (y0 - 1, y0 + th)
        assert t["cols"] == tuple(range(x0 - 1, x0 + tw + 1))
        ys = np.arange(y0 - 1, y0 + th + 1)[:, None]
        xs = np.arange(x0 - 1, x0 + tw + 1)[None, :]
        assert np.array_equal(t["read"], (ys >= lo) & (ys < hi) & (xs >= 0) & (xs < w))
        assert np.array_equal(t["out"], ((ys >= 0) & (ys < h) & (xs >= 0) & (xs < w))[1:-1, 1:-1])
        ii, jj = np.nonzero(t["out"])
        np.add.at(written[t["b"]], (y0 + ii, x0 + jj), 1)
    assert (written == 1).all()
    pgrid = pblock.proj_grid(batch, h, w, 132, th, halo, y_img, h_img)
    r_rows = np.zeros((batch, hi - lo, w), dtype=np.int64)
    for t in (t for tiles in pblock.proj_tiles(batch, h, w, pgrid, th, halo, y_img, h_img)
              for t in tiles):
        assert lo <= t["y0"] < hi and t["out"].shape == (th, 32)
        ii, jj = np.nonzero(t["out"])
        np.add.at(r_rows[t["b"]], (t["y0"] - lo + ii, t["x0"] + jj), 1)
    assert (r_rows == 1).all()


@pytest.mark.parametrize("c,batch,h,w", [
    (192, 1, 512, 512), (384, 1, 256, 256), (192, 1, 61, 77), (384, 1, 37, 45),
    (192, 2, 20, 28)])
def test_schedules_write_every_pixel_once(c, batch, h, w):
    _check_schedule(c, batch, h, w)


@pytest.mark.parametrize("n_bands", [2, 4])
@pytest.mark.parametrize("c,h_img,w", [(192, 512, 512), (384, 256, 256), (384, 252, 45)])
def test_schedules_on_row_bands(n_bands, c, h_img, w):
    hb = h_img // n_bands
    for j in range(n_bands):
        _check_schedule(c, 1, hb, w, 1, j * hb, h_img)


# ---- BlockRunner's launches, over stub libraries ---------------------------

class _Lib:
    """Answers as the kernels' libraries do, and records launches."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.endswith("blocks_per_sm"):
            return lambda *a: 1
        if name.endswith("smem_bytes"):
            return lambda *a: 100_000
        if name.endswith("error_string"):
            return lambda code: b"stub"
        return lambda *a: self.calls.append(name) or 0


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: SimpleNamespace(cuda_stream=0))


def _weights(n, c, cq, heads, f, seed=0):
    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return torch.randn(*shape, generator=g)

    return dict(ln1_w=t(n, c), w_qkv=t(n, 1, 1, c, 3 * cq), dw_qkv=t(n, 3, 3, 1, 3 * cq),
                temperature=t(n, heads), w_proj=t(n, 1, 1, cq, c), ln2_w=t(n, c),
                w_in=t(n, 1, 1, c, 2 * f), w_dw=t(n, 3, 3, 1, 2 * f), w_out=t(n, 1, 1, f, c))


@pytest.mark.parametrize("c,heads,band", [(192, 4, None), (384, 8, None), (384, 8, (40, 100))])
def test_runner_launches_the_wide_kernels(no_card, c, heads, band):
    stage, wide = _Lib(), _Lib()
    x = torch.zeros(1, 20 + 2 * (band is not None), 28, c)
    p = pblock.pack_blocks("cpu", **_weights(1, c, c, heads, int(2.66 * c)))
    run = pblock.BlockRunner(x, heads, p["fp"], stage, band=band, wg_library=wide)
    assert run.route == "wgmma" and run.wide and run.plan.gram_tile == pblock.WIDE_TILE[c]
    counts = [fn.launches for fn in (pblock.gram_wide, pblock.proj_wide, pblock.ffn_wide,
                                     pblock.gram_wgmma, pblock.apply_wgmma)]
    run.run(x, torch.empty_like(x), p, 0, 1e-5)
    assert wide.calls == ["raie_stage_wide_gram", "raie_stage_wide_project", "raie_stage_wide_ffn"]
    assert stage.calls == ["raie_stage_softmax"]
    assert [fn.launches - n for fn, n in zip(
        (pblock.gram_wide, pblock.proj_wide, pblock.ffn_wide, pblock.gram_wgmma,
         pblock.apply_wgmma), counts)] == [1, 1, 1, 0, 0]
    assert run.r.shape == x.shape and run.r.dtype == torch.float32
    th = pblock.WIDE_TILE[c][0]
    h = 20
    assert run.apply_grid == pblock.wgmma_grid(1, h, 28, 132, pblock.WIDE_TILE[c])
    assert run.proj_grid == pblock.proj_grid(1, h, 28, 132, th, run.halo, run.y_img, run.h_img)
    assert run.groups == -(-h // th) * 1 and run.part.shape[1] == run.groups


def test_runner_on_a_model_shard_keeps_stage_cu(no_card):
    """A shard whose heads are not 48 channels wide (2 of 96 here)."""
    stage, wide = _Lib(), _Lib()
    x = torch.zeros(1, 16, 16, 384)
    p = pblock.pack_blocks("cpu", **_weights(1, 384, 192, 2, 64), shard=True)
    run = pblock.BlockRunner(x, 2, p["fp"], stage, cq=192, wg_library=wide)
    assert run.route == "mma_sync" and not run.wide and "wqkv_wg" not in p
    run.gram(x, p, 0, 1e-5)
    assert stage.calls == ["raie_stage_gram"] and wide.calls == []


@pytest.mark.parametrize("c,heads,hw", [(192, 4, (8, 16)), (384, 8, (8, 8))])
def test_plain_stage_matches_pallas_interpret_at_the_wide_widths(c, heads, hw):
    """One block, 48 channels a head, as the teacher's encoder_level3 and
    latent have them."""
    _, params = _block_params(c, heads, 1, seed=c + heads)
    x = np.random.default_rng(c).normal(size=(1, *hw, c)).astype(np.float32)
    ref = np.asarray(jstage.fused_transformer_stage(
        jnp.asarray(x), **jstage.stack_block_params(params), interpret=True))
    got = pstage.stage_plain(torch.from_numpy(x), **pstage.stack_block_params(params)).numpy()
    # bf16 operand rounding and the TPU kernel's one-pass LN variance
    assert _rel(got, ref) <= 1e-2
