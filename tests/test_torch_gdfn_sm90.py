"""The Hopper LN+GDFN kernel and the model-shard stage on the Hopper tile
kernels (``csrc/stage_sm90_wide.cu``) from the host's side, on the CPU:
which launches take them (``ops/gdfn.py::ffn_route``, ``ops/block.py::
apply_route`` on a shard), the operand layouts of a hidden range and of a
head range (every weight and tap exactly once, in the order the kernels
read them), and the tiles at C = 96 (6 x 30 outputs on an 8 x 32 halo; (P)'s
8 x 32 pixels), each run here by a CPU emulation that reads the packed
operands as the kernel does, tile by tile, and held to ``gdfn_plain``,
``gdfn_part_plain`` and ``stage_plain_shards``. Pure Python: no GPU, no
compiler, no JAX."""

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.models.shards import shard_stage_weights
from rethink_acoustic_image_enhancement_tpu_torch.ops import block as pblock
from rethink_acoustic_image_enhancement_tpu_torch.ops import gdfn as pgdfn
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
from rethink_acoustic_image_enhancement_tpu_torch.ops.gdfn import bf16_round
from rethink_acoustic_image_enhancement_tpu_torch.ops.norm import channel_layernorm
from rethink_acoustic_image_enhancement_tpu_torch.parallel.tensor import LocalShards

torch.set_num_threads(2)
EPS = 1e-5
HC = pblock.WIDE_HC
# of max|ref|: the emulation sums in the tiles' order, the plain version in
# its own, and a few bf16 roundings of the hidden activations may flip
TOL = 2e-3


@pytest.mark.parametrize("c,route", [(96, "wgmma"), (192, "wgmma"), (384, "wgmma"),
                                     (48, "mma_sync"), (128, "mma_sync"), (64, "mma_sync")])
def test_ffn_route_by_width(c, route):
    assert pgdfn.ffn_route(c) == route


@pytest.mark.parametrize("c,heads,cq,route", [
    (96, 1, 48, "wgmma"), (96, 2, 96, "wgmma"), (192, 1, 48, "wgmma"), (192, 2, 96, "wgmma"),
    (384, 4, 192, "wgmma"), (384, 8, 384, "wgmma"), (96, 1, 96, "mma_sync"),
    (384, 2, 192, "mma_sync"), (48, 1, 48, "mma_sync"), (128, 1, 64, "mma_sync")])
def test_shard_route_by_width_and_head_width(c, heads, cq, route):
    """A shard takes the Hopper kernels at C = 96, 192 and 384 where its
    heads are 48 channels wide, whatever their number."""
    assert pblock.apply_route(c, True, heads, cq) == route


def _b_at(k, n):
    """Flat index of B element (k, n) of a K x N operand in the kernels'
    layout: plane k // 8, core matrix n // 8, row n % 8, column k % 8."""
    kk, nn = np.meshgrid(np.arange(k), np.arange(n), indexing="ij")
    return torch.from_numpy((kk // 8) * (n * 8) + (nn // 8) * 64 + (nn % 8) * 8 + kk % 8)


def _b(flat, k, n):
    """The K x N matrix of a B operand in the kernels' layout."""
    return flat.reshape(-1)[_b_at(k, n)]


def _pack(w_in, w_dw, w_out, c):
    """One block's GDFN operands for the kernel of ffn_route(c), on the CPU."""
    return pgdfn.pack_ffn_route(w_in.reshape(1, c, -1), w_dw.reshape(1, 9, -1),
                                w_out.reshape(1, -1, c), c, "cpu")


@pytest.mark.parametrize("f,fp", [(255, 256), (128, 128), (127, 128), (33, 64)])
def test_hidden_range_chunks_hold_every_weight_once(f, fp):
    """A hidden range padded to a multiple of 64, in chunks of 32: chunk j's
    W_in columns of both halves side by side ([f][half]), its taps, its rows
    of W_out, the padding zero; only the Hopper kernel's layout is packed."""
    c = 96
    w_in = torch.arange(1, c * 2 * f + 1).reshape(1, c, 2 * f).float()
    w_dw = -torch.arange(1, 9 * 2 * f + 1).reshape(1, 9, 2 * f).float()
    w_out = torch.arange(1, f * c + 1).reshape(1, f, c).float() * 1e-3
    p = _pack(w_in, w_dw, w_out, c)
    assert p["fp"] == fp and p["win_wg"].shape[1] == fp // pgdfn.SM90_FC and "win" not in p
    fc = pgdfn.SM90_FC
    for j in range(fp // fc):
        ch = torch.arange(j * fc, (j + 1) * fc)
        real = ch < f
        cols = torch.stack([ch, f + ch], 1).reshape(-1).clamp(max=2 * f - 1)
        keep = torch.stack([real, real], 1).reshape(-1)
        win = _b(p["win_wg"][0, j], c, 2 * fc).float()
        assert torch.equal(win[:, keep], bf16_round(w_in[0][:, cols[keep]]))
        assert (win[:, ~keep] == 0).all()
        taps = p["wtaps_wg"][0, j].reshape(9, 2 * fc)
        assert torch.equal(taps[:, keep], w_dw[0][:, cols[keep]])
        assert (taps[:, ~keep] == 0).all()
        wout = _b(p["wout_wg"][0, j], fc, c).float()
        assert torch.equal(wout[real], bf16_round(w_out[0][ch[real]]))
        assert (wout[~real] == 0).all()


@pytest.mark.parametrize("c,layout", [(96, "wgmma"), (192, "wgmma"), (48, "mma_sync"),
                                      (64, "mma_sync")])
def test_one_layout_is_packed_for_the_routed_kernel(c, layout):
    """pack_ffn_route keeps the layout of ffn_route's kernel alone:
    csrc/gdfn.cu's padded (C, 2Fp) / (9, 2Fp) / (Fp, C), or only the Hopper
    chunks; Fp a multiple of 64 either way."""
    f = int(2.66 * c)
    g = torch.Generator().manual_seed(c)
    p = _pack(torch.randn(c, 2 * f, generator=g), torch.randn(3, 3, 2 * f, generator=g),
              torch.randn(f, c, generator=g), c)
    assert p["fp"] % pgdfn.HIDDEN_PAD == 0 and p["fp"] - f < pgdfn.HIDDEN_PAD
    hopper = {"fp", "win_wg", "wtaps_wg", "wout_wg"}
    assert set(p) == (hopper if layout == "wgmma" else {"fp", "win", "wdw", "wout"})
    assert pgdfn.ffn_route(c) == layout


def _seeded(rng, n, c, heads, f):
    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale + shift)

    return dict(ln1_w=t(n, c, scale=0.1, shift=1.0), w_qkv=t(n, 1, 1, c, 3 * c, scale=c ** -0.5),
                dw_qkv=t(n, 3, 3, 1, 3 * c, scale=1 / 3),
                temperature=t(n, heads, 1, 1, scale=0.2, shift=1.0),
                w_proj=t(n, 1, 1, c, c, scale=c ** -0.5), ln2_w=t(n, c, scale=0.1, shift=1.0),
                w_in=t(n, 1, 1, c, 2 * f, scale=c ** -0.5),
                w_dw=t(n, 3, 3, 1, 2 * f, scale=1 / 3), w_out=t(n, 1, 1, f, c, scale=f ** -0.5))


@pytest.mark.parametrize("c,n_shards,heads", [(96, 2, 2), (192, 2, 4), (192, 4, 4),
                                              (384, 2, 8)])
def test_head_range_operands_in_the_kernels_order(c, n_shards, heads):
    """A shard's W_qkv (C, 3 cq) in head chunks (q_h, k_h side by side, then
    every v_h) with their taps, and its W_proj rows (cq, C) a head at a
    time, exactly the shard's columns and rows."""
    wts = _seeded(np.random.default_rng(c), 1, c, heads, 8)
    for j in range(n_shards):
        sw = shard_stage_weights(wts, n_shards, j)
        p = pblock.pack_blocks("cpu", **sw, shard=True)
        cq = p["cq"]
        hs = cq // HC
        assert cq == c // n_shards and "wqkv_wg" in p
        order = pblock.qkv_chunk_order(c, cq)
        assert order == [t * hs + h for h in range(hs) for t in (0, 1)] + [2 * hs + h
                                                                            for h in range(hs)]
        wq = sw["w_qkv"][0].reshape(c, 3 * cq)
        for k, src in enumerate(order):
            cols = slice(src * HC, (src + 1) * HC)
            assert torch.equal(_b(p["wqkv_wg"][0, k], c, HC).float(), bf16_round(wq[:, cols]))
            assert torch.equal(p["qtaps_wg"][0, k].reshape(9, HC),
                               sw["dw_qkv"][0].reshape(9, 3 * cq)[:, cols])
        wp = p["wproj_wg"][0].reshape(hs, HC * c)
        for h in range(hs):
            assert torch.equal(_b(wp[h], HC, c).float(),
                               bf16_round(sw["w_proj"][0].reshape(cq, c)[h * HC:(h + 1) * HC]))


# ---- the tiles at C = 96, emulated ------------------------------------------

def _gate(a):
    return bf16_round(0.5 * a[..., 0] * (1 + torch.erf(a[..., 0] * 2 ** -0.5)) * a[..., 1])


def emulate_ffn(x, lnw, lnb, apply_ln, p, i, residual, eps=EPS):
    """k_ffn_wide tile by tile over its persistent schedule: the halo's LN
    (zero where not read), per chunk of 32 hidden channels W_in from the
    packed B operand, the depthwise step on the halo from the chunk's taps,
    the gate, and W_out accumulated onto the own pixels (seeded with x with
    the residual); the own outputs written once."""
    b, h, w, c = x.shape
    th, tw = pblock.WIDE_TILE[c]
    fc = pgdfn.SM90_FC
    x32 = x.float()
    y = torch.full_like(x32, float("nan"))
    grid = pblock.wgmma_grid(b, h, w, 3, (th, tw))
    for t in (t for tiles in pblock.wgmma_tiles(b, h, w, grid, tile=(th, tw)) for t in tiles):
        y0, x0 = t["y0"], t["x0"]
        read = torch.from_numpy(t["read"])
        box = torch.zeros(th + 2, tw + 2, c)
        rr, cc = np.nonzero(t["read"])
        box[rr, cc] = x32[t["b"], y0 - 1 + rr, x0 - 1 + cc]
        a_op = channel_layernorm(box[None], lnw, lnb, eps=eps)[0] if apply_ln else box
        a_op = bf16_round(a_op) * read[..., None]
        acc = box[1:-1, 1:-1].clone() if residual else torch.zeros(th, tw, c)
        for j in range(p["fp"] // fc):
            t2 = bf16_round(a_op @ _b(p["win_wg"][i, j], c, 2 * fc).float())
            t2 = t2.reshape(th + 2, tw + 2, fc, 2)
            taps = p["wtaps_wg"][i, j].reshape(9, fc, 2)
            dw = sum(t2[di:di + th, dj:dj + tw] * taps[di * 3 + dj]
                     for di in range(3) for dj in range(3))
            acc = acc + _gate(dw) @ _b(p["wout_wg"][i, j], fc, c).float()
        oi, oj = np.nonzero(t["out"])
        assert torch.isnan(y[t["b"], y0 + oi, x0 + oj]).all(), "an output written twice"
        y[t["b"], y0 + oi, x0 + oj] = acc[oi, oj]
    assert not torch.isnan(y).any(), "an output not written"
    return y


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("batch,h,w,norm", [(2, 13, 40, "bias_free"), (1, 8, 31, "with_bias"),
                                            (1, 7, 30, "none")])
def test_ffn_tiles_at_96_match_gdfn_plain(batch, h, w, norm):
    c, f = 96, 255
    rng = np.random.default_rng(h + w)
    wts = _seeded(rng, 1, c, 2, f)
    lnb = torch.from_numpy(rng.normal(size=c).astype(np.float32) * 0.5)
    x = torch.from_numpy(rng.normal(size=(batch, h, w, c)).astype(np.float32))
    p = _pack(wts["w_in"][0], wts["w_dw"][0], wts["w_out"][0], c)
    apply_ln, bias_free = norm != "none", norm == "bias_free"
    got = emulate_ffn(x, wts["ln2_w"][0], None if bias_free else lnb, apply_ln, p, 0, True)
    ref = pgdfn.gdfn_plain(x, wts["ln2_w"][0], lnb, wts["w_in"][0], wts["w_dw"][0],
                           wts["w_out"][0], bias_free=bias_free, apply_ln=apply_ln)
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("shard", [0, 1])
def test_ffn_tiles_at_96_on_a_hidden_range_match_the_part(shard):
    """128 and 127 of 255 hidden channels, the residual on shard 0 only."""
    c, f = 96, 255
    rng = np.random.default_rng(5)
    sw = shard_stage_weights(_seeded(rng, 1, c, 2, f), 2, shard)
    args = (sw["ln2_w"][0], sw["w_in"][0], sw["w_dw"][0], sw["w_out"][0])
    assert args[3].shape[-2] == (128, 127)[shard]
    r = torch.from_numpy(rng.normal(size=(1, 9, 33, c)).astype(np.float32))
    p = _pack(*args[1:], c)
    assert p["fp"] == 128
    got = emulate_ffn(r, args[0], None, True, p, 0, shard == 0)
    ref = pgdfn.gdfn_part_plain(r, *args, residual=shard == 0)
    assert _rel(got, ref) <= TOL


def emulate_gram(x, p, i, heads, c, eps=EPS):
    """k_gram_wide on a shard's heads, tile by tile: per packed chunk c (in
    the kernel's reading: q_h at 2h, k_h at 2h + 1, then v_h) the chunk's
    product on the halo and its depthwise step; each head's Gram (bf16 q, k)
    and the squared norms (fp32) summed over the tiles' own pixels, v
    written there. Returns (Gram (heads, 48, 48), q norms, k norms, v)."""
    b, h, w, _ = x.shape
    th, tw = pblock.WIDE_TILE[c]
    cq = heads * HC
    gram = torch.zeros(heads, HC, HC)
    norms = torch.zeros(2, cq)
    v = torch.full((b, h, w, cq), float("nan"))
    x32 = x.float()
    for t in (t for tiles in pblock.wgmma_tiles(b, h, w, 1, tile=(th, tw)) for t in tiles):
        y0, x0 = t["y0"], t["x0"]
        rr, cc = np.nonzero(t["read"])
        box = torch.zeros(th + 2, tw + 2, c)
        box[rr, cc] = x32[t["b"], y0 - 1 + rr, x0 - 1 + cc]
        ln = bf16_round(channel_layernorm(box[None], p["ln1"][i], None, eps=eps)[0])
        ln = ln * torch.from_numpy(t["read"])[..., None]
        out = torch.from_numpy(t["out"])[..., None]
        qk = {}
        for k in range(3 * heads):
            tt = bf16_round(ln @ _b(p["wqkv_wg"][i, k], c, HC).float())
            taps = p["qtaps_wg"][i, k].reshape(9, HC)
            a = sum(tt[di:di + th, dj:dj + tw] * taps[di * 3 + dj]
                    for di in range(3) for dj in range(3)) * out
            if k < 2 * heads:
                qk[k] = a
                norms[k & 1, (k >> 1) * HC:(k >> 1) * HC + HC] += a.square().sum((0, 1))
            else:
                oi, oj = np.nonzero(t["out"])
                hh = k - 2 * heads
                v[t["b"], y0 + oi, x0 + oj, hh * HC:(hh + 1) * HC] = bf16_round(a[oi, oj])
        for hh in range(heads):
            q, kk = bf16_round(qk[2 * hh]).reshape(-1, HC), bf16_round(qk[2 * hh + 1]).reshape(-1, HC)
            gram[hh] += q.T @ kk
    assert not torch.isnan(v).any()
    return gram, norms[0], norms[1], v


def emulate_proj(x, v, attn, p, i, heads, c, residual):
    """k_proj_wide on a shard's heads over its 8 x 32 tiles: o_h =
    bf16(v_h attn_h^T), r = [x +] sum_h o_h W_proj[48 h..], W_proj's rows
    from the packed operand; every pixel's r written once."""
    b, h, w, _ = x.shape
    th = pblock.PROJ_TH[c]
    r = torch.full((b, h, w, c), float("nan"))
    wp = p["wproj_wg"][i].reshape(heads, HC * c)
    for t in (t for tiles in pblock.proj_tiles(b, h, w, 2, th) for t in tiles):
        oi, oj = np.nonzero(t["out"])
        ys, xs = t["y0"] + oi, t["x0"] + oj
        acc = x[t["b"], ys, xs].float() if residual else torch.zeros(len(oi), c)
        for hh in range(heads):
            o = bf16_round(v[t["b"], ys, xs, hh * HC:(hh + 1) * HC] @ bf16_round(attn[hh]).T)
            acc = acc + o @ _b(wp[hh], HC, c).float()
        assert torch.isnan(r[t["b"], ys, xs]).all()
        r[t["b"], ys, xs] = acc
    assert not torch.isnan(r).any()
    return r


def _softmax(gram, qn, kn, temp):
    """Kernel (B)'s attn (per head, query channel by key channel)."""
    q = qn.reshape(-1, HC).sqrt().clamp_min(1e-12)
    k = kn.reshape(-1, HC).sqrt().clamp_min(1e-12)
    return torch.softmax(gram / q[..., :, None] / k[..., None, :] * temp.reshape(-1, 1, 1), -1)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_stage_tiles_at_96_match_stage_plain_shards(n_shards):
    """One block at C = 96 with 2 heads on 2 shards (a head each:
    k_gram_wide's chunks) and on 4 (every head on each, the whole MDTA; its
    (A) is k_gram_wgmma, emulated here as head chunks too), (P) on the
    heads, the partials summed in shard order, then each shard's GDFN part
    on its hidden range and a second sum: held to stage_plain_shards."""
    c, heads, f = 96, 2, 255
    rng = np.random.default_rng(n_shards)
    wts = _seeded(rng, 1, c, heads, f)
    x = torch.from_numpy(rng.normal(size=(1, 9, 33, c)).astype(np.float32))
    shards = LocalShards(["cpu"] * n_shards)
    sw = [shard_stage_weights(wts, n_shards, j) for j in range(n_shards)]
    split = heads % n_shards == 0
    rs, packs = [], []
    for j, w in enumerate(sw):
        p = pblock.pack_blocks("cpu", **w, shard=True)
        if not split:  # the whole MDTA, packed as it lies (q_0, q_1, k_0, k_1, v_0, v_1)
            assert pblock.qkv_chunk_order(c, p["cq"]) == list(range(6))
            order = [0, 2, 1, 3, 4, 5]  # in head chunks for the emulation
            p["wqkv_wg"], p["qtaps_wg"] = p["wqkv_wg"][:, order], p["qtaps_wg"][:, order]
        hs = p["cq"] // HC
        gram, qn, kn, v = emulate_gram(x, p, 0, hs, c)
        attn = _softmax(gram, qn, kn, p["temp"][0])
        rs.append(emulate_proj(x, v, attn, p, 0, hs, c, j == 0 or not split))
        packs.append(p)
    if split:
        rs = shards.sum_across(rs)
    ys = shards.sum_across([emulate_ffn(r, p["ln2"][0], None, True, p, 0, j == 0)
                            for j, (r, p) in enumerate(zip(rs, packs))])
    ref = pstage.stage_plain_shards([x] * n_shards, sw, shards)
    for y in ys:
        assert torch.equal(y, ys[0])
    assert _rel(ys[0], ref[0]) <= TOL


@pytest.mark.parametrize("batch,h,w", [(1, 512, 512), (2, 61, 77), (1, 7, 30)])
def test_proj_tiles_at_96_cover_every_pixel_once(batch, h, w):
    th = pblock.PROJ_TH[96]
    grid = pblock.proj_grid(batch, h, w, 132, th)
    seen = np.zeros((batch, h, w), dtype=np.int64)
    for t in (t for tiles in pblock.proj_tiles(batch, h, w, grid, th) for t in tiles):
        assert t["out"].shape == (th, 32)
        oi, oj = np.nonzero(t["out"])
        np.add.at(seen[t["b"]], (t["y0"] + oi, t["x0"] + oj), 1)
    assert (seen == 1).all()
