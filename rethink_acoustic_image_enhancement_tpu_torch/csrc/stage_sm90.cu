// Kernels (A) and (C) of the Transformer block at C = 96, redesigned for
// Hopper (sm_90a) with warpgroup matrix products (wgmma), TMA copies under
// mbarriers and, for (C), a persistent grid. One Restormer TransformerBlock,
// y = r + GDFN(LN2(r)), r = x + W_p MDTA(LN1(x)), is three launches as in
// stage.cu: (A) k_gram_wgmma (q, k, v; v to device memory, the per-head Gram
// and squared norms as partials over groups of tiles), stage.cu's (B)
// k_softmax (attn^T), and (C) k_apply_wgmma (attention apply, projection,
// LN2, GDFN and both residuals). The host takes these two at C = 96 and
// nowhere else (ops/block.py::apply_route): C = 192 and 384 take
// stage_sm90_wide.cu's, every other width, and every launch on a model
// shard, stage.cu's mma.sync kernels.
//
// Replaces, at C = 96 (the width of every stage of a 512^2 teacher request
// that runs through the kernels: encoder_level2, decoder_level2,
// decoder_level1, refinement, refinement_out):
// rethink_acoustic_image_enhancement_tpu/ops/pallas/stage.py
// ::fused_transformer_stage (its pallas_call at stage.py:324) and
// ops/pallas/block.py::fused_transformer_block (block.py:338).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s). Per pixel, (A)
// does the qkv product (2 C 3C), its depthwise 3x3 (2 9 3C) and the Gram
// (2 C hc), ~65 kFLOP; (C) attn @ v (2 C hc), W_proj (2 C C), W_in (2 C 2F),
// W_out (2 F C) and the GDFN depthwise 3x3 (2 9 2F), ~185 kFLOP (F = 255, one
// head). At 512x512 that is 17 and 48.5 GFLOP, 17 and 49 us, against 101 MB
// of x, v and y in bf16 (30 us): bound by the tensor-core rate.
//
// What held stage.cu's kernels back (PERF.md, phase clocks): an 8x8 tile on
// a 10x10 halo padded to 112 rows did 1.75x the needed products (1.5x at
// (A)'s 8x16); every product was a chain of ldmatrix -> mma.sync bound by
// latency (6.7 cycles a mma where an SM issues one every ~1.5); every phase
// ended in a barrier, so the depthwise steps (0.39 of (C)'s tile, 0.46 of
// (A)'s) never overlapped a product; 15.5 waves of tiles on 264 slots.
// This design:
//   - Tile: 6 x 30 outputs on an 8 x 32 halo, 256 halo pixels = four m64
//     operands, none padded (1.42x recompute). Warpgroup w < 3 owns halo rows
//     1 + 2w and 2 + 2w (64 pixels: the tile's own rows and the two halo
//     columns beside them), warpgroup 3 the halo rows above and below (the
//     ring). In (C) the own rows' accumulator of r is also the output's: r is
//     never stored, the W_out products accumulate onto it, and the store
//     keeps columns 1..30 inside the band.
//   - Products: wgmma m64nNk16, bf16 in, fp32 accumulate, B (weights,
//     attn^T) from shared memory; A from shared memory (LN1(x), v, LN2(r),
//     the gated hidden chunk) or from registers (bf16(attn @ v) straight from
//     its accumulator into W_proj). The Gram q^T k stays mma.sync (a head's
//     48 channels do not fill a 64-row operand), its fragments in registers
//     over the group's tiles.
//   - Overlap: in (A) the product of q, k or v's next 48-channel chunk runs
//     while the CUDA cores do this chunk's depthwise step and norms; in (C)
//     W_out of hidden chunk j - 1 runs while they do chunk j's depthwise step
//     and GELU gate; wgmma.wait_group before the chunk's barrier. (C)'s W_in
//     of chunk j + 1 is not overlapped: its 32 accumulator registers beside
//     r's 48 and the depthwise step's would spill at 128 registers a thread.
//   - Copies: v's halo box by TMA (12 planes of 8 channels as boxes of the
//     tensor's natural 5-D view (8, C/8, W, rows, B), which land in the
//     operand layout of hopper.cuh; the ring's two rows as one box with a row
//     stride of 7), the tensor map cut to the band's readable rows so that
//     its zero fill is the zero ring at the image's (and not a band's)
//     edges; the weights, taps and LayerNorm weights by bulk copies,
//     pre-packed on the host in the operand layout (ops/block.py::
//     pack_wgmma), weight chunks through two slots; all under mbarriers. x
//     goes straight into registers (an fp32 x halo would not fit beside the
//     tile), the next tile's rows prefetched into L2 a tile ahead. In (C)
//     the next tile's v loads while this tile's GDFN runs.
//   - Grids: (C) one persistent block of 512 threads (four warpgroups) per
//     SM walks tiles blockIdx.x, + gridDim.x, ...; (A) one block per SM too,
//     each a group of one sample's tiles (groups x B blocks, one wave), whose
//     partials it writes once.
//   - No warp specialisation: the depthwise steps want every CUDA core, the
//     products are issued asynchronously by the warpgroups that own their
//     rows, and one thread issues every copy.
//
// Shared memory at C = 96 (bytes):
//   (C)  v / LN2(r), own rows and ring  12 planes x 256 rows x 16    49,152
//        attn^T (block-diagonal over heads), W_proj, 96 x 96 each    36,864
//        W_in + taps chunks, 2 slots x (12,288 + 2,304)              29,184
//        W_out chunks, 2 slots x 6,144                               12,288
//        t2 = bf16(W_in) on the halo, 256 x (64 + 8) x 2             36,864
//        gg = gated chunk on the own rows, 2 x 4 planes x 3,088 (+)  24,832
//        LN2 weight and bias, mbarriers                                 832
//        total 190,016: one block an SM (fc = 64 would need ~290 KB)
//   (A)  LN1(x), own rows and ring                                   49,152
//        W_qkv + taps chunks (48 columns), 2 slots x 11,008          22,016
//        t = bf16(qkv chunk) on the halo, 256 x (48 + 8) x 2         28,672
//        q | k on the own rows, 192 x (192 + 8) x 2                  76,800
//        norm partials 192 x 10 x 4, LN1 weight and bias, mbarriers   8,480
//        total 185,120: one block an SM
//
// Numerics are stage.cu's: the products bf16 x bf16 -> fp32; qkv, attn @ v
// and W_in rounded to bf16 before their next use; depthwise taps in fp32;
// the two-pass LayerNorm variance; the Abramowitz-Stegun erf; LN1 and LN2
// zero outside the image; q/k norms from the fp32 depthwise outputs; y in
// fp32 or bf16 (a stage hands blocks over in fp32). Sums run in another
// order than stage.cu's kernels, so the bits differ from theirs; a launch
// gives the same bits every time (no atomics).

#include "tile_ops.cuh"
#include "hopper.cuh"

namespace {

constexpr int WC = 96;                 // the width these kernels take
constexpr int WTH = 6, WTW = 30;       // output tile
constexpr int WHW = WTW + 2;           // 32 halo columns
constexpr int WNT = 512;               // four warpgroups
constexpr int WFC = 32;                // hidden channels a chunk
constexpr int NCG = WC / 8;            // planes of 8 channels
constexpr int OWN_ROWS = WTH * WHW;    // 192: three m64 operands
constexpr int RING_ROWS = 2 * WHW;     // 64: one
constexpr int OWN_PLANE = OWN_ROWS * 16;
constexpr int RING_PLANE = RING_ROWS * 16;
constexpr int B96 = WC * WC * 2;            // a 96 x 96 B operand
constexpr int B96_LBO = (WC / 8) * 128;     // its k-planes
constexpr int WIN_B = WC * 2 * WFC * 2;     // W_in chunk (N = 2 fc as [f][half], K = C)
constexpr int WIN_LBO = (2 * WFC / 8) * 128;
constexpr int TAPS_B = 18 * WFC * 4;        // its taps, [tap][f][half]
constexpr int WIN_SLOT = WIN_B + TAPS_B;
constexpr int WOUT_B = WFC * WC * 2;        // W_out chunk (N = C, K = fc)
constexpr int LT2 = 2 * WFC + 8;            // t2's row (bf16), padded
constexpr int GG_PLANE = OWN_ROWS * 16 + 16;  // padded: the 4 planes in other banks
constexpr int GG_B = 12416;                 // 4 planes, 128-byte aligned

enum : int {
  S_VOWN = 0,
  S_VRING = S_VOWN + NCG * OWN_PLANE,
  S_ATTN = S_VRING + NCG * RING_PLANE,
  S_WPROJ = S_ATTN + B96,
  S_WIN = S_WPROJ + B96,
  S_WOUT = S_WIN + 2 * WIN_SLOT,
  S_T2 = S_WOUT + 2 * WOUT_B,
  S_GG = S_T2 + 8 * WHW * LT2 * 2,
  S_LNW = S_GG + 2 * GG_B,
  S_LNB = S_LNW + WC * 4,
  S_BARS = S_LNB + WC * 4,
  S_TOTAL = S_BARS + 8 * 8,
};
static_assert(S_TOTAL <= SMEM_LIMIT, "kernel (C)'s tile must fit one SM");
static_assert(S_WIN % 128 == 0 && S_WOUT % 128 == 0 && S_T2 % 128 == 0 && S_GG % 128 == 0,
              "copy targets 128-byte aligned");

// Phases of the instrumented build (ops/phase_clocks.py APPLY_WG_PHASES).
enum { PW_WAIT, PW_ATTN, PW_LN2, PW_W_IN, PW_DW, PW_STORE };
#ifdef RAIE_PHASE_CLOCKS
__device__ long long* phase_buf_apply_wg = nullptr;
#define PHASE_BUF_WG phase_buf_apply_wg
#else
#define PHASE_BUF_WG nullptr
#endif

__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// LayerNorm over the 96 channels of the two rows a thread holds in an m64n96
// accumulator layout (v[4j], v[4j+1]: row r0; v[4j+2], v[4j+3]: row r0 + 8;
// columns 8j + q2, + 1), two-pass over the quad that shares the rows,
// written as bf16 into the operand rows r0 and r0 + 8 of `blk` (planes of 8
// channels `plane` bytes apart); zero where the pixel is not readable (rd0,
// rd1), where torch zero-pads the depthwise input. BiasFree where lnb is
// null: v / sqrt(var + eps) * w.
__device__ __forceinline__ void layernorm_rows(const float (&v)[48], bool rd0, bool rd1,
                                               const float* lnw, const float* lnb, float eps,
                                               unsigned char* blk, int plane, int r0, int q2) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < 12; ++j) s0 += v[4 * j] + v[4 * j + 1], s1 += v[4 * j + 2] + v[4 * j + 3];
  s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
  const float mean0 = s0 / WC, mean1 = s1 / WC;
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const float e0 = v[4 * j] - mean0, e1 = v[4 * j + 1] - mean0;
    const float e2 = v[4 * j + 2] - mean1, e3 = v[4 * j + 3] - mean1;
    d0 += e0 * e0 + e1 * e1;
    d1 += e2 * e2 + e3 * e3;
  }
  d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
  d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
  const float inv0 = rsqrtf(d0 / WC + eps), inv1 = rsqrtf(d1 / WC + eps);
  const bool bias = lnb != nullptr;
  const float m0 = bias ? mean0 : 0.f, m1 = bias ? mean1 : 0.f;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const float2 w = *reinterpret_cast<const float2*>(lnw + 8 * j + q2);
    const float2 bb = bias ? *reinterpret_cast<const float2*>(lnb + 8 * j + q2)
                           : make_float2(0.f, 0.f);
    const float2 lo = rd0 ? make_float2((v[4 * j] - m0) * inv0 * w.x + bb.x,
                                        (v[4 * j + 1] - m0) * inv0 * w.y + bb.y)
                          : make_float2(0.f, 0.f);
    const float2 hi = rd1 ? make_float2((v[4 * j + 2] - m1) * inv1 * w.x + bb.x,
                                        (v[4 * j + 3] - m1) * inv1 * w.y + bb.y)
                          : make_float2(0.f, 0.f);
    st2((bf16*)(blk + j * plane + r0 * 16) + q2, lo);
    st2((bf16*)(blk + j * plane + (r0 + 8) * 16) + q2, hi);
  }
}

// Threads 0..7 of the block: the readable part of each of the 8 halo rows
// of x around the tile at (y0, x0) of sample b into L2, so that the tile's
// loads of x (straight into registers) find it there.
template <class Tin>
__device__ __forceinline__ void prefetch_x(const Tin* x, const Geo& g, int b, int y0, int x0) {
  const int row = threadIdx.x, yy = y0 - 1 + row;
  if (row >= WTH + 2 || !readable(g, yy, 0)) return;
  const int xa = x0 - 1 < 0 ? 0 : x0 - 1, xb = x0 + WTW + 1 > g.W ? g.W : x0 + WTW + 1;
  if (xb > xa) prefetch_l2(x + pix(g, b, yy, xa), (uint32_t)((xb - xa) * WC * sizeof(Tin)));
}

// One persistent block of WNT threads per SM walks the tiles of every sample
// (tile t = blockIdx.x + k gridDim.x, sample t / ntiles); see the note above.
template <class Tin, class Tout>
__global__ void __launch_bounds__(WNT, 1)
k_apply_wgmma(const Tin* __restrict__ x, Tout* __restrict__ y,
              const __grid_constant__ CUtensorMap vown_map,
              const __grid_constant__ CUtensorMap vring_map, const bf16* __restrict__ attn_t,
              int gheads, const bf16* __restrict__ wproj_p, const float* __restrict__ ln2,
              const float* __restrict__ ln2b, const bf16* __restrict__ win_p,
              const float* __restrict__ wtaps_p, const bf16* __restrict__ wout_p, Geo g,
              int rows_lo, float eps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* t2 = (bf16*)(smem + S_T2);
  const float* lnw = (const float*)(smem + S_LNW);
  const float* lnb = (const float*)(smem + S_LNB);
  uint64_t* bars = (uint64_t*)(smem + S_BARS);
  uint64_t* vbar = bars;         // v's halo box, once a tile
  uint64_t* cbar = bars + 1;     // W_proj and LN2's weights, once
  uint64_t* winbar = bars + 2;   // [2] W_in + taps slots
  uint64_t* woutbar = bars + 4;  // [2] W_out slots

  const int tid = threadIdx.x, wg = tid >> 7, wi = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, q2 = (lane & 3) * 2;
  const bool ring = wg == 3;
  const int nch = g.Fp / WFC, total = g.B * g.ntiles;
  const int first = blockIdx.x, step = gridDim.x;
  const int my_tiles = first < total ? (total - first + step - 1) / step : 0;
  const int my_chunks = my_tiles * nch;
  const bool with_bias = ln2b != nullptr;
  PHASE_CLOCK(pc);

  auto origin = [&](int t, int& b, int& y0, int& x0) {
    const int tt = t % g.ntiles;
    b = t / g.ntiles;
    y0 = (tt / g.ntj) * WTH;
    x0 = (tt % g.ntj) * WTW;
  };
  // thread 0: v's halo box of tile t, own rows y0..y0+5 and the ring rows
  // y0-1, y0+6, a box per plane of 8 channels
  auto issue_v = [&](int t) {
    int b, y0, x0;
    origin(t, b, y0, x0);
    mbar_expect_tx(vbar, NCG * (OWN_PLANE + RING_PLANE));
    for (int c = 0; c < NCG; ++c) {
      tma_load_5d(smem + S_VOWN + c * OWN_PLANE, &vown_map, vbar, 0, c, x0 - 1, y0 - rows_lo, b);
      tma_load_5d(smem + S_VRING + c * RING_PLANE, &vring_map, vbar, 0, c, x0 - 1,
                  y0 - 1 - rows_lo, b);
    }
  };
  // thread 0: hidden chunk gc (of this block's sequence, gc % nch of the
  // block's weights) into its slot
  auto issue_win = [&](int gc) {
    const int s = gc & 1;
    mbar_expect_tx(winbar + s, WIN_SLOT);
    bulk_load(smem + S_WIN + s * WIN_SLOT, win_p + (size_t)(gc % nch) * (WIN_B / 2), WIN_B,
              winbar + s);
    bulk_load(smem + S_WIN + s * WIN_SLOT + WIN_B, wtaps_p + (size_t)(gc % nch) * (TAPS_B / 4),
              TAPS_B, winbar + s);
  };
  auto issue_wout = [&](int gc) {
    const int s = gc & 1;
    mbar_expect_tx(woutbar + s, WOUT_B);
    bulk_load(smem + S_WOUT + s * WOUT_B, wout_p + (size_t)(gc % nch) * (WOUT_B / 2), WOUT_B,
              woutbar + s);
  };

  if (tid == 0) {
    for (int i = 0; i < 6; ++i) mbar_init(bars + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && my_tiles > 0) {
    mbar_expect_tx(cbar, B96 + WC * 4 * (with_bias ? 2 : 1));
    bulk_load(smem + S_WPROJ, wproj_p, B96, cbar);
    bulk_load(smem + S_LNW, ln2, WC * 4, cbar);
    if (with_bias) bulk_load(smem + S_LNB, ln2b, WC * 4, cbar);
    issue_v(first);
    for (int gc = 0; gc < 2 && gc < my_chunks; ++gc) {
      issue_win(gc);
      issue_wout(gc);
    }
  }

  // this warpgroup's 64 halo rows: v and then LN2(r) in the operand layout
  unsigned char* vblk = ring ? smem + S_VRING : smem + S_VOWN + wg * 1024;
  const int plane = ring ? RING_PLANE : OWN_PLANE;
  // this thread's two accumulator rows and their halo pixels (hy, hx): the
  // rows r0 and r0 + 8 lie in the same halo row
  const int r0 = 16 * wi + gq;
  const int hy = ring ? (r0 < 32 ? 0 : WTH + 1) : 1 + 2 * wg + r0 / 32;
  const int hx0 = r0 % 32, hx1 = hx0 + 8;
  bf16* t2_0 = t2 + (hy * WHW + hx0) * LT2 + q2;
  bf16* t2_1 = t2 + (hy * WHW + hx1) * LT2 + q2;

  float r[48];  // r = x + bf16(attn @ v) @ W_proj; for own rows then y
  int prev_b = -1;
  for (int it = 0; it < my_tiles; ++it) {
    int b, y0, x0;
    origin(first + it * step, b, y0, x0);
    if (b != prev_b) {
      // attn^T of sample b as the B operand of attn @ v: B[k = d][n = c] =
      // attn[c][d] where c and d lie in one of the Gram's heads, else 0
      __syncthreads();  // every warpgroup is past the last sample's attn @ v
      const int hcg = WC / gheads;
      const bf16* at = attn_t + (size_t)b * WC * hcg;
      bf16* as = (bf16*)(smem + S_ATTN);
      for (int i = tid; i < WC * WC; i += WNT) {
        const int k = i / WC, n = i % WC, h = k / hcg;
        const bf16 v = h == n / hcg ? at[(h * hcg + k % hcg) * hcg + n % hcg] : __float2bfloat16(0.f);
        as[(k / 8) * (B96_LBO / 2) + (n / 8) * 64 + (n % 8) * 8 + k % 8] = v;
      }
      fence_proxy_async();
      __syncthreads();
      prev_b = b;
    }
    if (it + 1 < my_tiles) {
      int nb, ny0, nx0;
      origin(first + (it + 1) * step, nb, ny0, nx0);
      prefetch_x(x, g, nb, ny0, nx0);
    }
    const int yy = y0 - 1 + hy, xx0 = x0 - 1 + hx0, xx1 = x0 - 1 + hx1;
    const bool rd0 = readable(g, yy, xx0), rd1 = readable(g, yy, xx1);
    mbar_wait(vbar, it & 1);
    pc.mark(PW_WAIT);

    // o = v @ attn^T (block-diagonal over the heads), then r = x + bf16(o) @
    // W_proj, x read into the accumulator before o's product is issued (its
    // loads land while the product runs)
    {
      load_rows(r, x + pix(g, b, rd0 ? yy : 0, rd0 ? xx0 : 0) + q2,
                x + pix(g, b, rd1 ? yy : 0, rd1 ? xx1 : 0) + q2, rd0, rd1);
      float o[48];
      wg_fence();
#pragma unroll
      for (int s = 0; s < WC / 16; ++s)
        wgmma_ss_n96(o, wg_desc(vblk + 2 * s * plane, plane, 128),
                     wg_desc(smem + S_ATTN + 2 * s * B96_LBO, B96_LBO, 128), s > 0);
      wg_commit();
      wg_wait<0>();
      reg_fence(o);
      if (it == 0) mbar_wait(cbar, 0);
      unsigned af[6][4];
#pragma unroll
      for (int s = 0; s < 6; ++s) {
        af[s][0] = pack_bf16(o[8 * s], o[8 * s + 1]);
        af[s][1] = pack_bf16(o[8 * s + 2], o[8 * s + 3]);
        af[s][2] = pack_bf16(o[8 * s + 4], o[8 * s + 5]);
        af[s][3] = pack_bf16(o[8 * s + 6], o[8 * s + 7]);
      }
      wg_fence();
#pragma unroll
      for (int s = 0; s < 6; ++s)
        wgmma_rs_n96(r, af[s], wg_desc(smem + S_WPROJ + 2 * s * B96_LBO, B96_LBO, 128), 1);
      wg_commit();
      wg_wait<0>();
      reg_fence(r);
    }
    pc.mark(PW_ATTN);

    // LN2(r) as bf16 over v's rows of this warpgroup (only its own products
    // read them)
    layernorm_rows(r, rd0, rd1, lnw, with_bias ? lnb : nullptr, eps, vblk, plane, r0, q2);
    fence_proxy_async();
    wg_bar(wg);  // the warpgroup's LN2 rows are written
    pc.mark(PW_LN2);

    // t2 = bf16(LN2(r) @ W_in[:, chunk gc]) on this warpgroup's halo rows, the
    // two halves of each hidden channel side by side
    auto w_in = [&](int gc) {
      const int s = gc & 1;
      mbar_wait(winbar + s, (gc >> 1) & 1);
      const unsigned char* wb = smem + S_WIN + s * WIN_SLOT;
      float tacc[32];
      wg_fence();
#pragma unroll
      for (int k = 0; k < WC / 16; ++k)
        wgmma_ss_n64(tacc, wg_desc(vblk + 2 * k * plane, plane, 128),
                     wg_desc(wb + 2 * k * WIN_LBO, WIN_LBO, 128), k > 0);
      wg_commit();
      wg_wait<0>();
      reg_fence(tacc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        st2(t2_0 + 8 * j, make_float2(tacc[4 * j], tacc[4 * j + 1]));
        st2(t2_1 + 8 * j, make_float2(tacc[4 * j + 2], tacc[4 * j + 3]));
      }
    };
    // r += gg @ W_out[chunk gc, :], issued and left running (own rows only)
    auto w_out = [&](int gc) {
      const int s = gc & 1;
      mbar_wait(woutbar + s, (gc >> 1) & 1);
      const unsigned char* ga = smem + S_GG + (gc & 1) * GG_B + wg * 1024;
      const unsigned char* wb = smem + S_WOUT + s * WOUT_B;
      wg_fence();
#pragma unroll
      for (int k = 0; k < WFC / 16; ++k)
        wgmma_ss_n96(r, wg_desc(ga + 2 * k * GG_PLANE, GG_PLANE, 128),
                     wg_desc(wb + 2 * k * B96_LBO, B96_LBO, 128), 1);
      wg_commit();
    };
    // depthwise 3x3 (fp32 taps) and GELU gate of chunk gc on the tile: a
    // thread takes one hidden channel and two adjacent output columns down
    // the tile's rows, its 9 taps and three halo rows by four columns in
    // registers, each a float2 of the GELU half (.x) and the gate half (.y),
    // which t2 and the taps hold side by side; gg goes to the W_out operand's
    // layout, own row (i, column + 1)
    auto dw_gate = [&](int gc) {
      const float2* taps = (const float2*)(smem + S_WIN + (gc & 1) * WIN_SLOT + WIN_B);
      bf16* gg = (bf16*)(smem + S_GG + (gc & 1) * GG_B);
      for (int idx = tid; idx < WFC * (WTW / 2); idx += WNT) {
        const int f = idx % WFC, j = idx / WFC * 2;
        bf16* gf = gg + (f / 8) * (GG_PLANE / 2) + f % 8;
        const bf16* tf = t2 + j * LT2 + 2 * f;
        float2 wk[9], u[3][4];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) wk[tap] = taps[tap * WFC + f];
#pragma unroll
        for (int row = 0; row < 2; ++row)
#pragma unroll
          for (int c = 0; c < 4; ++c) u[row][c] = ld2(tf + (row * WHW + c) * LT2);
#pragma unroll
        for (int i0 = 0; i0 < WTH; i0 += 3) {
#pragma unroll
          for (int sl = 0; sl < 3; ++sl) {
            const int i = i0 + sl;  // output row; halo row i + di lies in slot (sl + di) % 3
#pragma unroll
            for (int c = 0; c < 4; ++c) u[(sl + 2) % 3][c] = ld2(tf + ((i + 2) * WHW + c) * LT2);
            float2 a[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
#pragma unroll
            for (int dj = 0; dj < 3; ++dj)
#pragma unroll
              for (int di = 0; di < 3; ++di)
#pragma unroll
                for (int o = 0; o < 2; ++o) fma2(a[o], u[(sl + di) % 3][o + dj], wk[di * 3 + dj]);
#pragma unroll
            for (int o = 0; o < 2; ++o)
              gf[(i * WHW + j + o + 1) * 8] = __float2bfloat16(gelu(a[o].x) * a[o].y);
          }
        }
      }
    };

    const int gc0 = it * nch;
    w_in(gc0);
    __syncthreads();  // t2 of chunk 0 is complete
    pc.mark(PW_W_IN);
    if (nch == 1 && tid == 0 && it + 1 < my_tiles) {
      fence_proxy_async();
      issue_v(first + (it + 1) * step);  // every warpgroup is past its last W_in
    }
    for (int j = 0; j < nch; ++j) {
      const int gc = gc0 + j;
      if (!ring && j > 0) w_out(gc - 1);
      dw_gate(gc);
      __syncwarp();
      wg_wait<0>();
      reg_fence(r);
      fence_proxy_async();
      // gg of chunk gc is complete and t2 free; W_out of chunk gc - 1 is done,
      // and W_in of chunk gc long since: their slots take the chunks after
      __syncthreads();
      pc.mark(PW_DW);
      if (tid == 0) {
        if (gc + 2 < my_chunks) issue_win(gc + 2);
        if (gc >= 1 && gc + 1 < my_chunks) issue_wout(gc + 1);
      }
      if (j + 1 < nch) {
        w_in(gc + 1);
        __syncthreads();  // t2 of chunk gc + 1 is complete
        pc.mark(PW_W_IN);
        if (j + 2 == nch && tid == 0 && it + 1 < my_tiles) {
          fence_proxy_async();
          issue_v(first + (it + 1) * step);  // every warpgroup is past its last W_in
        }
      }
    }
    if (!ring) {
      w_out(gc0 + nch - 1);
      wg_wait<0>();
      reg_fence(r);
      // y on the tile's own pixels: halo columns 1..30, inside the band
      const int xo0 = xx0, xo1 = xx1;
      const bool out0 = hx0 >= 1 && hx0 <= WTW && inside(g, yy, xo0);
      const bool out1 = hx1 >= 1 && hx1 <= WTW && inside(g, yy, xo1);
      Tout* py0 = y + pix(g, b, out0 ? yy : 0, out0 ? xo0 : 0) + q2;
      Tout* py1 = y + pix(g, b, out1 ? yy : 0, out1 ? xo1 : 0) + q2;
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        if (out0) st2(py0 + 8 * j, make_float2(r[4 * j], r[4 * j + 1]));
        if (out1) st2(py1 + 8 * j, make_float2(r[4 * j + 2], r[4 * j + 3]));
      }
    }
    pc.mark(PW_STORE);
    pc.tile();
  }
  pc.flush(PHASE_BUF_WG);
}

// ---- (A) q, k, v; Gram and squared norms at C = 96 -------------------------

// The same tile and warpgroups as kernel (C): each warpgroup takes LN1(x) on
// its 64 halo rows (x read straight into the accumulator layout) into the
// operand layout, then q, k and v go through the 1x1 product and the
// depthwise step in six chunks of 48 channels (a third's halves), the
// product of chunk c + 1 (wgmma m64n48, B streamed through two slots with
// its taps) running while the CUDA cores do chunk c's depthwise step. q and
// k land on the tile's own rows (bf16, zero outside the band and on the
// halo columns) for the Gram q^T k, an mma.sync product (48-channel heads do
// not fill a 64-row operand) whose fragments stay in registers over the
// group's tiles; the squared norms come from the fp32 depthwise outputs in
// fixed order; v goes to device memory for (C).
constexpr int QCH = 48;                      // channels of q, k or v a chunk
constexpr int NQC = 3 * WC / QCH;            // 6 chunks a tile
constexpr int WQ_B = WC * QCH * 2;           // W_qkv chunk (N = 48, K = C)
constexpr int WQ_LBO = (QCH / 8) * 128;
constexpr int WQ_SLOT = WQ_B + 9 * QCH * 4;  // + its taps [tap][48]: a packed chunk
constexpr int WQ_SLOT_S = 11008;             // its slot in shared memory, 128-byte aligned
constexpr int LTQ = QCH + 8;                 // t's row (bf16), padded
constexpr int LQK = 2 * WC + 8;              // q | k on the own rows (bf16), padded
constexpr int DWC = 3;                       // output columns a depthwise thread takes
constexpr int NDP = WTW / DWC;               // partial norms a channel (column groups)
constexpr int NDW = QCH * NDP;               // 480 depthwise threads
constexpr int GMAX = 3;                      // Gram fragments a warp holds (36 at one head)
constexpr int NW = WNT / 32;

enum : int {
  G_XOWN = 0,
  G_XRING = G_XOWN + NCG * OWN_PLANE,
  G_W = G_XRING + NCG * RING_PLANE,
  G_T = G_W + 2 * WQ_SLOT_S,
  G_QK = G_T + 8 * WHW * LTQ * 2,
  G_NRM = G_QK + OWN_ROWS * LQK * 2,
  G_LNW = G_NRM + 2 * WC * NDP * 4,
  G_LNB = G_LNW + WC * 4,
  G_BARS = G_LNB + WC * 4,
  G_TOTAL = G_BARS + 4 * 8,
};
static_assert(G_TOTAL <= SMEM_LIMIT, "kernel (A)'s tile must fit one SM");
static_assert(WQ_SLOT <= WQ_SLOT_S && G_T % 128 == 0 && G_QK % 128 == 0, "slots aligned");

enum { PG_LN1, PG_PROD, PG_DW, PG_GRAM, PG_REST };
#ifdef RAIE_PHASE_CLOCKS
__device__ long long* phase_buf_gram_wg = nullptr;
#define PHASE_BUF_GRAM_WG phase_buf_gram_wg
#else
#define PHASE_BUF_GRAM_WG nullptr
#endif

// Block (grp, b) walks tiles grp, grp + groups, ... of sample b (one wave:
// groups * B blocks resident) and writes part[b][grp] = (Gram [heads][hc][hc],
// squared norms [2C]) once, as stage.cu's kernel (A).
template <class Tin>
__global__ void __launch_bounds__(WNT, 1)
k_gram_wgmma(const Tin* __restrict__ x, const float* __restrict__ ln1,
             const float* __restrict__ ln1b, const bf16* __restrict__ wq_p,
             const float* __restrict__ qtaps_p, float* __restrict__ part,
             bf16* __restrict__ vout, Geo g, int groups, float eps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* t = (bf16*)(smem + G_T);
  bf16* qk = (bf16*)(smem + G_QK);
  float* nrm = (float*)(smem + G_NRM);
  const float* lnw = (const float*)(smem + G_LNW);
  const float* lnb = (const float*)(smem + G_LNB);
  uint64_t* wbar = (uint64_t*)(smem + G_BARS);  // [2] W_qkv chunk slots
  uint64_t* lbar = wbar + 2;                    // LN1's weights

  const int tid = threadIdx.x, wg = tid >> 7, wi = (tid >> 5) & 3, warp = tid >> 5;
  const int lane = tid & 31, gq = lane >> 2, q2 = (lane & 3) * 2;
  const bool ring = wg == 3;
  const int b = blockIdx.y, grp = blockIdx.x;
  const int my_tiles = grp < g.ntiles ? (g.ntiles - grp + groups - 1) / groups : 0;
  const int my_chunks = my_tiles * NQC;
  const bool with_bias = ln1b != nullptr;
  const int hc = g.hc, nh = hc / 16, per_head = nh * nh, nfrags = g.heads * per_head;
  PHASE_CLOCK(pc);

  auto issue_w = [&](int gc) {
    const int s = gc & 1;
    mbar_expect_tx(wbar + s, WQ_SLOT);
    bulk_load(smem + G_W + s * WQ_SLOT_S, wq_p + (size_t)(gc % NQC) * (WQ_B / 2), WQ_B, wbar + s);
    bulk_load(smem + G_W + s * WQ_SLOT_S + WQ_B, qtaps_p + (size_t)(gc % NQC) * 9 * QCH,
              9 * QCH * 4, wbar + s);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(wbar + i, 1);
    mbar_fence_init();
  }
  // q | k's halo columns 0 and 31 stay zero (the depthwise step writes 1..30)
  for (int i = tid; i < OWN_ROWS * LQK * 2 / 16; i += WNT)
    reinterpret_cast<uint4*>(qk)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(lbar, WC * 4 * (with_bias ? 2 : 1));
    bulk_load(smem + G_LNW, ln1, WC * 4, lbar);
    if (with_bias) bulk_load(smem + G_LNB, ln1b, WC * 4, lbar);
    for (int gc = 0; gc < 2 && gc < my_chunks; ++gc) issue_w(gc);
  }

  // this warpgroup's 64 halo rows of LN1(x), and this thread's two of them
  unsigned char* xblk = ring ? smem + G_XRING : smem + G_XOWN + wg * 1024;
  const int plane = ring ? RING_PLANE : OWN_PLANE;
  const int r0 = 16 * wi + gq;
  const int hy = ring ? (r0 < 32 ? 0 : WTH + 1) : 1 + 2 * wg + r0 / 32;
  const int hx0 = r0 % 32, hx1 = hx0 + 8;
  bf16* t_0 = t + (hy * WHW + hx0) * LTQ + q2;
  bf16* t_1 = t + (hy * WHW + hx1) * LTQ + q2;
  // the depthwise step's thread: channel df of each chunk, output columns
  // dj..dj+2, all rows (threads NDW.. take none)
  const int df = tid % QCH, dg = tid / QCH, dj = dg * DWC;

  // this warp's 16x16 fragments of the per-head Gram, f = warp, warp + NW,
  // ..., as mma accumulators (columns 0-7 and 8-15); q's and k's squared
  // norms of this thread's channel and columns, q0, q1, k0, k1 (chunks 0-3)
  float gacc[GMAX][2][4];
#pragma unroll
  for (int i = 0; i < GMAX; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) gacc[i][0][e] = gacc[i][1][e] = 0.f;
  float nq[4] = {0.f, 0.f, 0.f, 0.f};
  // acc += q^T k of fragment f over the tile's own rows (as stage.cu's)
  auto gram_frag = [&](float (&acc)[2][4], int f) {
    const int h = f / per_head, m0 = (f % per_head) / nh * 16, n0 = (f % nh) * 16;
    const bf16* qa = qk + ((lane & 7) + (lane >> 4) * 8) * LQK + h * hc + m0 + ((lane >> 3) & 1) * 8;
    const bf16* kb = qk + (lane & 15) * LQK + WC + h * hc + n0 + (lane >> 4) * 8;
    for (int k = 0; k < OWN_ROWS; k += 16) {
      unsigned af[4], bf[4];
      ldsm_x4_t(af, qa + k * LQK);
      ldsm_x4_t(bf, kb + k * LQK);
      frag_mma(acc[0], acc[1], af, bf);
    }
  };
  // t = bf16(LN1(x) @ W_qkv[:, chunk gc]) on this warpgroup's halo rows,
  // issued and left running into acc
  auto product = [&](int gc, float (&acc)[24]) {
    const int s = gc & 1;
    mbar_wait(wbar + s, (gc >> 1) & 1);
    const unsigned char* wb = smem + G_W + s * WQ_SLOT_S;
    wg_fence();
#pragma unroll
    for (int k = 0; k < WC / 16; ++k)
      wgmma_ss_n48(acc, wg_desc(xblk + 2 * k * plane, plane, 128),
                   wg_desc(wb + 2 * k * WQ_LBO, WQ_LBO, 128), k > 0);
    wg_commit();
  };
  auto store_t = [&](const float (&acc)[24]) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      st2(t_0 + 8 * j, make_float2(acc[4 * j], acc[4 * j + 1]));
      st2(t_1 + 8 * j, make_float2(acc[4 * j + 2], acc[4 * j + 3]));
    }
  };

  if (my_tiles > 0) mbar_wait(lbar, 0);
  for (int it = 0; it < my_tiles; ++it) {
    const int tile = grp + it * groups;
    const int y0 = (tile / g.ntj) * WTH, x0 = (tile % g.ntj) * WTW;
    if (it + 1 < my_tiles) {
      const int next = tile + groups;
      prefetch_x(x, g, b, (next / g.ntj) * WTH, (next % g.ntj) * WTW);
    }
    const int yy = y0 - 1 + hy, xx0 = x0 - 1 + hx0, xx1 = x0 - 1 + hx1;
    const bool rd0 = readable(g, yy, xx0), rd1 = readable(g, yy, xx1);
    {
      float xr[48];
      load_rows(xr, x + pix(g, b, rd0 ? yy : 0, rd0 ? xx0 : 0) + q2,
                x + pix(g, b, rd1 ? yy : 0, rd1 ? xx1 : 0) + q2, rd0, rd1);
      layernorm_rows(xr, rd0, rd1, lnw, with_bias ? lnb : nullptr, eps, xblk, plane, r0, q2);
    }
    fence_proxy_async();
    wg_bar(wg);  // the warpgroup's LN1 rows are written
    pc.mark(PG_LN1);
    const int gc0 = it * NQC;
    {
      float acc[24];
      product(gc0, acc);
      wg_wait<0>();
      reg_fence(acc);
      // the last tile's depthwise step is done with t (its last barrier)
      store_t(acc);
    }
    __syncthreads();  // t of chunk 0 is complete
    pc.mark(PG_PROD);
#pragma unroll 1
    for (int c = 0; c < NQC; ++c) {
      const int gc = gc0 + c, s3 = c / 2, ch0 = (c % 2) * QCH;
      float nx[24];
      if (c + 1 < NQC) product(gc + 1, nx);
      // depthwise 3x3 (fp32 taps) of channel ch0 + df of third s3 on output
      // columns dj..dj+2, three halo rows by five columns in registers
      if (tid < NDW) {
        const float* taps = (const float*)(smem + G_W + (gc & 1) * WQ_SLOT_S + WQ_B);
        const bf16* tf = t + dj * LTQ + df;
        const int ch = ch0 + df;
        float wk[9], u[3][5], nacc = 0.f;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) wk[tap] = taps[tap * QCH + df];
#pragma unroll
        for (int row = 0; row < 2; ++row)
#pragma unroll
          for (int cc = 0; cc < 5; ++cc) u[row][cc] = __bfloat162float(tf[(row * WHW + cc) * LTQ]);
#pragma unroll
        for (int i0 = 0; i0 < WTH; i0 += 3) {
#pragma unroll
          for (int sl = 0; sl < 3; ++sl) {
            const int i = i0 + sl;  // output row; halo row i + di lies in slot (sl + di) % 3
#pragma unroll
            for (int cc = 0; cc < 5; ++cc)
              u[(sl + 2) % 3][cc] = __bfloat162float(tf[((i + 2) * WHW + cc) * LTQ]);
            float a[DWC] = {0.f, 0.f, 0.f};
#pragma unroll
            for (int dj2 = 0; dj2 < 3; ++dj2)
#pragma unroll
              for (int di = 0; di < 3; ++di)
#pragma unroll
                for (int o = 0; o < DWC; ++o) a[o] += u[(sl + di) % 3][o + dj2] * wk[di * 3 + dj2];
#pragma unroll
            for (int o = 0; o < DWC; ++o) {
              const int yo = y0 + i, xo = x0 + dj + o;
              const bool in = inside(g, yo, xo);
              if (s3 < 2) {
                const float q = in ? a[o] : 0.f;
                qk[(i * WHW + dj + o + 1) * LQK + s3 * WC + ch] = __float2bfloat16(q);
                nacc += q * q;
              } else if (in) {
                vout[pix(g, b, yo, xo, WC) + ch] = __float2bfloat16(a[o]);
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) nq[k] += c == k ? nacc : 0.f;
      }
      __syncwarp();
      wg_wait<0>();
      reg_fence(nx);
      // chunk c's depthwise step is done with t (and with its taps: the slot
      // takes chunk gc + 2); after chunk 3, q | k is complete
      __syncthreads();
      pc.mark(PG_DW);
      if (tid == 0 && gc + 2 < my_chunks) issue_w(gc + 2);
      if (c + 1 < NQC) store_t(nx);
      if (c == 3) {
#pragma unroll
        for (int i = 0; i < GMAX; ++i)
          if (warp + i * NW < nfrags) gram_frag(gacc[i], warp + i * NW);
        pc.mark(PG_GRAM);
      }
      if (c + 1 < NQC) __syncthreads();  // t of chunk c + 1 is complete
    }
    pc.tile();
  }
  // part[b][grp] = (Gram [heads][hc][hc], norms [2C]) unpadded
  const int gout = g.heads * hc * hc;
  float* out = part + ((size_t)b * groups + grp) * (gout + 2 * WC);
#pragma unroll
  for (int i = 0; i < GMAX; ++i) {
    const int f = warp + i * NW;
    if (f >= nfrags) continue;
    float* at = out + ((f / per_head) * hc + (f % per_head) / nh * 16 + gq) * hc + (f % nh) * 16 + q2;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      st2(at + 8 * e, make_float2(gacc[i][e][0], gacc[i][e][1]));
      st2(at + 8 * hc + 8 * e, make_float2(gacc[i][e][2], gacc[i][e][3]));
    }
  }
  // the norms: each channel's column groups summed in order
  if (tid < NDW) {
#pragma unroll
    for (int k = 0; k < 4; ++k)  // chunks q0, q1, k0, k1
      nrm[(k / 2 * WC + k % 2 * QCH + df) * NDP + dg] = nq[k];
  }
  __syncthreads();
  for (int i = tid; i < 2 * WC; i += WNT) {
    float sq = 0.f;
    for (int j = 0; j < NDP; ++j) sq += nrm[i * NDP + j];
    out[gout + i] = sq;
  }
  pc.mark(PG_REST);
  pc.flush(PHASE_BUF_GRAM_WG);
}

// ---- host -----------------------------------------------------------------

constexpr int ERR_TMAP = 100003;  // the driver refused v's tensor map

// v (B, Hs, W, C) bf16 as the 5-D view (8, C/8, W, rows, B), rows the
// readable ones [rows_lo, rows_hi) of the band; a box of one plane of 8
// channels, 32 columns and `box_rows` rows taken every `row_stride` rows.
int v_map(CUtensorMap* map, const void* v, const Geo& g, int rows_lo, int rows_hi, int box_rows,
          int row_stride) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_TMAP;
  const size_t row = (size_t)g.W * WC;
  const cuuint64_t dims[5] = {8, (cuuint64_t)NCG, (cuuint64_t)g.W,
                              (cuuint64_t)(rows_hi - rows_lo), (cuuint64_t)g.B};
  const cuuint64_t strides[4] = {16, (cuuint64_t)WC * 2, (cuuint64_t)row * 2,
                                 (cuuint64_t)g.Hs * row * 2};
  const cuuint32_t box[5] = {8, 1, (cuuint32_t)WHW, (cuuint32_t)(box_rows * row_stride), 1};
  const cuuint32_t es[5] = {1, 1, 1, (cuuint32_t)row_stride, 1};
  void* base = (void*)((const bf16*)v + (size_t)(rows_lo + g.halo) * row);
  const CUresult res = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, base, dims, strides, box, es,
                           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_TMAP;
}

template <class Tin, class Tout>
int launch(const void* x, void* y, const CUtensorMap& mo, const CUtensorMap& mr,
           const void* attn_t, int gheads, const void* wproj_p, const void* ln2,
           const void* ln2b, const void* win_p, const void* wtaps_p, const void* wout_p,
           const Geo& g, int rows_lo, float eps, int grid, cudaStream_t stream) {
  auto k = k_apply_wgmma<Tin, Tout>;
  int err = opt_in(k, S_TOTAL);
  if (err) return err;
  k<<<grid, WNT, S_TOTAL, stream>>>((const Tin*)x, (Tout*)y, mo, mr, (const bf16*)attn_t, gheads,
                                    (const bf16*)wproj_p, (const float*)ln2, (const float*)ln2b,
                                    (const bf16*)win_p, (const float*)wtaps_p,
                                    (const bf16*)wout_p, g, rows_lo, eps);
  return (int)cudaGetLastError();
}

template <class Tin>
int launch_gram(const void* x, const void* ln1, const void* ln1b, const void* wq_p,
                const void* qtaps_p, void* part, void* vout, const Geo& g, int groups, float eps,
                cudaStream_t stream) {
  auto k = k_gram_wgmma<Tin>;
  int err = opt_in(k, G_TOTAL);
  if (err) return err;
  k<<<dim3(groups, g.B), WNT, G_TOTAL, stream>>>(
      (const Tin*)x, (const float*)ln1, (const float*)ln1b, (const bf16*)wq_p,
      (const float*)qtaps_p, (float*)part, (bf16*)vout, g, groups, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- C interface (ctypes); see stage.cu's for the conventions -------------

extern "C" {

// Thread blocks of kernel (C) at C = 96 the device keeps resident on one SM
// (one, by design: the tile takes most of the SM's shared memory).
int raie_stage_sm90_blocks_per_sm() {
  return resident_blocks(k_apply_wgmma<float, float>, WNT, S_TOTAL);
}

// The same of kernel (A) at C = 96.
int raie_stage_sm90_gram_blocks_per_sm() {
  return resident_blocks(k_gram_wgmma<float>, WNT, G_TOTAL);
}

// The tile this kernel takes: rows and columns of outputs, hidden channels a
// chunk, threads a block.
int raie_stage_sm90_geometry(int* th, int* tw, int* fc, int* threads) {
  *th = WTH, *tw = WTW, *fc = WFC, *threads = WNT;
  return 0;
}

const char* raie_stage_sm90_error_string(int code) {
  if (code == ERR_TMAP) return "the driver refused the TMA descriptor of v";
  return tile_error_string(code);
}

#ifdef RAIE_PHASE_CLOCKS
// Where kernels (A) and (C) write their cycles per phase (null: nowhere).
int raie_stage_sm90_phase_buffers(void* gram_rows, void* apply_rows) {
  cudaError_t err = cudaMemcpyToSymbol(phase_buf_gram_wg, &gram_rows, sizeof(void*));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(phase_buf_apply_wg, &apply_rows, sizeof(void*));
  return (int)err;
}
#endif

// Kernel (A) at C = 96: v (B, Hs, W, 96) bf16 on the band's own pixels and
// part (B, groups, heads hc hc + 192) fp32 from x (B, Hs, W, 96), LN1's weight
// and bias (null: BiasFree), W_qkv and its taps packed in chunks
// (ops/block.py::pack_wgmma); `gram_heads` as stage.cu's raie_stage_gram
// (C/gram_heads a multiple of 16).
int raie_stage_gram_wgmma(const void* x, int x_is_bf16, const void* ln1, const void* ln1b,
                          const void* wq_p, const void* qtaps_p, void* part, void* vout, int B,
                          int H, int W, int gram_heads, int groups, int halo, int y_img,
                          int H_img, float eps, void* stream) {
  if (gram_heads <= 0 || WC % gram_heads || (WC / gram_heads) % 16 || groups <= 0 || B <= 0 ||
      W <= 0)
    return ERR_SHAPE;
  Geo g = make_geo(B, H, W, WC, gram_heads, 0, 0, WTH, WTW);
  if (!set_band(g, halo, y_img, H_img) || g.heads * (g.hc / 16) * (g.hc / 16) > GMAX * NW)
    return ERR_SHAPE;
  cudaStream_t s = (cudaStream_t)stream;
  return x_is_bf16
             ? launch_gram<bf16>(x, ln1, ln1b, wq_p, qtaps_p, part, vout, g, groups, eps, s)
             : launch_gram<float>(x, ln1, ln1b, wq_p, qtaps_p, part, vout, g, groups, eps, s);
}

// Kernel (C) at C = 96: y (B, Hs, W, 96) = the block's output from x (the
// same shape), v (B, Hs, W, 96) bf16 and attn_t (B, gram_heads, hc, hc) bf16
// of kernels (A) and (B), W_proj, W_in, its taps and W_out packed in the
// operand layout (ops/block.py::pack_wgmma), LN2's weight and bias (null:
// BiasFree). (halo, y_img, H_img) as stage.cu's; `grid` persistent blocks (0:
// one an SM).
int raie_stage_apply_wgmma(const void* x, int x_is_bf16, void* y, int y_is_bf16, const void* vin,
                           const void* attn_t, int gram_heads, const void* wproj_p,
                           const void* ln2, const void* ln2b, const void* win_p,
                           const void* wtaps_p, const void* wout_p, int B, int H, int W, int Fp,
                           int halo, int y_img, int H_img, float eps, int grid, void* stream) {
  if (gram_heads <= 0 || WC % gram_heads || Fp <= 0 || Fp % WFC || B <= 0 || W <= 0)
    return ERR_SHAPE;
  Geo g = make_geo(B, H, W, WC, gram_heads, Fp, WFC, WTH, WTW);
  if (!set_band(g, halo, y_img, H_img)) return ERR_SHAPE;
  const int rows_lo = -halo > -y_img ? -halo : -y_img;
  const int rows_hi = H + halo < H_img - y_img ? H + halo : H_img - y_img;
  CUtensorMap mo, mr;
  int err = v_map(&mo, vin, g, rows_lo, rows_hi, WTH, 1);
  if (!err) err = v_map(&mr, vin, g, rows_lo, rows_hi, 2, WTH + 1);
  if (err) return err;
  if (grid <= 0) {
    int dev = 0;
    if ((err = (int)cudaGetDevice(&dev))) return err;
    if ((err = (int)cudaDeviceGetAttribute(&grid, cudaDevAttrMultiProcessorCount, dev)))
      return err;
  }
  if (grid > B * g.ntiles) grid = B * g.ntiles;
  cudaStream_t s = (cudaStream_t)stream;
  auto launch_as = x_is_bf16 ? (y_is_bf16 ? launch<bf16, bf16> : launch<bf16, float>)
                             : (y_is_bf16 ? launch<float, bf16> : launch<float, float>);
  return launch_as(x, y, mo, mr, attn_t, gram_heads, wproj_p, ln2, ln2b, win_p, wtaps_p, wout_p,
                   g, rows_lo, eps, grid, s);
}

}  // extern "C"
